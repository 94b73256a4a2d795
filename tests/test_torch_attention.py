"""The port's train-mode attention routes against the JAX package's on the
same numpy inputs: GQA (2 KV heads of 4), a causal offset, a sliding
window, a logit softcap, masked key slots, the block-local and chunked
routes, QKV bias and QK-norm, in f32 and bf16.

Tolerances are counted as ``torch_parity.spacings`` measures them, at the
largest magnitude of the reference's output.  f32: the score and output
products add in another order in ATen than in XLA, 8 f32 spacings
(1.5–5 measured).  bf16: the outputs are rounded to bf16 after those
sums, so a sum that lands near a rounding boundary moves one bf16 spacing;
1 bf16 spacing (0–0.0625 measured).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import bf16_spacings, spacings, to_torch

from repro import configs as jconfigs
from repro.models import attention as jattn, rope as jrope
from repro_torch import configs
from repro_torch.models import attention, rope

TOL_F32 = 8
TOL_BF16 = 1
B, H, KV, HD = 2, 4, 2, 16
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def _qkv(S, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(B, S, H, HD).astype(np.float32),
            rng.randn(B, S, KV, HD).astype(np.float32),
            rng.randn(B, S, KV, HD).astype(np.float32))


def _both(arrays, dtype):
    jd, td = DTYPES[dtype]
    return ([jnp.asarray(a, jd) for a in arrays],
            [to_torch(a, td) for a in arrays])


def _repeated(arrays, dtype):
    (jq, jk, jv), (tq, tk, tv) = _both(arrays, dtype)
    return ((jq, jattn._repeat_kv(jk, H), jattn._repeat_kv(jv, H)),
            (tq, attention._repeat_kv(tk, H), attention._repeat_kv(tv, H)))


def _close(got, want, dtype):
    if dtype == "f32":
        assert spacings(got, want) <= TOL_F32
    else:
        assert got.dtype == torch.bfloat16
        assert bf16_spacings(got, want) <= TOL_BF16


def test_repeat_kv_is_the_reference():
    _, k, _ = _qkv(8)
    got = attention._repeat_kv(to_torch(k), H)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jattn._repeat_kv(k, H)))
    assert attention._repeat_kv(got, H) is got


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_direct_attn_gqa_offset_window_cap_kv_valid(dtype):
    S, off = 40, 8
    j, t = _repeated(_qkv(S), dtype)
    valid = np.random.RandomState(1).rand(B, S) > 0.3
    valid[:, 0] = True
    kw = dict(causal_offset=off, window=12, cap=5.0)
    want = jattn._direct_attn(j[0][:, off:], j[1], j[2],
                              kv_valid=jnp.asarray(valid), **kw)
    got = attention._direct_attn(t[0][:, off:], t[1], t[2],
                                 kv_valid=torch.from_numpy(valid), **kw)
    _close(got, want, dtype)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_local_block_attn(dtype):
    j, t = _repeated(_qkv(48), dtype)
    want = jattn._local_block_attn(*j, window=16, cap=5.0)
    _close(attention._local_block_attn(*t, window=16, cap=5.0), want, dtype)
    with pytest.raises(ValueError, match="multiple of window"):
        attention._local_block_attn(*t, window=20, cap=0.0)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_flash_attn_small_chunks(dtype):
    j, t = _repeated(_qkv(64), dtype)
    kw = dict(q_chunk=8, kv_chunk=16, cap=5.0)
    _close(attention._flash_attn(*t, **kw), jattn._flash_attn(*j, **kw),
           dtype)
    with pytest.raises(ValueError, match="not a multiple"):
        attention._flash_attn(*t, q_chunk=24, kv_chunk=16)


def _cfgs(**kw):
    base = dict(n_layers=1, d_model=32, n_heads=H, n_kv_heads=KV,
                head_dim=HD, d_ff=64, vocab=64, qkv_bias=True, qk_norm=True,
                window=16, attn_softcap=5.0, rope_theta=1e6)
    base.update(kw)
    return (jconfigs.get_smoke("qwen2.5-3b").with_(**base),
            configs.get_smoke("qwen2.5-3b").with_(**base))


def _attn_params(jcfg, seed=2):
    """Random non-zero weights, biases and QK-norm gains (their init is
    zeros, which would test nothing)."""
    rng = np.random.RandomState(seed)
    d, hd = jcfg.d_model, jcfg.head_dim
    shapes = {"wq": (d, H * hd), "wk": (d, KV * hd), "wv": (d, KV * hd),
              "wo": (H * hd, d), "bq": (H * hd,), "bk": (KV * hd,),
              "bv": (KV * hd,), "q_norm": (hd,), "k_norm": (hd,)}
    return {k: (0.3 * rng.randn(*s)).astype(np.float32)
            for k, s in shapes.items()}


# (S, local): the route attn_apply takes at the window of 16
ROUTES = {"direct": (12, True), "block_local": (48, True),
          "direct_masked": (40, True), "direct_global": (40, False)}


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("route", list(ROUTES))
def test_attn_apply_bias_qk_norm(route, dtype):
    S, local = ROUTES[route]
    jcfg, tcfg = _cfgs(dtype="float32" if dtype == "f32" else "bfloat16")
    params = _attn_params(jcfg)
    x = np.random.RandomState(3).randn(B, S, jcfg.d_model).astype(np.float32)
    jd, td = DTYPES[dtype]
    jp = {k: jnp.asarray(v, jd) for k, v in params.items()}
    tp = {k: to_torch(v, td) for k, v in params.items()}
    pos = np.arange(S)
    jcos, jsin = jrope.rope_angles(jnp.broadcast_to(pos, (B, S)), HD, 1e6)
    tcos, tsin = rope.rope_angles(torch.arange(S), HD, 1e6)
    want, _ = jattn.attn_apply(jp, jcfg, jnp.asarray(x, jd), jcos, jsin,
                               local=local)
    got, cache = attention.attn_apply(tp, tcfg, to_torch(x, td), tcos,
                                      tsin, local=local)
    assert cache is None
    _close(got, want, dtype)


@pytest.mark.parametrize("S,local,route", [
    (16, True, "_direct_attn"), (48, True, "_local_block_attn"),
    (40, True, "_direct_attn"), (8192, False, "_direct_attn"),
    (8704, False, "_flash_attn")])
def test_attn_apply_dispatch(monkeypatch, S, local, route):
    """The reference's train-mode dispatch order: block-local where the
    window divides S, direct masked where it does not, chunked past 8192
    positions without a window, else direct."""
    taken = []
    for name in ("_direct_attn", "_local_block_attn", "_flash_attn"):
        monkeypatch.setattr(attention, name, lambda q, *a, _n=name, **kw:
                            taken.append(_n) or torch.zeros_like(q))
    _, tcfg = _cfgs(d_model=8, n_heads=1, n_kv_heads=1, head_dim=8)
    p = {"wq": torch.zeros(8, 8), "wk": torch.zeros(8, 8),
         "wv": torch.zeros(8, 8), "wo": torch.zeros(8, 8),
         "bq": torch.zeros(8), "bk": torch.zeros(8), "bv": torch.zeros(8),
         "q_norm": torch.zeros(8), "k_norm": torch.zeros(8)}
    cos, sin = rope.rope_angles(torch.arange(S), 8, 1e6)
    attention.attn_apply(p, tcfg, torch.zeros(1, S, 8), cos, sin,
                         local=local)
    assert taken == [route]


def test_attn_apply_refuses_what_is_not_ported():
    """A windowed block has no paged layout, as in the reference
    (bidirectional attention is held against the reference in
    ``tests/test_torch_encdec.py``)."""
    _, tcfg = _cfgs()
    with pytest.raises(NotImplementedError, match="no page-table form"):
        attention.attn_apply({}, tcfg, None, None, None, local=True,
                             mode="decode", page_table=torch.zeros(1, 1))
