"""The staged GWT-Adam update of the port against the JAX package: the plain
versions of K4 and K5 (``repro_torch.kernels.gwt_adam.ref.gwt_adam_tile``
and ``gwt_adam_tile_q8``), their entry points ``ops.fused_update`` and
``ops.fused_update_q8``, and ``gwt(fused_write=False)``, the staged path.

Tolerances.  The plain versions are held bitwise (G̃, m', v', codes,
scales) to the JAX oracle run op by op (``jax.disable_jit()``): both round
every operation once, and the port takes the correctly rounded square root
(``ref._sqrt``).  The JAX oracle's ‖G̃‖² is one XLA reduction, summed in
another order than the port's, which is the CUDA kernels' (``ref.chunk_ssq``):
within ``SSQ_RTOL`` = 2e-6 relative (measured: 1.57e-6).  Against the TPU kernels in Pallas interpret
mode, which XLA compiles with its CPU backend's FMA contraction
(``a*s + b*s``, ``b1*m + (1-b1)*a``), G̃ and the moments may move by a few
f32 spacings: 4 allowed (measured 2); bf16 G̃ by one bf16 spacing
(measured 0); codes
by exactly 1 at no more than ``MAX_CODES_OFF_BY_ONE`` of a case's codes,
scales within 2 f32 spacings.

The staged optimizer over 3 steps against JAX ``gwt(fused_write=False,
impl="interpret")`` (its K4 in interpret mode, jitted) on llama-60m-smoke
plus a FIRST-mode leaf.  That FMA contraction reaches the moments (3 f32
spacings measured, 4 allowed) and, through the limiter's norms (summed in
another order: 12 spacings measured, 16 allowed) and the clipped steps,
the f32 parameters: 7 spacings measured, 8 allowed (4 would not hold:
``w_gate`` reads 6-7 both against the jitted and the op-by-op JAX
update).  bf16 parameters: one bf16 spacing (measured 0).  int8 state
follows ``test_torch_gwt_q8.py``: codes off by one at most 8 per leaf
state (measured 0), scales within 16 spacings (measured 4), norms within
128 (measured 14), f32 parameters within 32 (measured 25).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import bf16_spacings, flat_numpy, jax_params, spacings, \
    to_torch

from repro import configs as jconfigs
from repro.core.gwt import gwt as jax_gwt
from repro.kernels.gwt_adam import kernel as jkernel, ops as jops, \
    ref as jref
from repro.optim import codec as jcodec, schedules as jsched
from repro_torch.core.gwt import gwt
from repro_torch.kernels.gwt_adam import kernel, ops, ref
from repro_torch.optim import codec
from repro_torch.optim.base import flatten_with_paths, unflatten
from repro_torch.optim.schedules import warmup_cosine

SSQ_RTOL = 2e-6
MAX_CODES_OFF_BY_ONE = 8


def _inputs(shape, level, seed):
    rng = np.random.RandomState(seed)
    mshape = shape[:-1] + (shape[-1] >> level,)
    return (rng.randn(*shape).astype(np.float32),
            (rng.randn(*mshape) * 0.1).astype(np.float32),
            (rng.rand(*mshape) * 0.01).astype(np.float32))


def _tdt(dtype):
    return getattr(torch, dtype)


def _bits_equal(got, want):
    np.testing.assert_array_equal(
        got.float().numpy() if got.dtype == torch.bfloat16
        else got.numpy(),
        np.asarray(jnp.asarray(want).astype(jnp.float32))
        if want.dtype == jnp.bfloat16 else np.asarray(want))


def _jax_tile(g, m, v, dtype, level, interpret):
    """The JAX tile over an (L, m, n) stack: the oracle op by op, or the
    Pallas kernel in interpret mode (jitted)."""
    args = (jnp.asarray(g).astype(dtype), jnp.asarray(m), jnp.asarray(v))
    if interpret:
        fn = lambda a, b, c: jkernel.gwt_adam_tile(a, b, c, level=level,
                                                   interpret=True)
        return jax.vmap(fn)(*args)
    with jax.disable_jit():
        return jax.vmap(lambda a, b, c: jref.gwt_adam_tile(
            a, b, c, level=level))(*args)


@pytest.mark.parametrize("level", [1, 2, 3])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tile_matches_reference_op_by_op(level, dtype):
    g, m, v = _inputs((2, 24, 344), level, seed=level)
    want = _jax_tile(g, m, v, dtype, level, interpret=False)
    got = ref.gwt_adam_tile(to_torch(g, _tdt(dtype)), to_torch(m),
                            to_torch(v), level=level)
    assert got[0].dtype == _tdt(dtype) and got[3].shape == (2,)
    for a, b in zip(got[:3], want[:3]):
        _bits_equal(a, b)
    np.testing.assert_allclose(got[3].numpy(),
                               np.asarray(want[3]).reshape(2),
                               rtol=SSQ_RTOL)


@pytest.mark.parametrize("level", [1, 2, 3])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tile_matches_pallas_interpret(level, dtype):
    g, m, v = _inputs((2, 16, 64), level, seed=10 + level)
    want = _jax_tile(g, m, v, dtype, level, interpret=True)
    got = ref.gwt_adam_tile(to_torch(g, _tdt(dtype)), to_torch(m),
                            to_torch(v), level=level)
    if dtype == "float32":
        assert spacings(got[0], want[0]) <= 4
    else:
        assert bf16_spacings(got[0], want[0]) <= 1
    assert spacings(got[1], want[1]) <= 4
    assert spacings(got[2], want[2]) <= 4
    np.testing.assert_allclose(got[3].numpy(),
                               np.asarray(want[3]).sum((1, 2)),
                               rtol=SSQ_RTOL)


def _q8_inputs(shape, level, seed):
    """g and the encoded moments (by the JAX codec, so both packages start
    from the same codes), with the step's per-leaf salts."""
    g, m, v = _inputs(shape, level, seed)
    L = shape[0]
    enc = jax.vmap(lambda x, s: jcodec.blocked_quant(x, s))
    st = {}
    for name, a, salt in (("m", m, 11), ("v", v, 12)):
        q, s = enc(jnp.asarray(a), jnp.arange(L, dtype=jnp.uint32) + salt)
        st[name] = (np.asarray(q), np.asarray(s))
    key, step = jcodec.make_key(0), jnp.int32(4)
    lids = jnp.arange(3, 3 + L, dtype=jnp.int32)
    salts = np.stack([np.asarray(jcodec.slot_salt(key, step, i, lids))
                      for i in (0, 1)]).astype(np.int64)
    return g, st, salts


def _codes_close(got, want):
    d = got.numpy().astype(np.int32) - np.asarray(want).astype(np.int32)
    assert np.abs(d).max(initial=0) <= 1
    assert int((d != 0).sum()) <= MAX_CODES_OFF_BY_ONE


def _port_tile_q8(g, st, salts, dtype, level):
    return ref.gwt_adam_tile_q8(
        to_torch(g, _tdt(dtype)), to_torch(st["m"][0]), to_torch(st["m"][1]),
        to_torch(st["v"][0]), to_torch(st["v"][1]),
        torch.from_numpy(salts[0]), torch.from_numpy(salts[1]),
        level=level, block=64)


def _jax_tile_q8(g, st, salts, dtype, level, interpret):
    args = (jnp.asarray(g).astype(dtype), *(jnp.asarray(a) for a in
                                            (*st["m"], *st["v"])),
            jnp.asarray(salts[0], jnp.uint32),
            jnp.asarray(salts[1], jnp.uint32))
    mod = jkernel if interpret else jref
    kw = dict(level=level, block=64)
    if interpret:
        kw["interpret"] = True
    fn = jax.vmap(lambda *a: mod.gwt_adam_tile_q8(*a, **kw))
    if interpret:
        return fn(*args)
    with jax.disable_jit():
        return fn(*args)


# (2, 24, 344) at level 2: 24 * 86 = 2064 coefficients per leaf, 32.25
# quantization blocks, so each leaf ends in a partial block
@pytest.mark.parametrize("level", [1, 2, 3])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tile_q8_matches_reference_op_by_op(level, dtype):
    g, st, salts = _q8_inputs((2, 24, 344), level, seed=20 + level)
    want = _jax_tile_q8(g, st, salts, dtype, level, interpret=False)
    got = _port_tile_q8(g, st, salts, dtype, level)
    assert [t.dtype for t in got[:5]] == [_tdt(dtype), torch.int8,
                                          torch.float32, torch.int8,
                                          torch.float32]
    for a, b in zip(got[:5], want[:5]):
        _bits_equal(a, b)
    np.testing.assert_allclose(got[5].numpy(),
                               np.asarray(want[5]).reshape(2),
                               rtol=SSQ_RTOL)


@pytest.mark.parametrize("level", [1, 2])
def test_tile_q8_matches_pallas_interpret(level):
    """On a shape the TPU kernel tiles: 16 rows of 64 >> level
    coefficients per leaf, whole quantization blocks."""
    shape = (2, 16, 64)
    assert jkernel.q8_row_block(16, 64, level, 64) is not None
    g, st, salts = _q8_inputs(shape, level, seed=30 + level)
    want = _jax_tile_q8(g, st, salts, "float32", level, interpret=True)
    got = _port_tile_q8(g, st, salts, "float32", level)
    assert spacings(got[0], want[0]) <= 4
    for i in (1, 3):
        _codes_close(got[i], want[i])
    for i in (2, 4):
        assert spacings(got[i], want[i]) <= 2
    np.testing.assert_allclose(got[5].numpy(),
                               np.asarray(want[5]).sum((1, 2)),
                               rtol=SSQ_RTOL)


@pytest.mark.parametrize("shape", [(24, 64), (2, 3, 8, 64)])
def test_entry_points_match_reference(shape):
    """``ops.fused_update`` on a 2-D leaf and on a stacked 4-D leaf (leading
    dims merged into rows), and ``ops.fused_update_q8`` on the stack,
    against the JAX entries (``impl="jnp"``: the jitted oracle)."""
    level = 2
    g, m, v = _inputs(shape, level, seed=40)
    step = 3
    jg, jl, js = jops.fused_update(
        jnp.asarray(g), {"m": jnp.asarray(m), "v": jnp.asarray(v)},
        jnp.int32(step), level=level, impl="jnp")
    tg, tl, ts = ops.fused_update(
        to_torch(g), {"m": to_torch(m), "v": to_torch(v)},
        torch.tensor(step, dtype=torch.int32), level=level)
    assert tg.shape == shape and ts["m"].shape == m.shape
    assert spacings(tg, jg) <= 4
    assert spacings(ts["m"], js["m"]) <= 4 and spacings(ts["v"], js["v"]) <= 4
    assert float(tl) == float(jl)
    if len(shape) == 2:
        return
    # the q8 entry on the (L, ..., n) stack, salts as the engine passes them
    L = shape[0]
    enc = jax.vmap(lambda x, s: jcodec.blocked_quant(x, s))
    jst, tst = {}, {}
    for name, a, salt in (("m", m, 11), ("v", v, 12)):
        q, s = enc(jnp.asarray(a), jnp.arange(L, dtype=jnp.uint32) + salt)
        jst[name] = {"q": q, "scale": s}
        tst[name] = {"q": to_torch(np.asarray(q)),
                     "scale": to_torch(np.asarray(s))}
    lids = np.arange(L, dtype=np.int32)
    jg8, jl8, js8 = jops.fused_update_q8(
        jnp.asarray(g), jst, jnp.int32(step), jcodec.make_key(0),
        jnp.asarray(lids), level=level, impl="jnp")
    tstep = torch.tensor(step, dtype=torch.int32)
    salts = codec.slot_salt(codec.make_key(0), tstep,
                            torch.arange(2)[:, None], torch.from_numpy(lids))
    tg8, tl8, ts8 = ops.fused_update_q8(to_torch(g), tst, tstep, salts,
                                        level=level)
    assert tg8.shape == shape and float(tl8) == float(jl8)
    assert spacings(tg8, jg8) <= 4
    for name in ("m", "v"):
        assert ts8[name]["q"].shape == js8[name]["q"].shape
        _codes_close(ts8[name]["q"], js8[name]["q"])
        assert spacings(ts8[name]["scale"], js8[name]["scale"]) <= 2


def test_cpu_tensors_never_reach_the_staged_kernels():
    """On CPU tensors the staged entries take the plain versions and the
    launch counters stay where they were; the kernel wrappers refuse CPU
    tensors."""
    before = (kernel.launches_tile, kernel.launches_tile_q8)
    g, m, v = _inputs((2, 8, 64), 2, seed=5)
    step = torch.tensor(0, dtype=torch.int32)
    gt, _, st = ops.fused_update(to_torch(g), {"m": to_torch(m),
                                               "v": to_torch(v)}, step,
                                 level=2)
    want = ref.gwt_adam_tile(to_torch(g), to_torch(m), to_torch(v), level=2)
    assert torch.equal(gt, want[0]) and torch.equal(st["m"], want[1])
    q, s = codec.quant_blocks(to_torch(m).reshape(2, -1), 0)
    enc = {"q": q.reshape(m.shape), "scale": s}
    ops.fused_update_q8(to_torch(g), {"m": enc, "v": enc}, step,
                        torch.zeros((2, 2), dtype=torch.int64), level=2)
    assert (kernel.launches_tile, kernel.launches_tile_q8) == before
    with pytest.raises(ValueError, match="CUDA"):
        kernel.gwt_adam_tile(to_torch(g), to_torch(m), to_torch(v), level=2)
    with pytest.raises(ValueError, match="CUDA"):
        kernel.gwt_adam_tile_q8(
            to_torch(g), enc["q"], enc["scale"], enc["q"], enc["scale"],
            torch.zeros(2, dtype=torch.uint32),
            torch.zeros(2, dtype=torch.uint32), level=2, block=64)
    assert (kernel.launches_tile, kernel.launches_tile_q8) == before


# ---------------------------------------------------------------------------
# The staged optimizer
# ---------------------------------------------------------------------------

def _smoke_tree():
    """llama-60m-smoke parameters plus a FIRST-mode leaf (last axis not
    divisible by 4)."""
    flat = flat_numpy(jax_params(jconfigs.get_smoke("llama-60m"), seed=1))
    flat["extra/w_first"] = np.random.RandomState(2).randn(2, 16, 6) \
        .astype(np.float32)
    return {k: v.astype(np.float32) for k, v in flat.items()}


def _tree(flat, dtype, jax_side):
    if jax_side:
        return unflatten(list(flat), [jnp.asarray(v).astype(dtype)
                                      for v in flat.values()])
    return unflatten(list(flat), [to_torch(v, _tdt(dtype))
                                  for v in flat.values()])


def run_staged(flat, dtype, codec_name, steps=3, **kw):
    """``steps`` updates of both packages' staged GWT from the same
    parameters and gradients; returns the JAX and the port's params and
    state."""
    jopt = jax_gwt(lr=jsched.warmup_cosine(0.01, 10), impl="interpret",
                   fused_write=False, state_codec=codec_name, **kw)
    topt = gwt(lr=warmup_cosine(0.01, 10), fused_write=False,
               state_codec=codec_name, **kw)
    jp, tp = _tree(flat, dtype, True), _tree(flat, dtype, False)
    js, ts = jopt.init(jp), topt.init(tp)
    jupd = jax.jit(jopt.update)
    for k in range(steps):
        rng = np.random.RandomState(100 + k)
        g = {p: rng.randn(*v.shape).astype(np.float32) * 0.1
             for p, v in flat.items()}
        jp, js = jupd(_tree(g, dtype, True), js, jp)
        tp, ts = topt.update(_tree(g, dtype, False), ts, tp)
    return jopt, topt, jp, js, tp, ts


@pytest.mark.parametrize("codec_name", ["f32", "int8"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_staged_optimizer_matches_reference(codec_name, dtype):
    flat = _smoke_tree()
    jopt, topt, jp, js, tp, ts = run_staged(flat, dtype, codec_name)
    tplan = topt.engine.plan(tp)
    assert [b.name for b in tplan.buckets] == \
        [b.name for b in jopt.engine.plan(jp).buckets]
    assert all(b.rule.vector_update is None for b in tplan.buckets)
    jflat, tflat = flat_numpy(js), dict(zip(*flatten_with_paths(ts)))
    assert sorted(tflat) == sorted(jflat) and int(tflat["step"]) == 3
    int8 = codec_name == "int8"
    for path, want in jflat.items():
        if path.endswith("/q"):
            _codes_close(tflat[path], want)
        elif path.endswith("/prev_norm"):
            assert spacings(tflat[path], want) <= (128 if int8 else 16), path
        elif path.endswith("/scale"):
            assert spacings(tflat[path], want) <= 16, path
        elif path not in ("step", "codec_key"):
            assert spacings(tflat[path], want) <= 4, path
    jpf = flat_numpy(jp)
    for path, t in zip(*flatten_with_paths(tp)):
        assert t.dtype == _tdt(dtype)
        if dtype == "bfloat16":
            assert bf16_spacings(t, jpf[path]) <= 1, path
        else:
            assert spacings(t, jpf[path]) <= (32 if int8 else 8), path


def test_staged_path_runs_the_tile_per_leaf(monkeypatch):
    """The staged path calls ``ops.fused_update`` once per GWT leaf and
    never the fused write; the default path the reverse, once per
    bucket."""
    from repro_torch.kernels.gwt_adam import ops as gops
    calls = {"tile": 0, "write": 0}
    tile, write = gops.fused_update, gops.fused_write_update

    def count(name, fn):
        def wrapped(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(gops, "fused_update", count("tile", tile))
    monkeypatch.setattr(gops, "fused_write_update", count("write", write))
    flat = _smoke_tree()
    tp = _tree(flat, "float32", False)
    g = _tree({k: v * 0.1 for k, v in flat.items()}, "float32", False)
    n_gwt = sum(len(b.indices) for b in gwt(lr=0.01).engine.plan(tp).buckets
                if b.name.startswith("gwt_"))
    n_buckets = sum(1 for b in gwt(lr=0.01).engine.plan(tp).buckets
                    if b.name.startswith("gwt_"))
    for kw, want in (({"fused_write": False}, {"tile": n_gwt, "write": 0}),
                     ({}, {"tile": 0, "write": n_buckets})):
        calls.update(tile=0, write=0)
        opt = gwt(lr=0.01, **kw)
        opt.update(g, opt.init(tp), tp)
        assert calls == want, kw
