"""The port's cached decode against its own train forward and against the
JAX package's decode, on the five ported dense smoke configs: the twin of
``tests/test_models.py::test_decode_matches_full_forward`` (prefill of
S - 4 positions, then 4 decode steps; gemma's local layers through the
ring buffer), the paged chunk-prefill and decode steps against the JAX
package's, and the grouped decode attention's batch-chunk route.

Parameters are JAX-initialised and carried over by ``repro_torch.interop``;
the tokens are numpy draws.  Tolerances:

* against the port's own train forward, the reference test's ``atol =
  rtol = 0.05`` (the same quantities in another summation order; the
  bf16 configs round every matmul output);
* against the JAX package: llama-60m-smoke is f32, held to 8 f32 spacings
  of the logits' largest magnitude, as ``test_torch_lm.py`` holds the
  train logits; the other four are bf16, held to 4 bf16 spacings, as
  ``test_torch_dense.py`` holds theirs (a sum near a rounding boundary
  moves one bf16 spacing, which the next layers carry);
* the batch-chunk route to 8 f32 spacings (``test_torch_attention.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import bf16_spacings, port_model, spacings, to_torch

from repro import configs as jconfigs
from repro.launch.serve import pad_cache as jax_pad_cache
from repro.models import attention as jattn, lm as jlm
from repro_torch import configs
from repro_torch.launch.serve import pad_cache
from repro_torch.models import attention, lm

ARCHS = ["llama-60m", "qwen2.5-3b", "gemma2-9b", "gemma3-27b",
         "deepseek-67b"]
PAGED = ["llama-60m", "qwen2.5-3b", "deepseek-67b"]
B = 2


def _close_to_jax(got, want, cfg):
    if cfg.dtype == "float32":
        return spacings(got, want) <= 8
    return bf16_spacings(got, want) <= 4


def _tokens(cfg, shape, seed=0):
    return np.random.RandomState(seed).randint(0, cfg.vocab, shape) \
        .astype(np.int32)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_full_forward(arch):
    """Prefill + incremental decode == the sliced train forward (port) and
    == the JAX package's prefill + decode logits."""
    jcfg, tcfg = jconfigs.get_smoke(arch), configs.get_smoke(arch)
    S = max(32, tcfg.window)   # the ring handoff needs S % window == 0
    prefix = S - 4
    jp, model = port_model(jcfg, tcfg, seed=0)
    params = model.tree()
    tokens = _tokens(tcfg, (B, S))
    tt = torch.from_numpy(tokens)
    with torch.no_grad():
        full = model(tt).float().numpy()

    logits, cache = lm.make_prefill_step(tcfg)(params,
                                               {"tokens": tt[:, :prefix]})
    jlogits, jcache = jax.jit(jlm.make_prefill_step(jcfg))(
        jp, {"tokens": jnp.asarray(tokens[:, :prefix])})
    assert cache["pos"] == prefix
    np.testing.assert_allclose(logits.float().numpy(), full[:, prefix - 1],
                               atol=0.05, rtol=0.05)
    assert _close_to_jax(logits, jlogits, tcfg)
    cache = pad_cache(cache, S, window=tcfg.window)
    jcache = jax_pad_cache(jcache, S, window=jcfg.window)
    decode = lm.make_decode_step(tcfg)
    jdecode = jax.jit(jlm.make_decode_step(jcfg))
    for t in range(prefix, S):
        logits, cache = decode(params, cache, {"tokens": tt[:, t:t + 1]})
        jlogits, jcache = jdecode(jp, jcache,
                                  {"tokens": jnp.asarray(tokens[:, t:t + 1])})
        np.testing.assert_allclose(
            logits.float().numpy(), full[:, t], atol=0.05, rtol=0.05,
            err_msg=f"{arch} decode step {t}")
        assert _close_to_jax(logits, jlogits, tcfg), (arch, t)
    assert cache["pos"] == S


def test_ring_buffer_wraps_like_the_reference():
    """gemma2-9b-smoke (window 32): a 64-position prefill hands over the
    last 32 entries, and 4 decode steps write ring slots 0-3 over the
    oldest ones; logits against the JAX package's ring decode."""
    arch, S, steps = "gemma2-9b", 64, 4
    jcfg, tcfg = jconfigs.get_smoke(arch), configs.get_smoke(arch)
    jp, model = port_model(jcfg, tcfg, seed=1)
    params = model.tree()
    tokens = _tokens(tcfg, (B, S + steps), seed=1)
    tt = torch.from_numpy(tokens)
    _, cache = lm.make_prefill_step(tcfg)(params, {"tokens": tt[:, :S]})
    _, jcache = jax.jit(jlm.make_prefill_step(jcfg))(
        jp, {"tokens": jnp.asarray(tokens[:, :S])})
    local = cache["layers"]["b0"]["k"]
    assert local.shape[2] == tcfg.window          # (periods, B, w, KV, hd)
    glob = cache["layers"]["b1"]["k"]
    assert glob.shape[2] == S
    cache = pad_cache(cache, S + steps, window=tcfg.window)
    jcache = jax_pad_cache(jcache, S + steps, window=jcfg.window)
    assert cache["layers"]["b0"]["k"].shape[2] == tcfg.window
    decode = lm.make_decode_step(tcfg)
    jdecode = jax.jit(jlm.make_decode_step(jcfg))
    for t in range(S, S + steps):
        logits, cache = decode(params, cache, {"tokens": tt[:, t:t + 1]})
        jlogits, jcache = jdecode(jp, jcache,
                                  {"tokens": jnp.asarray(tokens[:, t:t + 1])})
        assert _close_to_jax(logits, jlogits, tcfg), t
    # the ring's slots 0..3 hold the new entries: as the reference's
    np.testing.assert_array_equal(
        cache["layers"]["b0"]["k"][:, :, :steps].float().numpy() != 0, True)


@pytest.mark.parametrize("quant", [None, "int8"])
@pytest.mark.parametrize("arch", PAGED)
def test_paged_steps_match_reference(arch, quant):
    """Chunk prefill of two slots' prompts (the second over a page
    boundary, its last chunk padded), then paged decode ticks with one
    slot idle on the trash page: logits and every written page against
    the JAX package's steps from the same params and inputs."""
    jcfg, tcfg = jconfigs.get_smoke(arch), configs.get_smoke(arch)
    jp, model = port_model(jcfg, tcfg, seed=2)
    params = model.tree()
    PAGE, MP, C, SLOTS = 4, 6, 8, 3
    pools = lm.init_paged_caches(tcfg, 1 + SLOTS * MP, PAGE, kv_quant=quant,
                                 device="cpu")
    jpools = jlm.init_paged_caches(jcfg, 1 + SLOTS * MP, PAGE,
                                   kv_quant=quant)
    pt = np.zeros((SLOTS, MP), np.int32)
    pt[0, :3] = [1, 2, 3]
    pt[2, :4] = [7, 9, 8, 10]
    prompts = {0: _tokens(tcfg, (5,), 3), 2: _tokens(tcfg, (11,), 4)}
    chunk = lm.make_chunk_prefill_step(tcfg)
    jchunk = jax.jit(jlm.make_chunk_prefill_step(jcfg))
    lens = np.zeros((SLOTS,), np.int32)
    last = np.zeros((SLOTS, 1), np.int32)
    for slot, prompt in prompts.items():
        for start in range(0, len(prompt), C):
            piece = prompt[start:start + C]
            toks = np.zeros((1, C), np.int32)
            toks[0, :len(piece)] = piece
            args = (pt[slot:slot + 1], np.array([start], np.int32), toks)
            logits, out = chunk(params, pools, *map(torch.from_numpy, args))
            assert out is pools
            jlogits, jpools = jchunk(jp, jpools, *map(jnp.asarray, args))
            assert _close_to_jax(logits, jlogits, tcfg), (slot, start)
        lens[slot] = len(prompt)
        last[slot, 0] = int(np.argmax(np.asarray(jlogits[0, len(piece) - 1])))
    decode = lm.make_paged_decode_step(tcfg)
    jdecode = jax.jit(jlm.make_paged_decode_step(jcfg))
    live = pt.copy()
    live[1] = 0                                        # slot 1 idle: trash
    for _ in range(3):
        args = (live, lens, last)
        logits, _ = decode(params, pools, *map(torch.from_numpy, args))
        jlogits, jpools = jdecode(jp, jpools, *map(jnp.asarray, args))
        assert _close_to_jax(logits[[0, 2]], jlogits[jnp.array([0, 2])],
                             tcfg)
        last = np.asarray(jnp.argmax(jlogits, -1))[:, None].astype(np.int32)
        lens[[0, 2]] += 1
    # the pages the slots own hold what the reference's hold (page 0,
    # the trash page, takes either winner of its duplicate writes)
    owned = sorted({int(p) for p in pt.ravel() if p})
    for (name, got), want in zip(_leaves(pools), _leaves(jpools)):
        g, w = got[:, owned], np.asarray(want[1])[:, owned]
        if g.dtype == torch.int8:
            # codes may differ by one where the inputs differ by a spacing
            assert (g.numpy().astype(int) - w.astype(int)).__abs__().max() \
                <= 1, name
        else:
            assert _close_to_jax(g, jnp.asarray(w), tcfg), name


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += _leaves(tree[k], f"{prefix}/{k}")
        return out
    return [(prefix, tree)]


def test_decode_attn_grouped_batch_chunks_match_reference():
    """B = 32 rows over a 131072-entry cache (T·B = 2^22): the rows go in
    two interleaved chunks of 16, as the reference's scan takes them."""
    Bq, T, H, KV, HD = 32, 131072, 2, 1, 4
    rng = np.random.RandomState(0)
    q = rng.randn(Bq, 1, H, HD).astype(np.float32)
    k = rng.randn(Bq, T, KV, HD).astype(np.float32)
    v = rng.randn(Bq, T, KV, HD).astype(np.float32)
    valid = np.arange(T)[None, :] <= rng.randint(0, T, (Bq, 1))
    want = jattn._decode_attn_grouped(*map(jnp.asarray, (q, k, v, valid)),
                                      0.0)
    got = attention._decode_attn_grouped(
        *map(to_torch, (q, k, v, valid)), 0.0)
    assert spacings(got, want) <= 8


@pytest.mark.parametrize("arch", ["llama-60m", "gemma2-9b"])
def test_decode_from_init_cache_matches_full_forward(arch):
    """Token-by-token decode from ``lm.init_cache`` (no prefill) equals the
    train forward at every position; gemma2-9b-smoke's local layers run 40
    positions through a ring of 32, wrapping as the window slides."""
    cfg = configs.get_smoke(arch)
    S = 40
    _, model = port_model(jconfigs.get_smoke(arch), cfg, seed=3)
    params = model.tree()
    tt = torch.from_numpy(_tokens(cfg, (B, S), seed=3))
    with torch.no_grad():
        full = model(tt).float().numpy()
    cache = lm.init_cache(cfg, B, S, "cpu")
    if cfg.window:
        assert cache["layers"]["b0"]["k"].shape[2] == cfg.window
    decode = lm.make_decode_step(cfg)
    for t in range(S):
        logits, cache = decode(params, cache, {"tokens": tt[:, t:t + 1]})
        np.testing.assert_allclose(logits.float().numpy(), full[:, t],
                                   atol=0.05, rtol=0.05, err_msg=str(t))
    assert cache["pos"] == S
