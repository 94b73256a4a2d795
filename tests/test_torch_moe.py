"""The MoE substrate of the port (``repro_torch.models.moe``, the
``attn+moe`` block, the aux loss through ``lm``) against the JAX package's
``repro.models.moe`` on the same numpy inputs, for both MoE smoke configs.

Every routing test sets a capacity that really drops tokens (the smokes'
``capacity_factor=8.0`` drops none): the dropped ``(token, k)`` pairs must
be the JAX package's exactly, and so must the slots of the kept ones.

Tolerances.  f32: the expert matmuls sum in another order in ATen than in
XLA, so outputs are held to 8 f32 spacings of their largest magnitude
(2 measured), the aux loss to 4 (0 measured: the counts are exact and the
probability means sum 8-64 terms), and gradients to 32 (10 measured).
bf16: each expert matmul is rounded to bf16, so outputs are held to 2 bf16
spacings (1 measured).  A model-level bf16 run is not held here: a
layer's bf16 input rounds differently in the two packages, which can flip
a near-tied top-k choice downstream (the dense slice's bf16 logit test
does not route).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import bf16_spacings, flat_numpy, port_model, spacings, \
    to_torch

from repro import configs as jconfigs
from repro.core.gwt import gwt as jax_gwt
from repro.data.pipeline import SyntheticLM as JaxSyntheticLM
from repro.models import lm as jlm, moe as jmoe
from repro.optim.schedules import warmup_cosine as jax_warmup_cosine
from repro.runtime.fault_tolerance import TrainLoop as JaxTrainLoop
from repro_torch import configs
from repro_torch.core.gwt import gwt
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.launch.serve import generate
from repro_torch.models import lm, moe
from repro_torch.models.layers import Builder
from repro_torch.optim.base import flatten_with_paths
from repro_torch.optim.schedules import warmup_cosine
from repro_torch.runtime.fault_tolerance import TrainLoop
from repro_torch.serve.engine import Engine, EngineConfig, Request

ARCHS = ["qwen2-moe-a2.7b", "qwen3-moe-30b-a3b"]


def _cfgs(arch, **kw):
    return (jconfigs.get_smoke(arch).with_(**kw),
            configs.get_smoke(arch).with_(**kw))


def _moe_params(cfg, seed=0):
    """One MoE layer's parameters as numpy f32, from the port's builder."""
    p = moe.moe_init(Builder(torch.Generator().manual_seed(seed), "cpu",
                             torch.float32), cfg)
    return {k: ({kk: vv.numpy() for kk, vv in v.items()}
                if isinstance(v, dict) else v.numpy()) for k, v in p.items()}


def _cast(p, jax_dtype, torch_dtype):
    """The JAX and the port's copies of ``p``; the router stays f32."""
    def j(k, v):
        return jnp.asarray(v, jnp.float32 if k == "router" else jax_dtype)

    def t(k, v):
        return to_torch(v, torch.float32 if k == "router" else torch_dtype)

    jp = {k: ({kk: j(kk, vv) for kk, vv in v.items()}
              if isinstance(v, dict) else j(k, v)) for k, v in p.items()}
    tp = {k: ({kk: t(kk, vv) for kk, vv in v.items()}
              if isinstance(v, dict) else t(k, v)) for k, v in p.items()}
    return jp, tp


def _jax_route(probs, cfg):
    """The JAX package's routing lines (``repro/models/moe.py:88-103``),
    for the slots its ``_moe_dense`` keeps inside."""
    T, E = probs.shape
    K = cfg.top_k
    gate_vals, expert_idx = jax.lax.top_k(probs, K)
    gate_vals = gate_vals / jnp.maximum(gate_vals.sum(-1, keepdims=True),
                                        1e-9)
    C = max(1, math.ceil(T * K / E * cfg.capacity_factor))
    onehot = jax.nn.one_hot(expert_idx.reshape(T * K), E, dtype=jnp.int32)
    pos = jnp.cumsum(onehot, axis=0) - onehot
    slot = jnp.take_along_axis(pos, expert_idx.reshape(T * K, 1),
                               axis=1)[:, 0]
    slot = jnp.where(slot < C, slot, C).reshape(T, K)
    return gate_vals, expert_idx, slot, C


def _probs(p, x):
    xt = x.reshape(-1, x.shape[-1]).astype(np.float32)
    logits = xt @ p["router"]
    e = np.exp(logits - logits.max(-1, keepdims=True))
    return (e / e.sum(-1, keepdims=True)).astype(np.float32)


def _x(cfg, B=2, S=64, seed=1):
    return np.random.RandomState(seed).randn(B, S, cfg.d_model) \
        .astype(np.float32)


def _check_routing(jcfg, tcfg, p, x):
    """Both packages' routing of the same probabilities: the same experts,
    gates within 2 f32 spacings, the same slots and so the same dropped
    pairs; returns the number dropped."""
    probs = _probs(p, x)
    jg, je, js, jC = _jax_route(jnp.asarray(probs), jcfg)
    tg, te, ts, tC = moe.route(torch.from_numpy(probs), tcfg)
    assert tC == jC
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert spacings(tg, jg) <= 2
    return int((ts == tC).sum())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_apply_matches_reference_with_drops(arch, dtype):
    jcfg, tcfg = _cfgs(arch, capacity_factor=1.0)
    p = _moe_params(tcfg)
    x = _x(tcfg)
    dropped = _check_routing(jcfg, tcfg, p, x)
    assert dropped > 0
    jp, tp = _cast(p, getattr(jnp, dtype), getattr(torch, dtype))
    jy, jaux = jmoe.moe_apply(jp, jcfg, jnp.asarray(x, getattr(jnp, dtype)))
    ty, taux = moe.moe_apply(tp, tcfg, to_torch(x, getattr(torch, dtype)))
    assert ty.dtype == getattr(torch, dtype) and taux.dtype == torch.float32
    if dtype == "float32":
        assert spacings(ty, jy) <= 8
        assert spacings(taux, jaux) <= 4
    else:
        assert bf16_spacings(ty, jy) <= 2
        assert spacings(taux, jaux) <= 4


def _tied_params(cfg):
    """Experts 1 and 2 share a router column: their probabilities tie
    exactly for every token."""
    p = _moe_params(cfg, seed=3)
    p["router"][:, 2] = p["router"][:, 1]
    # make the tied pair the top choice of most tokens
    p["router"][:, 1:3] *= 4.0
    return p


@pytest.mark.parametrize("arch", ARCHS)
def test_constructed_tie_takes_the_lower_expert(arch):
    """Exact ties: ``jax.lax.top_k`` takes the lower index first, and so
    does the port (a stable sort); ``torch.topk`` promises no order."""
    jcfg, tcfg = _cfgs(arch, capacity_factor=1.0)
    p = _tied_params(tcfg)
    x = _x(tcfg, seed=5)
    probs = _probs(p, x)
    assert (probs[:, 1] == probs[:, 2]).all()
    _, te, _, _ = moe.route(torch.from_numpy(probs), tcfg)
    both = (te == 1).any(-1) & (te == 2).any(-1)
    assert both.any()
    first = te[both]
    assert ((first == 1).int().argmax(-1)
            < (first == 2).int().argmax(-1)).all()
    assert _check_routing(jcfg, tcfg, p, x) > 0
    jp, tp = _cast(p, jnp.float32, torch.float32)
    jy, jaux = jmoe.moe_apply(jp, jcfg, jnp.asarray(x))
    ty, taux = moe.moe_apply(tp, tcfg, torch.from_numpy(x))
    assert spacings(ty, jy) <= 8 and spacings(taux, jaux) <= 4


def test_expert_padding_changes_nothing():
    """The twin of tests/test_models.py::
    test_moe_expert_padding_is_semantically_invisible: padded experts are
    never routed, so the outputs and aux equal the unpadded layer's
    bitwise, and both equal the JAX package's padded layer."""
    tcfg0 = configs.get_smoke("qwen2-moe-a2.7b").with_(
        expert_padding=0, capacity_factor=1.0)
    tcfg4 = tcfg0.with_(expert_padding=4)
    p0 = _moe_params(tcfg0)
    p4 = _moe_params(tcfg4, seed=9)
    E = tcfg0.n_experts
    for k in ("w_gate", "w_up", "w_down"):
        p4[k][:E] = p0[k]
    p4["router"], p4["shared"] = p0["router"], p0["shared"]
    x = _x(tcfg0)
    for dtype in (torch.float32, torch.bfloat16):
        _, t0 = _cast(p0, jnp.float32, dtype)
        _, t4 = _cast(p4, jnp.float32, dtype)
        y0, a0 = moe.moe_apply(t0, tcfg0, to_torch(x, dtype))
        y4, a4 = moe.moe_apply(t4, tcfg4, to_torch(x, dtype))
        assert torch.equal(y0, y4) and torch.equal(a0, a4)
    jcfg4 = jconfigs.get_smoke("qwen2-moe-a2.7b").with_(capacity_factor=1.0)
    jp, tp = _cast(p4, jnp.float32, torch.float32)
    jy, _ = jmoe.moe_apply(jp, jcfg4, jnp.asarray(x))
    ty, _ = moe.moe_apply(tp, tcfg4, torch.from_numpy(x))
    assert spacings(ty, jy) <= 8


@pytest.mark.parametrize("arch", ARCHS)
def test_chunked_path_matches_reference(arch):
    """Above 8192 tokens (2 x 8192 at width 16): two chunks of 4096 rows
    each, each recomputed in the backward; outputs, the chunks' mean aux
    and the gradients against the JAX package's scan."""
    jcfg, tcfg = _cfgs(arch, d_model=16, d_ff_expert=16, capacity_factor=1.0)
    p = _moe_params(tcfg)
    x = _x(tcfg, B=2, S=8192)
    calls = []
    dense = moe._moe_dense

    def spy(*a):
        calls.append(a[2].shape)
        return dense(*a)

    jp, tp = _cast(p, jnp.float32, torch.float32)
    tleaves = [t for t in flatten_with_paths(tp)[1]]
    for t in tleaves:
        t.requires_grad_(True)
    xt = torch.from_numpy(x)
    moe._moe_dense = spy
    try:
        ty, taux = moe.moe_apply(tp, tcfg, xt)
        tl = (ty * ty).mean() + taux
        tg = torch.autograd.grad(tl, tleaves)
    finally:
        moe._moe_dense = dense
    assert calls[:2] == [(2, 4096, 16)] * 2
    assert len(calls) == 4      # twice each: the backward recomputes

    def jloss(p):
        y, aux = jmoe.moe_apply(p, jcfg, jnp.asarray(x))
        return (y * y).mean() + aux, (y, aux)

    (_, (jy, jaux)), jg = jax.value_and_grad(jloss, has_aux=True)(jp)
    assert spacings(ty, jy) <= 8 and spacings(taux, jaux) <= 4
    jgf = flat_numpy(jg)
    for path, g in zip(flatten_with_paths(tp)[0], tg):
        assert spacings(g, jgf[path]) <= 32, path


@pytest.mark.parametrize("arch", ARCHS)
def test_aux_loss_and_grads_match_reference(arch):
    """The gradients of out and aux with respect to every parameter and
    the input, with drops; the aux counts dropped pairs too."""
    jcfg, tcfg = _cfgs(arch, capacity_factor=1.0)
    p = _moe_params(tcfg)
    x = _x(tcfg)
    jp, tp = _cast(p, jnp.float32, torch.float32)
    paths, tleaves = flatten_with_paths(tp)
    for t in tleaves:
        t.requires_grad_(True)
    xt = torch.from_numpy(x).requires_grad_(True)
    ty, taux = moe.moe_apply(tp, tcfg, xt)
    tl = (ty * ty).mean() + 0.01 * taux
    tg = torch.autograd.grad(tl, tleaves + [xt])

    def jloss(p, x):
        y, aux = jmoe.moe_apply(p, jcfg, x)
        return (y * y).mean() + 0.01 * aux

    jgp, jgx = jax.grad(jloss, argnums=(0, 1))(jp, jnp.asarray(x))
    jgf = flat_numpy(jgp)
    for path, g in zip(paths, tg[:-1]):
        assert spacings(g, jgf[path]) <= 32, path
    assert spacings(tg[-1], jgx) <= 32
    assert float(jnp.abs(jgf["router"]).max()) > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_model_logits_loss_grads_match_reference(arch):
    """The whole smoke model in f32 with drops: logits, CE + 0.01 aux and
    every gradient (the router's through the aux and the gates)."""
    jcfg, tcfg = _cfgs(arch, dtype="float32", capacity_factor=1.0)
    jp, model = port_model(jcfg, tcfg)
    assert model.tree()["layers"]["b0"]["ffn"]["router"].dtype == \
        torch.float32
    rng = np.random.RandomState(1)
    b = {"tokens": rng.randint(0, 512, (2, 64)).astype(np.int32),
         "labels": rng.randint(0, 512, (2, 64)).astype(np.int32)}
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    tb = {k: torch.from_numpy(v) for k, v in b.items()}
    jlogits, _, jaux = jlm.forward(jcfg, jp, jb["tokens"])
    jloss, jg = jax.value_and_grad(lambda p: jlm.loss_fn(jcfg, p, jb))(jp)
    tree = model.tree()
    logits, aux = lm._train_forward(tcfg, tree, tb["tokens"])
    loss = lm.loss_fn(tcfg, tree, tb)
    paths, leaves = flatten_with_paths(tree)
    grads = torch.autograd.grad(loss, leaves)
    assert spacings(logits, jlogits) <= 8
    assert spacings(aux, jaux) <= 4
    assert spacings(loss, jloss) <= 4
    jgf = flat_numpy(jg)
    for path, g in zip(paths, grads):
        assert spacings(g, jgf[path]) <= 32, path


@pytest.mark.parametrize("arch", ARCHS)
def test_train_steps_track_reference(arch):
    """3 GWT-2 steps through each package's TrainLoop (f32, accum 2, drops
    at capacity 1.0): losses within 2e-5, as the dense slice's."""
    steps = 3
    jcfg, tcfg = _cfgs(arch, dtype="float32", capacity_factor=1.0)
    jp, model = port_model(jcfg, tcfg, seed=0)
    jopt = jax_gwt(lr=jax_warmup_cosine(0.01, steps), impl="jnp")
    jloop = JaxTrainLoop(jlm.make_train_step(jcfg, jopt, accum_steps=2),
                         None, JaxSyntheticLM(512, 32, 4, 0), log_every=3,
                         log=lambda s: None)
    _, _, jlosses = jloop.run(jp, jopt.init(jp), num_steps=steps)
    topt = gwt(lr=warmup_cosine(0.01, steps))
    tree = model.tree()
    tloop = TrainLoop(lm.make_train_step(tcfg, topt, accum_steps=2),
                      SyntheticLM(512, 32, 4, 0), device="cpu", log_every=3,
                      log=lambda s: None)
    _, _, tlosses = tloop.run(tree, topt.init(tree), num_steps=steps)
    np.testing.assert_allclose(tlosses, jlosses, rtol=0, atol=2e-5)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_full_forward(arch):
    """The twin of tests/test_models.py::test_decode_matches_full_forward:
    prefill of S-4 tokens, then 4 decode steps, against the train forward
    (the smoke's capacity 8.0 drops nothing, so routing one token at a
    time is the same); f32, within 1e-4."""
    _, tcfg = _cfgs(arch, dtype="float32")
    params = lm.init(tcfg, torch.Generator().manual_seed(0), "cpu").tree()
    B, S = 2, 32
    tokens = torch.from_numpy(
        np.random.RandomState(2).randint(0, tcfg.vocab, (B, S)))
    with torch.no_grad():
        full = lm.forward(tcfg, params, tokens)
    prefix = S - 4
    logits, cache = lm.make_prefill_step(tcfg)(
        params, {"tokens": tokens[:, :prefix]})
    from repro_torch.launch.serve import pad_cache
    cache = pad_cache(cache, S)
    np.testing.assert_allclose(logits.numpy(), full[:, prefix - 1].numpy(),
                               atol=1e-4, rtol=1e-4)
    step = lm.make_decode_step(tcfg)
    for t in range(prefix, S):
        logits, cache = step(params, cache, {"tokens": tokens[:, t:t + 1]})
        np.testing.assert_allclose(logits.numpy(), full[:, t].numpy(),
                                   atol=1e-4, rtol=1e-4, err_msg=str(t))


@pytest.mark.parametrize("arch", ARCHS)
def test_paged_engine_serves_moe(arch):
    """The paged engine admits ``attn+moe`` (as the JAX package's does):
    its greedy tokens equal dense generate's."""
    _, tcfg = _cfgs(arch, dtype="float32")
    params = lm.init(tcfg, torch.Generator().manual_seed(1), "cpu").tree()
    eng = Engine(tcfg, params, EngineConfig(num_slots=2, page_size=4,
                                            max_ctx=24, prefill_chunk=8))
    rng = np.random.RandomState(4)
    reqs = [Request(rid=i, prompt=rng.randint(0, tcfg.vocab, 10).tolist(),
                    max_gen=6) for i in range(3)]
    eng.run(reqs)
    for r in reqs:
        assert r.generated == generate(tcfg, params, torch.tensor(
            [list(r.prompt)]), 6)[0].tolist()


def test_full_width_expert_buckets():
    """The GWT-2 plan at full width on ``meta`` (the 2-layer cuts of the
    chip check): the expert leaves stack to the buckets K1 takes."""
    for arch, want in (
            ("qwen3-moe-30b-a3b", {"gwt_last__layers.b0.ffn.w_gate":
                                   (2, 2, 128, 2048, 768),
                                   "gwt_last__layers.b0.ffn.w_down":
                                   (1, 2, 128, 768, 2048)}),
            ("qwen2-moe-a2.7b", {"gwt_last__layers.b0.ffn.w_gate":
                                 (2, 2, 64, 2048, 1408),
                                 "gwt_last__layers.b0.ffn.w_down":
                                 (1, 2, 64, 1408, 2048)})):
        tcfg = configs.get_config(arch).with_(n_layers=2)
        tabs = lm.abstract_params(tcfg)
        plan = gwt(lr=0.01).engine.plan(tabs)
        got = {b.name: (len(b.paths),) + tuple(
            dict(zip(*flatten_with_paths(tabs)))[b.paths[0]].shape)
            for b in plan.buckets}
        for name, shape in want.items():
            assert got[name] == shape, (arch, name, got)
        assert "plain__layers.b0.ffn.router" in got
