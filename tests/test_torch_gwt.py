"""The port's GWT optimizer (``repro_torch.core.gwt``) against the JAX
package's ``gwt(impl="jnp")`` on the same parameters and gradients.

The JAX optimizer on the CPU runs its staged per-leaf path; the port runs
its fused-write bucket path (the plain version on the CPU).  In f32 the two
differ only in the association of the limiter norm (the port sums it in
the CUDA kernels' order) and in XLA's FMA contractions, so over 4 steps
parameters stay within 8 f32 spacings (measured 6) and moments within 16
(measured 5).  bf16 parameters are held against the JAX package's
fused-write path instead (its Pallas kernel in interpret mode), to one
bf16 spacing.
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
from repro.models import lm as jlm
from repro.optim import adam as jadam, schedules as jsched
from repro_torch import configs
from repro_torch.core.gwt import gwt
from repro_torch.models import lm
from repro_torch.optim.base import flatten_with_paths, unflatten
from repro_torch.optim.schedules import warmup_cosine


def _smoke_tree():
    """llama-60m-smoke parameters (as f32 numpy) plus one leaf whose last
    axis does not divide by 4 (a FIRST-mode leaf at level 2)."""
    flat = flat_numpy(jax_params(jconfigs.get_smoke("llama-60m"), seed=1))
    flat["extra/w_first"] = np.random.RandomState(2).randn(2, 16, 6) \
        .astype(np.float32)
    return {k: v.astype(np.float32) for k, v in flat.items()}


def _jax_tree(flat, dtype):
    return unflatten(list(flat), [jnp.asarray(v).astype(dtype)
                                  for v in flat.values()])


def _torch_tree(flat, dtype):
    return unflatten(list(flat), [to_torch(v, getattr(torch, dtype))
                                  for v in flat.values()])


def _grads(flat, k):
    rng = np.random.RandomState(100 + k)
    return {p: rng.randn(*v.shape).astype(np.float32) * 0.1
            for p, v in flat.items()}


def _run(flat, dtype, steps, impl="jnp", **kw):
    jopt = jax_gwt(lr=jsched.warmup_cosine(0.01, 10), impl=impl, **kw)
    topt = gwt(lr=warmup_cosine(0.01, 10), **kw)
    jp, tp = _jax_tree(flat, dtype), _torch_tree(flat, dtype)
    js, ts = jopt.init(jp), topt.init(tp)
    jupd = jax.jit(jopt.update)
    for k in range(steps):
        g = _grads(flat, k)
        jp, js = jupd(_jax_tree(g, dtype), js, jp)
        tp, ts = topt.update(_torch_tree(g, dtype), ts, tp)
    return jopt, topt, jp, js, tp, ts


@pytest.mark.parametrize("use_limiter,weight_decay",
                         [(True, 0.0), (False, 0.0), (True, 0.1)])
def test_gwt_matches_reference_f32(use_limiter, weight_decay):
    flat, dtype = _smoke_tree(), "float32"
    jopt, topt, jp, js, tp, ts = _run(flat, dtype, 4, level=2,
                                      use_limiter=use_limiter,
                                      weight_decay=weight_decay)
    jplan = jopt.engine.plan(_jax_tree(flat, dtype))
    tplan = topt.engine.plan(_torch_tree(flat, dtype))
    assert [b.name for b in tplan.buckets] == [b.name for b in jplan.buckets]
    assert any(b.name.startswith("gwt_first__") for b in tplan.buckets)
    jflat, tflat = flat_numpy(js), dict(zip(*flatten_with_paths(ts)))
    assert sorted(tflat) == sorted(jflat)
    assert int(tflat["step"]) == int(jflat["step"]) == 4
    for path in jflat:
        if path != "step":
            assert spacings(tflat[path], jflat[path]) <= 16, path
    for path, t in zip(*flatten_with_paths(tp)):
        assert spacings(t, flat_numpy(jp)[path]) <= 8, path


def test_gwt_matches_fused_reference_bf16():
    """bf16 parameters against the JAX package's own fused-write path (its
    Pallas kernel in interpret mode): the staged path transforms bf16
    gradients in bf16 and the fused path in f32, and at the first steps,
    where ``1/(sqrt(v)+eps)`` is large, that difference is not small."""
    flat, dtype = _smoke_tree(), "bfloat16"
    _, _, jp, js, tp, ts = _run(flat, dtype, 2, impl="interpret", level=2)
    jflat = flat_numpy(jp)
    for path, t in zip(*flatten_with_paths(tp)):
        assert t.dtype == torch.bfloat16
        assert bf16_spacings(t, jflat[path]) <= 1, path


def test_level0_is_adam():
    flat, dtype = _smoke_tree(), "float32"
    jopt = jadam(lr=jsched.warmup_cosine(0.01, 10))
    topt = gwt(lr=warmup_cosine(0.01, 10), level=0)
    jp, tp = _jax_tree(flat, dtype), _torch_tree(flat, dtype)
    js, ts = jopt.init(jp), topt.init(tp)
    assert all(b.name.startswith("plain__")
               for b in topt.engine.plan(tp).buckets)
    for k in range(3):
        g = _grads(flat, k)
        jp, js = jax.jit(jopt.update)(_jax_tree(g, dtype), js, jp)
        tp, ts = topt.update(_torch_tree(g, dtype), ts, tp)
    jflat = flat_numpy(jp)
    for path, t in zip(*flatten_with_paths(tp)):
        assert spacings(t, jflat[path]) <= 4, path


def test_staged_leaf_update_matches_reference():
    """Each rule's per-leaf ``update`` (the staged path) against the JAX
    rule's on one leaf, FIRST mode included: the same algorithm, op for
    op, within 4 f32 spacings."""
    flat, dtype = _smoke_tree(), "float32"
    jopt = jax_gwt(lr=0.01, impl="jnp")
    topt = gwt(lr=0.01)
    jp, tp = _jax_tree(flat, dtype), _torch_tree(flat, dtype)
    js, ts = jopt.init(jp), topt.init(tp)
    g = _grads(flat, 0)
    step = 1
    for jb, tb in zip(jopt.engine.plan(jp).buckets,
                      topt.engine.plan(tp).buckets):
        path = tb.paths[0]
        jst = jax.tree.map(lambda a: a[0], js["buckets"][jb.name])
        tst = {"host": {k: v[0] for k, v in
                        ts["buckets"][tb.name]["host"].items()}}
        if "prev_norm" in ts["buckets"][tb.name]:
            tst["prev_norm"] = torch.tensor(0.5)
            jst["prev_norm"] = jnp.float32(0.5)
        jnew, jns = jb.rule.update(jnp.asarray(g[path]), jnp.asarray(
            flat[path]), jst, jnp.int32(step), 0)
        tnew, tns = tb.rule.update(to_torch(g[path]), to_torch(flat[path]),
                                   tst, torch.tensor(step,
                                                     dtype=torch.int32))
        assert spacings(tnew, jnew) <= 4, path
        for k in ("m", "v"):
            assert spacings(tns["host"][k], jns["host"][k]) <= 4, path


def test_full_width_bucket_plan_matches_reference():
    """llama-60m at full width, on the meta device: bucket names, leaves
    and every state shape and dtype equal the JAX ``eval_shape`` plan."""
    jcfg, tcfg = jconfigs.get_config("llama-60m"), configs.get_config(
        "llama-60m")
    jabs = jlm.abstract_params(jcfg)
    tabs = lm.abstract_params(tcfg)
    jopt, topt = jax_gwt(lr=0.01, impl="jnp"), gwt(lr=0.01)
    jstate = jax.eval_shape(jopt.init, jabs)
    tstate = topt.init(tabs)
    jplan, tplan = jopt.engine.plan(jabs), topt.engine.plan(tabs)
    assert [(b.name, b.paths) for b in tplan.buckets] == \
        [(b.name, b.paths) for b in jplan.buckets]
    assert sorted(b.name for b in tplan.buckets) == [
        "gwt_last__layers.b0.ffn.w_down", "gwt_last__layers.b0.ffn.w_gate",
        "gwt_last__layers.b0.mixer.wk", "plain__embed.embedding",
        "plain__final_norm", "plain__layers.b0.norm1"]
    from repro.optim.base import flatten_with_paths as jflatten
    jp, jl, _ = jflatten(jstate)
    want = {p: (tuple(l.shape), str(l.dtype)) for p, l in zip(jp, jl)}
    tp, tl = flatten_with_paths(tstate)
    got = {p: (tuple(l.shape), str(l.dtype).replace("torch.", ""))
           for p, l in zip(tp, tl)}
    assert got == want
    assert got["buckets/gwt_last__layers.b0.ffn.w_gate/host/m"][0] == \
        (2, 8, 512, 344)
