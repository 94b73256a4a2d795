"""The int8-state slice of the port against the JAX package: the fused
q8 update (``repro_torch.kernels.gwt_adam.ops.fused_write_update_q8``, its
plain version on the CPU), GWT with ``state_codec="int8"``, the engine's
encoded state layout, and training on llama-60m-smoke.

Tolerances.  XLA contracts ``b1*m + (1-b1)*a`` and its kin into FMAs and
PyTorch's op-by-op arithmetic does not, so a new f32 moment can differ by
an f32 spacing or two before it is requantized.  Where such a difference
crosses a rounding threshold (``u < frac(y)``, or the block's absmax) a
code moves by exactly 1; such codes are counted and at most
``MAX_CODES_OFF_BY_ONE`` of the ~10^4 codes of a case may differ, all by 1.
Scales (absmax / 127) are held to 2 f32 spacings.  Parameters follow the
f32 update's rule (``test_torch_gwt_adam.py``): 4 f32 spacings in f32
(measured 0.5), one bf16 spacing in bf16 (measured 0.25); the limiter
norm, summed in the kernels' order against the oracle's row stripes, 4
f32 spacings in f32 (measured 3) and 64 in bf16 (measured 11).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import bf16_spacings, flat_numpy, jax_params, port_model, \
    spacings, to_torch

from repro import configs as jconfigs
from repro.core.gwt import gwt as jax_gwt
from repro.data.pipeline import SyntheticLM as JaxSyntheticLM
from repro.kernels.gwt_adam import kernel as jkernel, ops as jops
from repro.models import lm as jlm
from repro.optim import codec as jcodec, engine as jengine
from repro.optim.base import flatten_with_paths as jflatten
from repro.optim.schedules import warmup_cosine as jax_warmup_cosine
from repro.runtime.fault_tolerance import TrainLoop as JaxTrainLoop
from repro_torch import configs
from repro_torch.core.gwt import gwt
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.kernels.gwt_adam import kernel, ops
from repro_torch.models import lm
from repro_torch.optim import codec, engine
from repro_torch.optim.base import flatten_with_paths, unflatten
from repro_torch.optim.schedules import warmup_cosine

MAX_CODES_OFF_BY_ONE = 8

# (limiter on, prev_norm, weight decay): off; first step; not clipping with
# weight decay; clipping
CASES = [(False, 0.0, 0.0), (True, 0.0, 0.0), (True, 1e3, 0.1),
         (True, 1e-3, 0.0)]


def _inputs(shape, level, seed):
    """g, p, and the encoded moments (made by the JAX codec from random f32
    moments, so both packages start from the same codes)."""
    rng = np.random.RandomState(seed)
    lead, n = shape[:-1], shape[-1]
    mshape = lead + (n >> level,)
    g = rng.randn(*shape).astype(np.float32)
    p = rng.randn(*shape).astype(np.float32)
    m = (rng.randn(*mshape) * 0.1).astype(np.float32)
    v = (rng.rand(*mshape) * 0.01).astype(np.float32)
    enc = jax.vmap(lambda x, s: jcodec.blocked_quant(x, s))
    st = {}
    for name, a, salt in (("m", m, 11), ("v", v, 12)):
        q, s = enc(jnp.asarray(a), jnp.arange(shape[0], dtype=jnp.uint32)
                   + salt)
        st[name] = {"q": np.asarray(q), "scale": np.asarray(s)}
    return g, p, st


def _codes_close(got, want):
    d = got.numpy().astype(np.int32) - np.asarray(want).astype(np.int32)
    assert np.abs(d).max(initial=0) <= 1
    assert int((d != 0).sum()) <= MAX_CODES_OFF_BY_ONE
    return int((d != 0).sum())


def _run_both(shape, level, dtype, case, impl, seed=0):
    use_limiter, prev, wd = case
    L = shape[0]
    g, p, st = _inputs(shape, level, seed)
    pn = np.full((L,), prev, np.float32)
    lids = np.arange(3, 3 + L, dtype=np.int32)
    kw = dict(alpha=0.25, weight_decay=wd, gamma=1.01,
              use_limiter=use_limiter, level=level)
    jst = {k: {kk: jnp.asarray(vv) for kk, vv in d.items()}
           for k, d in st.items()}
    want = jops.fused_write_update_q8(
        jnp.asarray(g).astype(dtype), jnp.asarray(p).astype(dtype), jst,
        jnp.int32(5), jcodec.make_key(0), jnp.asarray(lids),
        jnp.asarray(pn), lr_t=0.01, impl=impl, **kw)
    tdt = getattr(torch, dtype)
    tst = {k: {kk: to_torch(vv) for kk, vv in d.items()}
           for k, d in st.items()}
    step = torch.tensor(5, dtype=torch.int32)
    salts = codec.slot_salt(codec.make_key(0), step,
                            torch.arange(2)[:, None], torch.from_numpy(lids))
    got = ops.fused_write_update_q8(
        to_torch(g, tdt), to_torch(p, tdt), tst, step, salts, to_torch(pn),
        lr_t=torch.tensor(0.01), **kw)
    return got, want


def _check(got, want, dtype, use_limiter, prev):
    tp, tn, ts = got
    jp, jn, js = want
    assert tp.dtype == getattr(torch, dtype) and tp.shape == jp.shape
    for name in ("m", "v"):
        assert ts[name]["q"].dtype == torch.int8
        assert ts[name]["q"].shape == js[name]["q"].shape
        assert ts[name]["scale"].shape == js[name]["scale"].shape
        _codes_close(ts[name]["q"], js[name]["q"])
        assert spacings(ts[name]["scale"], js[name]["scale"]) <= 2
    if dtype == "float32":
        assert spacings(tp, jp) <= 4
        assert spacings(tn, jn) <= 4
    else:
        assert bf16_spacings(tp, jp) <= 1
        assert spacings(tn, jn) <= 64
    if not use_limiter:
        np.testing.assert_array_equal(tn.numpy(), np.full(tn.shape, prev))


# (2, 16, 344): 16·86 = 1376 coefficients per leaf, 21.5 blocks, so each
# leaf ends in a partial block; (2, 3, 8, 64): a 3-D leaf, merged into rows
@pytest.mark.parametrize("shape", [(2, 16, 64), (2, 16, 344),
                                   (2, 3, 8, 64)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CASES)
def test_fused_write_q8_matches_reference(shape, dtype, case):
    got, want = _run_both(shape, 2, dtype, case, "jnp")
    _check(got, want, dtype, case[0], case[1])


@pytest.mark.parametrize("case", [CASES[1], CASES[2]])
def test_fused_write_q8_matches_pallas_interpret(case):
    """Against the TPU kernel itself, run by Pallas's interpreter, on a
    shape it tiles ((16·16) coefficients per leaf: whole blocks)."""
    shape = (2, 16, 64)
    assert jkernel.q8_row_block(16, 64, 2, 64) is not None
    got, want = _run_both(shape, 2, "float32", case, "interpret")
    _check(got, want, "float32", case[0], case[1])


def test_cpu_tensors_never_reach_the_q8_kernel():
    """On CPU tensors the entry point takes the plain version and the
    kernel's launch counter stays where it was; the kernel wrapper itself
    refuses CPU tensors."""
    before = kernel.launches_q8
    g, p, st = _inputs((1, 8, 64), 2, 3)
    tst = {k: {kk: to_torch(vv) for kk, vv in d.items()}
           for k, d in st.items()}
    ops.fused_write_update_q8(
        to_torch(g), to_torch(p), tst, torch.tensor(0, dtype=torch.int32),
        torch.zeros((2, 1), dtype=torch.int64), torch.zeros(1),
        lr_t=torch.tensor(0.01), alpha=0.25, weight_decay=0.0, gamma=1.01,
        use_limiter=True, level=2)
    assert kernel.launches_q8 == before
    with pytest.raises(ValueError, match="CUDA"):
        kernel.gwt_adam_fused_q8(
            to_torch(g), to_torch(p), tst["m"]["q"], tst["m"]["scale"],
            tst["v"]["q"], tst["v"]["scale"],
            torch.zeros(1, dtype=torch.uint32),
            torch.zeros(1, dtype=torch.uint32), torch.zeros(1),
            torch.tensor(0.01), torch.tensor(0.0), level=2, block=64,
            gamma=1.01, use_limiter=True, weight_decay=False)
    assert kernel.launches_q8 == before


# ---------------------------------------------------------------------------
# GWT with int8 state, the engine layout and the training slice
# ---------------------------------------------------------------------------

def _smoke_tree():
    """llama-60m-smoke parameters plus a FIRST-mode leaf (last axis not
    divisible by 4)."""
    flat = flat_numpy(jax_params(jconfigs.get_smoke("llama-60m"), seed=1))
    flat["extra/w_first"] = np.random.RandomState(2).randn(2, 16, 6) \
        .astype(np.float32)
    return {k: v.astype(np.float32) for k, v in flat.items()}


def test_gwt_int8_matches_reference():
    """Three GWT steps with int8 state on the smoke tree (LAST and FIRST
    buckets, plain Adam on the embedding and norms): the port against the
    JAX package's staged path with the generic codec wrap.

    The limiter norms are sums of squares taken in another order in each
    package, and at the first step G̃ is heavy-tailed (a detail divided by
    a near-zero ``sqrt(v)``): they differ by up to 11 f32 spacings (128
    allowed).  Through the clipped steps that reaches the parameters as up
    to 13.25 spacings after 3 steps (32 allowed); scales and the other f32
    state stay within 16 (measured 3), and the codes agree as in the fused
    test."""
    flat = _smoke_tree()
    jopt = jax_gwt(lr=jax_warmup_cosine(0.01, 10), impl="jnp",
                   state_codec="int8")
    topt = gwt(lr=warmup_cosine(0.01, 10), state_codec="int8")
    jp = unflatten(list(flat), [jnp.asarray(v) for v in flat.values()])
    tp = unflatten(list(flat), [to_torch(v) for v in flat.values()])
    js, ts = jopt.init(jp), topt.init(tp)
    assert int(ts["codec_key"]) == int(js["codec_key"])
    assert any(b.name.startswith("gwt_first__")
               for b in topt.engine.plan(tp).buckets)
    jupd = jax.jit(jopt.update)
    for k in range(3):
        rng = np.random.RandomState(100 + k)
        g = {p: rng.randn(*v.shape).astype(np.float32) * 0.1
             for p, v in flat.items()}
        jp, js = jupd(unflatten(list(g), [jnp.asarray(v)
                                          for v in g.values()]), js, jp)
        tp, ts = topt.update(unflatten(list(g), [to_torch(v)
                                                 for v in g.values()]),
                             ts, tp)
    jflat, tflat = flat_numpy(js), dict(zip(*flatten_with_paths(ts)))
    assert sorted(tflat) == sorted(jflat)
    assert int(tflat["step"]) == 3
    for path, want in jflat.items():
        if path.endswith("/q"):
            _codes_close(tflat[path], want)
        elif path.endswith("/prev_norm"):
            assert spacings(tflat[path], want) <= 128, path
        elif path not in ("step", "codec_key"):
            assert spacings(tflat[path], want) <= 16, path
    jpf = flat_numpy(jp)
    for path, t in zip(*flatten_with_paths(tp)):
        assert spacings(t, jpf[path]) <= 32, path


@pytest.mark.parametrize("state_codec", ["f32", "int8"])
def test_update_makes_no_tensor_from_host_data(state_codec, monkeypatch):
    """After a plan's first step, an update builds no tensor from host
    data on the step's device: on a card each such tensor is a blocking
    copy that drains the stream.  The salts come from index tensors cached
    per plan and host-int hash operands.  (A host-only constant, built
    without a device, stays allowed.)"""
    flat = _smoke_tree()
    opt = gwt(lr=warmup_cosine(0.01, 10), state_codec=state_codec)
    tp = unflatten(list(flat), [to_torch(v) for v in flat.values()])
    g = unflatten(list(flat), [to_torch(v * 0.1) for v in flat.values()])
    st = opt.init(tp)
    tp, st = opt.update(g, st, tp)

    def guard(fn):
        def call(*a, **k):
            if k.get("device") is not None:
                raise AssertionError("tensor built from host data on the "
                                     "step's device")
            return fn(*a, **k)
        return call

    for name in ("tensor", "as_tensor"):
        monkeypatch.setattr(torch, name, guard(getattr(torch, name)))
    tp, st = opt.update(g, st, tp)
    monkeypatch.undo()
    assert int(st["step"]) == 2


def test_full_width_int8_layout_matches_reference():
    """llama-60m at full width on the meta device: bucket names, every
    encoded state leaf's shape and dtype, the codec key and the state
    bytes equal the JAX package's (48,273,508 bytes = 46.04 MiB)."""
    jcfg, tcfg = jconfigs.get_config("llama-60m"), configs.get_config(
        "llama-60m")
    jabs, tabs = jlm.abstract_params(jcfg), lm.abstract_params(tcfg)
    jopt = jax_gwt(lr=0.01, impl="jnp", state_codec="int8")
    topt = gwt(lr=0.01, state_codec="int8")
    jstate = jax.eval_shape(jopt.init, jabs)
    tstate = topt.init(tabs)
    assert [b.name for b in topt.engine.plan(tabs).buckets] == \
        [b.name for b in jopt.engine.plan(jabs).buckets]
    jp, jl, _ = jflatten(jstate)
    want = {p: (tuple(l.shape), str(l.dtype)) for p, l in zip(jp, jl)}
    tp, tl = flatten_with_paths(tstate)
    got = {p: (tuple(l.shape), engine.dtype_name(l.dtype))
           for p, l in zip(tp, tl)}
    assert got == want
    assert got["buckets/gwt_last__layers.b0.ffn.w_gate/host/m/q"] == \
        ((2, 8, 512, 344), "int8")
    assert got["buckets/gwt_last__layers.b0.ffn.w_gate/host/m/scale"] == \
        ((2, 22016), "float32")
    assert int(topt.engine.codec_key()) == int(jopt.engine.codec_key())
    assert engine.state_bytes(tstate) == jengine.state_bytes(jopt, jabs) \
        == 48_273_508


def test_int8_optimizer_on_the_same_gradients_tracks_reference():
    """The witness for the loop test below: llama-60m-smoke, int8 state,
    6 steps in which both optimizers get the JAX model's gradients along
    the JAX run.  With equal gradients the port stays with the reference
    for all 6 steps: per step at most ``MAX_CODES_OFF_BY_ONE`` codes differ,
    all by 1 (measured: 0-1 of 14,656 over seeds 0-5), scales within 16
    f32 spacings (measured: 4), parameters within 64 (measured: 51, set at
    the first clipped step and flat after), and the port's loss at its
    parameters within 2e-5 of JAX's at its own on every step (measured:
    3.8e-6 here, at most 7.6e-6 over seeds 0-5).  So the loop test's later
    drift comes from the two models' gradients, not from the optimizer
    (``tests/torch_int8_drift.py`` prints these readings per seed)."""
    steps = 6
    jcfg, tcfg = jconfigs.get_smoke("llama-60m"), configs.get_smoke(
        "llama-60m")
    jp, model = port_model(jcfg, tcfg, seed=0)
    tp = model.tree()
    jopt = jax_gwt(lr=jax_warmup_cosine(0.01, steps), impl="jnp",
                   state_codec="int8")
    topt = gwt(lr=warmup_cosine(0.01, steps), state_codec="int8")
    js, ts = jopt.init(jp), topt.init(tp)
    value_grad = jax.jit(jax.value_and_grad(
        lambda p, b: jlm.loss_fn(jcfg, p, b)))
    jupd = jax.jit(jopt.update)
    data = JaxSyntheticLM(64, 16, 4, 0)
    for k in range(steps):
        batch = data.batch(k)
        jloss, g = value_grad(jp, {n: jnp.asarray(v)
                                   for n, v in batch.items()})
        with torch.no_grad():
            tloss = lm.loss_fn(tcfg, tp, {n: torch.from_numpy(v)
                                          for n, v in batch.items()})
        assert abs(float(tloss) - float(jloss)) <= 2e-5, k
        gf = flat_numpy(g)
        jp, js = jupd(g, js, jp)
        tp, ts = topt.update(unflatten(list(gf), [to_torch(v)
                                                  for v in gf.values()]),
                             ts, tp)
        jflat, tflat = flat_numpy(js), dict(zip(*flatten_with_paths(ts)))
        off = 0
        for path, want in jflat.items():
            if path.endswith("/q"):
                off += _codes_close(tflat[path], want)
            elif path.endswith("/scale"):
                assert spacings(tflat[path], want) <= 16, (k, path)
        assert off <= MAX_CODES_OFF_BY_ONE, k
        jpf = flat_numpy(jp)
        for path, t in zip(*flatten_with_paths(tp)):
            assert spacings(t, jpf[path]) <= 64, (k, path)


def test_int8_train_loop_tracks_reference_losses():
    """llama-60m-smoke, int8 state, 6 steps from the same parameters and
    batches, against the JAX loop.

    The first 3 steps' losses agree within the f32 loop's 2e-5
    (``test_torch_lm.py``; measured: 8e-6).
    After that int8 state diverges faster than f32: the two packages'
    gradients differ in the last places (matmul order), a moment whose
    code is 0 dequantizes to 0 so ``1/(sqrt(v)+eps)`` is large, and from the
    third step on stochastic rounding turns f32-spacing differences into
    whole-quantum code flips (1-18 codes per bucket and step).  Steps 4-6
    are held to 1e-3 (measured: 4.2e-4).  The JAX package's own two int8
    paths (staged ``impl="jnp"`` and fused ``impl="interpret"``) differ by
    3.8e-5 at step 5, so 2e-5 there is not a property of the reference
    either.  The witness above shows the optimizer itself within 2e-5 for
    all 6 steps on equal gradients.  Over seeds 0-5
    (``tests/torch_int8_drift.py``): the two models' gradients differ by
    3.9e-7 to 1.05e-6 of each leaf's largest element; the JAX run against
    itself with each step's gradients times ``1 + 4e-7 * N(0, 1)`` moves
    steps 4-6 by 2.1e-5 to 8.4e-3, and the port against JAX moves them by
    7.6e-6 to 1.1e-2.  The 1e-3 limit is read on seed 0 only."""
    from repro_torch.runtime.fault_tolerance import TrainLoop
    steps = 6
    jcfg, tcfg = jconfigs.get_smoke("llama-60m"), configs.get_smoke(
        "llama-60m")
    jp, model = port_model(jcfg, tcfg, seed=0)
    jopt = jax_gwt(lr=jax_warmup_cosine(0.01, steps), impl="jnp",
                   state_codec="int8")
    jloop = JaxTrainLoop(jlm.make_train_step(jcfg, jopt), None,
                         JaxSyntheticLM(64, 16, 4, 0), log_every=3,
                         log=lambda s: None)
    _, _, jlosses = jloop.run(jp, jopt.init(jp), num_steps=steps)
    topt = gwt(lr=warmup_cosine(0.01, steps), state_codec="int8")
    tree = model.tree()
    tloop = TrainLoop(lm.make_train_step(tcfg, topt),
                      SyntheticLM(64, 16, 4, 0), device="cpu", log_every=3,
                      log=lambda s: None)
    _, state, tlosses = tloop.run(tree, topt.init(tree), num_steps=steps)
    assert len(tlosses) == len(jlosses) == steps
    np.testing.assert_allclose(tlosses[:3], jlosses[:3], rtol=0, atol=2e-5)
    np.testing.assert_allclose(tlosses, jlosses, rtol=0, atol=1e-3)
    assert int(state["step"]) == steps
    assert state["buckets"]["plain__embed.embedding"]["host"]["m"]["q"] \
        .dtype == torch.int8
