"""``state_dtype=torch.bfloat16`` in the port (``optim/hosts.py``,
``optim/standard.py``, ``core/gwt.py``, the plain versions of K1 and K4)
against the JAX package's ``state_dtype=jnp.bfloat16``.

Both compute in f32 from the stored moments and round only what they
store, once, to nearest even.  Tolerances:

* the plain versions of K1 and K4 with bf16 moments: against the JAX
  oracle run op by op (``jax.disable_jit()``), K4's G̃, m' and v' bitwise;
  against the fused-write oracle (XLA's FMA contractions move the f32
  moment by a few spacings before it is rounded, so it can land on the
  neighbouring bf16 value) m' and v' within ``BF16_MOMENT_SPACINGS`` = 1
  bf16 spacing of the largest element (measured 0.5), p and the norm as
  ``tests/test_torch_gwt_adam.py`` holds them (measured 0.25 f32 spacings
  and 0);
* the optimizers over 3 steps: the stored bf16 moments within
  ``BF16_MOMENT_SPACINGS`` (measured 0.125: one neighbouring bf16 value at
  an element an eighth of the largest); parameters within
  ``UPDATE_RTOL`` = 1e-4 of each leaf's total update (measured 2.2e-5);
  f32 values (norms, int8 scales) within ``F32_STATE_SPACINGS`` = 64
  (measured 7 after 3 steps, 17 on a limiter norm of the checkpoint test's
  fourth step: the port sums the norm in the CUDA kernels' order, the JAX
  package in XLA's);
  int8 codes at most one apart at ``MAX_CODES_OFF_BY_ONE`` = 8 codes of a
  leaf (measured 0).

State bytes of bf16 state at full-width llama-60m equal the JAX package's
``engine.state_bytes`` exactly, and a bf16-state GWT checkpoint written by
the JAX package resumes in the port.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import bf16_spacings, flat_numpy, jax_params, spacings, \
    to_numpy, to_torch

from repro import configs as jconfigs, optim as joptim
from repro.checkpoint import manager as jmanager
from repro.core.gwt import gwt as jax_gwt
from repro.kernels.gwt_adam import ops as jops, ref as jref
from repro.models import lm as jlm
from repro.optim import engine as jengine
from repro.optim.base import flatten_with_paths as jflatten
from repro_torch import configs, optim
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.core.gwt import gwt
from repro_torch.kernels.gwt_adam import ops, ref
from repro_torch.models import lm
from repro_torch.optim import engine
from repro_torch.optim.base import flatten_with_paths, unflatten

BF16_MOMENT_SPACINGS = 1
UPDATE_RTOL = 1e-4
F32_STATE_SPACINGS = 64
MAX_CODES_OFF_BY_ONE = 8
BF = torch.bfloat16


def _smoke_params():
    return {k: v.astype(np.float32) for k, v in flat_numpy(
        jax_params(jconfigs.get_smoke("llama-60m"), seed=2)).items()}


def _grads(flat, k):
    rng = np.random.RandomState(300 + k)
    return {p: (rng.randn(*v.shape) * 0.1).astype(np.float32)
            for p, v in flat.items()}


def _run_port(opt, flat, steps, start=0, tp=None, ts=None):
    if tp is None:
        tp = unflatten(list(flat), [to_torch(v) for v in flat.values()])
        ts = opt.init(tp)
    for k in range(start, start + steps):
        g = _grads(flat, k)
        tp, ts = opt.update(unflatten(list(g), [to_torch(v)
                                               for v in g.values()]),
                            ts, tp)
    return tp, ts


def _run_jax(opt, flat, steps, start=0, jp=None, js=None):
    if jp is None:
        jp = unflatten(list(flat), [jnp.asarray(v) for v in flat.values()])
        js = opt.init(jp)
    upd = jax.jit(opt.update)
    for k in range(start, start + steps):
        g = _grads(flat, k)
        jp, js = upd(unflatten(list(g), [jnp.asarray(v)
                                         for v in g.values()]), js, jp)
    return jp, js


def _assert_tracks(tp, ts, jp, js, flat):
    jleaves = dict(zip(*jflatten(js)[:2]))
    tleaves = dict(zip(*flatten_with_paths(ts)))
    assert sorted(tleaves) == sorted(jleaves)
    for path, want in jleaves.items():
        got = tleaves[path]
        assert tuple(got.shape) == tuple(want.shape), path
        if want.dtype == jnp.bfloat16:
            assert got.dtype == BF, path
            assert bf16_spacings(got, want) <= BF16_MOMENT_SPACINGS, path
        elif path.endswith("/q") or path == "codec_key":
            d = got.numpy().astype(np.int64) - np.asarray(want).astype(
                np.int64)
            assert np.abs(d).max(initial=0) <= (0 if path == "codec_key"
                                                else 1), path
            assert int((d != 0).sum()) <= MAX_CODES_OFF_BY_ONE, path
        elif path == "step":
            assert int(got) == int(want)
        else:
            assert got.dtype == torch.float32, path
            assert spacings(got, want) <= F32_STATE_SPACINGS, path
    jpf = flat_numpy(jp)
    for path, got in zip(*flatten_with_paths(tp)):
        update = max(np.abs(jpf[path] - flat[path]).max(), 1e-30)
        err = np.abs(got.numpy() - jpf[path]).max()
        assert err <= UPDATE_RTOL * update, (path, err / update)


FAMILIES = [("adam", {}), ("adam_mini", {}), ("sgd", {}), ("muon", {}),
            ("gwt", {"level": 2}),
            ("gwt", {"level": 2, "fused_write": False}),
            ("gwt", {"level": 2, "host": "muon"})]
IDS = ["adam", "adam_mini", "sgd", "muon", "gwt", "gwt-staged", "gwt-muon"]


@pytest.mark.parametrize("codec_name", ["f32", "int8"])
@pytest.mark.parametrize("name,kw", FAMILIES, ids=IDS)
def test_bf16_state_matches_reference(name, kw, codec_name):
    """3 steps with ``state_dtype=bfloat16``; GWT against the JAX
    package's fused path (its Pallas kernels in interpret mode)."""
    flat = _smoke_params()
    jkw = dict(kw, impl="interpret") if name == "gwt" else kw
    tp, ts = _run_port(optim.make(name, lr=0.01, state_dtype=BF,
                                  state_codec=codec_name, **kw), flat, 3)
    jp, js = _run_jax(joptim.make(name, lr=0.01, state_dtype=jnp.bfloat16,
                                  state_codec=codec_name, **jkw), flat, 3)
    if codec_name == "f32":
        moments = [t for p, t in zip(*flatten_with_paths(ts))
                   if p.endswith("/m") or p.endswith("/v")
                   or (name == "sgd" and p != "step")]
        assert moments and all(t.dtype == BF for t in moments)
    _assert_tracks(tp, ts, jp, js, flat)


@pytest.mark.parametrize("name", ["adam", "adam_mini", "muon"])
def test_host_uses_unrounded_moments(name):
    """The host's preconditioner comes from the f32 moments; only the
    stored state is rounded to bf16, once, to nearest even."""
    from repro_torch.optim import hosts
    g = torch.from_numpy(np.random.RandomState(4).randn(3, 8, 16)
                         .astype(np.float32))
    h32, h16 = hosts.make_host(name), hosts.make_host(name, state_dtype=BF)
    s32, s16 = h32.init(g.shape, "cpu"), h16.init(g.shape, "cpu")
    assert all(t.dtype == BF for t in s16.values())
    step = torch.tensor(0, dtype=torch.int32)
    a = h32.update(g, s32, step)
    b = h16.update(g, s16, step)
    assert torch.equal(a[0], b[0])
    for k in a[3]:
        assert b[3][k].dtype == BF and torch.equal(b[3][k], a[3][k].to(BF))


def _fused_inputs(L, m, n, level, seed):
    rng = np.random.RandomState(seed)
    return (rng.randn(L, m, n).astype(np.float32),
            rng.randn(L, m, n).astype(np.float32),
            (rng.randn(L, m, n >> level) * 0.1).astype(np.float32),
            (rng.rand(L, m, n >> level) * 0.01).astype(np.float32))


@pytest.mark.parametrize("level", [1, 2, 3])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_k1_plain_version_with_bf16_moments(level, dtype):
    """The plain version of K1 (``ops.fused_write_update`` on the CPU) with
    bf16 moments against the JAX fused-write oracle with bf16 moments."""
    L, m, n = 3, 24, 344
    g, p, mm, vv = _fused_inputs(L, m, n, level, seed=level)
    pn = np.full((L,), 1e-3, np.float32)
    kw = dict(alpha=0.25, weight_decay=0.1, gamma=1.01, use_limiter=True,
              level=level)
    jp, jn, js = jops.fused_write_update(
        jnp.asarray(g).astype(dtype), jnp.asarray(p).astype(dtype),
        {"m": jnp.asarray(mm).astype(jnp.bfloat16),
         "v": jnp.asarray(vv).astype(jnp.bfloat16)}, jnp.int32(3),
        jnp.asarray(pn), lr_t=0.01, impl="jnp", **kw)
    tdt = getattr(torch, dtype)
    tp, tn, ts = ops.fused_write_update(
        to_torch(g, tdt), to_torch(p, tdt),
        {"m": to_torch(mm, BF), "v": to_torch(vv, BF)},
        torch.tensor(3, dtype=torch.int32), to_torch(pn),
        lr_t=torch.tensor(0.01), **kw)
    assert js["m"].dtype == jnp.bfloat16
    assert ts["m"].dtype == ts["v"].dtype == BF
    for k in ("m", "v"):
        assert bf16_spacings(ts[k], js[k]) <= BF16_MOMENT_SPACINGS
    if dtype == "float32":
        assert spacings(tp, jp) <= 4 and spacings(tn, jn) <= 4
    else:
        assert bf16_spacings(tp, jp) <= 1 and spacings(tn, jn) <= 64


@pytest.mark.parametrize("level", [1, 2, 3])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_k4_plain_version_with_bf16_moments_op_by_op(level, dtype):
    """The plain version of K4 with bf16 moments equals the JAX oracle run
    op by op, bitwise (G̃, m', v')."""
    g, _, mm, vv = _fused_inputs(2, 24, 344, level, seed=10 + level)
    with jax.disable_jit():
        want = jax.vmap(lambda a, b, c: jref.gwt_adam_tile(
            a, b, c, level=level))(jnp.asarray(g).astype(dtype),
                                   jnp.asarray(mm).astype(jnp.bfloat16),
                                   jnp.asarray(vv).astype(jnp.bfloat16))
    got = ref.gwt_adam_tile(to_torch(g, getattr(torch, dtype)),
                            to_torch(mm, BF), to_torch(vv, BF), level=level)
    assert got[1].dtype == got[2].dtype == BF
    for a, b in zip(got[:3], want[:3]):
        np.testing.assert_array_equal(
            a.float().numpy(), np.asarray(jnp.asarray(b).astype(
                jnp.float32)))


def _bf16(flat):
    return unflatten(list(flat), [to_torch(v) for v in flat.values()])


@pytest.mark.parametrize("name,kw", [("gwt", {}),
                                     ("gwt", {"fused_write": False}),
                                     ("adam", {}), ("adam_mini", {}),
                                     ("sgd", {}), ("muon", {})],
                         ids=["gwt", "gwt-staged", "adam", "adam_mini",
                              "sgd", "muon"])
def test_full_width_bf16_state_bytes_match_reference(name, kw):
    """llama-60m at full width on the meta device."""
    jkw = dict(kw, impl="jnp") if name == "gwt" else kw
    want = jengine.state_bytes(
        joptim.make(name, lr=0.01, state_dtype=jnp.bfloat16, **jkw),
        jlm.abstract_params(jconfigs.get_config("llama-60m")))
    st = optim.make(name, lr=0.01, state_dtype=BF, **kw).init(
        lm.abstract_params(configs.get_config("llama-60m")))
    assert engine.state_bytes(st) == want
    assert engine.state_bytes(optim.make(name, lr=0.01, **kw).init(
        lm.abstract_params(configs.get_config("llama-60m")))) > want


def test_jax_bf16_gwt_checkpoint_resumes_in_the_port(tmp_path):
    """A bf16-state GWT checkpoint the JAX package wrote after 2 steps (its
    fused path, interpret mode) restores in the port with bf16 moments; 2
    more steps on each side agree within this file's tolerances."""
    flat = _smoke_params()
    jopt = jax_gwt(lr=0.01, state_dtype=jnp.bfloat16, impl="interpret")
    jp, js = _run_jax(jopt, flat, 2)
    jmanager.CheckpointManager(str(tmp_path)).save(
        2, {"params": jp, "opt": js}, blocking=True)
    topt = gwt(lr=0.01, state_dtype=BF)
    tp0 = _bf16(flat)
    state, start = CheckpointManager(str(tmp_path)).restore(
        None, {"params": tp0, "opt": topt.init(tp0)}, device="cpu")
    assert start == 2
    m = state["opt"]["buckets"]["gwt_last__layers.b0.ffn.w_down"]["host"]["m"]
    assert m.dtype == BF
    want = js["buckets"]["gwt_last__layers.b0.ffn.w_down"]["host"]["m"]
    assert torch.equal(m.float(), to_torch(np.asarray(want.astype(
        jnp.float32))))
    tp, ts = _run_port(topt, flat, 2, start=2, tp=state["params"],
                       ts=state["opt"])
    jp, js = _run_jax(jopt, flat, 2, start=2, jp=jp, js=js)
    _assert_tracks(tp, ts, jp, js, flat)


def test_port_bf16_checkpoint_loads_in_the_jax_package(tmp_path):
    """The port's bf16-state GWT checkpoint after 2 steps restores in the
    JAX package's manager into ``gwt(state_dtype=bfloat16).init``'s
    layout: the same paths, dtype names and bits."""
    flat = _smoke_params()
    tp, ts = _run_port(gwt(lr=0.01, state_dtype=BF), flat, 2)
    CheckpointManager(str(tmp_path)).save(2, {"params": tp, "opt": ts},
                                          blocking=True)
    jp0 = unflatten(list(flat), [jnp.asarray(v) for v in flat.values()])
    like = {"params": jp0, "opt": jax_gwt(
        lr=0.01, state_dtype=jnp.bfloat16, impl="jnp").init(jp0)}
    got, step = jmanager.CheckpointManager(str(tmp_path)).restore(None, like)
    assert step == 2
    want = dict(zip(*flatten_with_paths({"params": tp, "opt": ts})))
    paths, leaves, _ = jflatten(got)
    assert sorted(paths) == sorted(want)
    assert any(np.asarray(leaf).dtype.name == "bfloat16" for leaf in leaves)
    for path, leaf in zip(paths, leaves):
        ours = want[path]
        assert np.asarray(leaf).dtype.name == engine.dtype_name(ours.dtype)
        np.testing.assert_array_equal(to_numpy(leaf), to_numpy(ours))

