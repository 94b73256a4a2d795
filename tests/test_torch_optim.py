"""The port's optimizer families (``repro_torch.optim``: the registry,
``standard.py``, the adam_mini and muon hosts, db2 in ``core/haar.py``,
``engine.build(bucketed=False)``) against the JAX package's
``repro.optim.make``, and the launcher's ``--optimizer``/``--host``.

Tolerances.  Each family runs 3 steps from the same parameters and
gradients in both packages (the JAX update jitted).  XLA's CPU backend
contracts ``b*m + (1-b)*g`` and the db2 filter sums into FMAs, PyTorch's
op-by-op arithmetic does not, and torch's f32 ``sqrt`` on the CPU is not
always correctly rounded, so the state moves by a few f32 spacings
(``STATE_SPACINGS`` = 8; measured 4) and the parameters by a few
millionths of each leaf's total update (``UPDATE_RTOL`` = 5e-5 of
``max|p_3 - p_0|``; measured 8.6e-6).  The update, not the parameter,
sets the scale: where ``1/(√v+ε)`` is large at the first steps (db2's
filter sums), a one-spacing band difference shows as ~100 spacings of a
small parameter and still as 8e-6 of its update.  Codes may move by 1 at
``MAX_CODES_OFF_BY_ONE`` codes of a leaf state (measured 0).  The
Newton-Schulz iteration's f32 matmuls sum in another order (MKL against
XLA's): its output within ``NS_RTOL`` = 2e-5 of its largest element
(measured 3.4e-6; the JAX package's jitted and op-by-op runs differ by
2.7e-6 themselves).  db2 is bitwise to the JAX transform run op by op, in
f32 and bf16.

Inside the port the unrolled engine (``bucketed=False``) equals the
bucketed one bitwise for every family whose rules have no
``vector_update``.  GWT's default bucket runs the fused write (norm summed
in the CUDA kernels' order) and its unrolled leaf the staged update (norm by
``torch.linalg.vector_norm``): 4 f32 spacings (measured 1).  The JAX
package's own adam_mini bucketed-vs-unrolled check is red
(``test_engine.py::...[adam_mini-kw1]``), so the port's adam_mini is held
to JAX's unrolled run with the tolerances above, not to its
self-consistency.

State bytes of every family and codec at full-width llama-60m are exact
integers and equal the JAX package's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import flat_numpy, spacings, to_torch

from repro import configs as jconfigs, optim as joptim
from repro.core import haar as jhaar
from repro.models import lm as jlm
from repro.optim import engine as jengine, hosts as jhosts
from repro_torch import configs, optim
from repro_torch.core import haar
from repro_torch.launch import train
from repro_torch.models import lm
from repro_torch.optim import engine, hosts
from repro_torch.optim.base import flatten_with_paths, unflatten

STATE_SPACINGS = 8
UPDATE_RTOL = 5e-5
MAX_CODES_OFF_BY_ONE = 8
NS_RTOL = 2e-5

FAMILIES = [("adam", {}), ("adam_mini", {}), ("muon", {}), ("sgd", {}),
            ("gwt", {"level": 1, "host": "adam_mini"}),
            ("gwt", {"level": 2, "host": "muon"}),
            ("gwt", {"level": 2, "wavelet": "db2"})]
IDS = ["adam", "adam_mini", "muon", "sgd", "gwt-adam_mini", "gwt-muon",
       "gwt-db2"]


def _layered(n_layers=2, d=16, f=32, vocab=10):
    """Per-layer attention/MLP leaves plus an embedding and a norm."""
    rng = np.random.RandomState(0)
    p = {"embed": rng.randn(vocab, d), "norm": np.ones(d)}
    for i in range(n_layers):
        p[f"layer_{i}/attn/wq"] = rng.randn(d, d) * 0.1
        p[f"layer_{i}/attn/wo"] = rng.randn(d, d) * 0.1
        p[f"layer_{i}/mlp/w1"] = rng.randn(d, f) * 0.1
        p[f"layer_{i}/mlp/w2"] = rng.randn(f, d) * 0.1
    return {k: v.astype(np.float32) for k, v in p.items()}


def _grads(flat, k):
    rng = np.random.RandomState(50 + k)
    return {p: (rng.randn(*v.shape) * 0.1).astype(np.float32)
            for p, v in flat.items()}


def _run_port(opt, flat, steps=3):
    tp = unflatten(list(flat), [to_torch(v) for v in flat.values()])
    ts = opt.init(tp)
    for k in range(steps):
        g = _grads(flat, k)
        tp, ts = opt.update(unflatten(list(g), [to_torch(v)
                                               for v in g.values()]),
                            ts, tp)
    return tp, ts


def _run_jax(opt, flat, steps=3):
    jp = unflatten(list(flat), [jnp.asarray(v) for v in flat.values()])
    js = opt.init(jp)
    upd = jax.jit(opt.update)
    for k in range(steps):
        g = _grads(flat, k)
        jp, js = upd(unflatten(list(g), [jnp.asarray(v)
                                         for v in g.values()]), js, jp)
    return jp, js


def _assert_tracks(tp, ts, jp, js, flat):
    jsf, tsf = flat_numpy(js), dict(zip(*flatten_with_paths(ts)))
    assert sorted(tsf) == sorted(jsf)
    for path, want in jsf.items():
        got = tsf[path]
        assert tuple(got.shape) == want.shape, path
        if path.endswith("/q") or path == "codec_key":
            d = got.numpy().astype(np.int64) - want.astype(np.int64)
            assert np.abs(d).max(initial=0) <= (0 if path == "codec_key"
                                                else 1), path
            assert int((d != 0).sum()) <= MAX_CODES_OFF_BY_ONE, path
        elif path == "step":
            assert int(got) == int(want)
        else:
            assert spacings(got, want) <= STATE_SPACINGS, path
    jpf = flat_numpy(jp)
    for path, got in zip(*flatten_with_paths(tp)):
        update = max(np.abs(jpf[path] - flat[path]).max(), 1e-30)
        err = np.abs(got.numpy() - jpf[path]).max()
        assert err <= UPDATE_RTOL * update, (path, err / update)


@pytest.mark.parametrize("codec_name", ["f32", "int8"])
@pytest.mark.parametrize("name,kw", FAMILIES, ids=IDS)
def test_family_matches_reference(name, kw, codec_name):
    flat = _layered()
    tp, ts = _run_port(optim.make(name, lr=0.01, state_codec=codec_name,
                                  **kw), flat)
    jp, js = _run_jax(joptim.make(name, lr=0.01, state_codec=codec_name,
                                  **kw), flat)
    _assert_tracks(tp, ts, jp, js, flat)


@pytest.mark.parametrize("name,kw", FAMILIES + [("gwt", {"level": 2})],
                         ids=IDS + ["gwt"])
def test_unrolled_engine(name, kw):
    """``bucketed=False`` equals the port's bucketed run (bitwise where no
    rule has a ``vector_update``) and tracks JAX ``bucketed=False``."""
    flat = _layered()
    pb, sb = _run_port(optim.make(name, lr=0.01, **kw), flat)
    unrolled = optim.make(name, lr=0.01, bucketed=False, **kw)
    assert not unrolled.engine.bucketed
    pu, su = _run_port(unrolled, flat)
    fa, fb = (dict(zip(*flatten_with_paths({"p": p, "s": st})))
              for p, st in ((pb, sb), (pu, su)))
    assert sorted(fa) == sorted(fb)
    fused = name == "gwt" and "host" not in kw and "wavelet" not in kw
    for path in fa:
        if fused:
            assert spacings(fb[path], fa[path]) <= 4, path
        else:
            assert torch.equal(fa[path], fb[path]), path
    jp, js = _run_jax(joptim.make(name, lr=0.01, bucketed=False, **kw), flat)
    _assert_tracks(pu, su, jp, js, flat)


def test_newton_schulz_matches_reference():
    rng = np.random.RandomState(0)
    for shape in [(8, 32, 48), (48, 32), (4, 512, 128), (128, 344)]:
        x = rng.randn(*shape).astype(np.float32)
        want = np.asarray(jax.jit(jhosts.newton_schulz)(jnp.asarray(x)))
        got = hosts.newton_schulz(to_torch(x)).numpy()
        assert got.shape == want.shape
        assert np.abs(got - want).max() <= NS_RTOL * np.abs(want).max()


def test_adam_mini_keeps_one_v_per_row():
    h = hosts.adam_mini()
    st = h.init((3, 5, 7), "cpu")
    assert st["m"].shape == (3, 5, 7) and st["v"].shape == (3, 5, 1)
    assert h.init((7,), "cpu")["v"].shape == ()
    with pytest.raises(ValueError, match="unknown host"):
        hosts.make_host("lion")


@pytest.mark.parametrize("level", [1, 2, 3])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_db2_matches_reference_op_by_op(level, dtype):
    g = np.random.RandomState(level).randn(3, 5, 64).astype(np.float32)
    with jax.disable_jit():
        a, d = jhaar.db2_forward(jnp.asarray(g).astype(dtype), level)
        inv = jhaar.db2_inverse(a, d)
    ta, td = haar.db2_forward(to_torch(g, getattr(torch, dtype)), level)
    tinv = haar.db2_inverse(ta, td)
    f32 = lambda x: np.asarray(jnp.asarray(x).astype(jnp.float32))
    assert ta.dtype == tinv.dtype == getattr(torch, dtype)
    for got, want in zip([ta, *td, tinv], [a, *d, inv]):
        np.testing.assert_array_equal(got.float().numpy(), f32(want))
    if dtype == "float32":
        np.testing.assert_allclose(tinv.numpy(), g, atol=1e-5)


def test_make_names_what_is_not_ported():
    for name in ("galore", "apollo", "fira", "adarankgrad", "rso"):
        with pytest.raises(ValueError, match="not ported yet"):
            optim.make(name, lr=0.01)
    with pytest.raises(ValueError, match="unknown optimizer"):
        optim.make("lion", lr=0.01)


STATE_CASES = FAMILIES + [("gwt", {"level": 2}),
                          ("gwt", {"level": 2, "fused_write": False})]


@pytest.mark.parametrize("codec_name", ["f32", "int8"])
@pytest.mark.parametrize("name,kw", STATE_CASES,
                         ids=IDS + ["gwt", "gwt-staged"])
def test_full_width_state_bytes_match_reference(name, kw, codec_name):
    """llama-60m at full width on the meta device: the exact state bytes
    equal the JAX package's ``engine.state_bytes``."""
    jkw = dict(kw, impl="jnp") if name == "gwt" else kw
    jopt = joptim.make(name, lr=0.01, state_codec=codec_name, **jkw)
    want = jengine.state_bytes(jopt, jlm.abstract_params(
        jconfigs.get_config("llama-60m")))
    topt = optim.make(name, lr=0.01, state_codec=codec_name, **kw)
    got = engine.state_bytes(topt.init(lm.abstract_params(
        configs.get_config("llama-60m"))))
    assert got == want


SMOKE = ["--arch", "llama-60m", "--smoke", "--batch", "4", "--seq", "16",
         "--log-every", "2", "--device", "cpu"]


def _equal_trees(a, b, what):
    fa, fb = (dict(zip(*flatten_with_paths(t))) for t in (a, b))
    assert sorted(fa) == sorted(fb), what
    for path in fa:
        assert fa[path].dtype == fb[path].dtype, (what, path)
        assert torch.equal(fa[path], fb[path]), (what, path)


def test_launcher_adam_mini_int8_resumes_bitwise(tmp_path):
    """``--optimizer adam_mini --state-codec int8``: 8 straight steps equal
    4 steps + checkpoint + a resumed run of 4, bitwise."""
    args = SMOKE + ["--optimizer", "adam_mini", "--state-codec", "int8",
                    "--steps", "8"]
    straight = train.main(args)
    st = straight.opt_state["buckets"]["adam_mini__embed.embedding"]
    assert st["v"]["q"].shape[-1] == 1 and st["m"]["q"].dtype == torch.int8
    ck = ["--ckpt-dir", str(tmp_path), "--ckpt-every", "4"]
    first = train.main(args + ck)
    assert first.losses == straight.losses
    import shutil
    shutil.rmtree(tmp_path / "step_000000008")
    resumed = train.main(args + ck + ["--resume"])
    assert resumed.start_step == 4 and resumed.losses == straight.losses[4:]
    _equal_trees(resumed.params, straight.params, "params")
    _equal_trees(resumed.opt_state, straight.opt_state, "state")


def test_launcher_sgd_bare_state_and_host_choice():
    """``--optimizer sgd`` keeps a bare momentum tensor per leaf (int8:
    its codes and scales); ``--host`` reaches GWT's host."""
    res = train.main(SMOKE + ["--optimizer", "sgd", "--state-codec", "int8",
                              "--steps", "2"])
    st = res.opt_state["buckets"]["sgd__embed.embedding"]
    assert sorted(st) == ["q", "scale"] and st["q"].dtype == torch.int8
    res = train.main(SMOKE + ["--optimizer", "gwt", "--host", "muon",
                              "--steps", "2"])
    bucket = res.opt_state["buckets"]["gwt_last__layers.b0.mixer.wk"]
    assert sorted(bucket["host"]) == ["m"]
    assert np.all(np.isfinite(res.losses))


def test_launcher_rejects_unported_optimizers():
    for name in ("galore", "rso"):
        with pytest.raises(SystemExit):
            train.main(SMOKE + ["--optimizer", name, "--steps", "1"])
