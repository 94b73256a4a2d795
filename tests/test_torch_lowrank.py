"""The port's low-rank families (``repro_torch.optim.lowrank``: GaLore,
APOLLO, Fira, AdaRankGrad, RSO) against the JAX package's
``repro.optim.make``, their helpers, the port's own projector draws, the
engine's host step, and the launcher's low-rank ``--optimizer`` choices.

Every family runs 5 steps on llama-60m-smoke parameters and gradients
with ``rank=4, update_gap=2`` (refreshes at steps 0, 2 and 4; AdaRankGrad
and RSO rotate their moments at each), under both codecs, bucketed and
unrolled.  The JAX update is jitted.  The SVDs (GaLore, Fira,
AdaRankGrad) are the JAX package's, injected into the port
(``lowrank.svd``), because SVD signs are arbitrary (a sign flip of
GaLore's new basis mixes with the unrotated moments of the last epoch);
the family test injects the JAX package's draws (APOLLO, RSO) too
(``lowrank.draw_normal``), so it holds the update alone, and
``test_random_families_match_reference_with_the_ports_draws`` holds the
port's own draws (``core.prng``, normals within 4 f32 spacings of
``jax.random``'s) under the same tolerances.  Everything downstream of the
projector is held tightly:

* moments, projectors, scales and norms within ``STATE_SPACINGS`` = 16
  f32 spacings of the leaf's largest element (measured 9): the
  projections are f32 matrix products that MKL and XLA sum in other
  orders;
* parameters within ``UPDATE_RTOL`` = 1e-4 of each leaf's total update
  ``max|p_5 - p_0|`` (measured 1.2e-5); the update, not the parameter,
  sets the scale, as in ``tests/test_torch_optim.py``.  Under int8 a moment
  one spacing apart can round to the neighbouring code, one quantum
  (1/127 of its block's largest moment) away, which moves that element's
  step by up to that share: ``INT8_UPDATE_RTOL`` = 8e-3 (measured 1.65e-3:
  GaLore's step 1 has one code apart, the next refresh step carries it
  into the parameters);
* int8 codes at most one apart, at no more than ``MAX_CODES_OFF_BY_ONE``
  = 8 codes of a leaf (measured 0 after 5 steps, 1 after step 1).

With the port's own SVD the subspace ``P Pᵀ`` matches the JAX package's
within ``SUBSPACE_ATOL`` = 1e-4 (measured 6.1e-6).  The two SVDs differ by
about 1e-4 in their vectors, so over one refresh epoch (where the update
does not depend on column signs) parameters agree within
``SVD_UPDATE_RTOL`` = 1e-3 of the update (measured 3.4e-4) and the
sign-free moments within ``SVD_STATE_SPACINGS`` = 1024 (measured 197).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import flat_numpy, jax_params, spacings, to_numpy, \
    to_torch

from repro import configs as jconfigs, optim as joptim
from repro.checkpoint import manager as jmanager
from repro.optim import lowrank as jlowrank
from repro.optim.base import flatten_with_paths as jflatten
from repro_torch import optim
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.launch import train
from repro_torch.optim import engine, lowrank
from repro_torch.optim.base import flatten_with_paths, unflatten

STATE_SPACINGS = 16
UPDATE_RTOL = 1e-4
INT8_UPDATE_RTOL = 8e-3
MAX_CODES_OFF_BY_ONE = 8
SUBSPACE_ATOL = 1e-4
SVD_UPDATE_RTOL = 1e-3
SVD_STATE_SPACINGS = 1024
STEPS = 5
LOWRANK_KW = {"rank": 4, "update_gap": 2}
FAMILIES = ("galore", "apollo", "fira", "adarankgrad", "rso")


def _smoke_params():
    return {k: v.astype(np.float32) for k, v in flat_numpy(
        jax_params(jconfigs.get_smoke("llama-60m"), seed=1)).items()}


def _grads(flat, k):
    rng = np.random.RandomState(200 + k)
    return {p: (rng.randn(*v.shape) * 0.1).astype(np.float32)
            for p, v in flat.items()}


def jax_draw(shape, seed, leaf_id, epoch, device):
    """The JAX package's APOLLO/RSO draw for ``(seed, leaf_id, epoch)``."""
    key = jax.random.fold_in(jax.random.key(seed + leaf_id), epoch)
    return to_torch(np.asarray(jax.random.normal(key, tuple(shape),
                                                 jnp.float32)))


def jax_svd(g32):
    """The JAX package's SVD of the same f32 input."""
    u, s, vh = jnp.linalg.svd(jnp.asarray(g32.numpy()), full_matrices=False)
    return tuple(to_torch(np.asarray(a)) for a in (u, s, vh))


@pytest.fixture
def jax_projectors(monkeypatch):
    monkeypatch.setattr(lowrank, "draw_normal", jax_draw)
    monkeypatch.setattr(lowrank, "svd", jax_svd)


def _run_port(opt, flat, steps=STEPS, start=0, tp=None, ts=None):
    if tp is None:
        tp = unflatten(list(flat), [to_torch(v) for v in flat.values()])
        ts = opt.init(tp)
    for k in range(start, start + steps):
        g = _grads(flat, k)
        tp, ts = opt.update(unflatten(list(g), [to_torch(v)
                                               for v in g.values()]),
                            ts, tp)
    return tp, ts


def _run_jax(opt, flat, steps=STEPS, start=0, jp=None, js=None):
    if jp is None:
        jp = unflatten(list(flat), [jnp.asarray(v) for v in flat.values()])
        js = opt.init(jp)
    upd = jax.jit(opt.update)
    for k in range(start, start + steps):
        g = _grads(flat, k)
        jp, js = upd(unflatten(list(g), [jnp.asarray(v)
                                         for v in g.values()]), js, jp)
    return jp, js


def _assert_params(tp, jp, flat, rtol=UPDATE_RTOL):
    jpf = flat_numpy(jp)
    for path, got in zip(*flatten_with_paths(tp)):
        update = max(np.abs(jpf[path] - flat[path]).max(), 1e-30)
        err = np.abs(got.float().numpy() - jpf[path]).max()
        assert err <= rtol * update, (path, err / update)


def _assert_state(ts, js):
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
        elif path == "step" or path.endswith("/rank"):
            assert np.array_equal(got.numpy(), want), path
        else:
            assert spacings(got, want) <= STATE_SPACINGS, path


@pytest.mark.parametrize("bucketed", [True, False],
                         ids=["bucketed", "unrolled"])
@pytest.mark.parametrize("codec_name", ["f32", "int8"])
@pytest.mark.parametrize("name", FAMILIES)
def test_family_matches_reference(name, codec_name, bucketed,
                                  jax_projectors):
    flat = _smoke_params()
    kw = dict(LOWRANK_KW, state_codec=codec_name, bucketed=bucketed)
    tp, ts = _run_port(optim.make(name, lr=0.01, **kw), flat)
    jp, js = _run_jax(joptim.make(name, lr=0.01, **kw), flat)
    _assert_state(ts, js)
    _assert_params(tp, jp, flat, UPDATE_RTOL if codec_name == "f32"
                   else INT8_UPDATE_RTOL)


@pytest.mark.parametrize("codec_name", ["f32", "int8"])
@pytest.mark.parametrize("name", ["apollo", "rso"])
def test_random_families_match_reference_with_the_ports_draws(name,
                                                              codec_name):
    """APOLLO and RSO with the port's own draws (``core.prng``, nothing
    injected) through refreshes at steps 0, 2 and 4: the state and the
    parameters within the family test's tolerances, the projectors
    within ``STATE_SPACINGS`` and their subspaces ``P Pᵀ`` within
    ``SUBSPACE_ATOL`` (RSO's QR signs need not agree)."""
    flat = _smoke_params()
    kw = dict(LOWRANK_KW, state_codec=codec_name)
    tp, ts = _run_port(optim.make(name, lr=0.01, **kw), flat)
    jp, js = _run_jax(joptim.make(name, lr=0.01, **kw), flat)
    _assert_state(ts, js)
    _assert_params(tp, jp, flat, UPDATE_RTOL if codec_name == "f32"
                   else INT8_UPDATE_RTOL)
    projs = [(b["proj"], np.asarray(js["buckets"][n]["proj"]))
             for n, b in ts["buckets"].items() if "proj" in b]
    assert len(projs) == 3
    for got, want in projs:
        np.testing.assert_allclose(_subspace(got), _subspace(want),
                                   atol=SUBSPACE_ATOL)


def _subspace(proj):
    p = proj.numpy() if isinstance(proj, torch.Tensor) else np.asarray(proj)
    return p @ np.swapaxes(p, -1, -2)


@pytest.mark.parametrize("name", ["galore", "fira", "adarankgrad"])
def test_first_epoch_with_the_ports_svd(name):
    """The port's own SVD over one refresh epoch (3 steps, one refresh at
    step 0): parameters, the subspace ``P Pᵀ``, the moments brought back
    to the full space (``P m`` or ``m Pᵀ``, free of column signs) and ``v``
    (squares) match the JAX package."""
    flat = _smoke_params()
    kw = {"rank": 4, "update_gap": 100}
    tp, ts = _run_port(optim.make(name, lr=0.01, **kw), flat, steps=3)
    jp, js = _run_jax(joptim.make(name, lr=0.01, **kw), flat, steps=3)
    _assert_params(tp, jp, flat, SVD_UPDATE_RTOL)
    for bname, tb in ts["buckets"].items():
        if "proj" not in tb:
            continue
        jb = js["buckets"][bname]
        tproj, jproj = tb["proj"], np.asarray(jb["proj"])
        np.testing.assert_allclose(_subspace(tproj), _subspace(jproj),
                                   atol=SUBSPACE_ATOL)
        # a right projector's moments end in the rank, a left one's do not
        left = tb["host"]["m"].shape[-1] != tproj.shape[-1]
        up = (lambda p, m: p @ m) if left else \
            (lambda p, m: m @ np.swapaxes(p, -1, -2))
        got = up(tproj.numpy(), tb["host"]["m"].numpy())
        want = up(jproj, np.asarray(jb["host"]["m"]))
        assert spacings(got, want) <= SVD_STATE_SPACINGS, bname
        assert spacings(tb["host"]["v"], jb["host"]["v"]) \
            <= SVD_STATE_SPACINGS, bname


@pytest.mark.parametrize("shape,left", [((2, 16, 32), True),
                                        ((2, 32, 16), False),
                                        ((48, 40), False)])
def test_svd_projector_matches_by_subspace(shape, left):
    g = np.random.RandomState(3).randn(*shape).astype(np.float32)
    r = 4
    got = lowrank._svd_projector(to_torch(g), r, left)
    want = jlowrank._svd_projector(jnp.asarray(g), r, left)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(_subspace(got), _subspace(want),
                               atol=SUBSPACE_ATOL)


def test_update_is_invariant_to_a_column_sign_flip(monkeypatch):
    """A valid SVD with some singular pairs negated gives the same GaLore
    parameters and subspace within an epoch, bitwise: each negated column
    of P negates one row of the subspace gradient and moment, and the
    products back to the full space negate both factors."""
    flat = _smoke_params()
    kw = {"rank": 4, "update_gap": 100}
    base = _run_port(optim.make("galore", lr=0.01, **kw), flat, steps=3)

    def flipped(g32):
        u, s, vh = torch.linalg.svd(g32, full_matrices=False)
        sign = torch.ones(s.shape[-1])
        sign[::2] = -1.0
        return u * sign, s, vh * sign[:, None]

    monkeypatch.setattr(lowrank, "svd", flipped)
    flip = _run_port(optim.make("galore", lr=0.01, **kw), flat, steps=3)
    for (pa, a), (pb, b) in zip(zip(*flatten_with_paths(base[0])),
                                zip(*flatten_with_paths(flip[0]))):
        assert torch.equal(a, b), pa
    for name, st in base[1]["buckets"].items():
        if "proj" in st:
            other = flip[1]["buckets"][name]
            assert not torch.equal(st["proj"], other["proj"])
            np.testing.assert_allclose(_subspace(st["proj"]),
                                       _subspace(other["proj"]), atol=1e-6)


# ---------------------------------------------------------------------------
# The helpers against the reference


def test_effective_rank_reference_cases():
    """The reference's exact cases (``tests/test_lowrank_props.py``)."""
    t = lambda x: torch.tensor(x, dtype=torch.float32)
    assert float(lowrank._effective_rank(t([10.0, 0, 0, 0]), 0.9, 4)) == 1.0
    assert float(lowrank._effective_rank(torch.ones(4), 0.9, 4)) == 4.0
    assert float(lowrank._effective_rank(torch.ones(4), 0.5, 4)) == 2.0


@pytest.mark.parametrize("seed", range(6))
def test_effective_rank_matches_reference_away_from_tau(seed):
    """Random batched spectra whose cumulative energy fractions stay 1e-3
    or more from every ``tau``: the same rank as the JAX package's (a
    fraction within a rounding of ``tau`` may land either side, as XLA's
    cumsum adds in another order)."""
    rng = np.random.RandomState(seed)
    s = -np.sort(-np.abs(rng.randn(3, 12)), axis=-1).astype(np.float32)
    frac = np.cumsum(s.astype(np.float64) ** 2, -1)
    frac /= frac[..., -1:]
    for tau in (0.3, 0.5, 0.75, 0.9, 0.99):
        if np.abs(frac - tau).min() < 1e-3:
            continue
        for r_max in (2, 6, 12):
            got = lowrank._effective_rank(to_torch(s), tau, r_max)
            want = jlowrank._effective_rank(jnp.asarray(s), tau, r_max)
            assert got.dtype == torch.float32
            assert float(got) == float(want), (tau, r_max)


@pytest.mark.parametrize("left", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rotate_down_up_match_reference(left, dtype):
    """``_rotate_moments``, ``_down`` and ``_up`` within 8 f32 spacings
    (measured 2; products summed in another order), bf16 moments to one
    bf16 rounding of the same f32 values."""
    rng = np.random.RandomState(5)
    m, n, r = (16, 24, 4) if left else (24, 16, 4)
    side = m if left else n
    low = (2, r, n) if left else (2, m, r)
    po, pn = (np.linalg.qr(rng.randn(2, side, r))[0].astype(np.float32)
              for _ in range(2))
    hm = (rng.randn(*low) * 1e-2).astype(np.float32)
    hv = (np.abs(rng.randn(*low)) * 1e-4).astype(np.float32)
    g = rng.randn(2, m, n).astype(np.float32)
    td = getattr(torch, dtype)
    got = lowrank._rotate_moments({"m": to_torch(hm, td),
                                   "v": to_torch(hv, td)},
                                  to_torch(po), to_torch(pn), left)
    want = jlowrank._rotate_moments(
        {"m": jnp.asarray(hm).astype(dtype), "v": jnp.asarray(hv).astype(
            dtype)}, jnp.asarray(po), jnp.asarray(pn), left)
    for k in ("m", "v"):
        assert got[k].dtype == td
        tol = 8 if dtype == "float32" else 2.0 ** 16
        assert spacings(got[k], want[k]) <= tol, k
    down = lowrank._down(to_torch(g), to_torch(pn), left)
    jdown = jlowrank._down(jnp.asarray(g), jnp.asarray(pn), left)
    assert spacings(down, jdown) <= 8
    up = lowrank._up(down, to_torch(pn), left)
    assert spacings(up, jlowrank._up(jdown, jnp.asarray(pn), left)) <= 8


# ---------------------------------------------------------------------------
# The port's own draws


def test_port_draws_repeat_per_leaf_and_epoch():
    a = lowrank.draw_normal((2, 16, 4), 0, 3, 1, "cpu")
    assert a.dtype == torch.float32 and a.shape == (2, 16, 4)
    assert torch.equal(a, lowrank.draw_normal((2, 16, 4), 0, 3, 1, "cpu"))
    for other in ((0, 3, 2), (0, 4, 1), (1, 3, 1)):
        assert not torch.equal(a, lowrank.draw_normal((2, 16, 4), *other,
                                                      "cpu"))


def test_rso_projector_is_orthonormal():
    p = torch.zeros(3, 32, 48)
    q = lowrank._orth_rand_projector(p, 8, True, 0, 5, 2)
    assert q.shape == (3, 32, 8)
    eye = q.transpose(-1, -2) @ q
    torch.testing.assert_close(eye, torch.eye(8).expand(3, 8, 8),
                               atol=1e-5, rtol=0)
    assert torch.equal(q, lowrank._orth_rand_projector(p, 8, True, 0, 5, 2))


# ---------------------------------------------------------------------------
# The host step


class _CountingStep(torch.Tensor):
    """A step tensor that counts the host reads of its value."""
    reads = 0

    def __int__(self):
        type(self).reads += 1
        return super().__int__()


def test_the_engine_reads_the_device_step_once(monkeypatch):
    """From ``init`` the engine reads the step once; every later update
    takes it from the host mirror of the ``step + 1`` it returned.  The SVD
    runs on the refresh steps (0, 2, 4) only, once per low-rank leaf."""
    flat = _smoke_params()
    opt = optim.make("galore", lr=0.01, **LOWRANK_KW)
    tp = unflatten(list(flat), [to_torch(v) for v in flat.values()])
    ts = opt.init(tp)
    ts["step"] = ts["step"].as_subclass(_CountingStep)
    _CountingStep.reads = 0
    calls = []
    real = lowrank.svd
    monkeypatch.setattr(lowrank, "svd",
                        lambda g: calls.append(1) or real(g))
    n_leaves = sum(len(b.indices) for b in opt.engine.plan(tp).buckets
                   if b.rule.host_step)
    reads, svds = [], []
    for k in range(STEPS):
        g = _grads(flat, k)
        before = (_CountingStep.reads, len(calls))
        tp, ts = opt.update(unflatten(list(g), [to_torch(v)
                                               for v in g.values()]),
                            ts, tp)
        assert type(ts["step"]) is _CountingStep
        reads.append(_CountingStep.reads - before[0])
        svds.append(len(calls) - before[1])
    assert reads == [1, 0, 0, 0, 0]
    assert svds == [n_leaves, 0, n_leaves, 0, n_leaves] and n_leaves == 7


def _refresh_steps(monkeypatch):
    """The host steps at which RSO draws a projector, in order."""
    seen = []
    real = lowrank.draw_normal

    def logged(shape, seed, leaf_id, epoch, device):
        seen.append(epoch)
        return real(shape, seed, leaf_id, epoch, device)
    monkeypatch.setattr(lowrank, "draw_normal", logged)
    return seen


@pytest.mark.parametrize("how", ["checkpoint", "transcode"])
def test_resumed_state_refreshes_at_the_straight_steps(how, monkeypatch,
                                                       tmp_path):
    """A state that arrives through a checkpoint load or a transcode (a
    step tensor the engine did not make) refreshes at the steps of an
    uninterrupted run: RSO draws at epochs 0, 1, 2 (steps 0, 2, 4) either
    way, and the continued run equals the straight one bitwise (f32) or
    its transcoded counterpart."""
    flat = _smoke_params()
    seen = _refresh_steps(monkeypatch)
    opt = optim.make("rso", lr=0.01, **LOWRANK_KW)
    straight = _run_port(opt, flat)
    n_leaves = len(seen) // 3
    assert seen == [0] * n_leaves + [1] * n_leaves + [2] * n_leaves
    seen.clear()
    opt = optim.make("rso", lr=0.01, **LOWRANK_KW)
    tp, ts = _run_port(opt, flat, steps=3)
    if how == "checkpoint":
        mgr = CheckpointManager(str(tmp_path))
        mgr.save(3, {"params": tp, "opt": ts}, blocking=True)
        like = {"params": tp, "opt": opt.init(tp)}
        state, start = mgr.restore(None, like, device="cpu")
        tp, ts = state["params"], state["opt"]
        cont = opt
    else:
        cont = optim.make("rso", lr=0.01, state_codec="int8", **LOWRANK_KW)
        ts = engine.transcode(ts, tp, opt, cont)
        start = 3
    assert start == 3
    tp, ts = _run_port(cont, flat, steps=2, start=3, tp=tp, ts=ts)
    assert seen == [0] * n_leaves + [1] * n_leaves + [2] * n_leaves
    if how == "checkpoint":
        for (path, a), b in zip(zip(*flatten_with_paths(straight[0])),
                                flatten_with_paths(tp)[1]):
            assert torch.equal(a, b), path


# ---------------------------------------------------------------------------
# State bytes and the launcher


@pytest.mark.parametrize("codec_name", ["f32", "int8"])
@pytest.mark.parametrize("name", FAMILIES)
def test_full_width_state_bytes_match_reference(name, codec_name):
    """llama-60m at full width on the meta device: the exact state bytes
    equal the JAX package's ``engine.state_bytes`` (the launcher's
    ``rank_frac=0.25``)."""
    from repro.models import lm as jlm
    from repro.optim import engine as jengine
    from repro_torch import configs
    from repro_torch.models import lm
    kw = {"rank_frac": 0.25, "state_codec": codec_name}
    want = jengine.state_bytes(joptim.make(name, lr=0.01, **kw),
                               jlm.abstract_params(
                                   jconfigs.get_config("llama-60m")))
    got = engine.state_bytes(optim.make(name, lr=0.01, **kw).init(
        lm.abstract_params(configs.get_config("llama-60m"))))
    assert got == want


SMOKE = ["--arch", "llama-60m", "--smoke", "--batch", "4", "--seq", "16",
         "--log-every", "2", "--device", "cpu"]


@pytest.mark.parametrize("name", FAMILIES)
def test_launcher_trains_each_family(name):
    res = train.main(SMOKE + ["--optimizer", name, "--steps", "2"])
    assert len(res.losses) == 2 and np.all(np.isfinite(res.losses))
    buckets = res.opt_state["buckets"]
    lowrank_buckets = [b for b in buckets if b.startswith(name + "__")]
    assert lowrank_buckets, sorted(buckets)
    st = buckets[lowrank_buckets[0]]
    assert "proj" in st and st["proj"].dtype == torch.float32
    # rank 1/4 of the smaller side: (2, 32, 32) -> r = 8
    assert buckets[f"{name}__layers.b0.mixer.wk"]["proj"].shape[-1] == 8


def _equal_trees(a, b, what):
    fa, fb = (dict(zip(*flatten_with_paths(t))) for t in (a, b))
    assert sorted(fa) == sorted(fb), what
    for path in fa:
        assert fa[path].dtype == fb[path].dtype, (what, path)
        assert torch.equal(fa[path], fb[path]), (what, path)


def test_launcher_galore_int8_resumes_and_transcodes(tmp_path):
    """``--optimizer galore --state-codec int8``: 6 straight steps equal 3
    steps + checkpoint + a resumed run of 3, bitwise (the refresh at step
    4 comes after the resume; the projectors are exact slots).  The same
    checkpoint resumed under ``--state-codec f32`` is transcoded and
    trains on."""
    import shutil
    args = SMOKE + ["--optimizer", "galore", "--state-codec", "int8",
                    "--steps", "6"]
    straight = train.main(args)
    ck = ["--ckpt-dir", str(tmp_path), "--ckpt-every", "3"]
    first = train.main(args + ck)
    assert first.losses == straight.losses
    shutil.rmtree(tmp_path / "step_000000006")
    resumed = train.main(args + ck + ["--resume"])
    assert resumed.start_step == 3 and resumed.losses == straight.losses[3:]
    _equal_trees(resumed.params, straight.params, "params")
    _equal_trees(resumed.opt_state, straight.opt_state, "state")
    shutil.rmtree(tmp_path / "step_000000006")
    f32 = ["--state-codec", "f32"]
    moved = train.main(SMOKE + ["--optimizer", "galore", "--steps", "6"]
                       + f32 + ck + ["--resume"])
    assert moved.start_step == 3 and np.all(np.isfinite(moved.losses))
    st = moved.opt_state["buckets"]["galore__layers.b0.mixer.wk"]
    assert st["host"]["m"].dtype == torch.float32


# ---------------------------------------------------------------------------
# A checkpoint written by the JAX package


def test_jax_galore_checkpoint_resumes_in_the_port(tmp_path,
                                                   jax_projectors):
    """A ``galore`` state the JAX package checkpointed after 2 steps loads
    in the port; 3 more steps on each side (refreshes at 2 and 4, the
    JAX package's SVD injected) agree within the family test's
    tolerances."""
    flat = _smoke_params()
    jopt = joptim.make("galore", lr=0.01, **LOWRANK_KW)
    jp, js = _run_jax(jopt, flat, steps=2)
    jmanager.CheckpointManager(str(tmp_path)).save(
        2, {"params": jp, "opt": js}, blocking=True)
    topt = optim.make("galore", lr=0.01, **LOWRANK_KW)
    tp0 = unflatten(list(flat), [to_torch(v) for v in flat.values()])
    state, start = CheckpointManager(str(tmp_path)).restore(
        None, {"params": tp0, "opt": topt.init(tp0)}, device="cpu")
    assert start == 2
    tp, ts = _run_port(topt, flat, steps=3, start=2, tp=state["params"],
                       ts=state["opt"])
    jp, js = _run_jax(jopt, flat, steps=3, start=2, jp=jp, js=js)
    _assert_state(ts, js)
    _assert_params(tp, jp, flat)


def test_jax_apollo_checkpoint_resumes_in_the_port(tmp_path):
    """An ``apollo`` state the JAX package checkpointed after 3 steps
    loads in the port; 2 more steps on each side, across the refresh at
    step 4, where the port draws its own projector (``core.prng``), agree
    within the family test's tolerances."""
    flat = _smoke_params()
    jopt = joptim.make("apollo", lr=0.01, **LOWRANK_KW)
    jp, js = _run_jax(jopt, flat, steps=3)
    jmanager.CheckpointManager(str(tmp_path)).save(
        3, {"params": jp, "opt": js}, blocking=True)
    topt = optim.make("apollo", lr=0.01, **LOWRANK_KW)
    tp0 = unflatten(list(flat), [to_torch(v) for v in flat.values()])
    state, start = CheckpointManager(str(tmp_path)).restore(
        None, {"params": tp0, "opt": topt.init(tp0)}, device="cpu")
    assert start == 3
    tp, ts = _run_port(topt, flat, steps=2, start=3, tp=state["params"],
                       ts=state["opt"])
    jp, js = _run_jax(jopt, flat, steps=2, start=3, jp=jp, js=js)
    _assert_state(ts, js)
    _assert_params(tp, jp, flat)


@pytest.mark.parametrize("codec_name", ["f32", "int8"])
@pytest.mark.parametrize("name", FAMILIES)
def test_port_checkpoint_loads_in_the_jax_package(name, codec_name,
                                                  tmp_path):
    """Each family's state after 3 port steps (refreshes at 0 and 2),
    saved by the port, restores in the JAX package's manager into its own
    ``init`` layout: the same paths, shapes, dtype names and bytes."""
    flat = _smoke_params()
    kw = dict(LOWRANK_KW, state_codec=codec_name)
    tp, ts = _run_port(optim.make(name, lr=0.01, **kw), flat, steps=3)
    CheckpointManager(str(tmp_path)).save(3, {"params": tp, "opt": ts},
                                          blocking=True)
    jp0 = unflatten(list(flat), [jnp.asarray(v) for v in flat.values()])
    like = {"params": jp0, "opt": joptim.make(name, lr=0.01, **kw).init(jp0)}
    got, step = jmanager.CheckpointManager(str(tmp_path)).restore(None, like)
    assert step == 3
    want = dict(zip(*flatten_with_paths({"params": tp, "opt": ts})))
    paths, leaves, _ = jflatten(got)
    assert sorted(paths) == sorted(want)
    for path, leaf in zip(paths, leaves):
        ours = want[path]
        assert np.asarray(leaf).dtype.name == engine.dtype_name(ours.dtype)
        np.testing.assert_array_equal(to_numpy(leaf), to_numpy(ours))
