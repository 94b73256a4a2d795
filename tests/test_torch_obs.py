"""The port's observability slice (DESIGN.md §12) against the JAX package:
the engine's ``tapped_update`` with GWT's band-energy and limiter taps and
the int8 codec's taps, ``make_train_step(taps=True)``, ``TrainLoop``'s
boundary-sampled taps, spans and ``train_step`` records, and the
launcher's ``--metrics-dir``.

Tolerances.  The same numpy parameters and gradients go through both
packages (the JAX optimizer jitted with ``impl="jnp"``).  The gradient's
taps (``grad_ssq``, ``band_a_ssq``) are sums of the same f32 squares, which
the port takes block by block over row blocks (each block's sum as the
square of its f32 2-norm: two more f32 roundings) and adds in order, and
the reference in one ``jnp.sum``; they agree to ``SSQ_RTOL`` = 1e-5
relative (measured 7.4e-7);
``band_d_ssq`` is the difference ``grad_ssq - band_a_ssq`` and is held to
``SSQ_RTOL`` of ``grad_ssq``, not of itself.  The update's taps
(``update_ssq``, ``gnorm_ssq``) also carry the two packages' different
updates (the kernels' plain version against JAX's op-by-op core, a few f32
spacings of each element): ``UPDATE_RTOL`` = 2e-4 (measured 3.8e-5), and
the port's own sums are held to an f64 sum of its own outputs within
``SSQ_RTOL``.  ``clip_count``, ``clip_rate`` and ``q8_sat_rate`` are
exact; ``q8_absmax`` is bitwise to the JAX package's ``_codec_taps`` on the
same encoded state.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import to_torch

from repro import obs as jobs, optim as joptim
from repro.launch import train as jtrain
from repro.optim.engine import _codec_taps as j_codec_taps
from repro.runtime.fault_tolerance import TrainLoop as JTrainLoop
from repro_torch import configs, obs, optim
from repro_torch.core import haar, limiter
from repro_torch.data.pipeline import make_source
from repro_torch.launch import train
from repro_torch.models import lm
from repro_torch.obs import trace as obs_trace
from repro_torch.obs.sink import MemorySink
from repro_torch.optim import engine
from repro_torch.optim.base import flatten_with_paths, unflatten
from repro_torch.runtime.fault_tolerance import TrainLoop

SSQ_RTOL = 1e-5
UPDATE_RTOL = 2e-4
SPANS = {"prefetch", "dispatch", "block", "eval", "save"}

# (optimizer, kwargs): fused (K1/K2's plain versions), staged (K4's), the
# adam_mini host (the op-by-op core) and a plain family
CASES = [("gwt", {}), ("gwt", {"fused_write": False}),
         ("gwt", {"host": "adam_mini"}), ("adam", {})]
IDS = ["gwt-fused", "gwt-staged", "gwt-adam_mini", "adam"]


@pytest.fixture(autouse=True)
def _reset_telemetry():
    yield
    obs.shutdown()
    jobs.shutdown()


def _layered():
    """Two layers of GWT leaves (a FIRST-mode (32, 18) among them), an
    embedding and a norm."""
    rng = np.random.RandomState(0)
    p = {"embed": rng.randn(10, 16), "norm": np.ones(16)}
    for i in range(2):
        p[f"layer_{i}/attn/wq"] = rng.randn(16, 16) * 0.1
        p[f"layer_{i}/mlp/w1"] = rng.randn(16, 32) * 0.1
        p[f"layer_{i}/mlp/w3"] = rng.randn(32, 18) * 0.1
    return {k: v.astype(np.float32) for k, v in p.items()}


def _grads(flat, k):
    rng = np.random.RandomState(50 + k)
    return {p: (rng.randn(*v.shape) * 0.1 * (1 + k)).astype(np.float32)
            for p, v in flat.items()}


def _tree(flat, conv):
    return unflatten(list(flat), [conv(v) for v in flat.values()])


def _leaves(tree):
    return dict(zip(*flatten_with_paths(tree)))


def _jax_opt(name, kw, codec):
    extra = {"impl": "jnp"} if name == "gwt" else {}
    return joptim.make(name, lr=0.01, state_codec=codec, **kw, **extra)


@pytest.mark.parametrize("codec", ["f32", "int8"])
@pytest.mark.parametrize("name,kw", CASES, ids=IDS)
def test_tapped_update_equals_update_bitwise(name, kw, codec):
    """Taps only read: three steps of ``tapped_update`` leave the
    parameters and the state bitwise where ``update`` leaves them."""
    flat = _layered()
    opt = optim.make(name, lr=0.01, state_codec=codec, **kw)
    pa, pb = _tree(flat, to_torch), _tree(flat, to_torch)
    sa, sb = opt.init(pa), opt.init(pb)
    for k in range(3):
        g = _tree(_grads(flat, k), to_torch)
        pa, sa = opt.update(g, sa, pa)
        pb, sb, taps = opt.tapped_update(g, sb, pb)
        assert taps
    for want, got in ((_leaves(pa), _leaves(pb)), (_leaves(sa),
                                                    _leaves(sb))):
        assert sorted(want) == sorted(got)
        for path, t in want.items():
            assert t.dtype == got[path].dtype and torch.equal(t, got[path]), \
                path


@pytest.mark.parametrize("codec", ["f32", "int8"])
@pytest.mark.parametrize("name,kw", CASES, ids=IDS)
def test_taps_match_reference(name, kw, codec):
    """Three steps in each package from the same inputs: the tap names
    equal the JAX package's letter for letter, the values within the
    module's tolerances (exact where they count)."""
    flat = _layered()
    jo, to = _jax_opt(name, kw, codec), optim.make(name, lr=0.01,
                                                   state_codec=codec, **kw)
    jp, tp = _tree(flat, jnp.asarray), _tree(flat, to_torch)
    js, ts = jo.init(jp), to.init(tp)
    upd = jax.jit(jo.tapped_update)
    for k in range(3):
        g = _grads(flat, k)
        old_p = {p: t.clone() for p, t in _leaves(tp).items()}
        jp, js, jt = upd(_tree(g, jnp.asarray), js, jp)
        tp, ts, tt = to.tapped_update(_tree(g, to_torch), ts, tp)
        assert list(sorted(tt)) == list(sorted(jt))
        for key, want in jt.items():
            want, got = float(np.asarray(want)), tt[key]
            assert got.dtype == torch.float32 and got.ndim == 0, key
            bucket, tap = key.rsplit("/", 1)
            got = float(got)
            if tap in ("clip_count", "clip_rate", "q8_sat_rate"):
                assert got == want, (key, got, want)
            elif tap == "band_d_ssq":
                scale = float(np.asarray(jt[f"{bucket}/grad_ssq"]))
                assert abs(got - want) <= SSQ_RTOL * scale, key
            elif tap in ("update_ssq", "gnorm_ssq"):
                assert abs(got - want) <= UPDATE_RTOL * abs(want), key
            elif tap != "q8_absmax":
                assert abs(got - want) <= SSQ_RTOL * abs(want), key
        _check_own_sums(to, tt, tp, ts, old_p, g)


def _check_own_sums(opt, taps, params, state, old_p, g):
    """The port's generic and limiter taps against f64 sums of its own
    inputs and outputs; its codec taps bitwise to the JAX package's
    ``_codec_taps`` on the same encoded state."""
    new_p = _leaves(params)
    for b in opt.engine.plan(params).buckets:
        sq = lambda xs: sum(float(np.sum(np.float64(x) ** 2))  # noqa: E731
                            for x in xs)
        want = {"grad_ssq": sq(g[p] for p in b.paths),
                "update_ssq": sq(new_p[p].numpy() - old_p[p].numpy()
                                 for p in b.paths)}
        st = state["buckets"][b.name]
        if "prev_norm" in st:
            want["gnorm_ssq"] = sq([st["prev_norm"].numpy()])
        for tap, w in want.items():
            got = float(taps[f"{b.name}/{tap}"])
            assert abs(got - w) <= SSQ_RTOL * w, (b.name, tap, got, w)
        if f"{b.name}/q8_sat_rate" in taps:
            ref = j_codec_taps(jax.tree.map(
                lambda t: jnp.asarray(t.numpy()), st))
            for tap in ("q8_sat_rate", "q8_absmax"):
                assert taps[f"{b.name}/{tap}"].numpy().tobytes() \
                    == np.asarray(ref[tap]).tobytes(), (b.name, tap)


def test_parseval_and_band_energy():
    """``band_a + band_d = grad_ssq`` (within 1e-5), and ``band_a_ssq`` is
    the energy of the full forward transform's ``A_l`` (FIRST-mode buckets
    transposed)."""
    flat = _layered()
    opt = optim.make("gwt", lr=0.01)
    tp = _tree(flat, to_torch)
    g = _grads(flat, 0)
    _, _, taps = opt.tapped_update(_tree(g, to_torch), opt.init(tp), tp)
    gwt_buckets = [b for b in opt.engine.plan(tp).buckets
                   if b.name.startswith("gwt_")]
    assert {b.name.split("__")[0] for b in gwt_buckets} == {"gwt_last",
                                                            "gwt_first"}
    for b in gwt_buckets:
        band_a = taps[f"{b.name}/band_a_ssq"]
        grad = taps[f"{b.name}/grad_ssq"]
        assert abs(float(band_a + taps[f"{b.name}/band_d_ssq"])
                   - float(grad)) <= 1e-5 * float(grad)
        a = [haar.haar_forward(torch.from_numpy(
            g[p].T if b.name.startswith("gwt_first") else g[p]).double(),
            2)[0] for p in b.paths]
        want = sum(float((x * x).sum()) for x in a)
        assert abs(float(band_a) - want) <= SSQ_RTOL * want


def test_clip_taps_track_forced_limiter_scenarios():
    """The reference's scenario: no clip on the first step (no history),
    none when the update norm collapses, every leaf when it jumps back."""
    rng = np.random.RandomState(3)
    flat = {n: rng.randn(8, 16).astype(np.float32) for n in ("w1", "w2")}
    dense = {n: rng.randn(8, 16).astype(np.float32) for n in flat}
    sparse = {n: np.zeros((8, 16), np.float32) for n in flat}
    for v in sparse.values():
        v[0, 0] = 1.0
    opt = optim.make("gwt", lr=1e-2, level=2)
    tp = _tree(flat, to_torch)
    st = opt.init(tp)
    rates, counts = [], []
    for g in (dense, sparse, dense):
        tp, st, taps = opt.tapped_update(_tree(g, to_torch), st, tp)
        (bname,) = {k.split("/")[0] for k in taps}
        rates.append(float(taps[f"{bname}/clip_rate"]))
        counts.append(float(taps[f"{bname}/clip_count"]))
    assert rates == [0.0, 0.0, 1.0]
    assert counts == [0.0, 0.0, 2.0]
    assert limiter.clip_flags(torch.tensor([0.0, 1.0, 1.0, 1.0]),
                              torch.tensor([5.0, 1.0, 1.01, 2.0]),
                              1.01).tolist() == [False, False, True, True]


@pytest.mark.parametrize("name,kw", [("adam", {}), ("gwt", {})],
                         ids=["adam", "gwt"])
def test_unbucketed_engine_has_no_tap_channel(name, kw):
    assert optim.make(name, lr=1e-2, bucketed=False, **kw).tapped_update \
        is None
    assert joptim.make(name, lr=1e-2, bucketed=False).tapped_update is None
    assert optim.make(name, lr=1e-2, **kw).tapped_update is not None


def test_row_blocks_and_small_cap(monkeypatch):
    """The sums over row blocks: blocks cover the tensors in order and stay
    under the cap (a contiguous tensor across its merged rows, a transposed
    one matrix by matrix, paired tensors block for block); with the cap
    set to 8 elements every tap equals the one-block taps (the f32 block
    sums add in another order: within 1e-6), and the update is still
    bitwise."""
    x = torch.arange(3 * 5 * 16, dtype=torch.float32).reshape(3, 5, 16)
    monkeypatch.setattr(engine, "TAP_BLOCK", 32)
    for t in (x, x.transpose(-1, -2)):
        blocks = [b for (b,) in engine.row_blocks(t)]
        assert all(b.numel() <= 32 for b in blocks)
        assert torch.equal(torch.cat([b.reshape(-1) for b in blocks]),
                           t.reshape(-1))
    assert len(list(engine.row_blocks(x))) == 8        # 15 rows, 2 a block
    pairs = list(engine.row_blocks(x.transpose(-1, -2), x.transpose(-1, -2)
                                   .contiguous()))
    assert all(a.shape == b.shape and torch.equal(a, b) for a, b in pairs)
    assert len(list(engine.row_blocks(torch.ones(7)))) == 1
    assert abs(float(engine.tap_ssq(x, x - 1.0)) - x.numel()) \
        <= 1e-6 * x.numel()

    flat = _layered()
    results = []
    for cap in (1 << 26, 8):
        monkeypatch.setattr(engine, "TAP_BLOCK", cap)
        opt = optim.make("gwt", lr=0.01, state_codec="int8")
        tp = _tree(flat, to_torch)
        st = opt.init(tp)
        for k in range(2):
            tp, st, taps = opt.tapped_update(_tree(_grads(flat, k),
                                                   to_torch), st, tp)
        results.append((_leaves(tp), taps))
    (p_big, t_big), (p_small, t_small) = results
    assert all(torch.equal(p_big[k], p_small[k]) for k in p_big)
    assert sorted(t_big) == sorted(t_small)
    for key, want in t_big.items():
        scale = float(t_big[key.rsplit("/", 1)[0] + "/grad_ssq"]) \
            if key.endswith("band_d_ssq") else abs(float(want))
        assert abs(float(t_small[key]) - float(want)) <= 1e-6 * scale, key


def test_codec_taps_rails_bitwise():
    """``q8_sat_rate`` counts codes at ±127 and -128, ``q8_absmax`` is the
    largest scale times 127: bitwise to the JAX package's on one state."""
    rng = np.random.RandomState(7)
    q = rng.randint(-128, 128, size=(3, 4, 64)).astype(np.int8)
    q[0, 0, :5] = [127, -127, -128, 126, -126]
    state = {"host": {"m": {"q": q, "scale": rng.rand(3, 4).astype(
        np.float32)}, "v": {"q": q[::-1].copy(), "scale": rng.rand(
            3, 4).astype(np.float32)}}, "prev_norm": np.ones(3, np.float32)}
    got = engine._codec_taps(jax.tree.map(to_torch, state))
    want = j_codec_taps(jax.tree.map(jnp.asarray, state))
    assert sorted(got) == sorted(want) == ["q8_absmax", "q8_sat_rate"]
    for k in got:
        assert got[k].numpy().tobytes() == np.asarray(want[k]).tobytes(), k
    assert engine._codec_taps({"m": torch.zeros(3)}) == {}


def test_train_step_taps_and_refusals():
    cfg = configs.get_smoke("llama-60m")
    opt = optim.make("gwt", lr=0.01)
    with pytest.raises(ValueError, match="dp_reduce"):
        lm.make_train_step(cfg, opt, dp_reduce="exact", taps=True)
    plain = optim.make("adam", lr=0.01, bucketed=False)
    model = lm.init(cfg, torch.Generator().manual_seed(0), "cpu")
    params = model.tree()
    batch = {"tokens": torch.randint(0, cfg.vocab, (2, 16)),
             "labels": torch.randint(0, cfg.vocab, (2, 16))}
    _, _, m = lm.make_train_step(cfg, plain, taps=True)(
        params, plain.init(params), batch)
    assert set(m) == {"loss"}
    _, _, m = lm.make_train_step(cfg, opt, taps=True)(
        params, opt.init(params), batch)
    assert set(m) == {"loss", "taps"} and m["taps"]


# ---------------------------------------------------------------------------
# TrainLoop: boundary-sampled taps, records, spans, metrics-off invariance
# ---------------------------------------------------------------------------

class _CountSource:
    """batch(step) == step, as the reference's toy source."""

    def batch(self, step):
        return {"x": np.full((2,), step, np.float32)}


def _toy_steps():
    def step(p, s, batch):
        p = {"n": p["n"] + 1.0}
        return p, s, {"loss": torch.sum(batch["x"]) + 0.0 * p["n"]}

    def tap_step(p, s, batch):
        p, s, m = step(p, s, batch)
        return p, s, {"loss": m["loss"], "taps": {"toy/n": p["n"]}}
    return step, tap_step


def _jax_toy_records():
    def step(p, s, batch):
        p = {"n": p["n"] + 1.0}
        return p, s, {"loss": jnp.sum(batch["x"]) + 0.0 * p["n"]}

    def tap_step(p, s, batch):
        p, s, m = step(p, s, batch)
        return p, s, {"loss": m["loss"], "taps": {"toy/n": p["n"]}}
    sink = MemorySink()
    jobs.configure(sink=sink)
    JTrainLoop(step, None, _CountSource(), log_every=4, log=lambda s: None,
               tap_step=tap_step).run({"n": jnp.float32(0)}, {},
                                      num_steps=12)
    jobs.shutdown()
    return [{k: v for k, v in r.items() if k != "kind"}
            for r in sink.records if r["kind"] == "train_step"]


def test_trainloop_taps_on_chunk_boundaries_like_reference():
    sink = MemorySink()
    tracer = obs_trace.Tracer()
    obs.configure(sink=sink, tracer=tracer)
    step, tap_step = _toy_steps()
    loop = TrainLoop(step, _CountSource(), device="cpu", log_every=4,
                     log=lambda s: None, tap_step=tap_step)
    _, _, losses = loop.run({"n": torch.tensor(0.0)}, {}, num_steps=12)
    assert len(losses) == 12
    recs = [{k: v for k, v in r.items() if k != "kind"}
            for r in sink.records if r["kind"] == "train_step"]
    assert [r["step"] for r in recs] == list(range(1, 13))
    tapped = [r for r in recs if "toy/n" in r]
    assert [r["step"] for r in tapped] == [4, 8, 12]
    assert [r["toy/n"] for r in tapped] == [4.0, 8.0, 12.0]
    assert recs == _jax_toy_records()
    spans = [(e["name"], e["args"]) for e in tracer.events]
    assert ("dispatch", {"step": 4, "steps": 4}) in spans
    assert ("block", {"steps": 4}) in spans
    assert ("prefetch", {"steps": 4}) in spans


def test_trainloop_sink_and_taps_change_nothing():
    """The smoke model, GWT-2 int8, 8 steps: with a sink, a tracer and the
    tapped step the losses and parameters are bitwise those of the run
    with neither; without a sink no record is made."""
    cfg = configs.get_smoke("llama-60m")
    src = make_source("synthetic", cfg.vocab, 16, 2, seed=0)

    def run(observe):
        params = lm.init(cfg, torch.Generator().manual_seed(0),
                         "cpu").tree()
        opt = optim.make("gwt", lr=0.01, state_codec="int8")
        sink = MemorySink()
        if observe:
            obs.configure(sink=sink, tracer=obs_trace.Tracer())
        loop = TrainLoop(lm.make_train_step(cfg, opt), src, device="cpu",
                         log_every=4, log=lambda s: None,
                         tap_step=lm.make_train_step(cfg, opt, taps=True)
                         if observe else None)
        params, _, losses = loop.run(params, opt.init(params), num_steps=8)
        obs.shutdown()
        return params, losses, sink.records

    p0, l0, r0 = run(False)
    p1, l1, r1 = run(True)
    assert l0 == l1 and r0 == []
    for (path, a), b in zip(_leaves(p0).items(), _leaves(p1).values()):
        assert torch.equal(a, b), path
    tapped = [r["step"] for r in r1 if r["kind"] == "train_step"
              and any("/q8_sat_rate" in k for k in r)]
    assert tapped == [4, 8]


# ---------------------------------------------------------------------------
# The launcher's --metrics-dir against the JAX launcher's
# ---------------------------------------------------------------------------

def _records(path):
    with open(path) as f:
        recs = [json.loads(line) for line in f]
    # the watchdog's incidents depend on the host's timing
    return [r for r in recs if r["kind"] != "watchdog_incident"]


def _shape(recs):
    """Record kinds in order of first appearance, and each kind's keys."""
    kinds, keys = [], {}
    for r in recs:
        if r["kind"] not in keys:
            kinds.append(r["kind"])
        keys.setdefault(r["kind"], set()).update(r)
    return kinds, keys


@pytest.mark.parametrize("flags", [["--dp-reduce", "exact"],
                                   ["--dp-reduce", "compressed"],
                                   ["--finetune", "lora"]],
                         ids=["exact", "compressed", "lora"])
def test_launcher_builds_no_tapped_step(tmp_path, flags):
    """``--metrics-dir`` with the user's ``--dp-reduce`` or with
    ``--finetune lora`` builds no tapped step, as the JAX launcher
    (``src/repro/launch/train.py``): the step records carry the loss and
    no tap.  Without either, on any mesh, the records carry taps
    (``test_torch_tp_ranks.py``, ``test_torch_shard_ranks.py``)."""
    train.main(["--smoke", "--steps", "2", "--batch", "2", "--seq", "16",
                "--log-every", "1", "--device", "cpu", "--metrics-dir",
                str(tmp_path), *flags])
    steps = [r for r in _records(tmp_path / "metrics.jsonl")
             if r["kind"] == "train_step"]
    assert [r["step"] for r in steps] == [1, 2]
    assert not any("/" in k for r in steps for k in r)


def test_launcher_metrics_dir_matches_reference(tmp_path):
    argv = ["--smoke", "--steps", "4", "--batch", "2", "--seq", "16",
            "--log-every", "2", "--state-codec", "int8", "--eval-every",
            "2", "--eval-batches", "1", "--ckpt-every", "2"]
    jtrain.main(argv + ["--metrics-dir", str(tmp_path / "jm"),
                        "--ckpt-dir", str(tmp_path / "jc")])
    res = train.main(argv + ["--device", "cpu", "--metrics-dir",
                             str(tmp_path / "tm"), "--ckpt-dir",
                             str(tmp_path / "tc")])
    want, got = (_records(tmp_path / d / "metrics.jsonl")
                 for d in ("jm", "tm"))
    assert _shape(got) == _shape(want)
    steps = [r for r in got if r["kind"] == "train_step"]
    assert [r["loss"] for r in steps] == res.losses
    assert [r["step"] for r in steps if len(r) > 5] == [2, 4]
    assert got[0]["run"] == want[0]["run"]
    with open(tmp_path / "tm" / "trace.json") as f:
        doc = json.load(f)
    obs_trace.validate(doc)
    assert SPANS <= {e["name"] for e in doc["traceEvents"]}
    # without --metrics-dir: no files, the same losses, bitwise
    plain = train.main(argv + ["--device", "cpu", "--ckpt-dir",
                               str(tmp_path / "tc2")])
    assert plain.losses == res.losses
    for (path, a), b in zip(_leaves(res.params).items(),
                            _leaves(plain.params).values()):
        assert torch.equal(a, b), path
