"""The port's loop around the data: the evaluator, eval and prefetch in
``TrainLoop``, the step watchdog and the telemetry it reports through,
held against the JAX package on llama-60m-smoke (f32) over the BPE-512
fixture corpus.

Tolerances, those of ``test_torch_lm.py``: an eval batch's loss is held to
4 f32 spacings (ATen and XLA sum the matmuls in other orders), and over 6
training steps the train and eval losses stay within 2e-5 of the JAX
loop's.  Inside the port no tolerance: eval and the worker count change
nothing, bitwise.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from torch_parity import port_model, spacings

from repro import configs as jconfigs
from repro.core.gwt import gwt as jax_gwt
from repro.data import pipeline as jpipe
from repro.data.eval import make_lm_evaluator as jax_make_evaluator
from repro.models import lm as jlm
from repro.optim.schedules import warmup_cosine as jax_warmup_cosine
from repro.runtime.fault_tolerance import TrainLoop as JaxTrainLoop
from repro_torch import configs, obs
from repro_torch.core.gwt import gwt
from repro_torch.data import build_corpus
from repro_torch.data.eval import Evaluator, make_lm_evaluator
from repro_torch.data.pipeline import CorpusLM
from repro_torch.launch import train
from repro_torch.models import lm
from repro_torch.obs import trace as obs_trace
from repro_torch.obs.sink import JsonlSink, MemorySink, NullSink
from repro_torch.optim.base import flatten_with_paths
from repro_torch.optim.schedules import warmup_cosine
from repro_torch.runtime.fault_tolerance import StepWatchdog, TrainLoop

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE_GLOB = os.path.join(REPO, "tests", "fixtures", "corpus", "*.txt")
JCFG = jconfigs.get_smoke("llama-60m").with_(vocab=512)
TCFG = configs.get_smoke("llama-60m").with_(vocab=512)
SEQ, BATCH = 32, 4


@pytest.fixture(scope="module")
def corpus_dir(tmp_path_factory):
    """The BPE-512 fixture corpus, built by the port (byte for byte the
    reference's build, ``test_torch_data.py``)."""
    out = tmp_path_factory.mktemp("corpus")
    build_corpus.build(FIXTURE_GLOB, str(out), tokenizer_kind="bpe",
                       vocab_size=512)
    return str(out)


@pytest.fixture(autouse=True)
def _reset_global_telemetry():
    """Tests install process-global sinks; always restore the null one."""
    yield
    obs.shutdown()


# ---------------------------------------------------------------------------
# Evaluator
# ---------------------------------------------------------------------------

def test_evaluator_matches_reference(corpus_dir, capsys):
    """Same exported parameters, same eval windows: each batch's loss
    within 4 f32 spacings of the JAX loss, the mean likewise, the same
    cap to the unique held-out windows (9 windows of 4 rows: 2 batches of
    the 8 asked for), and the parameters untouched."""
    jp, model = port_model(JCFG, TCFG, seed=0)
    tree = model.tree()
    before = {p: t.detach().clone() for p, t in
              zip(*flatten_with_paths(tree))}
    src = CorpusLM(corpus_dir, SEQ, BATCH, split="eval")
    ev = make_lm_evaluator(TCFG, lm, src, n_batches=8)
    port_said = capsys.readouterr().out
    jev = jax_make_evaluator(JCFG, jlm, jpipe.CorpusLM(
        corpus_dir, SEQ, BATCH, split="eval"), n_batches=8)
    assert port_said == capsys.readouterr().out
    assert "capping eval batches 8 -> 2" in port_said
    assert ev.n_batches == jev.n_batches == 2

    got, want = ev(tree, step=5), jev(jp, step=5)
    with torch.no_grad():
        for i in range(ev.n_batches):
            b = src.batch(i)
            tl = lm.loss_fn(TCFG, tree, {k: torch.from_numpy(v)
                                         for k, v in b.items()})
            assert spacings(tl, jlm.loss_fn(JCFG, jp, b)) <= 4, i
    assert abs(got["loss"] - want["loss"]) \
        <= 4 * np.spacing(np.float32(want["loss"]))
    assert got["n_batches"] == 2
    assert got["ppl"] == np.exp(min(got["loss"], 30.0))
    assert ev.history == [(5, got["loss"])]
    for path, t in zip(*flatten_with_paths(tree)):
        assert torch.equal(t, before[path]), path
        assert t.grad is None, path


def test_evaluator_rules():
    """The reference's rules: n_batches >= 1, the perplexity's overflow
    guard at a loss of 30, no history without a step."""
    with pytest.raises(ValueError, match="n_batches"):
        Evaluator(lambda p, b: None, None, n_batches=0)

    class Const:
        def batch(self, i):
            return {"x": np.zeros((1,), np.float32)}

    ev = Evaluator(lambda p, b: 40.0 + b["x"].sum(), Const(), n_batches=3)
    r = ev(None)
    assert r == {"loss": 40.0, "ppl": float(np.exp(30.0)), "n_batches": 3}
    assert ev.history == []


# ---------------------------------------------------------------------------
# TrainLoop with eval and prefetch
# ---------------------------------------------------------------------------

def _port_loop(corpus_dir, steps, *, evaluate, workers=0):
    _, model = port_model(JCFG, TCFG, seed=0)
    tree = model.tree()
    opt = gwt(lr=warmup_cosine(0.01, steps))
    ev = make_lm_evaluator(TCFG, lm, CorpusLM(corpus_dir, SEQ, BATCH,
                                              split="eval"),
                           n_batches=2) if evaluate else None
    logged = []
    loop = TrainLoop(lm.make_train_step(TCFG, opt),
                     CorpusLM(corpus_dir, SEQ, BATCH, seed=0), device="cpu",
                     log_every=3, log=logged.append, num_workers=workers,
                     evaluator=ev, eval_every=2 if evaluate else 0)
    params, state, losses = loop.run(tree, opt.init(tree), num_steps=steps)
    return params, state, losses, ev, loop, logged


def test_train_loop_with_eval_tracks_reference(corpus_dir):
    """6 steps with eval every 2 against the JAX loop: eval at the same
    steps, chunks ending at the same steps, train and eval losses within
    2e-5."""
    steps = 6
    jp, _ = port_model(JCFG, TCFG, seed=0)
    jopt = jax_gwt(lr=jax_warmup_cosine(0.01, steps), impl="jnp")
    jev = jax_make_evaluator(JCFG, jlm, jpipe.CorpusLM(
        corpus_dir, SEQ, BATCH, split="eval"), n_batches=2)
    jloop = JaxTrainLoop(jlm.make_train_step(JCFG, jopt), None,
                         jpipe.CorpusLM(corpus_dir, SEQ, BATCH, seed=0),
                         log_every=3, log=lambda s: None, evaluator=jev,
                         eval_every=2)
    _, _, jlosses = jloop.run(jp, jopt.init(jp), num_steps=steps)
    _, state, losses, ev, loop, logged = _port_loop(corpus_dir, steps,
                                                    evaluate=True)
    np.testing.assert_allclose(losses, jlosses, rtol=0, atol=2e-5)
    assert [s for s, _ in ev.history] == [s for s, _ in jev.history] \
        == [2, 4, 6]
    np.testing.assert_allclose([v for _, v in ev.history],
                               [v for _, v in jev.history], rtol=0,
                               atol=2e-5)
    ends = [[], []]
    for grid, lp in zip(ends, (loop, jloop)):
        s = 0
        while s < steps:
            s = lp._chunk_end(s, steps)
            grid.append(s)
    assert ends[0] == ends[1] == [2, 3, 4, 6]
    assert [line.split(":")[0] for line in logged] == \
        ["step 2", "step 3", "step 4", "step 6", "step 6"]
    assert "eval_loss=" in logged[0] and int(state["step"]) == steps


def test_chunk_grid_with_eval_matches_reference():
    class Ev:
        n_batches = 1
    for log_every, eval_every, num in [(10, 3, 37), (4, 6, 30), (0, 5, 23),
                                       (7, 7, 30)]:
        j = JaxTrainLoop(None, None, None, log_every=log_every,
                         evaluator=Ev(), eval_every=eval_every)
        t = TrainLoop(None, None, device="cpu", log_every=log_every,
                      evaluator=Ev(), eval_every=eval_every)
        for step in range(num):
            assert t._chunk_end(step, num) == j._chunk_end(step, num)


def _assert_same(a, b):
    pa, la = flatten_with_paths(a)
    pb, lb = flatten_with_paths(b)
    assert pa == pb
    for path, x, y in zip(pa, la, lb):
        assert x.dtype == y.dtype and torch.equal(x, y), path


@pytest.mark.parametrize("workers", [0, 2])
def test_eval_and_workers_change_nothing(corpus_dir, workers):
    """Losses, parameters and optimizer state of 6 steps with eval (thread
    prefetch or 2 worker processes) equal those of a plain run, bitwise."""
    p0, s0, l0, _, _, _ = _port_loop(corpus_dir, 6, evaluate=False)
    p1, s1, l1, ev, _, _ = _port_loop(corpus_dir, 6, evaluate=True,
                                      workers=workers)
    assert l1 == l0 and len(ev.history) == 3
    _assert_same(p1, p0)
    _assert_same(s1, s0)


def test_desync_is_refused(corpus_dir):
    """A prefetcher that skips a batch stops the loop."""
    src = CorpusLM(corpus_dir, SEQ, BATCH, seed=0)
    loop = TrainLoop(lambda p, s, b: (p, s, {"loss": torch.zeros(())}),
                     src, device="cpu", log_every=0, log=lambda s: None)

    class Prefetch:
        def __init__(self):
            self.i = 0

        def __next__(self):
            self.i += 2
            return self.i, src.batch(self.i)

        def close(self):
            pass

    loop._prefetcher = lambda start: Prefetch()
    with pytest.raises(RuntimeError, match="desync"):
        loop.run({}, {}, num_steps=3)


# ---------------------------------------------------------------------------
# Launcher
# ---------------------------------------------------------------------------

def test_launcher_trains_on_a_corpus_with_workers_and_eval(corpus_dir):
    """``python -m repro_torch.launch.train`` on the CPU: the fixture
    corpus, 2 worker processes (spawned: they re-import the launcher
    module), eval every 2 steps; the model's vocab grows to the corpus'."""
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--device",
         "cpu", "--smoke", "--data", "corpus", "--corpus-dir", corpus_dir,
         "--workers", "2", "--eval-every", "2", "--steps", "4", "--batch",
         "4", "--seq", "32", "--log-every", "2"], cwd=REPO,
        capture_output=True, text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH="src", OMP_NUM_THREADS="2"))
    assert r.returncode == 0, r.stdout + r.stderr
    out = r.stdout
    assert "model vocab 64 -> 512 (corpus tokenizer)" in out
    assert "step 2: eval_loss=" in out and "step 4: eval_loss=" in out
    assert "final eval (step 4)" in out and "dispatch=" in out


def test_launcher_results_carry_eval_and_watchdog(corpus_dir):
    """``TrainResult.evals`` holds the eval history and ``watchdog`` the
    summary; the launcher's losses are those of the same run without eval
    or workers."""
    argv = ["--device", "cpu", "--smoke", "--data", "corpus", "--corpus-dir",
            corpus_dir, "--steps", "4", "--batch", "4", "--seq", "32",
            "--log-every", "2"]
    res = train.main(argv + ["--eval-every", "2", "--eval-batches", "1",
                             "--workers", "1"])
    plain = train.main(argv)
    assert res.losses == plain.losses
    assert [s for s, _ in res.evals] == [2, 4]
    assert all(np.isfinite(v) for _, v in res.evals)
    assert plain.evals == ()
    wd = res.watchdog
    assert wd["dispatch_s_per_step"] > 0 and wd["blocked_s_per_step"] > 0
    assert set(wd) == {"dispatch_s_per_step", "blocked_s_per_step",
                       "incidents", "incidents_dropped", "incident_log"}


def test_launcher_refuses_corpus_without_directory(capsys):
    with pytest.raises(SystemExit):
        train.main(["--device", "cpu", "--smoke", "--data", "corpus"])
    assert "--data corpus needs --corpus-dir" in capsys.readouterr().err


# ---------------------------------------------------------------------------
# Watchdog (mirrors tests/test_obs.py)
# ---------------------------------------------------------------------------

def _escalate(wd, n):
    """Geometrically growing blocked samples: every one past the first is
    far above slow_factor x the EMA it left behind."""
    wd.block(1e-3)
    for k in range(n):
        wd.block(10.0 ** (k + 1))


def test_watchdog_ring_buffer_caps_records_keeps_exact_count():
    wd = StepWatchdog(slow_factor=2.0, log=lambda s: None, max_incidents=4)
    _escalate(wd, 10)
    assert wd.incidents == 10 and isinstance(wd.incidents, int)
    assert len(wd.incident_log) == 4
    assert wd.incidents_dropped == 6
    assert [r["id"] for r in wd.incident_log] == [7, 8, 9, 10]
    assert all(r["phase"] == "blocked" for r in wd.incident_log)


def test_watchdog_summary_folds_ring_and_reaches_sink():
    sink = MemorySink()
    obs.configure(sink=sink)
    wd = StepWatchdog(slow_factor=2.0, log=lambda s: None, max_incidents=3)
    _escalate(wd, 5)
    s = wd.summary()
    assert s["incidents"] == 5 and s["incidents_dropped"] == 2
    assert s["incident_log"] == list(wd.incident_log)
    json.dumps(s["incident_log"])
    live = [r for r in sink.records if r["kind"] == "watchdog_incident"]
    assert [r["id"] for r in live] == [1, 2, 3, 4, 5]


def test_watchdog_below_threshold_and_dispatch_phase():
    said = []
    wd = StepWatchdog(slow_factor=3.0, log=said.append)
    for _ in range(20):
        wd.block(1e-3)
    assert wd.incidents == 0 and wd.incidents_dropped == 0
    wd.start()
    wd.stop(0, 4, record=False)       # the first chunk: not recorded
    assert wd.ema is None
    wd.start()
    assert wd.stop(4, 4) >= 0 and wd.ema is not None
    assert said == []


def test_loop_reports_eval_and_summary_to_the_sink(corpus_dir):
    sink = MemorySink()
    obs.configure(sink=sink)
    _port_loop(corpus_dir, 4, evaluate=True)
    kinds = [r["kind"] for r in sink.records]
    assert kinds.count("eval") == 2 and kinds[-1] == "watchdog_summary"
    assert [r["step"] for r in sink.records if r["kind"] == "eval"] == [2, 4]


# ---------------------------------------------------------------------------
# Telemetry (mirrors tests/test_obs.py)
# ---------------------------------------------------------------------------

def test_trace_schema_roundtrip(tmp_path):
    tr = obs_trace.Tracer(process_name="test-proc")
    with tr.span("outer", cat="train", step=3) as args:
        with tr.span("inner", cat="train", tid=1):
            pass
        args["extra"] = 7
    tr.counter("sched", cat="serve", queue_depth=2, slots_busy=1.0)
    tr.instant("admit", cat="serve", rid=0)
    path = tr.write(str(tmp_path / "trace.json"))
    with open(path) as f:
        doc = json.load(f)
    obs_trace.validate(doc)
    evs = doc["traceEvents"]
    assert evs[0] == {"name": "process_name", "ph": "M", "pid": 0,
                      "tid": 0, "args": {"name": "test-proc"}}
    by_name = {e["name"]: e for e in evs[1:]}
    assert by_name["outer"]["args"] == {"step": 3, "extra": 7}
    assert by_name["inner"]["dur"] <= by_name["outer"]["dur"]
    assert by_name["sched"]["args"] == {"queue_depth": 2.0,
                                        "slots_busy": 1.0}
    assert by_name["admit"]["ph"] == "i"
    ts = [e["ts"] for e in evs[1:]]
    assert ts == sorted(ts)
    for mutate in ({"ph": "Z"}, {"ts": -1.0}, {"name": ""}, {"dur": None}):
        bad = {"traceEvents": [dict(by_name["outer"], **mutate)]}
        with pytest.raises(ValueError):
            obs_trace.validate(bad)


def test_jsonl_sink_and_registry(tmp_path):
    path = tmp_path / "m.jsonl"
    sink = JsonlSink(str(path), run={"cmd": "train"})
    sink.emit({"kind": "train_step", "step": 1,
               "loss": torch.tensor(2.5)})    # tensor scalar -> number
    sink.close()
    with open(path) as f:
        recs = [json.loads(line) for line in f]
    assert [r["seq"] for r in recs] == [0, 1]
    assert recs[0]["run"] == {"cmd": "train"} and recs[1]["loss"] == 2.5
    assert isinstance(obs.get().sink, NullSink) and not obs.get().enabled
    d = tmp_path / "metrics"
    tel = obs.configure(str(d), run={"cmd": "t"})
    with tel.span("dispatch", steps=2):
        pass
    obs.shutdown()
    with open(d / "trace.json") as f:
        doc = json.load(f)
    obs_trace.validate(doc)
    assert any(e["name"] == "dispatch" for e in doc["traceEvents"])
    assert isinstance(obs.get().sink, NullSink)
