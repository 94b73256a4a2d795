"""One run of one cell: set-up, the checked steps, the measured window,
the traced sub-window, the reference and the result line.

Set-up draws the weights on the device from the seed
(``gpubench.weights``) and builds the launcher's objects once
(``gpubench.program``).  The loop's first steps (the traffic file's
``checked_steps``) are the checked ones and the warm-up: after the first
the optimizer's moments give the first gradient, after the last the
parameters give each leaf's change (the time these readings take is
the check's, and is left out of set-up).  The window runs the same loop on
from there until the first chunk boundary (a loss fetch every
``log_every`` steps) past ``--seconds``.  With ``--trace 1`` the step and
``optimizer.update`` are wrapped with CUDA events, and one more chunk runs
under ``torch.profiler`` after the window.  Once the peak memory is read
and the program's state is freed, the reference follows the checked
steps (``gpubench.reference``) and ``gpubench.check`` compares them.
"""

from __future__ import annotations

import gc
import math
import sys
import time
from typing import Dict, Optional

import torch

from gpubench import check, program, spec, trace, weights as weights_lib
from gpubench import traffic as traffic_lib
from gpubench.counts import flops_module, update_bytes
from gpubench.reference import model as ref_model, optim as ref_optim
from gpubench.reference import train as ref_train

PEAK_BF16_FLOPS = 989e12       # H100 SXM, bf16 dense (data sheet)
PEAK_HBM_BYTES = 3.35e12       # H100 SXM, bytes/s (data sheet)


def say(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


class Marks:
    """The step and update wrappers: the deadline, and with ``events`` a
    ``STEP`` range around each step call and a CUDA event at each step's
    start and around each update."""

    def __init__(self, loop_ref: list, events: bool, fault: Optional[str]):
        self.loop_ref = loop_ref
        self.events = events
        self.fault = fault
        self.deadline = math.inf
        self.marks = []
        self._start = None

    def _event(self):
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        return e

    def step(self, inner):
        def timed_step(params, opt_state, batch):
            if self.events:
                self._start = self._event()
            if self.fault == "half":
                batch = {k: v[:v.shape[0] // 2] for k, v in batch.items()}
            if self.events:
                with torch.profiler.record_function(trace.STEP):
                    out = inner(params, opt_state, batch)
            else:
                out = inner(params, opt_state, batch)
            if time.perf_counter() > self.deadline:
                self.loop_ref[0].loop.preempt.requested = True
            return out
        return timed_step

    def update(self, inner):
        def timed_update(grads, opt_state, params):
            if self.fault == "frozen":
                return params, opt_state
            if not self.events:
                return inner(grads, opt_state, params)
            u0 = self._event()
            out = inner(grads, opt_state, params)
            self.marks.append((self._start, u0, self._event()))
            return out
        return timed_update

    def reset(self):
        self.marks = []

    def means_ms(self):
        """Mean forward-backward and update device ms over the marks."""
        if not self.marks:
            return None, None
        fb = sum(a.elapsed_time(b) for a, b, _ in self.marks)
        up = sum(b.elapsed_time(c) for _, b, c in self.marks)
        return fb / len(self.marks), up / len(self.marks)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Inputs:
    """What the benchmark makes for one seed and hands to both sides: the
    weights (drawn again on request) and the batches."""

    def __init__(self, cell: spec.Cell, seed: int, device):
        c = cell.config
        self.rspec = ref_model.Spec.from_config(c)
        self.layout = ref_model.layout(self.rspec)
        self.src = traffic_lib.source(cell.traffic, c["vocab_size"], seed)
        self.wts = weights_lib.Weights(self.layout, getattr(
            torch, c["torch_dtype"]), c["initializer_range"], seed, device)


class Built(Inputs):
    """A cell's program over the seed's weights and batches."""

    def __init__(self, cell: spec.Cell, seed: int, device, marks: "Marks",
                 state_dtype: Optional[torch.dtype] = None):
        super().__init__(cell, seed, device)
        cfg = program.model_config(cell.config)
        theirs = program.layout_of(cfg)
        mine = {k: (shape, weights_lib.dtype_of(k, cfg.torch_dtype))
                for k, (shape, _) in self.layout.items()}
        if theirs != mine:
            raise RuntimeError(f"the program's parameters {theirs} are not "
                               f"the benchmark's layout {mine}")
        self.prog = program.Program(cfg, cell.traffic, self.src, device,
                                    wrap_step=marks.step,
                                    wrap_update=marks.update, log=say,
                                    state_dtype=state_dtype)
        marks.loop_ref.append(self.prog)
        # trained leaves take gradients, as the launcher's parameters do
        self.params = weights_lib.nest(
            {k: t.requires_grad_(True) for k, t in self.wts.draw().items()})
        self.opt_state = self.prog.optimizer.init(self.params)

    def run(self, start: int, end: int):
        self.params, self.opt_state, losses = self.prog.run(
            self.params, self.opt_state, start, end)
        return losses

    def checked(self, steps: int) -> dict:
        """The first ``steps`` steps through the window's own loop, and the
        program's readings of them; ``read_s`` is the time the readings
        took, which is the check's and not set-up."""
        l1 = self.run(0, 1)
        t0 = time.perf_counter()
        grad = self.prog.first_moments(self.params, self.opt_state)
        self.read_s = time.perf_counter() - t0
        l23 = self.run(1, steps)
        t0 = time.perf_counter()
        now = weights_lib.flat(self.params)
        delta = {k: program.norm(now[k].float() - self.wts.again(k).float())
                 for k in self.layout}
        self.read_s += time.perf_counter() - t0
        return {"losses": list(l1) + list(l23), "grad": grad,
                "delta": delta}

    def free(self) -> None:
        self.params = self.opt_state = self.prog = None
        gc.collect()
        if torch.cuda.is_available():
            torch.cuda.empty_cache()


def reference(cell: spec.Cell, built: Inputs, seed: int,
              precision: str = "f32") -> dict:
    """The reference's (or with ``precision="fp8"`` the control's)
    readings of the checked steps, from the seed's weights and batches."""
    tr = cell.traffic
    batches = [built.src.batch(i) for i in range(tr["checked_steps"])]
    w = built.wts.draw()
    try:
        return ref_train.readings(built.rspec, reference_rule(tr), w,
                                  batches, tr["accum"], built.wts.again,
                                  precision=precision, seed=seed)
    finally:
        del w
        gc.collect()


def run(cell: spec.Cell, seed: int, seconds: float, trace_on: bool,
        device, t_process: float, fault: Optional[str] = None,
        state_dtype: Optional[torch.dtype] = None,
        precision: str = "f32") -> dict:
    """The run; returns the result line's fields (and ``readings``)."""
    device = torch.device(device)
    cuda = device.type == "cuda"
    tr = cell.traffic
    marks = Marks([], events=trace_on and cuda, fault=fault)
    t_built = time.perf_counter()
    b = Built(cell, seed, device, marks, state_dtype)
    # the checked steps build, load and warm up everything the window runs
    t_checked = time.perf_counter()
    readings = b.checked(tr["checked_steps"])
    warm_end = tr["checked_steps"]
    gc.collect()
    _sync(device)
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)

    # the window
    marks.reset()
    t0 = time.perf_counter()
    setup_s = t0 - t_process - b.read_s
    say(f"set-up {setup_s:.2f} s: imports and the card "
        f"{t_built - t_process:.2f} s, weights, optimizer and state "
        f"{t_checked - t_built:.2f} s, checked steps "
        f"{t0 - t_checked - b.read_s:.2f} s; the check's readings "
        f"{b.read_s:.2f} s left out")
    marks.deadline = t0 + seconds
    losses = b.run(warm_end, 1 << 60)
    _sync(device)
    t1 = time.perf_counter()
    marks.deadline = math.inf
    b.prog.loop.preempt.requested = False
    steps = len(losses)
    tokens = steps * tr["batch"] * tr["seq"]
    window = {"steps": steps, "tokens": tokens, "seconds": t1 - t0,
              "tokens_per_s": tokens / (t1 - t0)}
    failed = sum(1 for x in losses if not math.isfinite(x))
    fwd_bwd_ms, update_ms = marks.means_ms()
    state_bytes = _state_bytes(b.opt_state)
    traced = None
    if trace_on and cuda:
        start = warm_end + steps
        traced = trace.profile(lambda: b.run(start, start + tr["log_every"]),
                               device)
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    plan = {k: (tuple(t.shape), t.dtype)
            for k, t in weights_lib.flat(b.params).items()}
    marks.loop_ref.clear()
    b.free()

    # the reference follows the checked steps
    t_ref = time.perf_counter()
    ref = reference(cell, b, seed)
    if precision != "f32":
        readings = reference(cell, b, seed, precision)
    ref_s = time.perf_counter() - t_ref
    rule = reference_rule(tr)
    rspec = b.rspec
    nums = check.numbers(readings, ref)
    ok = check.verdict(nums, cell.limits)

    ctx = {"cell": cell, "window": window, "setup_s": setup_s,
           "peak_bytes": peak, "fwd_bwd_ms": fwd_bwd_ms,
           "update_ms": update_ms,
           "state_bytes": state_bytes, "trace": traced,
           "update_bytes": update_bytes.total(plan, rule.level,
                                              tr["codec"]),
           "flops_per_token": flops_module(rspec.family).per_token(
               rspec, tr["seq"]),
           "peak_flops": PEAK_BF16_FLOPS, "peak_bytes_per_s": PEAK_HBM_BYTES}
    return {"correct": ok, "attempted": steps, "failed": failed,
            "ctx": ctx, "numbers": nums, "readings": readings,
            "reference": ref, "reference_s": ref_s}


def reference_rule(tr: dict) -> ref_optim.Rule:
    o = tr["optimizer"]
    return ref_optim.Rule(lr=tr["lr"], schedule_steps=tr["schedule_steps"],
                          level=o["level"], alpha=o["alpha"],
                          codec=tr["codec"])


def _state_bytes(opt_state) -> int:
    from repro_torch.optim import engine
    return engine.state_bytes(opt_state)


def metrics(result: dict, trace_on: bool) -> Dict[str, dict]:
    """The result line's metrics: the cell's end-to-end metrics, or with
    ``--trace 1`` the per-layer ones whose readers find something."""
    ctx = result["ctx"]
    cell = ctx["cell"]
    out = {}
    if not trace_on:
        e2e = {"tokens_per_s": ctx["window"]["tokens_per_s"],
               "peak_mem_gib": ctx["peak_bytes"] / 2 ** 30,
               "setup_s": ctx["setup_s"]}
        for m in cell.end_to_end:
            if m["name"] in e2e:
                out[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}
        return out
    for m in cell.per_layer:
        v = spec.reader(m["name"])(ctx)
        if v is not None:
            out[m["name"]] = {"value": v, "unit": m["unit"]}
    return out
