"""Checkpointed, preemption-safe, straggler-monitored training loop
(counterpart of ``TrainLoop``, ``StepWatchdog`` and ``PreemptionHandler``
in ``repro/runtime/fault_tolerance.py``).

Steps run in chunks on the JAX package's absolute chunk grid: boundaries
are multiples of the chunk size, of ``log_every``, with a checkpoint
manager of ``ckpt_every`` and with an evaluator of ``eval_every``, plus
``num_steps``.  A resumed run therefore stops, logs, evaluates and saves at
the same steps as an uninterrupted one.  Each step's loss stays on the
device; the host fetches the pending losses once per ``log_every``
boundary (and at the end).

Data: batches come from a background ``Prefetcher`` thread
(``num_workers=0``) or from ``num_workers`` shared-memory worker processes
(``repro_torch.data.workers.ProcessPrefetcher``), started at
``start_step``; both yield ``(index, batch)`` and the loop checks the index
against the step.  A chunk's batches are stacked and copied to the device
once per key, as the reference places a chunk.  Batches are a pure
function of the step, so the worker count never changes the stream and
may change across a resume.

Eval: ``evaluator`` (``repro_torch.data.eval.Evaluator``) runs between
chunks every ``eval_every`` steps.  Its boundaries join the chunk grid, and
a step's arithmetic does not depend on where chunks fall, so losses and
parameters with eval equal those without, bitwise.

Watchdog: ``StepWatchdog`` keeps a dispatch EMA (the host's time to
enqueue a chunk; the run's first chunk, which builds and warms up the
kernels, is not recorded) and a blocked EMA (the loss fetch at
``log_every``, an eval, a checkpoint's host copy or a blocking save).

Checkpoints, with a checkpoint manager: every ``ckpt_every`` steps
(asynchronous write of a host copy), and at the end of a run that was not
preempted.  SIGTERM or SIGINT during ``run`` sets a
flag; at the next chunk boundary the loop saves blocking and stops, and the
run can be resumed from that step.

Data parallel (``dp``, a ``launch.mesh.DPContext`` of several ranks): the
ranks agree on a preemption at each chunk boundary (stopping if any rank was
signalled), every rank takes part in gathering the error-feedback residues
into the checkpoint's ``(D, *shape)`` leaves, and only rank 0 writes.
"""

from __future__ import annotations

import signal
import time
from collections import deque
from typing import Callable, List, Optional

import torch

from repro_torch import obs
from repro_torch.data.pipeline import Prefetcher, stack_batches
from repro_torch.distributed import compression
from repro_torch.optim.base import tree_map

MAX_CHUNK = 16   # the JAX loop's default chunk length
SIGNALS = (signal.SIGTERM, signal.SIGINT)


class PreemptionHandler:
    """Sets ``requested`` on SIGTERM or SIGINT while installed.  Installing
    is a no-op outside the main thread, where Python delivers no
    signals."""

    def __init__(self):
        self.requested = False
        self._orig = {}

    def _on_signal(self, signum, frame):
        self.requested = True

    def install(self):
        for s in SIGNALS:
            try:
                self._orig[s] = signal.signal(s, self._on_signal)
            except ValueError:  # not the main thread
                pass

    def restore(self):
        for s, h in self._orig.items():
            signal.signal(s, h)
        self._orig = {}


class StepWatchdog:
    """Two-phase straggler monitor.

    * ``start()`` / ``stop(step, n_steps)`` time the **dispatch** phase:
      how long the host spends enqueueing ``n_steps`` worth of work.  On
      the card this is python + launch overhead, NOT device compute —
      which is why it is tracked separately from
    * ``block(dt, n_steps)``: the **blocked** phase — host time stalled on
      device results (loss fetches at ``log_every``, evals, checkpoint
      host copies and blocking saves).  Device-side stragglers surface
      here.

    Each phase keeps a per-step EMA; a sample slower than
    ``slow_factor×EMA`` is logged with a monotonically-increasing incident
    id.  ``ema`` is the dispatch EMA, ``block_ema`` the blocked one.

    Incident *records* land in ``incident_log``, a ring buffer capped at
    ``max_incidents`` (a pathological run — e.g. one straggling host in a
    large pod — can flag every chunk for days; the count stays exact while
    the records stay bounded, with ``incidents_dropped`` reporting the
    overflow).  ``incidents`` remains the total integer count.  Each
    incident is also emitted to the process-global metric sink
    (``repro_torch.obs``) as a ``watchdog_incident`` record.
    """

    def __init__(self, slow_factor: float = 3.0, ema_alpha: float = 0.1,
                 log: Callable[[str], None] = print,
                 max_incidents: int = 64):
        self.slow_factor = slow_factor
        self.alpha = ema_alpha
        self.ema: Optional[float] = None         # dispatch s/step
        self.block_ema: Optional[float] = None   # blocked s/step
        self._incidents = 0
        self.incident_log: deque = deque(maxlen=max(int(max_incidents), 1))
        self.log = log
        self._t0: Optional[float] = None
        self._step = 0

    @property
    def incidents(self) -> int:
        """Total incident count (exact even after the ring drops records)."""
        return self._incidents

    @property
    def incidents_dropped(self) -> int:
        return self._incidents - len(self.incident_log)

    def _observe(self, phase: str, step: int, per_step: float,
                 ema: Optional[float]) -> float:
        if ema is not None and per_step > self.slow_factor * ema:
            self._incidents += 1
            rec = {"id": self._incidents, "step": step, "phase": phase,
                   "s_per_step": per_step, "ema": ema}
            self.incident_log.append(rec)
            obs.get().emit("watchdog_incident", **rec)
            self.log(f"[watchdog] step {step}: {phase} {per_step:.3f}s/step"
                     f" > {self.slow_factor:.1f}x EMA {ema:.3f}s "
                     f"(incident #{self._incidents})")
        return per_step if ema is None \
            else self.alpha * per_step + (1 - self.alpha) * ema

    def start(self):
        self._t0 = time.monotonic()

    def stop(self, step: int, n_steps: int = 1, record: bool = True) -> float:
        """``record=False`` returns the elapsed time without feeding the
        EMA — used for samples known to be unrepresentative (a run's first
        chunk includes the kernel build and warm-up; letting that seed the
        EMA would mask real stragglers for many chunks)."""
        dt = time.monotonic() - self._t0
        self._step = step
        if record:
            self.ema = self._observe("dispatch", step, dt / max(n_steps, 1),
                                     self.ema)
        return dt

    def block(self, dt: float, n_steps: int = 1, step: Optional[int] = None):
        self.block_ema = self._observe(
            "blocked", self._step if step is None else step,
            dt / max(n_steps, 1), self.block_ema)

    def summary(self) -> dict:
        return {"dispatch_s_per_step": self.ema,
                "blocked_s_per_step": self.block_ema,
                "incidents": self.incidents,
                "incidents_dropped": self.incidents_dropped,
                "incident_log": list(self.incident_log)}


class TrainLoop:
    def __init__(self, train_step, data_source, *, device, ckpt=None,
                 ckpt_every: int = 100, log_every: int = 10,
                 log: Callable[[str], None] = print, dp=None,
                 num_workers: int = 0, evaluator=None, eval_every: int = 0):
        self.train_step = train_step
        self.data = data_source
        self.device = torch.device(device)
        self.ckpt = ckpt
        self.ckpt_every = ckpt_every
        self.log_every = log_every
        self.log = log
        self.dp = dp
        self.num_workers = int(num_workers)
        self.evaluator = evaluator
        self.eval_every = int(eval_every)
        self.watchdog = StepWatchdog(log=log)
        self.preempt = PreemptionHandler()
        # Seconds per step measured between the first and the last loss
        # fetch (each fetch waits for the card), i.e. without the first
        # window's warm-up; None when the run had fewer than two fetches.
        self.steady_step_s: Optional[float] = None
        # the JAX loop aligns its chunk grid to log_every when a reasonable
        # divisor exists; keep its grid so chunks fall where its do
        g = MAX_CHUNK
        if log_every:
            cap = min(g, log_every)
            d = next((d for d in range(cap, 0, -1)
                      if log_every % d == 0), g)
            if d >= max(1, cap // 2):
                g = d
        self._grid = g

    def _chunk_end(self, step: int, num_steps: int) -> int:
        """Next chunk boundary after ``step`` on the absolute grid."""
        def nxt(every: int) -> int:
            return (step // every + 1) * every

        ends = [num_steps, nxt(self._grid)]
        if self.log_every:
            ends.append(nxt(self.log_every))
        if self.ckpt is not None and self.ckpt_every:
            ends.append(nxt(self.ckpt_every))
        if self.evaluator is not None and self.eval_every:
            ends.append(nxt(self.eval_every))
        return max(min(ends), step + 1)

    def _prefetcher(self, start_step: int):
        if self.num_workers > 0:
            from repro_torch.data.workers import ProcessPrefetcher
            return ProcessPrefetcher(self.data, start_step=start_step,
                                     depth=2 * MAX_CHUNK,
                                     num_workers=self.num_workers)
        return Prefetcher(self.data, start_step=start_step,
                          depth=2 * MAX_CHUNK)

    def _to_device(self, batch):
        return {k: torch.from_numpy(v).to(self.device)
                for k, v in batch.items()}

    def _maybe_eval(self, step: int, params, k: int):
        if self.evaluator is None or not self.eval_every \
                or step % self.eval_every:
            return
        t0 = time.monotonic()
        r = self.evaluator(params, step)
        self.watchdog.block(time.monotonic() - t0, k)
        obs.get().emit("eval", step=step, loss=float(r["loss"]),
                       ppl=float(r["ppl"]),
                       n_batches=self.evaluator.n_batches)
        self.log(f"step {step}: eval_loss={r['loss']:.4f} "
                 f"ppl={r['ppl']:.2f} ({self.evaluator.n_batches} batches)")

    def _save(self, step, params, opt_state, blocking=False):
        inner, ef = compression.split_ef(opt_state)
        if ef is not None and self.dp is not None and self.dp.world > 1:
            opt_state = {"opt": inner,
                         "dp_ef": tree_map(self.dp.gather_rows, ef)}
        if self.dp is None or self.dp.rank == 0:
            self.ckpt.save(step, {"params": params, "opt": opt_state},
                           blocking=blocking)

    def _timed_save(self, step, params, opt_state, k, blocking=False):
        t0 = time.monotonic()
        self._save(step, params, opt_state, blocking=blocking)
        self.watchdog.block(time.monotonic() - t0, k)

    def _preempted(self) -> bool:
        if self.dp is None:
            return self.preempt.requested
        return self.dp.any(self.preempt.requested)

    def run(self, params, opt_state, *, start_step: int = 0,
            num_steps: int = 100):
        losses: List[float] = []
        window: List[torch.Tensor] = []   # per-step losses, on the device
        fetches: List[tuple] = []         # (step, host time) after a fetch

        def flush(step: int):
            if not window:
                return
            t0 = time.monotonic()
            losses.extend(torch.stack(window).cpu().tolist())
            self.watchdog.block(time.monotonic() - t0, len(window))
            window.clear()
            fetches.append((step, time.perf_counter()))

        step = start_step
        preempted = False
        last_saved = None
        first_chunk = True
        pf = self._prefetcher(step)
        self.preempt.install()
        try:
            while step < num_steps:
                end = self._chunk_end(step, num_steps)
                k = end - step
                batches = []
                for j in range(k):
                    i, b = next(pf)
                    if i != step + j:   # bit-determinism depends on this
                        raise RuntimeError(f"data stream desync: got batch "
                                           f"{i}, want {step + j}")
                    batches.append(b)
                chunk = self._to_device(stack_batches(batches))
                self.watchdog.start()
                for j in range(k):
                    params, opt_state, metrics = self.train_step(
                        params, opt_state, {kk: v[j] for kk, v in
                                            chunk.items()})
                    window.append(metrics["loss"])
                dt = self.watchdog.stop(step, k, record=not first_chunk)
                first_chunk = False
                step = end
                if self.log_every and step % self.log_every == 0:
                    flush(step)
                    self.log(f"step {step}: loss={losses[-1]:.4f} "
                             f"(dispatch {dt / k * 1e3:.1f}ms/step, blocked "
                             f"{(self.watchdog.block_ema or 0) * 1e3:.1f}"
                             f"ms/step)")
                self._maybe_eval(step, params, k)
                if self.ckpt is not None and self.ckpt_every \
                        and step % self.ckpt_every == 0:
                    self._timed_save(step, params, opt_state, k)
                    last_saved = step
                if self._preempted():
                    preempted = True
                    flush(step)
                    self.log(f"[preempt] checkpoint@{step} and exit")
                    if self.ckpt is not None:
                        self._timed_save(step, params, opt_state, k,
                                         blocking=True)
                    break
        finally:
            pf.close()
            self.preempt.restore()
        flush(step)
        if self.ckpt is not None:
            if not preempted and last_saved != step:
                self._save(step, params, opt_state, blocking=True)
            self.ckpt.wait()
        if len(fetches) >= 2 and fetches[-1][0] > fetches[0][0]:
            (s0, t0), (s1, t1) = fetches[0], fetches[-1]
            self.steady_step_s = (t1 - t0) / (s1 - s0)
        obs.get().emit("watchdog_summary", step=step,
                       **self.watchdog.summary())
        return params, opt_state, losses
