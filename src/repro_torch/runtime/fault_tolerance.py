"""Checkpointed, preemption-safe training loop (counterpart of ``TrainLoop``
and ``PreemptionHandler`` in ``repro/runtime/fault_tolerance.py``; the
watchdog, eval and process-prefetch parts are not ported yet).

Steps run in chunks on the JAX package's absolute chunk grid: boundaries
are multiples of the chunk size, of ``log_every`` and, with a checkpoint
manager, of ``ckpt_every``, plus ``num_steps``.  A resumed run therefore
stops, logs and saves at the same steps as an uninterrupted one.  Each
step's loss stays on the device; the host fetches the pending losses once
per ``log_every`` boundary (and at the end).

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
from typing import Callable, List, Optional

import torch

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


class TrainLoop:
    def __init__(self, train_step, data_source, *, device, ckpt=None,
                 ckpt_every: int = 100, log_every: int = 10,
                 log: Callable[[str], None] = print, dp=None):
        self.train_step = train_step
        self.data = data_source
        self.device = torch.device(device)
        self.ckpt = ckpt
        self.ckpt_every = ckpt_every
        self.log_every = log_every
        self.log = log
        self.dp = dp
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
        return max(min(ends), step + 1)

    def _to_device(self, batch):
        return {k: torch.from_numpy(v).to(self.device)
                for k, v in batch.items()}

    def _save(self, step, params, opt_state, blocking=False):
        inner, ef = compression.split_ef(opt_state)
        if ef is not None and self.dp is not None and self.dp.world > 1:
            opt_state = {"opt": inner,
                         "dp_ef": tree_map(self.dp.gather_rows, ef)}
        if self.dp is None or self.dp.rank == 0:
            self.ckpt.save(step, {"params": params, "opt": opt_state},
                           blocking=blocking)

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
            losses.extend(torch.stack(window).cpu().tolist())
            window.clear()
            fetches.append((step, time.perf_counter()))

        step = start_step
        preempted = False
        last_saved = None
        self.preempt.install()
        try:
            while step < num_steps:
                end = self._chunk_end(step, num_steps)
                batches = [self.data.batch(i) for i in range(step, end)]
                for b in batches:
                    params, opt_state, metrics = self.train_step(
                        params, opt_state, self._to_device(b))
                    window.append(metrics["loss"])
                step = end
                if self.log_every and step % self.log_every == 0:
                    flush(step)
                    self.log(f"step {step}: loss={losses[-1]:.4f}")
                if self.ckpt is not None and self.ckpt_every \
                        and step % self.ckpt_every == 0:
                    self._save(step, params, opt_state)
                    last_saved = step
                if self._preempted():
                    preempted = True
                    flush(step)
                    self.log(f"[preempt] checkpoint@{step} and exit")
                    if self.ckpt is not None:
                        self._save(step, params, opt_state, blocking=True)
                    break
        finally:
            self.preempt.restore()
        flush(step)
        if self.ckpt is not None:
            if not preempted and last_saved != step:
                self._save(step, params, opt_state, blocking=True)
            self.ckpt.wait()
        if len(fetches) >= 2 and fetches[-1][0] > fetches[0][0]:
            (s0, t0), (s1, t1) = fetches[0], fetches[-1]
            self.steady_step_s = (t1 - t0) / (s1 - s0)
        return params, opt_state, losses
