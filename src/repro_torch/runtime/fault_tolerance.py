"""Training loop (counterpart of ``TrainLoop`` in
``repro/runtime/fault_tolerance.py``; the checkpoint, SIGTERM, watchdog,
eval and process-prefetch parts are not ported yet).

Steps run in chunks on the JAX package's absolute chunk grid: boundaries
are multiples of the chunk size and of ``log_every``, plus ``num_steps``.
Each step's loss stays on the device; the host fetches the pending losses
once per ``log_every`` boundary (and at the end), which is the only point
where the loop waits for the card.
"""

from __future__ import annotations

import time
from typing import Callable, List, Optional

import torch

MAX_CHUNK = 16   # the JAX loop's default chunk length


class TrainLoop:
    def __init__(self, train_step, data_source, *, device,
                 log_every: int = 10, log: Callable[[str], None] = print):
        self.train_step = train_step
        self.data = data_source
        self.device = torch.device(device)
        self.log_every = log_every
        self.log = log
        # Seconds per step measured between the first and the last loss
        # fetch (each fetch waits for the card, so the span is device
        # time), i.e. without the first window's warm-up; None when the run
        # had fewer than two fetches.
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
        return max(min(ends), step + 1)

    def _to_device(self, batch):
        return {k: torch.from_numpy(v).to(self.device)
                for k, v in batch.items()}

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
        flush(step)
        if len(fetches) >= 2 and fetches[-1][0] > fetches[0][0]:
            (s0, t0), (s1, t1) = fetches[0], fetches[-1]
            self.steady_step_s = (t1 - t0) / (s1 - s0)
        return params, opt_state, losses
