"""LR schedules (counterpart of ``repro/optim/schedules.py``).

A schedule maps the int32 step tensor to an f32 tensor on the step's
device, so reading the learning rate never waits for the card."""

from __future__ import annotations

import math
from typing import Callable

import torch

Schedule = Callable[[torch.Tensor], torch.Tensor]


def constant(lr: float) -> Schedule:
    return lambda step: torch.full((), lr, dtype=torch.float32,
                                   device=step.device)


def warmup_cosine(peak_lr: float, total_steps: int, warmup_frac: float = 0.1,
                  final_frac: float = 0.1) -> Schedule:
    """10% linear warmup, then cosine annealing to ``final_frac`` of peak."""
    warmup_steps = max(1, int(total_steps * warmup_frac))

    def sched(step: torch.Tensor) -> torch.Tensor:
        step = step.float()
        warm = step / warmup_steps
        prog = torch.clamp((step - warmup_steps)
                           / max(1, total_steps - warmup_steps), 0.0, 1.0)
        cos = final_frac + (1 - final_frac) * 0.5 * (
            1 + torch.cos(math.pi * prog))
        return peak_lr * torch.where(step < warmup_steps, warm, cos)

    return sched
