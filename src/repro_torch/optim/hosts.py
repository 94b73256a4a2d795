"""Host optimizers on a single tensor (counterpart of
``repro/optim/hosts.py``; the Adam host only).

    host.init(shape, device)       -> state dict shaped like the input
    host.update(g, state, step)    -> (precond_update, detail_scale, lr_mult, state)

States are f32; math is f32.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional, Tuple

import torch


class Host(NamedTuple):
    init: Callable[..., Any]
    update: Callable[..., Tuple[torch.Tensor, Optional[torch.Tensor],
                                torch.Tensor, Any]]
    name: str = "host"


def adam(b1: float = 0.9, b2: float = 0.999, eps: float = 1e-6) -> Host:
    def init(shape, device):
        return {"m": torch.zeros(shape, dtype=torch.float32, device=device),
                "v": torch.zeros(shape, dtype=torch.float32, device=device)}

    def update(g, state, step):
        g32 = g.float()
        m = b1 * state["m"].float() + (1 - b1) * g32
        v = b2 * state["v"].float() + (1 - b2) * g32 * g32
        denom = torch.sqrt(v) + eps
        precond = m / denom
        t = step.float() + 1.0
        lr_mult = torch.sqrt(1 - b2 ** t) / (1 - b1 ** t)
        return precond, 1.0 / denom, lr_mult, {"m": m, "v": v}

    return Host(init, update, "adam")
