"""Host optimizers on a single tensor (counterpart of
``repro/optim/hosts.py``): Adam, Adam-mini and MUON, the memory-intensive
optimizer slot of the paper's Algorithm 1.

    host.init(shape, device)       -> state dict shaped like the input
    host.update(g, state, step)    -> (precond_update, detail_scale, lr_mult, state)

``detail_scale`` is the diagonal preconditioner GWT applies to the wavelet
detail bands (Adam: ``1/(√V+ε)``), or None where the host has none (MUON:
the details pass unscaled).  States are kept in ``state_dtype`` (f32 by
default, bf16 for half the bytes); math is f32 from ``state[...].float()``,
and the returned preconditioner uses the unrounded f32 moments: only the
stored state is rounded.  The state codec may store the slots encoded; the
engine decodes them before ``update`` sees them.
"""

from __future__ import annotations

import math
from typing import Any, Callable, NamedTuple, Optional, Tuple

import torch


class Host(NamedTuple):
    init: Callable[..., Any]
    update: Callable[..., Tuple[torch.Tensor, Optional[torch.Tensor],
                                torch.Tensor, Any]]
    name: str = "host"
    # bool tree over the state: True marks a moment slot the state codec
    # stores encoded (see ``optim/codec.py``)
    slots: Any = None


def adam(b1: float = 0.9, b2: float = 0.999, eps: float = 1e-6,
         state_dtype: torch.dtype = torch.float32) -> Host:
    def init(shape, device):
        return {"m": torch.zeros(shape, dtype=state_dtype, device=device),
                "v": torch.zeros(shape, dtype=state_dtype, device=device)}

    def update(g, state, step):
        # the reference's expressions, each product and sum rounded as
        # there, with the sums taken in place and temporaries dropped as
        # soon as they are used: a leaf's update then holds three f32
        # copies of it besides the moments, not six (a (152064, 8192)
        # embedding is 5 GB a copy)
        g32 = g.float()
        m = b1 * state["m"].float()
        m.add_((1 - b1) * g32)
        v = b2 * state["v"].float()
        v.add_(((1 - b2) * g32).mul_(g32))
        del g32
        denom = torch.sqrt(v).add_(eps)
        precond = m / denom
        t = step.float() + 1.0
        lr_mult = torch.sqrt(1 - b2 ** t) / (1 - b1 ** t)
        return precond, denom.reciprocal_(), lr_mult, {
            "m": m.to(state_dtype), "v": v.to(state_dtype)}

    return Host(init, update, "adam", slots={"m": True, "v": True})


def adam_mini(b1: float = 0.9, b2: float = 0.999, eps: float = 1e-6,
              state_dtype: torch.dtype = torch.float32) -> Host:
    """Adam-mini: a full first moment and one second moment per row
    (``v`` shaped ``(..., 1)``; a scalar for 1-D tensors)."""
    def init(shape, device):
        shape = tuple(shape)
        vshape = shape[:-1] + (1,) if len(shape) >= 2 else ()
        return {"m": torch.zeros(shape, dtype=state_dtype, device=device),
                "v": torch.zeros(vshape, dtype=state_dtype, device=device)}

    def update(g, state, step):
        g32 = g.float()
        m = b1 * state["m"].float() + (1 - b1) * g32
        gsq = (g32 * g32).mean(-1, keepdim=True) if g32.ndim >= 2 \
            else (g32 * g32).mean()
        v = b2 * state["v"].float() + (1 - b2) * gsq
        denom = torch.sqrt(v) + eps
        precond = m / denom
        t = step.float() + 1.0
        lr_mult = torch.sqrt(1 - b2 ** t) / (1 - b1 ** t)
        return precond, 1.0 / denom, lr_mult, {"m": m.to(state_dtype),
                                               "v": v.to(state_dtype)}

    return Host(init, update, "adam_mini", slots={"m": True, "v": True})


_NS_COEFFS = (3.4445, -4.7750, 2.0315)


def newton_schulz(m: torch.Tensor, steps: int = 5) -> torch.Tensor:
    """Quintic Newton-Schulz iteration orthogonalizing the last two dims,
    in f32 (the caller keeps TF32 off, PyTorch's default for matmuls)."""
    a, b, c = _NS_COEFFS
    x = m.float()
    transpose = x.shape[-2] > x.shape[-1]
    if transpose:
        x = x.transpose(-1, -2)
    x = x / (torch.linalg.matrix_norm(x, keepdim=True) + 1e-7)
    for _ in range(steps):
        xxt = x @ x.transpose(-1, -2)
        x = a * x + (b * xxt + c * (xxt @ xxt)) @ x
    if transpose:
        x = x.transpose(-1, -2)
    return x


def muon(beta: float = 0.95, ns_steps: int = 5, nesterov: bool = True,
         state_dtype: torch.dtype = torch.float32) -> Host:
    """MUON: momentum, Newton-Schulz orthogonalization, the RMS-matching
    scale ``sqrt(max(1, rows/cols))``; ``lr_mult`` 1 and no detail scale.
    Momentum-only state; 2-D (or batched 2-D) tensors only."""
    def init(shape, device):
        return {"m": torch.zeros(tuple(shape), dtype=state_dtype,
                                 device=device)}

    def update(g, state, step):
        g32 = g.float()
        m = beta * state["m"].float() + g32
        eff = g32 + beta * m if nesterov else m
        o = newton_schulz(eff, ns_steps)
        rows, cols = o.shape[-2], o.shape[-1]
        o = o * math.sqrt(max(1.0, rows / cols))
        one = torch.ones((), dtype=torch.float32, device=g.device)
        return o, None, one, {"m": m.to(state_dtype)}

    return Host(init, update, "muon", slots={"m": True})


HOSTS = {"adam": adam, "adam_mini": adam_mini, "muon": muon}


def make_host(name: str, **kw) -> Host:
    if name not in HOSTS:
        raise ValueError(f"unknown host optimizer {name!r}; choices: "
                         f"{sorted(HOSTS)}")
    return HOSTS[name](**kw)
