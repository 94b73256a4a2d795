"""Multi-level discrete Haar wavelet transform along the last axis
(counterpart of ``repro/core/haar.py``: the butterfly forms only).

Layout: level ``l`` on width ``n`` gives ``A_l`` (width ``n/2^l``) and the
detail bands ``[D_l, ..., D_1]`` (band ``D_k`` has width ``n/2^k``).

Scalars are rounded to the tensor's dtype before they multiply it, as the
JAX package's weakly typed Python constants are, so a bf16 transform rounds
where the reference rounds.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

INV_SQRT2 = 0.7071067811865476


def _check(n: int, level: int) -> None:
    if level < 0:
        raise ValueError(f"level must be >= 0, got {level}")
    if n % (1 << level) != 0:
        raise ValueError(f"axis length {n} not divisible by 2^{level}")


def _const(value: float, dtype: torch.dtype) -> float:
    """``value`` rounded to ``dtype`` (exact as a Python float)."""
    return float(torch.tensor(value, dtype=dtype))


def haar_forward(g: torch.Tensor, level: int
                 ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """Returns ``(A_l, [D_l, ..., D_1])``; level 0 is the identity."""
    _check(g.shape[-1], level)
    s = _const(INV_SQRT2, g.dtype)
    a = g
    details: List[torch.Tensor] = []
    for _ in range(level):
        x = a.reshape(*a.shape[:-1], a.shape[-1] // 2, 2)
        even, odd = x[..., 0], x[..., 1]
        a = (even + odd) * s
        details.append((even - odd) * s)
    details.reverse()
    return a, details


def haar_approx(g: torch.Tensor, level: int) -> torch.Tensor:
    """``A_l`` alone: the averaging chain of :func:`haar_forward`."""
    _check(g.shape[-1], level)
    s = _const(INV_SQRT2, g.dtype)
    a = g
    for _ in range(level):
        x = a.reshape(*a.shape[:-1], a.shape[-1] // 2, 2)
        a = (x[..., 0] + x[..., 1]) * s
    return a


def haar_inverse(a: torch.Tensor, details: Sequence[torch.Tensor]
                 ) -> torch.Tensor:
    """Inverse of :func:`haar_forward`; ``D_l`` reconstructs first."""
    s = _const(INV_SQRT2, a.dtype)
    x = a
    for d in details:
        even = (x + d) * s
        odd = (x - d) * s
        x = torch.stack([even, odd], dim=-1).reshape(*x.shape[:-1],
                                                     x.shape[-1] * 2)
    return x


def detail_scale_upsample(scale_a: torch.Tensor, level: int,
                          band_level: int) -> torch.Tensor:
    """Repeat each ``A_l`` scale ``2^(level-band_level)`` times so it lines
    up with band ``D_band_level``."""
    if scale_a.ndim and scale_a.shape[-1] == 1:
        return scale_a
    reps = 1 << (level - band_level)
    if reps == 1:
        return scale_a
    return torch.repeat_interleave(scale_a, reps, dim=-1)
