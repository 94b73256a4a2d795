"""Multi-level discrete wavelet transforms along the last axis
(counterpart of ``repro/core/haar.py``): the Haar butterfly, and the
periodic Daubechies-4 (db2) transform, the beyond-paper wavelet option.

Layout: level ``l`` on width ``n`` gives ``A_l`` (width ``n/2^l``) and the
detail bands ``[D_l, ..., D_1]`` (band ``D_k`` has width ``n/2^k``).

Scalars are rounded to the tensor's dtype before they multiply it, as the
JAX package's weakly typed Python constants are, so a bf16 transform rounds
where the reference rounds.
"""

from __future__ import annotations

import math
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


# Daubechies-4 (db2): periodic (circular) boundary, so the transform stays
# orthonormal on widths divisible by 2^l and the GWT state shapes are the
# Haar ones.  The taps are Python floats rounded to the tensor's dtype, so
# the transform runs in the input dtype as the JAX package's weakly typed
# taps make it.
_SQRT3 = 1.7320508075688772
_DB2_LO = tuple(c / (4 * math.sqrt(2)) for c in
                (1 + _SQRT3, 3 + _SQRT3, 3 - _SQRT3, 1 - _SQRT3))
_DB2_HI = (_DB2_LO[3], -_DB2_LO[2], _DB2_LO[1], -_DB2_LO[0])


def _db2_level_fwd(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """One db2 analysis level along the last axis (periodic)."""
    n = x.shape[-1]
    xr = torch.cat([x, x[..., :3]], dim=-1)       # circular pad (4 taps)
    even = [xr[..., i:n + i:2] for i in range(4)]  # (..., n/2) each
    lo = hi = 0
    for i in range(4):
        lo = lo + _const(_DB2_LO[i], x.dtype) * even[i]
        hi = hi + _const(_DB2_HI[i], x.dtype) * even[i]
    return lo, hi


def _db2_level_inv(lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """Inverse via the transposed (orthonormal) synthesis operator."""
    n = 2 * lo.shape[-1]
    dtype = torch.promote_types(lo.dtype, hi.dtype)
    out = torch.zeros(lo.shape[:-1] + (n + 2,), dtype=dtype,
                      device=lo.device)
    for i in range(4):
        contrib = lo * _const(_DB2_LO[i], lo.dtype) \
            + hi * _const(_DB2_HI[i], hi.dtype)
        out[..., i:i + n:2] += contrib
    # fold the circular tail back
    folded = out[..., :n].clone()
    folded[..., :2] += out[..., n:n + 2]
    return folded


def db2_forward(g: torch.Tensor, level: int
                ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """Like :func:`haar_forward`: ``(A_l, [D_l, ..., D_1])`` in the input
    dtype."""
    _check(g.shape[-1], level)
    a = g
    details: List[torch.Tensor] = []
    for _ in range(level):
        a, d = _db2_level_fwd(a)
        details.append(d)
    details.reverse()
    return a, details


def db2_inverse(a: torch.Tensor, details: Sequence[torch.Tensor]
                ) -> torch.Tensor:
    """Inverse of :func:`db2_forward`; ``D_l`` reconstructs first."""
    x = a
    for d in details:
        x = _db2_level_inv(x, d)
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
