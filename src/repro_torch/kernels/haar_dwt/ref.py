"""Plain PyTorch versions of the Haar DWT kernels (counterpart of
``repro/kernels/haar_dwt/ref.py``, with the arithmetic of the TPU kernels in
``repro/kernels/haar_dwt/kernel.py``: every transform runs in f32 and each
band is cast once, at the end).

The CPU path runs them, and ``chip_smoke.py`` holds the CUDA kernels against
them on the card.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from repro_torch.core import haar

FP8 = torch.float8_e4m3fn
# the largest f32 magnitude that float8_e4m3fn rounds to its largest finite
# value, 448 (464 is the tie, which rounds to the even 448)
FP8_LAST = 464.0


def to_wire(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``x`` cast to ``dtype`` as the JAX package casts it.  bf16 and f16
    are ``.to()``.  For float8_e4m3fn a value whose magnitude rounds past
    448, and +-inf, becomes NaN with its sign (0x7f / 0xff), and NaN stays
    NaN with its sign; ``.to()`` alone would saturate to +-448."""
    y = x.to(dtype)
    if dtype != FP8:
        return y
    nan = ~(x.abs() <= FP8_LAST)
    bits = torch.where(torch.signbit(x), 0xFF, 0x7F).to(torch.uint8)
    return torch.where(nan, bits, y.view(torch.uint8)).view(FP8)


def haar_dwt_fwd(g: torch.Tensor, level: int) -> Tuple[torch.Tensor, ...]:
    """``(A_l, D_l, ..., D_1)`` of a 2-D ``(m, n)`` input, every band in
    ``g``'s dtype."""
    a, details = haar.haar_forward(g.float(), level)
    return (a.to(g.dtype), *(d.to(g.dtype) for d in details))


def haar_dwt_fwd_q(g: torch.Tensor, level: int, detail_dtype: torch.dtype
                   ) -> Tuple[torch.Tensor, ...]:
    """``(A_l f32, D_l..D_1 in detail_dtype)``: the wire terms of the
    compressed data-parallel reduction."""
    a, details = haar.haar_forward(g.float(), level)
    return (a, *(to_wire(d, detail_dtype) for d in details))


def haar_dwt_inv(a: torch.Tensor, details: Sequence[torch.Tensor]
                 ) -> torch.Tensor:
    """Inverse of :func:`haar_dwt_fwd`: ``(A_l, [D_l..D_1]) -> (m, n)`` in
    ``a``'s dtype."""
    return haar.haar_inverse(a.float(), [d.float() for d in details]) \
        .to(a.dtype)
