"""Entry points of the Haar DWT kernels (counterparts of ``dwt``,
``dwt_wire`` and ``idwt`` in ``repro/kernels/haar_dwt/ops.py``, and
:func:`dwt_wire_group`, the wire split of many leaves at once).

Dispatch depends only on the device of the input: a CUDA tensor launches
the hand-written kernel (``kernel.py``), which raises on anything it does
not take and on a failed launch; a CPU tensor takes the plain version
(``ref.py``).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

from repro_torch.kernels.haar_dwt import kernel, ref


def dwt(g: torch.Tensor, level: int) -> Tuple[torch.Tensor, ...]:
    """Forward multi-level DWT of an ``(m, n)`` tensor: ``(A_l, D_l, ...,
    D_1)`` in ``g``'s dtype."""
    if g.is_cuda:
        return kernel.haar_dwt_fwd(g, level)
    return ref.haar_dwt_fwd(g, level)


def dwt_wire(g: torch.Tensor, level: int, detail_dtype: torch.dtype
             ) -> Tuple[torch.Tensor, ...]:
    """The wire terms of an ``(m, n)`` f32 gradient: ``(A_l f32, D_l..D_1
    in detail_dtype)``, the details narrowed at the write."""
    if g.is_cuda:
        return kernel.haar_dwt_fwd_q(g, level, detail_dtype)
    return ref.haar_dwt_fwd_q(g, level, detail_dtype)


def dwt_wire_group(gs: Sequence[torch.Tensor], level: int,
                   detail_dtype: torch.dtype) -> List[Tuple[torch.Tensor, ...]]:
    """:func:`dwt_wire` of every ``(m, n)`` f32 leaf of ``gs``: the grouped
    K3 kernel for CUDA tensors (one launch for up to
    ``kernel.GROUP_LEAVES`` leaves), the plain version leaf by leaf for
    CPU ones."""
    if any(g.is_cuda for g in gs):
        return kernel.haar_dwt_fwd_q_group(gs, level, detail_dtype)
    return [ref.haar_dwt_fwd_q(g, level, detail_dtype) for g in gs]


def idwt(a: torch.Tensor, details: Sequence[torch.Tensor]) -> torch.Tensor:
    """Inverse: ``(A_l, [D_l..D_1]) -> (m, n)`` in ``a``'s dtype."""
    if a.is_cuda:
        return kernel.haar_dwt_inv(a, details)
    return ref.haar_dwt_inv(a, details)
