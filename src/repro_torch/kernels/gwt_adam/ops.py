"""Entry points of the fused-write GWT-Adam update (counterparts of
``fused_write_update`` and ``fused_write_update_q8`` in
``repro/kernels/gwt_adam/ops.py``).

One call per ``(L, ...)`` bucket runs DWT -> Adam -> inverse -> limiter ->
parameter write, over f32 moments or over blocked-int8 moments that are
dequantized and requantized inside the call.  Dispatch depends only on the
device of ``g``: a CUDA tensor launches the hand-written kernel
(``kernel.py``), which updates ``p`` and the moments in place and raises on
anything it does not take; a CPU tensor takes the plain version
(``ref.py``), which returns new tensors.  The CUDA kernels take every
shape, so the TPU path's fallback to the oracle for shapes it cannot tile
has no counterpart here.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.kernels.gwt_adam import kernel, ref


def _step_scalars(step: torch.Tensor, lr_t: torch.Tensor, alpha: float,
                  weight_decay: float, b1: float, b2: float):
    """Bias-corrected step size and weight-decay coefficient as f32 device
    scalars, term for term as ``core.gwt._apply`` computes them."""
    t = step.float() + 1.0
    lr_mult = torch.sqrt(1 - b2 ** t) / (1 - b1 ** t)
    step_size = (lr_t * lr_mult * alpha).float()
    wd_coef = (lr_t * weight_decay).float()
    return step_size, wd_coef


def _rows(x: torch.Tensor) -> torch.Tensor:
    """A leaf stack ``(L, ..., n)`` as ``(L, rows, n)``.  The transform is
    per row and the limiter norm per leaf, so merging is exact, and the norm
    covers the whole stacked ``(layers, m, n)`` leaf.  A contiguous stack
    gives a view, so the kernel's in-place writes land in it."""
    return x.reshape(x.shape[0], -1, x.shape[-1])


def fused_row_block(m: int, n: int, level: int) -> int:
    """Row-stripe height of the plain version's norm: the JAX package's
    ``kernel.fused_row_block``, so both packages sum the norm alike."""
    row_bytes = (4 + 4 / (1 << level)) * n * 4
    bm = 8 if m % 8 == 0 else m
    while bm * 2 <= min(m, 1024) and m % (bm * 2) == 0 \
            and (bm * 2) * row_bytes <= 4 * 1024 * 1024:
        bm *= 2
    return bm


def q8_row_block(m: int, n: int, level: int, block: int) -> Optional[int]:
    """Row-stripe height of the q8 plain version's norm: the JAX package's
    ``kernel.q8_row_block`` (None where the TPU kernel cannot tile the
    shape and the JAX package sums the norm over all rows at once)."""
    na = n >> level
    if na == 0 or (m * na) % block != 0:
        return None
    step = block // math.gcd(na, block)
    best = None
    for bm in range(step, m + 1, step):
        if m % bm:
            continue
        if 4 * bm * n * 4 <= 4 * 1024 * 1024 or best is None:
            best = bm
        else:
            break
    return best


def _contiguous(**tensors) -> None:
    for name, t in tensors.items():
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous for the CUDA "
                             "kernel (it is updated in place)")


def fused_write_update(g: torch.Tensor, p: torch.Tensor, state: dict,
                       step: torch.Tensor, prev_norm: torch.Tensor, *,
                       lr_t: torch.Tensor, alpha: float, weight_decay: float,
                       gamma: float, use_limiter: bool, level: int,
                       b1: float = 0.9, b2: float = 0.999, eps: float = 1e-6):
    """One bucket: ``g``, ``p`` are ``(L, ..., n)`` leaf stacks, ``state``
    holds ``m``, ``v`` of shape ``(L, ..., n >> level)`` and ``prev_norm``
    is ``(L,)``.  Returns ``(new_p, new_norm, {"m": new_m, "v": new_v})``.
    On CUDA the returned ``new_p``, ``m`` and ``v`` are the input tensors,
    updated in place; all four inputs must then be contiguous."""
    m_st, v_st = state["m"], state["v"]
    if g.is_cuda:
        _contiguous(g=g, p=p, m=m_st, v=v_st)
    step_size, wd_coef = _step_scalars(step, lr_t, alpha, weight_decay,
                                       b1, b2)
    g3, p3, m3, v3 = _rows(g), _rows(p), _rows(m_st), _rows(v_st)
    _, mm, nn = g3.shape
    kw = dict(level=level, gamma=gamma, use_limiter=use_limiter,
              weight_decay=weight_decay != 0, b1=b1, b2=b2, eps=eps)
    if g.is_cuda:
        new_p, m, v, new_norm = kernel.gwt_adam_fused(
            g3, p3, m3, v3, prev_norm, step_size, wd_coef, **kw)
    else:
        new_p, m, v, new_norm = ref.gwt_adam_fused(
            g3, p3, m3, v3, prev_norm, step_size, wd_coef,
            bm=fused_row_block(mm, nn, level), **kw)
    return (new_p.reshape(p.shape), new_norm,
            {"m": m.reshape(m_st.shape), "v": v.reshape(v_st.shape)})


def fused_write_update_q8(g: torch.Tensor, p: torch.Tensor, state: dict,
                          step: torch.Tensor, salts: torch.Tensor,
                          prev_norm: torch.Tensor, *,
                          lr_t: torch.Tensor, alpha: float,
                          weight_decay: float, gamma: float,
                          use_limiter: bool, level: int, block: int = 64,
                          b1: float = 0.9, b2: float = 0.999,
                          eps: float = 1e-6):
    """One bucket over blocked-int8 moments.  ``state`` is the encoded
    layout ``{"m": {"q", "scale"}, "v": {"q", "scale"}}`` with ``q`` int8
    ``(L, ..., n >> level)`` and ``scale`` f32 ``(L, nb)``; ``salts``
    (integer ``(2, L)``, uint32 values) salt the rounding: row 0 is
    ``codec.slot_salt(key, step, 0, leaf_ids)`` for m, row 1 the same with
    slot 1 for v.  Returns
    ``(new_p, new_norm, new_state)`` in the encoded layout; on CUDA the
    returned ``new_p``, codes and scales are the input tensors, updated in
    place."""
    qm, sm = state["m"]["q"], state["m"]["scale"]
    qv, sv = state["v"]["q"], state["v"]["scale"]
    if g.is_cuda:
        _contiguous(g=g, p=p, qm=qm, sm=sm, qv=qv, sv=sv)
    step_size, wd_coef = _step_scalars(step, lr_t, alpha, weight_decay,
                                       b1, b2)
    g3, p3, qm3, qv3 = _rows(g), _rows(p), _rows(qm), _rows(qv)
    L, mm, nn = g3.shape
    kw = dict(level=level, block=block, gamma=gamma,
              use_limiter=use_limiter, weight_decay=weight_decay != 0,
              b1=b1, b2=b2, eps=eps)
    if g.is_cuda:
        s32 = salts.to(torch.uint32)
        new_p, qm2, sm2, qv2, sv2, new_norm = kernel.gwt_adam_fused_q8(
            g3, p3, qm3, sm, qv3, sv, s32[0], s32[1], prev_norm, step_size,
            wd_coef, **kw)
    else:
        bm = q8_row_block(mm, nn, level, block)
        new_p, qm2, sm2, qv2, sv2, new_norm = ref.gwt_adam_fused_q8(
            g3, p3, qm3, sm, qv3, sv, salts[0], salts[1], prev_norm,
            step_size, wd_coef, bm=mm if bm is None else bm, **kw)
    return (new_p.reshape(p.shape), new_norm,
            {"m": {"q": qm2.reshape(qm.shape), "scale": sm2},
             "v": {"q": qv2.reshape(qv.shape), "scale": sv2}})
