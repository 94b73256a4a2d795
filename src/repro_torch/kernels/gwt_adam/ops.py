"""Entry point of the fused-write GWT-Adam update (counterpart of
``fused_write_update`` in ``repro/kernels/gwt_adam/ops.py``).

One call per ``(L, ...)`` bucket runs DWT -> Adam -> inverse -> limiter ->
parameter write.  Dispatch depends only on the device of ``g``: a CUDA
tensor launches the hand-written kernel (``kernel.py``), which updates
``p``, ``m`` and ``v`` in place and raises on anything it does not take; a
CPU tensor takes the plain version (``ref.py``), which returns new tensors.
"""

from __future__ import annotations

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
        for name, t in (("g", g), ("p", p), ("m", m_st), ("v", v_st)):
            if not t.is_contiguous():
                raise ValueError(f"{name} must be contiguous for the CUDA "
                                 "kernel (it is updated in place)")
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
