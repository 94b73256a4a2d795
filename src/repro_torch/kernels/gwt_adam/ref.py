"""Plain PyTorch version of the fused GWT-Adam update (counterpart of
``repro/kernels/gwt_adam/ref.py``).

The CPU path runs it, and ``chip_smoke.py`` holds the CUDA kernel against
it on the card.  It rounds where the kernel rounds; the only sum whose order
matters, the per-leaf norm, is taken as one sum per ``(bm, n)`` row stripe
with the stripes added left to right, as the JAX oracle does.
"""

from __future__ import annotations

from typing import List, Tuple

import torch

from repro_torch.core import haar
from repro_torch.core.limiter import limiter_scale


def gwt_adam_tile(g: torch.Tensor, m_st: torch.Tensor, v_st: torch.Tensor,
                  *, level: int, b1: float = 0.9, b2: float = 0.999,
                  eps: float = 1e-6
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """DWT -> Adam on ``A_l`` -> scaled details -> inverse, over any
    leading dims.  Returns ``(G̃ in g's dtype, m', v')``."""
    g32 = g.float()
    a, details = haar.haar_forward(g32, level)
    m = b1 * m_st.float() + (1 - b1) * a
    v = b2 * v_st.float() + (1 - b2) * a * a
    inv_denom = 1.0 / (torch.sqrt(v) + eps)
    a_t = m * inv_denom
    tilde_d: List[torch.Tensor] = [
        d * haar.detail_scale_upsample(inv_denom, level, level - i)
        for i, d in enumerate(details)]
    gt = haar.haar_inverse(a_t, tilde_d).to(g.dtype)
    return gt, m.to(m_st.dtype), v.to(v_st.dtype)


def _tiled_norm(gt: torch.Tensor, bm: int) -> torch.Tensor:
    """Per-leaf ``‖gt‖`` of an ``(L, m, n)`` stack: one sum per ``(bm, n)``
    row stripe, stripes added sequentially."""
    L, mm, n = gt.shape
    xr = gt.float()
    parts = (xr * xr).reshape(L, mm // bm, bm * n).sum(-1)
    acc = parts[:, 0]
    for k in range(1, mm // bm):
        acc = acc + parts[:, k]
    return torch.sqrt(acc)


def gwt_adam_fused(g: torch.Tensor, p: torch.Tensor, m_st: torch.Tensor,
                   v_st: torch.Tensor, prev_norm: torch.Tensor,
                   step_size: torch.Tensor, wd_coef: torch.Tensor, *,
                   level: int, gamma: float, use_limiter: bool,
                   weight_decay: bool, bm: int, b1: float = 0.9,
                   b2: float = 0.999, eps: float = 1e-6):
    """Fused-write update over an ``(L, m, n)`` bucket.  Returns new tensors
    ``(new_p, new_m, new_v, new_norm)`` with ``new_norm`` f32 ``(L,)``."""
    gt, m, v = gwt_adam_tile(g, m_st, v_st, level=level, b1=b1, b2=b2,
                             eps=eps)
    if use_limiter:
        norm = _tiled_norm(gt, bm)
        scale = limiter_scale(norm, prev_norm, gamma)
        new_norm = torch.where(norm > 0, norm * scale, prev_norm)
    else:
        scale = torch.ones_like(prev_norm)
        new_norm = prev_norm.clone()
    limited = gt * scale.to(gt.dtype)[:, None, None]
    p32 = p.float()
    new_p = p32 - step_size * limited.float()
    if weight_decay:
        new_p = new_p - wd_coef * p32
    return new_p.to(p.dtype), m, v, new_norm
