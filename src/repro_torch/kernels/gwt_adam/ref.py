"""Plain PyTorch versions of the GWT-Adam updates, staged (K4, K5) and
fused-write (K1, K2), over f32 and over blocked-int8 moments (counterpart
of ``repro/kernels/gwt_adam/ref.py``).

The CPU path runs them, and ``chip_smoke.py`` holds the CUDA kernels against
them on the card.  They round where the kernels round (the square root
included: :func:`_sqrt`); the only sum whose
order matters, the per-leaf norm, is taken as one sum per ``(bm, n)`` row
stripe with the stripes added left to right, as the JAX oracle does.
"""

from __future__ import annotations

from typing import List, Tuple

import torch

from repro_torch.core import haar
from repro_torch.core.limiter import limiter_scale
from repro_torch.optim import codec


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded f32 square root, as the kernels' ``__fsqrt_rn``
    and the JAX package's give it.  torch's vectorised f32 ``sqrt`` on the
    CPU is not correctly rounded (about 0.7% of inputs land one spacing
    off); the f64 root rounded to f32 is, since 53 >= 2 * 24 + 2 bits."""
    return torch.sqrt(x.double()).float()


def gwt_adam_tile(g: torch.Tensor, m_st: torch.Tensor, v_st: torch.Tensor,
                  *, level: int, b1: float = 0.9, b2: float = 0.999,
                  eps: float = 1e-6
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                             torch.Tensor]:
    """DWT -> Adam on ``A_l`` -> scaled details -> inverse, over any
    leading dims (the plain version of K4).  Returns ``(G̃ in g's dtype,
    m', v', ssq)``: ``ssq`` is f32 ``‖G̃‖²`` of the rounded G̃ summed over
    the last two axes, one per leaf of a ``(L, m, n)`` stack."""
    g32 = g.float()
    a, details = haar.haar_forward(g32, level)
    m = b1 * m_st.float() + (1 - b1) * a
    v = b2 * v_st.float() + (1 - b2) * a * a
    inv_denom = 1.0 / (_sqrt(v) + eps)
    a_t = m * inv_denom
    tilde_d: List[torch.Tensor] = [
        d * haar.detail_scale_upsample(inv_denom, level, level - i)
        for i, d in enumerate(details)]
    gt = haar.haar_inverse(a_t, tilde_d).to(g.dtype)
    gr = gt.float()
    ssq = (gr * gr).sum((-2, -1))
    return gt, m.to(m_st.dtype), v.to(v_st.dtype), ssq


def gwt_adam_tile_q8(g: torch.Tensor, qm: torch.Tensor, sm: torch.Tensor,
                     qv: torch.Tensor, sv: torch.Tensor,
                     salt_m: torch.Tensor, salt_v: torch.Tensor, *,
                     level: int, block: int, b1: float = 0.9,
                     b2: float = 0.999, eps: float = 1e-6):
    """:func:`gwt_adam_tile` over blocked-int8 moments of an ``(L, m, n)``
    stack (the plain version of K5).  ``qm``, ``qv``: int8 ``(L, m,
    n >> level)``; ``sm``, ``sv``: f32 ``(L, nb)``, one scale per ``block``
    flat coefficients of each leaf; ``salt_m``, ``salt_v``: ``(L,)``
    per-leaf slot salts.  Dequantize, update, then requantize each leaf's
    new moments in flat blocks with ``u = uniform01(salt, flat index)``.
    Returns new tensors ``(G̃, qm', sm', qv', sv', ssq)``."""
    L = g.shape[0]
    flat = lambda a: a.reshape(L, -1)
    m_st = codec.dequant_blocks(flat(qm), sm, block).reshape(qm.shape)
    v_st = codec.dequant_blocks(flat(qv), sv, block).reshape(qv.shape)
    gt, m, v, ssq = gwt_adam_tile(g, m_st, v_st, level=level, b1=b1, b2=b2,
                                  eps=eps)
    qm2, sm2 = codec.quant_blocks(flat(m), salt_m, block)
    qv2, sv2 = codec.quant_blocks(flat(v), salt_v, block)
    return (gt, qm2.reshape(qm.shape), sm2, qv2.reshape(qv.shape), sv2,
            ssq)


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


def _limit_write(gt, p, prev_norm, step_size, wd_coef, *, gamma,
                 use_limiter, weight_decay, bm):
    """Limiter -> bias-corrected step -> weight decay -> parameter write
    over an ``(L, m, n)`` bucket.  Returns ``(new_p, new_norm)``."""
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
    return new_p.to(p.dtype), new_norm


def gwt_adam_fused(g: torch.Tensor, p: torch.Tensor, m_st: torch.Tensor,
                   v_st: torch.Tensor, prev_norm: torch.Tensor,
                   step_size: torch.Tensor, wd_coef: torch.Tensor, *,
                   level: int, gamma: float, use_limiter: bool,
                   weight_decay: bool, bm: int, b1: float = 0.9,
                   b2: float = 0.999, eps: float = 1e-6):
    """Fused-write update over an ``(L, m, n)`` bucket.  Returns new tensors
    ``(new_p, new_m, new_v, new_norm)`` with ``new_norm`` f32 ``(L,)``."""
    gt, m, v, _ = gwt_adam_tile(g, m_st, v_st, level=level, b1=b1, b2=b2,
                                eps=eps)
    new_p, new_norm = _limit_write(
        gt, p, prev_norm, step_size, wd_coef, gamma=gamma,
        use_limiter=use_limiter, weight_decay=weight_decay, bm=bm)
    return new_p, m, v, new_norm


def gwt_adam_fused_q8(g: torch.Tensor, p: torch.Tensor, qm: torch.Tensor,
                      sm: torch.Tensor, qv: torch.Tensor, sv: torch.Tensor,
                      salt_m: torch.Tensor, salt_v: torch.Tensor,
                      prev_norm: torch.Tensor, step_size: torch.Tensor,
                      wd_coef: torch.Tensor, *, level: int, block: int,
                      gamma: float, use_limiter: bool, weight_decay: bool,
                      bm: int, b1: float = 0.9, b2: float = 0.999,
                      eps: float = 1e-6):
    """Fused-write update over blocked-int8 moments (counterpart of the
    JAX ``ref.gwt_adam_fused_q8``).  ``qm``, ``qv``: int8 ``(L, m,
    n >> level)``; ``sm``, ``sv``: f32 ``(L, nb)``, one scale per
    ``block`` flat coefficients of each leaf; ``salt_m``, ``salt_v``:
    ``(L,)`` per-leaf slot salts.  Returns new tensors ``(new_p, qm', sm',
    qv', sv', new_norm)``.

    :func:`gwt_adam_tile_q8`, then the limiter and the write; the norm is
    summed per ``(bm, n)`` row stripe as for the f32 version."""
    gt, qm2, sm2, qv2, sv2, _ = gwt_adam_tile_q8(
        g, qm, sm, qv, sv, salt_m, salt_v, level=level, block=block, b1=b1,
        b2=b2, eps=eps)
    new_p, new_norm = _limit_write(
        gt, p, prev_norm, step_size, wd_coef, gamma=gamma,
        use_limiter=use_limiter, weight_decay=weight_decay, bm=bm)
    return new_p, qm2, sm2, qv2, sv2, new_norm
