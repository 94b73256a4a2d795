"""Plain PyTorch versions of the GWT-Adam updates, staged (K4, K5) and
fused-write (K1, K2), over f32 and over blocked-int8 moments (counterpart
of ``repro/kernels/gwt_adam/ref.py``).

The CPU path runs them, and ``chip_smoke.py`` holds the CUDA kernels against
them on the card, bitwise.  They round where the kernels round (the square
root included: :func:`_sqrt`), and the only sums whose order matters, the
per-leaf ``‖G̃‖²``, are added in the kernels' order (:func:`chunk_ssq`,
:func:`leaf_ssq`) with element-wise tensor adds only, so the CPU and the
card give the same bits.
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


# the kernels' chunk: 8 rounds of 256 threads, one coefficient each
# (kThreads, kPerThread, kChunk of gwt_adam_common.cuh)
THREADS, PER_THREAD = 256, 8
CHUNK = THREADS * PER_THREAD


def _shfl_down_tree(acc: torch.Tensor) -> torch.Tensor:
    """Lane 0 of a warp's ``__shfl_down_sync`` sum over the last axis (32
    lanes): at offsets 16, 8, 4, 2, 1 lane i adds lane i + offset.  Only
    the lanes below the offset feed lane 0, so each step keeps those."""
    for off in (16, 8, 4, 2, 1):
        acc = acc[..., :off] + acc[..., off:2 * off]
    return acc[..., 0]


def chunk_ssq(gt: torch.Tensor, level: int) -> torch.Tensor:
    """The ``(L, ceil(na / 2048))`` f32 ``‖G̃‖²`` partials of a rounded G̃
    stack ``(L, ..., n)``, ``na = numel / L / 2^level`` coefficients per
    leaf, bit for bit as the kernels compute them: thread t of chunk s
    adds, for k = 0..7, the 2^level squares of coefficient
    ``2048 s + t + 256 k`` in order to an f32 sum from 0 (coefficients past
    ``na`` add nothing); each warp adds its lanes by the ``__shfl_down``
    tree; the 8 warp sums are added in order from 0."""
    L, B = gt.shape[0], 1 << level
    r = gt.reshape(L, -1, B).float()
    na = r.shape[1]
    S = -(-na // CHUNK)
    sq = torch.zeros(L, S * CHUNK, B, dtype=torch.float32, device=gt.device)
    sq[:, :na] = r * r
    sq = sq.reshape(L, S, PER_THREAD, THREADS, B)
    acc = torch.zeros(L, S, THREADS, dtype=torch.float32, device=gt.device)
    for k in range(PER_THREAD):
        for e in range(B):
            acc = acc + sq[:, :, k, :, e]
    warps = _shfl_down_tree(acc.reshape(L, S, THREADS // 32, 32))
    total = torch.zeros(L, S, dtype=torch.float32, device=gt.device)
    for w in range(THREADS // 32):
        total = total + warps[:, :, w]
    return total


def leaf_ssq(partials: torch.Tensor) -> torch.Tensor:
    """Each leaf's ``‖G̃‖²`` from its ``(L, S)`` partials, added as the
    kernels' ``leaf_scale_at`` adds them: lane i adds partials i, i + 32,
    ... in order from 0, then the 32 lane sums by the ``__shfl_down``
    tree."""
    L, S = partials.shape
    pad = torch.zeros(L, 32 * max(1, -(-S // 32)), dtype=torch.float32,
                      device=partials.device)
    pad[:, :S] = partials
    pad = pad.reshape(L, -1, 32)
    acc = torch.zeros(L, 32, dtype=torch.float32, device=partials.device)
    for i in range(pad.shape[1]):
        acc = acc + pad[:, i]
    return _shfl_down_tree(acc)


def leaf_norm(partials: torch.Tensor) -> torch.Tensor:
    """Each leaf's ``‖G̃‖`` from its partials: :func:`leaf_ssq`, then the
    correctly rounded root, as the kernels' ``__fsqrt_rn``."""
    return _sqrt(leaf_ssq(partials))


def gwt_adam_tile(g: torch.Tensor, m_st: torch.Tensor, v_st: torch.Tensor,
                  *, level: int, b1: float = 0.9, b2: float = 0.999,
                  eps: float = 1e-6
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                             torch.Tensor]:
    """DWT -> Adam on ``A_l`` -> scaled details -> inverse, over any
    leading dims (the plain version of K4).  Returns ``(G̃ in g's dtype,
    m', v', ssq)``: ``ssq`` is f32 ``‖G̃‖²`` of the rounded G̃, one per leaf
    (the first axis), summed in the kernels' order (:func:`chunk_ssq`,
    then :func:`leaf_ssq`)."""
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
    ssq = leaf_ssq(chunk_ssq(gt, level))
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


def _limit_write(gt, p, prev_norm, step_size, wd_coef, *, level, gamma,
                 use_limiter, weight_decay):
    """Limiter -> bias-corrected step -> weight decay -> parameter write
    over an ``(L, m, n)`` bucket.  Returns ``(new_p, new_norm)``."""
    if use_limiter:
        norm = leaf_norm(chunk_ssq(gt, level))
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
                   weight_decay: bool, b1: float = 0.9,
                   b2: float = 0.999, eps: float = 1e-6):
    """Fused-write update over an ``(L, m, n)`` bucket.  Returns new tensors
    ``(new_p, new_m, new_v, new_norm)`` with ``new_norm`` f32 ``(L,)``."""
    gt, m, v, _ = gwt_adam_tile(g, m_st, v_st, level=level, b1=b1, b2=b2,
                                eps=eps)
    new_p, new_norm = _limit_write(
        gt, p, prev_norm, step_size, wd_coef, gamma=gamma,
        level=level, use_limiter=use_limiter, weight_decay=weight_decay)
    return new_p, m, v, new_norm


def gwt_adam_fused_q8(g: torch.Tensor, p: torch.Tensor, qm: torch.Tensor,
                      sm: torch.Tensor, qv: torch.Tensor, sv: torch.Tensor,
                      salt_m: torch.Tensor, salt_v: torch.Tensor,
                      prev_norm: torch.Tensor, step_size: torch.Tensor,
                      wd_coef: torch.Tensor, *, level: int, block: int,
                      gamma: float, use_limiter: bool, weight_decay: bool,
                      b1: float = 0.9, b2: float = 0.999,
                      eps: float = 1e-6):
    """Fused-write update over blocked-int8 moments (counterpart of the
    JAX ``ref.gwt_adam_fused_q8``).  ``qm``, ``qv``: int8 ``(L, m,
    n >> level)``; ``sm``, ``sv``: f32 ``(L, nb)``, one scale per
    ``block`` flat coefficients of each leaf; ``salt_m``, ``salt_v``:
    ``(L,)`` per-leaf slot salts.  Returns new tensors ``(new_p, qm', sm',
    qv', sv', new_norm)``.

    :func:`gwt_adam_tile_q8`, then the limiter and the write, as for the
    f32 version."""
    gt, qm2, sm2, qv2, sv2, _ = gwt_adam_tile_q8(
        g, qm, sm, qv, sv, salt_m, salt_v, level=level, block=block, b1=b1,
        b2=b2, eps=eps)
    new_p, new_norm = _limit_write(
        gt, p, prev_norm, step_size, wd_coef, gamma=gamma,
        level=level, use_limiter=use_limiter, weight_decay=weight_decay)
    return new_p, qm2, sm2, qv2, sv2, new_norm
