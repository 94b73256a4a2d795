"""Attention, train mode (counterpart of ``repro/models/attention.py``):
GQA/MQA/MHA with QKV bias, QK-norm, a sliding window and a logit softcap,
over the reference's three compute routes chosen by static shape:

* direct (``_direct_attn``): the whole ``(S, T)`` score matrix, masked;
* block-local (``_local_block_attn``) for a sliding window when the length
  is a multiple of it: each window block attends itself and its
  predecessor, exact, O(S·2w);
* chunked (``_flash_attn``) past 8192 positions: an online softmax over
  ``(q_chunk, kv_chunk)`` score tiles.

The arithmetic is the reference's, written as explicit torch ops (no fused
library attention): f32 scores from the operands, ``-1e30`` masking,
softmax in f32, the probabilities cast to ``v.dtype`` before the second
product.  K/V heads are repeated to the query heads before every route.
The cached serving modes and bidirectional attention are not ported.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.models import rope as rope_lib
from repro_torch.models.layers import Builder, rms_norm, softcap

NEG_INF = -1e30


def attn_init(b: Builder, cfg, lead=()) -> dict:
    d, hd, H, KV = cfg.d_model, cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    p = {"wq": b.param((d, H * hd), lead=lead),
         "wk": b.param((d, KV * hd), lead=lead),
         "wv": b.param((d, KV * hd), lead=lead),
         "wo": b.param((H * hd, d), lead=lead)}
    if cfg.qkv_bias:
        p["bq"] = b.param((H * hd,), init="zeros", lead=lead)
        p["bk"] = b.param((KV * hd,), init="zeros", lead=lead)
        p["bv"] = b.param((KV * hd,), init="zeros", lead=lead)
    if cfg.qk_norm:
        p["q_norm"] = b.param((hd,), init="zeros", lead=lead)
        p["k_norm"] = b.param((hd,), init="zeros", lead=lead)
    return p


def _project(p, cfg, x):
    """q (B,S,H,hd), k/v (B,S,KV,hd): the bias added before the reshape,
    the QK RMSNorm over ``head_dim`` after it."""
    B, S, _ = x.shape
    hd, H, KV = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = q.reshape(B, S, H, hd)
    k = k.reshape(B, S, KV, hd)
    v = v.reshape(B, S, KV, hd)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    return q, k, v


def _repeat_kv(k: torch.Tensor, H: int) -> torch.Tensor:
    """(B,T,KV,hd) -> (B,T,H,hd): replicate each KV head over its group."""
    KV = k.shape[2]
    if KV == H:
        return k
    return torch.repeat_interleave(k, H // KV, dim=2)


def _direct_attn(q, k, v, *, causal_offset: int, window: int, cap: float,
                 kv_valid: Optional[torch.Tensor] = None):
    """Direct route.  q (B,Sq,H,hd); k/v (B,T,H,hd) (already KV-repeated).

    Query position i (global ``i + causal_offset``) may attend key position
    t iff ``t <= i + causal_offset`` and (window) ``t > i + offset -
    window``.  ``kv_valid`` (B,T) optionally masks key slots."""
    _, Sq, _, hd = q.shape
    T = k.shape[1]
    s = torch.einsum("bshd,bthd->bhst", q.float(), k.float()) / math.sqrt(hd)
    s = softcap(s, cap) if cap else s
    qpos = torch.arange(Sq, device=q.device)[:, None] + causal_offset
    tpos = torch.arange(T, device=q.device)[None, :]
    mask = tpos <= qpos                                  # (Sq, T)
    if window:
        mask = mask & (tpos > qpos - window)
    if kv_valid is not None:
        mask = mask[None, None] & kv_valid[:, None, None, :]
    else:
        mask = mask[None, None]
    s = torch.where(mask, s, NEG_INF)
    w = torch.softmax(s, dim=-1)
    return torch.einsum("bhst,bthd->bshd", w.to(v.dtype), v)


def _flash_attn(q, k, v, *, q_chunk: int = 512, kv_chunk: int = 2048,
                cap: float = 0.0):
    """Causal chunked attention: q chunks in turn, each an online softmax
    over the kv chunks.  Exact; the score tile is ``(q_chunk, kv_chunk)``.
    q/k/v (B,S,H,hd) (KV-repeated); ``S`` must be a multiple of both
    chunks."""
    B, S, H, hd = q.shape
    if S % q_chunk or S % kv_chunk:
        raise ValueError(f"_flash_attn: S={S} is not a multiple of "
                         f"q_chunk={q_chunk} and kv_chunk={kv_chunk}")
    scale = 1.0 / math.sqrt(hd)
    dev = q.device
    outs = []
    for qi in range(S // q_chunk):
        qblk = q[:, qi * q_chunk:(qi + 1) * q_chunk]
        qpos = qi * q_chunk + torch.arange(q_chunk, device=dev)[:, None]
        m = torch.full((B, H, q_chunk), NEG_INF, dtype=torch.float32,
                       device=dev)
        l = torch.zeros((B, H, q_chunk), dtype=torch.float32, device=dev)
        acc = torch.zeros((B, H, q_chunk, hd), dtype=torch.float32,
                          device=dev)
        for kj in range(S // kv_chunk):
            kblk = k[:, kj * kv_chunk:(kj + 1) * kv_chunk]
            vblk = v[:, kj * kv_chunk:(kj + 1) * kv_chunk]
            s = torch.einsum("bshd,bthd->bhst", qblk.float(),
                             kblk.float()) * scale
            s = softcap(s, cap) if cap else s
            tpos = kj * kv_chunk + torch.arange(kv_chunk, device=dev)[None, :]
            s = torch.where(tpos <= qpos, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(-1))
            pmat = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + pmat.sum(-1)
            pv = torch.einsum("bhst,bthd->bhsd", pmat.to(vblk.dtype), vblk)
            acc = acc * corr[..., None] + pv.float()
            m = m_new
        outs.append(acc / torch.clamp(l[..., None], min=1e-30))
    # nq x (B,H,q_chunk,hd) -> (B,S,H,hd)
    out = torch.cat(outs, dim=2).transpose(1, 2)
    return out.to(q.dtype)


def _local_block_attn(q, k, v, *, window: int, cap: float):
    """Exact sliding-window attention: block i attends blocks {i-1, i}.
    q/k/v (B,S,H,hd) (KV-repeated); ``S`` a multiple of ``window``."""
    B, S, H, hd = q.shape
    if S % window:
        raise ValueError(f"_local_block_attn: S={S} is not a multiple of "
                         f"window={window}")
    nb = S // window
    scale = 1.0 / math.sqrt(hd)
    qb = q.reshape(B, nb, window, H, hd)
    kb = k.reshape(B, nb, window, H, hd)
    vb = v.reshape(B, nb, window, H, hd)
    kprev = torch.cat([torch.zeros_like(kb[:, :1]), kb[:, :-1]], dim=1)
    vprev = torch.cat([torch.zeros_like(vb[:, :1]), vb[:, :-1]], dim=1)
    k2 = torch.cat([kprev, kb], dim=2)                   # (B,nb,2w,H,hd)
    v2 = torch.cat([vprev, vb], dim=2)
    s = torch.einsum("bnshd,bnthd->bnhst", qb.float(), k2.float()) * scale
    s = softcap(s, cap) if cap else s
    dev = q.device
    qpos = torch.arange(window, device=dev)[:, None] + window  # in 2w frame
    tpos = torch.arange(2 * window, device=dev)[None, :]
    mask = (tpos <= qpos) & (tpos > qpos - window)
    first = (torch.arange(nb, device=dev) == 0)[:, None, None]
    mask = mask[None] & ~(first & (tpos[None] < window))   # (nb, w, 2w)
    s = torch.where(mask[None, :, None, :, :], s, NEG_INF)
    w = torch.softmax(s, dim=-1)
    o = torch.einsum("bnhst,bnthd->bnshd", w.to(v2.dtype), v2)
    return o.reshape(B, S, H, hd)


def attn_apply(p, cfg, x, cos, sin, *, local: bool = False,
               mode: str = "train", bidirectional: bool = False,
               page_table: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Train-mode causal attention of ``x`` (B,S,d); ``local`` applies
    ``cfg.window``.  The route is the reference's train-mode dispatch: for
    a window shorter than ``S``, block-local where it divides ``S``, else
    direct masked; without one, chunked past 8192 positions, else direct.
    """
    if mode != "train" or page_table is not None:
        raise NotImplementedError(
            f"attention mode {mode!r} (page table: {page_table is not None})"
            ": the cached serving modes (prefill, decode, chunk_prefill, "
            "paged) wait for ROADMAP Queue 1 item 4")
    if bidirectional:
        raise NotImplementedError(
            "bidirectional attention (the encoder-decoder substrate) waits "
            "for ROADMAP Queue 1 item 5")
    B, S, _ = x.shape
    H = cfg.n_heads
    window = cfg.window if local else 0
    cap = cfg.attn_softcap
    q, k, v = _project(p, cfg, x)
    q = rope_lib.apply_rope(q, cos, sin)
    k = rope_lib.apply_rope(k, cos, sin)
    k, v = _repeat_kv(k, H), _repeat_kv(v, H)
    if window and S > window and S % window == 0:
        o = _local_block_attn(q, k, v, window=window, cap=cap)
    elif window and S > window:
        o = _direct_attn(q, k, v, causal_offset=0, window=window, cap=cap)
    elif S > 8192:
        o = _flash_attn(q, k, v, cap=cap)
    else:
        o = _direct_attn(q, k, v, causal_offset=0, window=window, cap=cap)
    return o.reshape(B, S, H * cfg.head_dim) @ p["wo"]
