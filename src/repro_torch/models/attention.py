"""Attention, train mode (counterpart of ``repro/models/attention.py``):
GQA/MQA/MHA with QKV bias, QK-norm, a sliding window and a logit softcap,
over the reference's three compute routes chosen by static shape:

* direct (``_direct_attn``): the whole ``(S, T)`` score matrix, masked;
* block-local (``_local_block_attn``) for a sliding window when the length
  is a multiple of it: each window block attends itself and its
  predecessor, exact, O(S·2w);
* chunked (``_flash_attn``) past 8192 positions: an online softmax over
  ``(q_chunk, kv_chunk)`` score tiles.

Bidirectional attention (``bidirectional=True``, the encoder) takes the
direct route with nothing masked, or past 4096 positions the non-causal
chunked route (``_flash_attn_noncausal``, also the long cross-attention of
``models/encdec.py``).

The cached serving modes (``attn_apply(mode=...)``): ``prefill`` hands its
K/V over as a cache (a sliding window's ring buffer: the last ``window``
entries); ``decode`` writes one entry per step into a dense cache (ring
slot ``pos % size`` for a windowed block) and attends through
``_decode_attn_grouped``, the grouped ``(KV, G)`` product with no KV
repeat; with a ``page_table`` the cache is the shared page arena of
``repro_torch.serve.kv``, written in place, and ``decode`` and
``chunk_prefill`` mask each slot by its own length.

The arithmetic is the reference's, written as explicit torch ops (no fused
library attention): f32 scores from the operands, ``-1e30`` masking,
softmax in f32, the probabilities cast to ``v.dtype`` before the second
product.  K/V heads are repeated to the query heads before every train
route.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from repro_torch.distributed import tensor_parallel
from repro_torch.models import rope as rope_lib
from repro_torch.models.layers import Builder, rms_norm, softcap
from repro_torch.serve import kv as kv_lib

NEG_INF = -1e30


def attn_init(b: Builder, cfg, lead=()) -> dict:
    d, hd, H, KV = cfg.d_model, cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    p = {"wq": b.param((d, H * hd), ("embed", "heads"), lead=lead),
         "wk": b.param((d, KV * hd), ("embed", "kv_heads"), lead=lead),
         "wv": b.param((d, KV * hd), ("embed", "kv_heads"), lead=lead),
         "wo": b.param((H * hd, d), ("heads", "embed"), lead=lead)}
    if cfg.qkv_bias:
        p["bq"] = b.param((H * hd,), ("heads",), init="zeros", lead=lead)
        p["bk"] = b.param((KV * hd,), ("kv_heads",), init="zeros",
                           lead=lead)
        p["bv"] = b.param((KV * hd,), ("kv_heads",), init="zeros",
                           lead=lead)
    if cfg.qk_norm:
        p["q_norm"] = b.param((hd,), (None,), init="zeros", lead=lead)
        p["k_norm"] = b.param((hd,), (None,), init="zeros", lead=lead)
    return p


def _project(p, cfg, x, tp=None):
    """q (B,S,H,hd), k/v (B,S,KV,hd): the bias added before the reshape,
    the QK RMSNorm over ``head_dim`` after it.

    With ``tp`` (the heads split over the model axis) q is this rank's
    heads; k/v are its KV heads where those split too, else the range of
    whole KV heads its query heads read, cut from the replicated
    projection (``tensor_parallel.kv_heads_of``).  Replicated weights
    inside the region get their gradient summed over the group."""
    B, S, _ = x.shape
    hd = cfg.head_dim
    wk, wv, bk, bv = p["wk"], p["wv"], p.get("bk"), p.get("bv")
    q_norm, k_norm = p.get("q_norm"), p.get("k_norm")
    if tp is not None:
        x = tp.copy_in(x)
        if cfg.n_kv_heads % tp.size:
            lo, hi, _ = tensor_parallel.kv_heads_of(tp, cfg)
            wk, wv = (tp.copy_in(w)[..., lo * hd:hi * hd] for w in (wk, wv))
            if cfg.qkv_bias:
                bk, bv = (tp.copy_in(b)[lo * hd:hi * hd] for b in (bk, bv))
        if cfg.qk_norm:
            q_norm, k_norm = tp.copy_in(q_norm), tp.copy_in(k_norm)
    q = x @ p["wq"]
    k = x @ wk
    v = x @ wv
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + bk, v + bv
    q = q.reshape(B, S, -1, hd)
    k = k.reshape(B, S, -1, hd)
    v = v.reshape(B, S, -1, hd)
    if cfg.qk_norm:
        q = rms_norm(q, q_norm, cfg.norm_eps)
        k = rms_norm(k, k_norm, cfg.norm_eps)
    return q, k, v


def _repeat_kv(k: torch.Tensor, H: int,
               idx: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(B,T,KV,hd) -> (B,T,H,hd): replicate each KV head over its group;
    ``idx`` (H,) names each query head's KV head where the groups do not
    tile the local heads evenly (a tensor-parallel rank's)."""
    if idx is not None:
        return k.index_select(2, idx.to(k.device))
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


def _flash_attn_noncausal(q, k, v, *, q_chunk: int = 512,
                          kv_chunk: int = 2048, cap: float = 0.0):
    """Non-causal chunked attention (the encoder's self-attention and the
    decoder's cross-attention at long lengths): q chunks in turn, each an
    online softmax over the kv chunks.  q (B,Sq,H,hd); k/v (B,Skv,H,hd)
    (KV-repeated).  The chunks shrink to the lengths; where they do not
    divide them, the direct route with nothing masked."""
    B, Sq, H, hd = q.shape
    Skv = k.shape[1]
    q_chunk = min(q_chunk, Sq)
    kv_chunk = min(kv_chunk, Skv)
    if Sq % q_chunk or Skv % kv_chunk:
        return _direct_attn(q, k, v, causal_offset=int(1e9), window=0,
                            cap=cap)
    scale = 1.0 / math.sqrt(hd)
    dev = q.device
    outs = []
    for qi in range(Sq // q_chunk):
        qblk = q[:, qi * q_chunk:(qi + 1) * q_chunk]
        m = torch.full((B, H, q_chunk), NEG_INF, dtype=torch.float32,
                       device=dev)
        l = torch.zeros((B, H, q_chunk), dtype=torch.float32, device=dev)
        acc = torch.zeros((B, H, q_chunk, hd), dtype=torch.float32,
                          device=dev)
        for kj in range(Skv // kv_chunk):
            kblk = k[:, kj * kv_chunk:(kj + 1) * kv_chunk]
            vblk = v[:, kj * kv_chunk:(kj + 1) * kv_chunk]
            s = torch.einsum("bshd,bthd->bhst", qblk.float(),
                             kblk.float()) * scale
            s = softcap(s, cap) if cap else s
            m_new = torch.maximum(m, s.amax(-1))
            pmat = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + pmat.sum(-1)
            pv = torch.einsum("bhst,bthd->bhsd", pmat.to(vblk.dtype), vblk)
            acc = acc * corr[..., None] + pv.float()
            m = m_new
        outs.append(acc / torch.clamp(l[..., None], min=1e-30))
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


def _decode_attn_grouped(q, k, v, kv_valid, cap: float):
    """Attention of a few new positions against a cache, grouped: q
    (B,S,H,hd); k/v (B,T,KV,hd), NOT repeated to ``H`` heads; kv_valid
    (B,T).  The score buffer is f32 ``(B,KV,G,S,T)``.

    Past ``B = 16`` rows, when ``B`` is a multiple of 16 and ``T·B >=
    2^22``, the rows go in chunks of 16 to bound that buffer, chunk ``c``
    holding rows ``m·nb + c`` (the reference's interleaved scan order)."""
    B, S, Hq, hd = q.shape
    KV = k.shape[2]
    G = Hq // KV

    def attend(qb, kb, vb, validb):
        qg = qb.reshape(qb.shape[0], S, KV, G, hd)
        s = torch.einsum("bskgd,btkd->bkgst", qg.float(),
                         kb.float()) / math.sqrt(hd)
        s = softcap(s, cap) if cap else s
        s = torch.where(validb[:, None, None, None, :], s, NEG_INF)
        w = torch.softmax(s, dim=-1)
        return torch.einsum("bkgst,btkd->bskgd", w.to(vb.dtype), vb)

    chunk_b = 16
    if B > chunk_b and B % chunk_b == 0 and k.shape[1] * B >= 1 << 22:
        nb = B // chunk_b
        o = q.new_empty((B, S, KV, G, hd))
        for c in range(nb):
            o[c::nb] = attend(q[c::nb], k[c::nb], v[c::nb], kv_valid[c::nb])
    else:
        o = attend(q, k, v, kv_valid)
    return o.reshape(B, S, Hq, hd)


def attn_apply(p, cfg, x, cos, sin, *, local: bool = False,
               mode: str = "train", cache: Optional[dict] = None,
               pos=None, bidirectional: bool = False,
               page_table: Optional[torch.Tensor] = None, tp=None
               ) -> Tuple[torch.Tensor, Optional[dict]]:
    """Causal attention of ``x`` (B,S,d); ``local`` applies ``cfg.window``.
    Returns ``(output, new_cache)``; the cache is None in train mode.

    ``mode="train"`` takes the reference's train-mode dispatch: for a
    window shorter than ``S``, block-local where it divides ``S``, else
    direct masked; without one, chunked past 8192 positions, else direct.
    ``"prefill"`` computes the same and hands over ``{"k", "v"}`` (a
    windowed block's last ``window`` entries; ``S % window == 0`` when
    ``S > window``, so ring slot 0 is the oldest).  ``"decode"`` (S = 1)
    writes the step's K/V into ``cache`` in place at ``pos`` (a host int;
    ring slot ``pos % size`` for a windowed block) and attends the filled
    slots.

    With ``page_table`` (B, max_pages) the cache is the slot-paged arena
    (``repro_torch.serve.kv``) and ``pos`` a per-slot fill-level tensor
    (B,): ``"decode"`` writes each slot's entry to its page, ``"chunk_
    prefill"`` writes one slot's (1, C) chunk at positions ``pos[0] ..
    pos[0]+C-1`` and attends everything paged in before it; every read is
    masked by the slot's own length.  Windowed blocks have no paged layout.

    ``bidirectional`` (the encoder, train mode) masks nothing: the direct
    route, or past 4096 positions ``_flash_attn_noncausal``.

    ``tp`` (a ``distributed.tensor_parallel.TP``, train mode; None or a
    group that does not divide ``n_heads`` leaves the attention
    replicated): this rank's heads of ``wq``/``wk``/``wv``/``wo`` and their
    biases, the routes on the local heads unchanged, and the output
    projection's partial sums reduced over the model group.
    """
    tensor_parallel.train_only(tp, mode, "attention")
    tp, kv_split = tensor_parallel.heads_split(tp, cfg)
    if page_table is not None and local and cfg.window:
        raise NotImplementedError(
            "paged serving covers full-attention blocks only; the "
            "sliding-window ring-buffer layout has no page-table form")
    if mode not in ("train", "prefill", "decode", "chunk_prefill"):
        raise ValueError(f"attention mode {mode!r}")
    B, S, _ = x.shape
    window = cfg.window if local else 0
    cap = cfg.attn_softcap
    q, k, v = _project(p, cfg, x, tp)
    H = q.shape[2]   # this rank's heads under tp
    kv_idx = None if tp is None or kv_split \
        else tensor_parallel.kv_heads_of(tp, cfg)[2]
    q = rope_lib.apply_rope(q, cos, sin)
    k = rope_lib.apply_rope(k, cos, sin)

    new_cache = None
    if mode == "decode" and page_table is not None:
        if cache is None or S != 1:
            raise ValueError("paged decode takes one token per slot and "
                             "the page arena")
        P = kv_lib.page_size(cache["k"])
        page, off = kv_lib.token_dest(page_table, pos, P)
        kv_lib.write(cache["k"], page, off, k[:, 0])
        kv_lib.write(cache["v"], page, off, v[:, 0])
        ck = kv_lib.gather(cache["k"], page_table, q.dtype)
        cv = kv_lib.gather(cache["v"], page_table, q.dtype)
        valid = torch.arange(ck.shape[1], device=x.device)[None, :] \
            <= pos[:, None]
        o = _decode_attn_grouped(q, ck, cv, valid, cap)
        new_cache = cache
    elif mode == "chunk_prefill":
        if cache is None or page_table is None or B != 1:
            raise ValueError("chunk_prefill is the paged engine's one-slot "
                             "prompt step")
        P = kv_lib.page_size(cache["k"])
        page, off = kv_lib.chunk_dest(page_table[0], pos[0], S, P)
        kv_lib.write(cache["k"], page, off, k[0])
        kv_lib.write(cache["v"], page, off, v[0])
        ck = kv_lib.gather(cache["k"], page_table, q.dtype)
        cv = kv_lib.gather(cache["v"], page_table, q.dtype)
        # entries past this chunk's last write are other slots' trash
        valid = torch.arange(ck.shape[1], device=x.device)[None, :] \
            <= pos[:, None] + (S - 1)
        o = _direct_attn(q, _repeat_kv(ck, H), _repeat_kv(cv, H),
                         causal_offset=pos[0], window=0, cap=cap,
                         kv_valid=valid)
        new_cache = cache
    elif mode == "decode":
        if cache is None or S != 1:
            raise ValueError("decode takes one token and a cache")
        size = cache["k"].shape[1]
        slot = pos % size if window else pos
        cache["k"][:, slot] = k[:, 0]
        cache["v"][:, slot] = v[:, 0]
        valid = torch.arange(size, device=x.device) <= min(pos, size - 1)
        o = _decode_attn_grouped(q, cache["k"], cache["v"],
                                 valid.expand(B, size), cap)
        new_cache = cache
    else:
        kr, vr = _repeat_kv(k, H, kv_idx), _repeat_kv(v, H, kv_idx)
        if bidirectional:
            if S > 4096:
                o = _flash_attn_noncausal(q, kr, vr, cap=cap)
            else:
                o = _direct_attn(q, kr, vr, causal_offset=int(1e9),
                                 window=0, cap=cap)
        elif window and S > window and S % window == 0:
            o = _local_block_attn(q, kr, vr, window=window, cap=cap)
        elif window and S > window:
            o = _direct_attn(q, kr, vr, causal_offset=0, window=window,
                             cap=cap)
        elif S > 8192:
            o = _flash_attn(q, kr, vr, cap=cap)
        else:
            o = _direct_attn(q, kr, vr, causal_offset=0, window=window,
                             cap=cap)
        if mode == "prefill":
            if window and S > window:
                if S % window:
                    raise ValueError(
                        f"prefill of {S} positions cannot hand over a ring "
                        f"buffer of window {window}: decode writes slot "
                        f"pos % window, so S must be a multiple of it")
                new_cache = {"k": k[:, -window:], "v": v[:, -window:]}
            else:
                new_cache = {"k": k, "v": v}
    o = o.reshape(B, S, H * cfg.head_dim) @ p["wo"]
    return (o if tp is None else tp.reduce_out(o)), new_cache
