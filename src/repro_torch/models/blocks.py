"""Layer block (counterpart of ``repro/models/blocks.py``): a mixer
(``"attn"``, ``"attn_local"`` with the sliding window, ``"mamba"``,
``"mlstm"`` or ``"slstm"``) and the FFN, with pre-norms and residuals: the
MoE (``models/moe.py``) for a kind with the ``"+moe"`` suffix
(``"mamba+moe"``), else the MLP where ``cfg.d_ff > 0``, else none (xLSTM);
and the block's serving caches, dense (``block_cache``: K/V for attention,
the recurrent state for the others) or paged (``block_paged_cache``,
attention blocks only)."""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.distributed import tensor_parallel
from repro_torch.models import attention, moe as moe_lib, ssm, xlstm
from repro_torch.models.layers import Builder, mlp_apply, mlp_init, rms_norm

ATTENTION_KINDS = ("attn", "attn_local")
RECURRENT_KINDS = ("mamba", "mlstm", "slstm")
_INIT = {"mamba": ssm.mamba_init, "mlstm": xlstm.mlstm_init,
         "slstm": xlstm.slstm_init}
_APPLY = {"mamba": ssm.mamba_apply, "mlstm": xlstm.mlstm_apply,
          "slstm": xlstm.slstm_apply}
_CACHE = {"mamba": ssm.mamba_cache, "mlstm": xlstm.mlstm_cache,
          "slstm": xlstm.slstm_cache}


def parse_kind(kind: str) -> Tuple[str, bool]:
    """``"mamba+moe"`` -> ``("mamba", True)``."""
    base, *mods = kind.split("+")
    return base, "moe" in mods


def _check_kind(kind: str) -> Tuple[str, bool]:
    base, use_moe = parse_kind(kind)
    if base not in ATTENTION_KINDS + RECURRENT_KINDS:
        raise ValueError(f"unknown block kind {base!r}")
    return base, use_moe


def block_init(b: Builder, cfg, kind: str, lead=()) -> dict:
    base, use_moe = _check_kind(kind)
    d = cfg.d_model
    p = {"norm1": b.param((d,), (None,), init="zeros", lead=lead)}
    if base in ATTENTION_KINDS:
        p["mixer"] = attention.attn_init(b, cfg, lead=lead)
    else:
        p["mixer"] = _INIT[base](b, cfg, lead=lead)
    if use_moe:
        p["norm2"] = b.param((d,), (None,), init="zeros", lead=lead)
        p["ffn"] = moe_lib.moe_init(b, cfg, lead=lead)
    elif cfg.d_ff > 0:
        p["norm2"] = b.param((d,), (None,), init="zeros", lead=lead)
        p["ffn"] = mlp_init(b, d, cfg.d_ff, lead=lead)
    return p


def block_apply(p, cfg, kind: str, x, cos, sin, *, mode: str = "train",
                cache: Optional[dict] = None, pos=None, page_table=None,
                tp=None):
    """Returns ``(x, new_mixer_cache, aux)``; the cache is None in train
    mode (see ``attention.attn_apply`` and the recurrent mixers' ``*_apply``
    for the cached modes), ``aux`` the MoE's load-balancing loss (an f32
    scalar), None for a block without one.  ``tp`` (a
    ``distributed.tensor_parallel.TP``, train mode) splits every mixer
    (attention heads, mamba's channels, mLSTM's and sLSTM's heads), the MLP
    and the MoE over the model axis where the rule table splits them."""
    base, use_moe = _check_kind(kind)
    if page_table is not None and base not in ATTENTION_KINDS:
        raise NotImplementedError(
            f"paged serving caches exist only for attention blocks, not "
            f"{base!r} (recurrent mixers keep O(1) state per slot and need "
            "no paging)")
    h = rms_norm(x, p["norm1"], cfg.norm_eps)
    if base in ATTENTION_KINDS:
        h, nc = attention.attn_apply(p["mixer"], cfg, h, cos, sin,
                                     local=base == "attn_local", mode=mode,
                                     cache=cache, pos=pos,
                                     page_table=page_table, tp=tp)
    else:
        h, nc = _APPLY[base](p["mixer"], cfg, h, mode=mode, cache=cache,
                             tp=tp)
    x = x + h
    aux = None
    if "ffn" in p:
        h = rms_norm(x, p["norm2"], cfg.norm_eps)
        if use_moe:
            h, aux = moe_lib.moe_apply(p["ffn"], cfg, h, tp)
        else:
            h = mlp_apply(p["ffn"], h, tensor_parallel.split(tp, cfg.d_ff))
        x = x + h
    return x, nc, aux


def block_cache(b: Builder, cfg, kind: str, B: int, max_len: int, lead=()
                ) -> dict:
    """A zeroed dense decode cache from ``b`` (zeros on its device, ``meta``
    tensors, or each leaf's axes with ``mode="axes"``): for attention
    ``{"k", "v"}`` of ``(*lead, B, size, KV, hd)`` in the model dtype,
    ``size = min(window, max_len)`` for a windowed block (a ring buffer),
    else ``max_len``; for a recurrent mixer its state
    (``ssm.mamba_cache``, ``xlstm.mlstm_cache``, ``xlstm.slstm_cache``)."""
    base, _ = _check_kind(kind)
    if base in RECURRENT_KINDS:
        return _CACHE[base](b, cfg, B, lead=lead)
    size = min(cfg.window, max_len) if base == "attn_local" and cfg.window \
        else max_len
    return {n: b.param((B, size, cfg.n_kv_heads, cfg.head_dim),
                       ("batch", "seq", "kv_heads", None), init="zeros",
                       lead=lead)
            for n in ("k", "v")}


def block_paged_cache(b: Builder, cfg, kind: str, num_pages: int,
                      page_size: int, quant: Optional[str], lead=()) -> dict:
    """The block's share of the serving arena, from ``b``: a page pool per
    K and V (``repro_torch.serve.kv`` layout), ``(*lead, num_pages,
    page_size, KV, hd)`` in the model dtype, or ``{"q": int8, "scale":
    f32}`` with ``quant="int8"``.  Only full-attention blocks are served
    (the engine checks); a recurrent block has no paged layout."""
    base, _ = _check_kind(kind)
    if base not in ATTENTION_KINDS:
        raise NotImplementedError(
            f"no paged cache layout for block kind {base!r}")
    shape = (num_pages, page_size, cfg.n_kv_heads, cfg.head_dim)
    axes = ("pages", "page", "kv_heads", None)
    if quant == "int8":
        def pool():
            return {"q": b.param(shape, axes, init="zeros", lead=lead,
                                 dtype=torch.int8),
                    "scale": b.param(shape[:-1], axes[:3], init="zeros",
                                     lead=lead, dtype=torch.float32)}
    elif quant is None:
        def pool():
            return b.param(shape, axes, init="zeros", lead=lead)
    else:
        raise ValueError(f"kv quant {quant!r}: expected None or 'int8'")
    return {"k": pool(), "v": pool()}
