"""Attention, train-mode causal path (counterpart of ``_project`` and
``_direct_attn`` in ``repro/models/attention.py``): scores and softmax in
f32, written as explicit torch ops."""

from __future__ import annotations

import math

import torch

from repro_torch.models import rope as rope_lib
from repro_torch.models.layers import Builder

NEG_INF = -1e30


def attn_init(b: Builder, cfg, lead=()) -> dict:
    if cfg.n_kv_heads != cfg.n_heads:
        raise ValueError("the port has multi-head attention only "
                         f"(n_kv_heads={cfg.n_kv_heads}, "
                         f"n_heads={cfg.n_heads})")
    d, hd, H = cfg.d_model, cfg.head_dim, cfg.n_heads
    return {"wq": b.param((d, H * hd), lead=lead),
            "wk": b.param((d, H * hd), lead=lead),
            "wv": b.param((d, H * hd), lead=lead),
            "wo": b.param((H * hd, d), lead=lead)}


def _project(p, cfg, x):
    B, S, _ = x.shape
    hd, H = cfg.head_dim, cfg.n_heads
    q = (x @ p["wq"]).reshape(B, S, H, hd)
    k = (x @ p["wk"]).reshape(B, S, H, hd)
    v = (x @ p["wv"]).reshape(B, S, H, hd)
    return q, k, v


def _direct_attn(q, k, v):
    """Causal attention; q (B,S,H,hd), k/v (B,S,H,hd).  Scores are f32
    products of the inputs (the JAX package's ``preferred_element_type``)."""
    _, S, _, hd = q.shape
    s = torch.einsum("bshd,bthd->bhst", q.float(), k.float()) / math.sqrt(hd)
    pos = torch.arange(S, device=q.device)
    mask = pos[None, :] <= pos[:, None]                  # (S, T)
    s = s.masked_fill(~mask, NEG_INF)
    w = torch.softmax(s, dim=-1)
    return torch.einsum("bhst,bthd->bshd", w.to(v.dtype), v)


def attn_apply(p, cfg, x, cos, sin):
    B, S, _ = x.shape
    H = cfg.n_heads
    q, k, v = _project(p, cfg, x)
    q = rope_lib.apply_rope(q, cos, sin)
    k = rope_lib.apply_rope(k, cos, sin)
    o = _direct_attn(q, k, v)
    return o.reshape(B, S, H * cfg.head_dim) @ p["wo"]
