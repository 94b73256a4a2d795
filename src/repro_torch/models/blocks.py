"""Layer block (counterpart of ``repro/models/blocks.py``, attention + MLP
only): pre-norms and residuals."""

from __future__ import annotations

from repro_torch.models import attention
from repro_torch.models.layers import Builder, mlp_apply, mlp_init, rms_norm


def block_init(b: Builder, cfg, kind: str, lead=()) -> dict:
    if kind != "attn":
        raise ValueError(f"the port has attention blocks only, not {kind!r}")
    d = cfg.d_model
    return {"norm1": b.param((d,), init="zeros", lead=lead),
            "mixer": attention.attn_init(b, cfg, lead=lead),
            "norm2": b.param((d,), init="zeros", lead=lead),
            "ffn": mlp_init(b, d, cfg.d_ff, lead=lead)}


def block_apply(p, cfg, x, cos, sin):
    h = rms_norm(x, p["norm1"], cfg.norm_eps)
    x = x + attention.attn_apply(p["mixer"], cfg, h, cos, sin)
    h = rms_norm(x, p["norm2"], cfg.norm_eps)
    return x + mlp_apply(p["ffn"], h)
