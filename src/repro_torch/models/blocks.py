"""Layer block (counterpart of ``repro/models/blocks.py``): an attention
mixer (``"attn"``, or ``"attn_local"`` with the sliding window) and, where
``cfg.d_ff > 0``, the MLP, with pre-norms and residuals.  The ``"+moe"``
suffix and the recurrent mixers (mamba, mLSTM, sLSTM) wait for ROADMAP
Queue 1 item 5."""

from __future__ import annotations

from typing import Tuple

from repro_torch.models import attention
from repro_torch.models.layers import Builder, mlp_apply, mlp_init, rms_norm

ATTENTION_KINDS = ("attn", "attn_local")


def parse_kind(kind: str) -> Tuple[str, bool]:
    """``"mamba+moe"`` -> ``("mamba", True)``."""
    base, *mods = kind.split("+")
    return base, "moe" in mods


def _check_kind(kind: str) -> str:
    base, use_moe = parse_kind(kind)
    if use_moe or base in ("mamba", "mlstm", "slstm"):
        raise NotImplementedError(
            f"block kind {kind!r}: the MoE and recurrent blocks wait for "
            "ROADMAP Queue 1 item 5")
    if base not in ATTENTION_KINDS:
        raise ValueError(f"unknown block kind {base!r}")
    return base


def block_init(b: Builder, cfg, kind: str, lead=()) -> dict:
    _check_kind(kind)
    d = cfg.d_model
    p = {"norm1": b.param((d,), init="zeros", lead=lead),
         "mixer": attention.attn_init(b, cfg, lead=lead)}
    if cfg.d_ff > 0:
        p["norm2"] = b.param((d,), init="zeros", lead=lead)
        p["ffn"] = mlp_init(b, d, cfg.d_ff, lead=lead)
    return p


def block_apply(p, cfg, kind: str, x, cos, sin):
    base = _check_kind(kind)
    h = rms_norm(x, p["norm1"], cfg.norm_eps)
    x = x + attention.attn_apply(p["mixer"], cfg, h, cos, sin,
                                 local=base == "attn_local")
    if "ffn" in p:
        h = rms_norm(x, p["norm2"], cfg.norm_eps)
        x = x + mlp_apply(p["ffn"], h)
    return x
