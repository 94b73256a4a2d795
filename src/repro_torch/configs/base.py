"""``ModelConfig``: the architecture dataclass (counterpart of
``repro/configs/base.py``, whose module imports JAX), every field with the
reference's default: the dense decoders, the MoE, M-RoPE, the SSM (mamba)
widths and the encoder-decoder split.  ``ShapeConfig`` is a workload cell;
``SHAPES`` holds the four assigned input shapes, ``input_specs`` their
model inputs as ``meta`` tensors (nothing allocated) and ``skip_reason``
the assignment's skip rule."""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch


@dataclass(frozen=True)
class ModelConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab: int
    # layer-kind pattern for ONE period; entries: "attn", "attn_local",
    # "mamba", "mlstm", "slstm"; the "+moe" suffix swaps the MLP for MoE
    pattern: Tuple[str, ...] = ("attn",)
    arch_class: str = "decoder"          # decoder | encdec
    family: str = "dense"
    # MoE
    n_experts: int = 0
    top_k: int = 0
    n_shared_experts: int = 0
    d_ff_expert: int = 0
    capacity_factor: float = 1.25
    # pad the expert WEIGHT arrays to n_experts + padding (the router
    # stays at n_experts; padded experts are never routed)
    expert_padding: int = 0
    # attention details
    window: int = 0                      # sliding window for attn_local
    attn_softcap: float = 0.0            # gemma-2 logit soft-capping
    final_softcap: float = 0.0
    qkv_bias: bool = False
    qk_norm: bool = False
    rope_theta: float = 1e4
    mrope_sections: Tuple[int, ...] = ()  # qwen2-vl M-RoPE (t,h,w) split
    # SSM (mamba)
    ssm_state: int = 16
    ssm_conv: int = 4
    ssm_expand: int = 2
    # enc-dec split (seamless): n_layers = n_enc + n_dec
    n_enc_layers: int = 0
    n_dec_layers: int = 0
    tie_embeddings: bool = True
    norm_eps: float = 1e-6
    dtype: str = "bfloat16"
    sub_quadratic: bool = False
    remat: bool = True

    @property
    def period(self) -> int:
        return len(self.pattern)

    @property
    def n_periods(self) -> int:
        return self.n_layers // self.period

    @property
    def rem_layers(self) -> int:
        return self.n_layers % self.period

    @property
    def d_inner(self) -> int:  # mamba inner width
        return self.ssm_expand * self.d_model

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    def with_(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str             # "train" | "prefill" | "decode"
    accum_steps: int = 1  # gradient-accumulation microbatches (train only)


# The four assigned LM shapes; ``accum_steps`` is a default
SHAPES = {
    "train_4k":    ShapeConfig("train_4k", 4096, 256, "train", accum_steps=16),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k":  ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k":   ShapeConfig("long_500k", 524288, 1, "decode"),
}


def _meta(shape, dtype: torch.dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ModelConfig, shape: ShapeConfig
                ) -> Dict[str, torch.Tensor]:
    """Every model input of ``shape`` as a ``meta`` tensor: tokens (and,
    to train, labels) ``int32`` ``(B, S)``; an encoder-decoder's
    ``enc_embeds`` bf16 ``(B, S // 4, d_model)``; M-RoPE's
    ``mrope_positions`` ``(3, B, S)``.  A decode step feeds one token
    against a ``seq_len``-deep cache."""
    B, S = shape.global_batch, shape.seq_len
    i32 = torch.int32
    if shape.kind == "decode":
        batch = {"tokens": _meta((B, 1), i32)}
        if cfg.mrope_sections:
            batch["mrope_positions"] = _meta((3, B, 1), i32)
        return batch
    batch = {"tokens": _meta((B, S), i32)}
    if shape.kind == "train":
        batch["labels"] = _meta((B, S), i32)
    if cfg.arch_class == "encdec":
        # the audio front end's stub: precomputed frame embeddings
        batch["enc_embeds"] = _meta((B, S // 4, cfg.d_model),
                                    torch.bfloat16)
    if cfg.mrope_sections:
        batch["mrope_positions"] = _meta((3, B, S), i32)
    return batch


def skip_reason(cfg: ModelConfig, shape: ShapeConfig) -> Optional[str]:
    """The assignment's skip rule (DESIGN.md §6), None where the cell
    runs."""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return ("pure full-attention arch: long_500k needs sub-quadratic "
                "attention (assignment rule)")
    return None
