"""``ModelConfig``: the architecture dataclass (counterpart of
``repro/configs/base.py``, whose module imports JAX), every field with the
reference's default: the dense decoders, the MoE, M-RoPE, the SSM (mamba)
widths and the encoder-decoder split."""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Tuple

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
