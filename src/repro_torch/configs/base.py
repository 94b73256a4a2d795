"""``ModelConfig``: the architecture dataclass (counterpart of
``repro/configs/base.py``, whose module imports JAX).  Only the fields the
dense LLaMA family reads are kept; embeddings are always tied."""

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
    pattern: Tuple[str, ...] = ("attn",)
    rope_theta: float = 1e4
    norm_eps: float = 1e-6
    dtype: str = "bfloat16"

    @property
    def n_periods(self) -> int:
        return self.n_layers // len(self.pattern)

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    def with_(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)
