"""Architecture registry of the port: the ten assigned archs and the
paper's LLaMA family.

``get_config(id)`` / ``get_smoke(id)`` accept the assignment's dashed ids.
"""

from repro_torch.configs import (deepseek_67b, gemma2_9b, gemma3_27b,
                                 jamba_v0_1_52b, llama_paper, qwen2_5_3b,
                                 qwen2_moe_a2_7b, qwen2_vl_72b,
                                 qwen3_moe_30b_a3b, seamless_m4t_large_v2,
                                 xlstm_350m)
from repro_torch.configs.base import (SHAPES, ModelConfig, ShapeConfig,
                                      input_specs, skip_reason)

_MODULES = {
    "jamba-v0.1-52b": jamba_v0_1_52b,
    "qwen3-moe-30b-a3b": qwen3_moe_30b_a3b,
    "qwen2-moe-a2.7b": qwen2_moe_a2_7b,
    "gemma3-27b": gemma3_27b,
    "deepseek-67b": deepseek_67b,
    "gemma2-9b": gemma2_9b,
    "qwen2.5-3b": qwen2_5_3b,
    "qwen2-vl-72b": qwen2_vl_72b,
    "xlstm-350m": xlstm_350m,
    "seamless-m4t-large-v2": seamless_m4t_large_v2,
}

LLAMA = {
    "llama-60m": llama_paper.LLAMA_60M,
    "llama-130m": llama_paper.LLAMA_130M,
    "llama-350m": llama_paper.LLAMA_350M,
    "llama-1b": llama_paper.LLAMA_1B,
    "llama-3b": llama_paper.LLAMA_3B,
}

ARCH_IDS = list(_MODULES)


def get_config(name: str) -> ModelConfig:
    if name in _MODULES:
        return _MODULES[name].CONFIG
    if name in LLAMA:
        return LLAMA[name]
    raise ValueError(f"unknown arch {name!r}; choices: "
                     f"{ARCH_IDS + list(LLAMA)}")


def get_smoke(name: str) -> ModelConfig:
    if name in _MODULES:
        return _MODULES[name].SMOKE
    if name in LLAMA:
        return llama_paper.smoke(LLAMA[name])
    raise ValueError(f"unknown arch {name!r}; choices: "
                     f"{ARCH_IDS + list(LLAMA)}")


__all__ = ["ModelConfig", "ShapeConfig", "SHAPES", "input_specs",
           "skip_reason", "get_config", "get_smoke", "ARCH_IDS", "LLAMA"]
