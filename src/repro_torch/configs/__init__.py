"""Architecture registry of the port: the dense, MoE and M-RoPE assigned
archs and the paper's LLaMA family.

``get_config(id)`` / ``get_smoke(id)`` accept the assignment's dashed ids.
The other three assigned ids (the hybrid, SSM and encoder-decoder
architectures) are refused: their substrates wait for ROADMAP Queue 1
items 5.4-5.6.
"""

from repro_torch.configs import (deepseek_67b, gemma2_9b, gemma3_27b,
                                 llama_paper, qwen2_5_3b, qwen2_moe_a2_7b,
                                 qwen2_vl_72b, qwen3_moe_30b_a3b)
from repro_torch.configs.base import ModelConfig

_MODULES = {
    "qwen3-moe-30b-a3b": qwen3_moe_30b_a3b,
    "qwen2-moe-a2.7b": qwen2_moe_a2_7b,
    "gemma3-27b": gemma3_27b,
    "deepseek-67b": deepseek_67b,
    "gemma2-9b": gemma2_9b,
    "qwen2.5-3b": qwen2_5_3b,
    "qwen2-vl-72b": qwen2_vl_72b,
}

LLAMA = {
    "llama-60m": llama_paper.LLAMA_60M,
    "llama-130m": llama_paper.LLAMA_130M,
    "llama-350m": llama_paper.LLAMA_350M,
    "llama-1b": llama_paper.LLAMA_1B,
    "llama-3b": llama_paper.LLAMA_3B,
}

# assigned ids whose blocks (mamba, xLSTM, encoder-decoder) the port does
# not build yet
NOT_PORTED = ("jamba-v0.1-52b", "xlstm-350m", "seamless-m4t-large-v2")

ARCH_IDS = list(_MODULES)


def _check(name: str) -> None:
    if name in NOT_PORTED:
        raise ValueError(
            f"arch {name!r} is not ported: its SSM, xLSTM or "
            f"encoder-decoder substrate waits for ROADMAP Queue 1 item 5 "
            f"(5.4-5.6)")
    if name not in _MODULES and name not in LLAMA:
        raise ValueError(f"unknown arch {name!r}; choices: "
                         f"{ARCH_IDS + list(LLAMA)}")


def get_config(name: str) -> ModelConfig:
    _check(name)
    if name in _MODULES:
        return _MODULES[name].CONFIG
    return LLAMA[name]


def get_smoke(name: str) -> ModelConfig:
    _check(name)
    if name in _MODULES:
        return _MODULES[name].SMOKE
    return llama_paper.smoke(LLAMA[name])


__all__ = ["ModelConfig", "get_config", "get_smoke", "ARCH_IDS", "LLAMA",
           "NOT_PORTED"]
