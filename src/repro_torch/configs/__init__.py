"""Architecture registry of the port: the paper's LLaMA family."""

from repro_torch.configs import llama_paper
from repro_torch.configs.base import ModelConfig

LLAMA = {
    "llama-60m": llama_paper.LLAMA_60M,
    "llama-130m": llama_paper.LLAMA_130M,
    "llama-350m": llama_paper.LLAMA_350M,
    "llama-1b": llama_paper.LLAMA_1B,
    "llama-3b": llama_paper.LLAMA_3B,
}


def get_config(name: str) -> ModelConfig:
    if name in LLAMA:
        return LLAMA[name]
    raise ValueError(f"unknown arch {name!r}; choices: {list(LLAMA)}")


def get_smoke(name: str) -> ModelConfig:
    return llama_paper.smoke(get_config(name))


__all__ = ["ModelConfig", "get_config", "get_smoke", "LLAMA"]
