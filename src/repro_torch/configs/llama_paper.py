"""The paper's LLaMA pre-training family (Appendix Table VIII)."""
from repro_torch.configs.base import ModelConfig


def _llama(name, n_layers, d_model, n_heads, d_ff, vocab=32000):
    return ModelConfig(
        name=name, family="dense",
        n_layers=n_layers, d_model=d_model, n_heads=n_heads,
        n_kv_heads=n_heads, head_dim=d_model // n_heads,
        d_ff=d_ff, vocab=vocab, pattern=("attn",),
        tie_embeddings=True, sub_quadratic=False, remat=False)


def smoke(cfg: ModelConfig) -> ModelConfig:
    """CI-scale variant of a LLaMA family member: 2 layers, d=32, f32."""
    return cfg.with_(
        name=f"{cfg.name}-smoke", n_layers=2, d_model=32, n_heads=2,
        n_kv_heads=2, head_dim=16, d_ff=64, vocab=64, dtype="float32",
        remat=False)


LLAMA_60M = _llama("llama-60m", 8, 512, 8, 1376)
LLAMA_130M = _llama("llama-130m", 12, 768, 12, 2048)
LLAMA_350M = _llama("llama-350m", 24, 1024, 16, 2736)
LLAMA_1B = _llama("llama-1b", 32, 2048, 24, 5461)
LLAMA_3B = _llama("llama-3b", 32, 2560, 32, 6848)
