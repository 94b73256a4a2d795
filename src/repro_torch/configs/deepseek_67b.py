"""deepseek-67b [dense] — 95-layer llama-arch GQA [arXiv:2401.02954]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-67b", family="dense",
    n_layers=95, d_model=8192, n_heads=64, n_kv_heads=8, head_dim=128,
    d_ff=22016, vocab=102400,
    pattern=("attn",),
    tie_embeddings=False, sub_quadratic=False,
)

SMOKE = CONFIG.with_(
    n_layers=3, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128, vocab=512, remat=False)
