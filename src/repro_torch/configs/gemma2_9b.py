"""gemma2-9b [dense] — local/global alternating, logit softcaps
[arXiv:2408.00118]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-9b", family="dense",
    n_layers=42, d_model=3584, n_heads=16, n_kv_heads=8, head_dim=256,
    d_ff=14336, vocab=256000,
    pattern=("attn_local", "attn"),
    window=4096, attn_softcap=50.0, final_softcap=30.0,
    tie_embeddings=True, sub_quadratic=True,
)

SMOKE = CONFIG.with_(
    n_layers=4, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128, vocab=512, window=32, remat=False)
