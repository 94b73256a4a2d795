"""gemma3-27b [dense] — 5:1 local:global attention, 128k context, QK-norm,
262k vocab [hf:google/gemma-3 family].  62 = 10 periods of 6 + 2 remainder
local layers (unrolled).  Single rope_theta=1e6 for both local and global
layers (simplification noted in DESIGN.md)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-27b", family="dense",
    n_layers=62, d_model=5376, n_heads=32, n_kv_heads=16, head_dim=128,
    d_ff=21504, vocab=262144,
    pattern=("attn_local",) * 5 + ("attn",),
    window=1024, qk_norm=True, rope_theta=1e6,
    tie_embeddings=True, sub_quadratic=True,
)

SMOKE = CONFIG.with_(
    n_layers=6, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128, vocab=512, window=32, remat=False)
