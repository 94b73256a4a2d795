"""jamba-v0.1-52b [hybrid] — Mamba+attention 1:7 interleave, MoE 16e top-2
[arXiv:2403.19887].  Period-8 Jamba block: attention at index 4, MoE on odd
indices (every other layer)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="jamba-v0.1-52b", family="hybrid",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=14336, vocab=65536,
    pattern=("mamba", "mamba+moe", "mamba", "mamba+moe",
             "attn", "mamba+moe", "mamba", "mamba+moe"),
    n_experts=16, top_k=2, d_ff_expert=14336,
    tie_embeddings=False, sub_quadratic=True,
)

SMOKE = CONFIG.with_(
    n_layers=8, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128, vocab=512, n_experts=4, top_k=2, d_ff_expert=128,
    ssm_state=8, remat=False, capacity_factor=8.0)
