"""qwen3-moe-30b-a3b [moe]: 128 experts top-8, QK-norm, every layer MoE
[hf:Qwen/Qwen3-30B-A3B]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-30b-a3b", family="moe",
    n_layers=48, d_model=2048, n_heads=32, n_kv_heads=4, head_dim=128,
    d_ff=0, vocab=151936,
    pattern=("attn+moe",),
    n_experts=128, top_k=8, d_ff_expert=768,
    qk_norm=True, rope_theta=1e6,
    tie_embeddings=False, sub_quadratic=False,
)

SMOKE = CONFIG.with_(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    vocab=512, n_experts=8, top_k=2, d_ff_expert=64, remat=False,
    capacity_factor=8.0)  # smoke: no capacity drops -> decode == train
