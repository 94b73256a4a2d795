"""qwen2-moe-a2.7b [moe]: 4 shared + 60 routed experts, top-4
[hf:Qwen/Qwen1.5-MoE-A2.7B]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-moe-a2.7b", family="moe",
    n_layers=24, d_model=2048, n_heads=16, n_kv_heads=16, head_dim=128,
    d_ff=0, vocab=151936,
    pattern=("attn+moe",),
    n_experts=60, top_k=4, n_shared_experts=4, d_ff_expert=1408,
    expert_padding=4,  # 60 -> 64 expert weights, as the JAX package pads
    qkv_bias=True,
    tie_embeddings=True, sub_quadratic=False,
)

SMOKE = CONFIG.with_(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
    vocab=512, n_experts=6, top_k=2, n_shared_experts=1, d_ff_expert=64,
    remat=False, capacity_factor=8.0)
