"""qwen2-vl-72b [vlm]: M-RoPE (t/h/w rotary sections); the dynamic-
resolution vision frontend is a stub, as in the JAX package (batches may
carry ``mrope_positions``) [arXiv:2409.12191]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-72b", family="vlm",
    n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8, head_dim=128,
    d_ff=29568, vocab=152064,
    pattern=("attn",), qkv_bias=True,
    mrope_sections=(16, 24, 24), rope_theta=1e6,
    tie_embeddings=False, sub_quadratic=False,
)

SMOKE = CONFIG.with_(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128, vocab=512, mrope_sections=(2, 3, 3), remat=False)
