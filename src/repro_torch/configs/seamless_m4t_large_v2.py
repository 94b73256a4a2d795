"""seamless-m4t-large-v2 [audio] — encoder-decoder backbone; 24L total split
12 enc + 12 dec per the assigned config; audio frontend is a STUB
(input_specs provides precomputed frame embeddings) [arXiv:2308.11596]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-large-v2", family="audio", arch_class="encdec",
    n_layers=24, n_enc_layers=12, n_dec_layers=12,
    d_model=1024, n_heads=16, n_kv_heads=16, head_dim=64,
    d_ff=8192, vocab=256206,
    pattern=("attn",),
    tie_embeddings=True, sub_quadratic=False,
)

SMOKE = CONFIG.with_(
    n_layers=4, n_enc_layers=2, n_dec_layers=2,
    d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
    d_ff=128, vocab=512, remat=False)
