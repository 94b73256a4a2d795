"""xlstm-350m [ssm] — 7:1 mLSTM:sLSTM interleave, no separate FFN (d_ff=0)
[arXiv:2405.04517]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-350m", family="ssm",
    n_layers=24, d_model=1024, n_heads=4, n_kv_heads=4, head_dim=256,
    d_ff=0, vocab=50304,
    pattern=("mlstm",) * 7 + ("slstm",),
    tie_embeddings=True, sub_quadratic=True,
)

SMOKE = CONFIG.with_(
    n_layers=8, d_model=64, n_heads=2, n_kv_heads=2, head_dim=32,
    vocab=512, remat=False)
