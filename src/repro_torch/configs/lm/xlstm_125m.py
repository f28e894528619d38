"""xLSTM 125M [arXiv:2405.04517] — sLSTM + mLSTM blocks (1 sLSTM per 6)."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="xlstm-125m", family="ssm",
    n_layers=12, d_model=768, n_heads=4, n_kv=4, d_ff=0,
    vocab=50304, pattern="xlstm", xlstm_period=6,
    sub_quadratic=True,
)

SMOKE = ArchConfig(
    name="xlstm-125m-smoke", family="ssm",
    n_layers=6, d_model=64, n_heads=2, n_kv=2, d_ff=0,
    vocab=512, pattern="xlstm", xlstm_period=6,
    sub_quadratic=True, dtype="float32", remat="none",
)
