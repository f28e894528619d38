"""Llama-3 8B [arXiv:2407.21783] — dense GQA, 128k vocab."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="llama3-8b", family="dense",
    n_layers=32, d_model=4096, n_heads=32, n_kv=8, d_ff=14336,
    vocab=128256, head_dim=128, rope_theta=500000.0,
)

SMOKE = ArchConfig(
    name="llama3-8b-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv=2, d_ff=128,
    vocab=512, head_dim=16, rope_theta=500000.0,
    dtype="float32", remat="none",
)
