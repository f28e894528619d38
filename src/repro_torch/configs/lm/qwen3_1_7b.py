"""Qwen3 1.7B [hf:Qwen/Qwen3-1.7B] — qk-norm, GQA, tied embeddings."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-1.7b", family="dense",
    n_layers=28, d_model=2048, n_heads=16, n_kv=8, d_ff=6144,
    vocab=151936, head_dim=128, rope_theta=1000000.0,
    qk_norm=True, tie_embeddings=True,
)

SMOKE = ArchConfig(
    name="qwen3-1.7b-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv=2, d_ff=128,
    vocab=512, head_dim=16, qk_norm=True, tie_embeddings=True,
    dtype="float32", remat="none",
)
