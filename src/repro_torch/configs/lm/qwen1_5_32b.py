"""Qwen1.5 32B [hf:Qwen/Qwen1.5-32B] — QKV bias, MHA (kv = heads)."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen1.5-32b", family="dense",
    n_layers=64, d_model=5120, n_heads=40, n_kv=40, d_ff=27392,
    vocab=152064, head_dim=128, qkv_bias=True,
)

SMOKE = ArchConfig(
    name="qwen1.5-32b-smoke", family="dense",
    n_layers=2, d_model=80, n_heads=5, n_kv=5, d_ff=160,
    vocab=512, head_dim=16, qkv_bias=True,
    dtype="float32", remat="none",
)
