"""Chameleon 34B [arXiv:2405.09818] — early-fusion VLM backbone.  The VQ
image tokenizer is a STUB per the assignment: image patches arrive as
precomputed VQ tokens inside the shared 65536 vocab."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="chameleon-34b", family="vlm",
    n_layers=48, d_model=8192, n_heads=64, n_kv=8, d_ff=22016,
    vocab=65536, head_dim=128, qk_norm=True,
)

SMOKE = ArchConfig(
    name="chameleon-34b-smoke", family="vlm",
    n_layers=2, d_model=64, n_heads=4, n_kv=2, d_ff=128,
    vocab=512, head_dim=16, qk_norm=True,
    dtype="float32", remat="none",
)
