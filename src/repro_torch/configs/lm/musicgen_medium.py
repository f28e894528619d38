"""MusicGen-medium [arXiv:2306.05284; hf] — decoder-only over EnCodec
tokens.  The EnCodec frontend is a STUB per the assignment: inputs are
precomputed codec tokens (vocab 2048) from the synthetic pipeline."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="musicgen-medium", family="audio",
    n_layers=48, d_model=1536, n_heads=24, n_kv=24, d_ff=6144,
    vocab=2048, head_dim=64, mlp_type="gelu",
)

SMOKE = ArchConfig(
    name="musicgen-medium-smoke", family="audio",
    n_layers=2, d_model=48, n_heads=3, n_kv=3, d_ff=96,
    vocab=256, head_dim=16, mlp_type="gelu",
    dtype="float32", remat="none",
)
