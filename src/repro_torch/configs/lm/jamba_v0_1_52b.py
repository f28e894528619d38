"""Jamba v0.1 52B [arXiv:2403.19887; hf] — Mamba+attn 1:7, 16-expert MoE."""
from repro_torch.configs.base import ArchConfig
from repro_torch.models.mamba import MambaConfig
from repro_torch.models.moe import MoEConfig

CONFIG = ArchConfig(
    name="jamba-v0.1-52b", family="hybrid",
    n_layers=32, d_model=4096, n_heads=32, n_kv=8, d_ff=14336,
    vocab=65536, head_dim=128, use_rope=False,
    pattern="jamba", jamba_period=8, jamba_attn_pos=3,
    mamba=MambaConfig(d_model=4096, d_state=16, d_conv=4, expand=2),
    moe=MoEConfig(n_experts=16, top_k=2, d_ff=14336, norm_topk=True),
    sub_quadratic=True,
)

SMOKE = ArchConfig(
    name="jamba-v0.1-52b-smoke", family="hybrid",
    n_layers=8, d_model=64, n_heads=4, n_kv=2, d_ff=128,
    vocab=512, head_dim=16, use_rope=False,
    pattern="jamba", jamba_period=8, jamba_attn_pos=3,
    mamba=MambaConfig(d_model=64, d_state=4, d_conv=4, expand=2, chunk=16),
    moe=MoEConfig(n_experts=8, top_k=2, d_ff=128, norm_topk=True,
                  capacity_factor=4.0),
    sub_quadratic=True, dtype="float32", remat="none",
)
