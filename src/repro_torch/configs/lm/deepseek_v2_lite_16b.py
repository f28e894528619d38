"""DeepSeek-V2-Lite 16B [arXiv:2405.04434; hf] — MLA + 2 shared/64 routed MoE."""
from repro_torch.configs.base import ArchConfig
from repro_torch.models.moe import MoEConfig

CONFIG = ArchConfig(
    name="deepseek-v2-lite-16b", family="moe",
    n_layers=27, d_model=2048, n_heads=16, n_kv=16, d_ff=1408,
    vocab=102400, head_dim=128, attn="mla",
    mla_kv_lora=512, mla_q_lora=0, mla_rope_dim=64,
    moe=MoEConfig(n_experts=64, top_k=6, d_ff=1408, n_shared=2),
    first_k_dense=1, d_ff_dense=10944,
)

SMOKE = ArchConfig(
    name="deepseek-v2-lite-16b-smoke", family="moe",
    n_layers=3, d_model=64, n_heads=4, n_kv=4, d_ff=48,
    vocab=512, head_dim=32, attn="mla",
    mla_kv_lora=32, mla_q_lora=0, mla_rope_dim=16,
    moe=MoEConfig(n_experts=8, top_k=2, d_ff=48, n_shared=1,
                  capacity_factor=4.0),
    first_k_dense=1, d_ff_dense=128, dtype="float32", remat="none",
)
