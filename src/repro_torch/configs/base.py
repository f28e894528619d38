"""ArchConfig — the schema of the LM model zoo, plus the input-shape suite
(port of ``repro/configs/base.py``)."""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.models.mamba import MambaConfig
from repro_torch.models.moe import MoEConfig
from repro_torch.models.xlstm import XLSTMConfig


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                    # dense|moe|hybrid|ssm|audio|vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv: int
    d_ff: int
    vocab: int
    head_dim: int = 0              # 0 -> d_model // n_heads
    rope_theta: float = 10000.0
    use_rope: bool = True
    qk_norm: bool = False
    qkv_bias: bool = False
    mlp_type: str = "swiglu"
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    # attention variant
    attn: str = "gqa"              # gqa | mla
    mla_kv_lora: int = 512
    mla_q_lora: int = 0
    mla_rope_dim: int = 64
    # memory-bounded (flash) attention tuning
    flash_threshold: int = 1024
    attn_q_chunk: int = 512
    attn_kv_chunk: int = 512
    attn_causal_skip: bool = False
    attn_score_dtype: str = "float32"
    kv_cache_quant: bool = False
    # sharding profile of the JAX package (no meaning on one card)
    shard_profile: str = "auto"
    # MoE placement
    moe: Optional[MoEConfig] = None
    moe_every: int = 1             # MoE on layer idx where idx % every == off
    moe_offset: int = 0
    first_k_dense: int = 0
    d_ff_dense: int = 0            # dense-layer FFN width (0 -> d_ff)
    # block pattern
    pattern: str = "dense"         # dense | jamba | xlstm
    jamba_period: int = 8
    jamba_attn_pos: int = 3
    mamba: Optional[MambaConfig] = None
    xlstm_period: int = 6          # sLSTM at the last slot of each period
    # paper technique (continuous-depth execution of the residual stack)
    ode_depth: int = 0             # >0: RK4 steps per weight-tied block
    # capability flags
    sub_quadratic: bool = False    # can run the 500k-context decode cell
    remat: str = "full"            # full | dots | none

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def torch_dtype(self) -> torch.dtype:
        """The param and activation dtype (``jdtype`` in the JAX package)."""
        return {"bfloat16": torch.bfloat16, "float32": torch.float32}[
            self.dtype]

    @property
    def d_ff_dense_(self) -> int:
        return self.d_ff_dense or self.d_ff

    def xlstm_cfg(self) -> XLSTMConfig:
        return XLSTMConfig(d_model=self.d_model, n_heads=self.n_heads)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                      # train | prefill | decode


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


def runnable_shapes(cfg: ArchConfig) -> list[str]:
    """long_500k needs sub-quadratic attention."""
    names = ["train_4k", "prefill_32k", "decode_32k"]
    if cfg.sub_quadratic:
        names.append("long_500k")
    return names


def param_count(cfg: ArchConfig) -> int:
    """Analytic parameter count, as the JAX package computes it."""
    d, hd = cfg.d_model, cfg.hd
    emb = cfg.vocab * d * (1 if cfg.tie_embeddings else 2)
    total = emb + d  # final norm

    def attn_params():
        if cfg.attn == "mla":
            p = d * cfg.mla_kv_lora                      # w_dkv
            p += cfg.mla_kv_lora * cfg.n_heads * hd * 2  # w_uk, w_uv
            p += d * cfg.mla_rope_dim                    # w_kr
            p += cfg.n_heads * hd * d                    # wo
            if cfg.mla_q_lora:
                p += d * cfg.mla_q_lora + cfg.mla_q_lora * cfg.n_heads * (
                    hd + cfg.mla_rope_dim)
            else:
                p += d * cfg.n_heads * (hd + cfg.mla_rope_dim)
            return p
        return d * hd * (cfg.n_heads + 2 * cfg.n_kv) + cfg.n_heads * hd * d

    def mlp_params(ff):
        mats = 3 if cfg.mlp_type == "swiglu" else 2
        return mats * d * ff

    def moe_params():
        m = cfg.moe
        p = d * m.n_experts
        p += m.n_experts * mlp_params(m.d_ff) // 1
        if m.n_shared:
            p += mlp_params(m.n_shared * m.d_ff)
        return p

    def mamba_params():
        mc = cfg.mamba
        di, n, r = mc.d_inner, mc.d_state, mc.dt_rank_
        return (d * 2 * di + mc.d_conv * di + di * (r + 2 * n) + r * di
                + di * n + 2 * di + di * d)

    def xlstm_m():
        xc = cfg.xlstm_cfg()
        di = xc.d_inner
        return d * 2 * di + xc.d_conv * di + 3 * di * di + 2 * di * \
            cfg.n_heads + di * d + di

    def xlstm_s():
        xc = cfg.xlstm_cfg()
        df = int(xc.s_proj_factor * d)
        return d * 4 * d + cfg.n_heads * (d // cfg.n_heads) * 4 * (
            d // cfg.n_heads) + 3 * d * df // 1 + 2 * d * df - 2 * d * df \
            + d * df * 3

    for i in range(cfg.n_layers):
        total += 2 * d  # norms
        if cfg.pattern == "dense":
            total += attn_params()
            if cfg.moe is not None and i >= cfg.first_k_dense and \
                    (i - cfg.moe_offset) % cfg.moe_every == 0:
                total += moe_params()
            else:
                total += mlp_params(cfg.d_ff_dense_)
        elif cfg.pattern == "jamba":
            pos = i % cfg.jamba_period
            total += attn_params() if pos == cfg.jamba_attn_pos \
                else mamba_params()
            if i % 2 == 1 and cfg.moe is not None:
                total += moe_params()
            else:
                total += mlp_params(cfg.d_ff)
        elif cfg.pattern == "xlstm":
            pos = i % cfg.xlstm_period
            total += xlstm_s() if pos == cfg.xlstm_period - 1 else xlstm_m()
    return int(total)


def active_param_count(cfg: ArchConfig) -> int:
    """Activated parameters per token (MoE: top-k + shared only)."""
    if cfg.moe is None:
        return param_count(cfg)
    m = cfg.moe
    full = param_count(cfg)
    mats = 3 if cfg.mlp_type == "swiglu" else 2

    def n_moe_layers():
        if cfg.pattern == "jamba":
            return sum(1 for i in range(cfg.n_layers) if i % 2 == 1)
        return sum(1 for i in range(cfg.n_layers)
                   if i >= cfg.first_k_dense and
                   (i - cfg.moe_offset) % cfg.moe_every == 0)

    inactive = n_moe_layers() * (m.n_experts - m.top_k) * mats * \
        cfg.d_model * m.d_ff
    return int(full - inactive)
