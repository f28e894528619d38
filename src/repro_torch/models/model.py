"""Model assembly: config -> init / forward / decode (port of
``repro/models/model.py``) for every architecture family: GQA, MLA
(DeepSeek-V2), Jamba and xLSTM.

Each architecture is an optional *prelude* (unstacked blocks) plus N
identical *periods* (Jamba's 8-layer Mamba/attention/MoE group, xLSTM's
6-block mLSTM/sLSTM group, or one dense block).  Period parameters keep
the JAX package's tree: every leaf
of ``params["stack"]`` has a leading ``n_periods`` axis, which the port
walks with a Python loop where JAX runs ``lax.scan``; the caches of the
periods are stacked on that axis as ``lax.scan`` stacks them.
``set_batch_axes`` keeps the JAX module's ambient batch axes; the
sharding constraint they feed is the identity here (no GSPMD), and the
remat of training is left out.  ``ode_depth > 0`` runs the period as one
weight-tied group integrated in pseudo-depth
(:class:`repro_torch.core.node.ContinuousDepthBlock`); it is
train/prefill only, as in the JAX package.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.node import ContinuousDepthBlock
from repro_torch.device import resolve_device
from repro_torch.models import attention as attn_lib
from repro_torch.models import mamba as mamba_lib
from repro_torch.models import moe as moe_lib
from repro_torch.models import xlstm as xlstm_lib
from repro_torch.models.attention import AttnConfig
from repro_torch.models.layers import (F32, embed_init, mlp_apply, mlp_init,
                                       rmsnorm, rmsnorm_init, unembed)
from repro_torch.tree import tree_map

Pytree = Any

# Ambient batch mesh axes for activation sharding constraints, set by a
# launcher before it builds a step (None: one device).  The JAX package
# feeds them to ``with_sharding_constraint`` at block boundaries so GSPMD
# keeps (B, S, d) activations batch-split; the port has no GSPMD (a
# program runs where its tensors lie), so that constraint is the identity,
# left out, and the axes are only kept.
_BATCH_AXES: tuple | None = None


def set_batch_axes(axes):
    global _BATCH_AXES
    _BATCH_AXES = tuple(axes) if axes else None


# ---------------------------------------------------------------------------
# Block program
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class BlockSpec:
    mixer: str                    # gqa | mla | mamba | mlstm | slstm
    ffn: Optional[tuple] = None   # ('mlp', width) | ('moe',) | None


def block_program(cfg: ArchConfig):
    """Returns (prelude: list[BlockSpec], period: list[BlockSpec], n_periods)."""
    if cfg.pattern == "dense":
        mixer = cfg.attn
        if cfg.moe is None:
            return [], [BlockSpec(mixer, ("mlp", cfg.d_ff))], cfg.n_layers
        prelude = [BlockSpec(mixer, ("mlp", cfg.d_ff_dense_))
                   ] * cfg.first_k_dense
        rem = cfg.n_layers - cfg.first_k_dense
        if cfg.moe_every == 1:
            return prelude, [BlockSpec(mixer, ("moe",))], rem
        period = [BlockSpec(mixer, ("moe",) if i == cfg.moe_offset
                            else ("mlp", cfg.d_ff))
                  for i in range(cfg.moe_every)]
        assert rem % cfg.moe_every == 0
        return prelude, period, rem // cfg.moe_every
    if cfg.pattern == "jamba":
        assert cfg.n_layers % cfg.jamba_period == 0
        period = []
        for pos in range(cfg.jamba_period):
            mixer = "gqa" if pos == cfg.jamba_attn_pos else "mamba"
            ffn = ("moe",) if (pos % 2 == 1 and cfg.moe is not None) \
                else ("mlp", cfg.d_ff)
            period.append(BlockSpec(mixer, ffn))
        return [], period, cfg.n_layers // cfg.jamba_period
    if cfg.pattern == "xlstm":
        assert cfg.n_layers % cfg.xlstm_period == 0
        period = [BlockSpec("mlstm")] * (cfg.xlstm_period - 1) + \
            [BlockSpec("slstm")]
        return [], period, cfg.n_layers // cfg.xlstm_period
    raise ValueError(cfg.pattern)


def attn_config(cfg: ArchConfig) -> AttnConfig:
    return AttnConfig(
        d_model=cfg.d_model, n_heads=cfg.n_heads, n_kv=cfg.n_kv,
        head_dim=cfg.hd, rope_theta=cfg.rope_theta, qk_norm=cfg.qk_norm,
        qkv_bias=cfg.qkv_bias, kv_lora=cfg.mla_kv_lora,
        q_lora=cfg.mla_q_lora, rope_dim=cfg.mla_rope_dim,
        v_head_dim=cfg.hd, flash_threshold=cfg.flash_threshold,
        q_chunk=cfg.attn_q_chunk, kv_chunk=cfg.attn_kv_chunk,
        causal_skip=cfg.attn_causal_skip,
        score_dtype=cfg.attn_score_dtype,
        kv_cache_quant=cfg.kv_cache_quant)


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

def _init_block(gen, cfg: ArchConfig, spec: BlockSpec, lead=()) -> dict:
    dtype = cfg.torch_dtype
    p = {"norm1": rmsnorm_init(cfg.d_model, dtype, lead=lead,
                               device=gen.device)}
    if spec.mixer == "gqa":
        p["mixer"] = attn_lib.gqa_init(gen, attn_config(cfg), dtype,
                                       lead=lead)
    elif spec.mixer == "mla":
        p["mixer"] = attn_lib.mla_init(gen, attn_config(cfg), dtype,
                                       lead=lead)
    elif spec.mixer == "mamba":
        p["mixer"] = mamba_lib.mamba_init(gen, cfg.mamba, dtype, lead=lead)
    elif spec.mixer == "mlstm":
        p["mixer"] = xlstm_lib.mlstm_init(gen, cfg.xlstm_cfg(), dtype,
                                          lead=lead)
    elif spec.mixer == "slstm":
        p["mixer"] = xlstm_lib.slstm_init(gen, cfg.xlstm_cfg(), dtype,
                                          lead=lead)
    else:
        raise ValueError(spec.mixer)
    if spec.ffn is not None:
        p["norm2"] = rmsnorm_init(cfg.d_model, dtype, lead=lead,
                                  device=gen.device)
        if spec.ffn[0] == "mlp":
            p["ffn"] = mlp_init(gen, cfg.d_model, spec.ffn[1], cfg.mlp_type,
                                dtype, lead=lead)
        else:
            p["ffn"] = moe_lib.moe_init(gen, cfg.moe, cfg.d_model, dtype,
                                        lead=lead)
    return p


def init_params(cfg: ArchConfig, seed: int = 0, device=None) -> Pytree:
    """Seeded random params on ``device`` (default ``cuda``), drawn there
    from a ``torch.Generator``: the JAX package's tree, shapes, dtypes and
    distributions, not its values.  Each stacked leaf is drawn at its full
    (n_periods, ...) shape, so nothing is built twice.  With ``ode_depth``
    the stack holds one weight-tied period."""
    prelude, period, n_periods = block_program(cfg)
    if cfg.ode_depth:
        n_periods = 1              # weight-tied continuous-depth stack
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    dtype = cfg.torch_dtype
    params = {
        "embed": embed_init(gen, cfg.vocab, cfg.d_model, dtype),
        "final_norm": rmsnorm_init(cfg.d_model, dtype, device=device),
    }
    if not cfg.tie_embeddings:
        params["head"] = embed_init(gen, cfg.vocab, cfg.d_model, dtype)
    params["prelude"] = [_init_block(gen, cfg, spec) for spec in prelude]
    params["stack"] = {f"b{i}": _init_block(gen, cfg, spec, (n_periods,))
                       for i, spec in enumerate(period)}
    return params


# ---------------------------------------------------------------------------
# Forward (prefill)
# ---------------------------------------------------------------------------

def _apply_block(p, cfg: ArchConfig, spec: BlockSpec, h, *, pos0=0,
                 want_cache=False):
    x = rmsnorm(p["norm1"], h, cfg.norm_eps)
    if spec.mixer == "gqa":
        out, cache = attn_lib.gqa_prefill(p["mixer"], attn_config(cfg), x,
                                          pos0=pos0)
    elif spec.mixer == "mla":
        out, cache = attn_lib.mla_prefill(p["mixer"], attn_config(cfg), x,
                                          pos0=pos0)
    elif spec.mixer == "mamba":
        out, cache = mamba_lib.mamba_prefill(p["mixer"], cfg.mamba, x)
    elif spec.mixer == "mlstm":
        out, cache = xlstm_lib.mlstm_prefill(p["mixer"], cfg.xlstm_cfg(), x)
    else:
        out, cache = xlstm_lib.slstm_prefill(p["mixer"], cfg.xlstm_cfg(), x)
    h = h + out
    aux = torch.zeros((), dtype=F32, device=h.device)
    if spec.ffn is not None:
        x = rmsnorm(p["norm2"], h, cfg.norm_eps)
        if spec.ffn[0] == "mlp":
            h = h + mlp_apply(p["ffn"], x, cfg.mlp_type)
        else:
            y, aux = moe_lib.moe_apply(p["ffn"], cfg.moe, x)
            h = h + y
    if not want_cache:
        cache = None
    return h, aux, cache


def _stack(trees: list) -> Pytree:
    """Leaf-wise ``torch.stack`` of same-structured trees (``lax.scan``'s
    stacked outputs)."""
    return tree_map(lambda *xs: torch.stack(xs), *trees)


def forward(params: Pytree, cfg: ArchConfig, tokens: torch.Tensor,
            *, return_cache: bool = False):
    """tokens (B, S) int -> (logits (B, S, V) float32, aux, cache|None).

    With ``ode_depth`` the period is one weight-tied residual group
    integrated by RK4 in ``ode_depth`` steps over the config's depth in
    periods; it keeps no cache (``cache["stack"]`` is None) and its aux
    loss is not summed, as in the JAX package."""
    prelude, period, n_periods = block_program(cfg)
    h = params["embed"][tokens].to(cfg.torch_dtype)
    aux = torch.zeros((), dtype=F32, device=h.device)
    pre_caches = []
    for p, spec in zip(params["prelude"], prelude):
        h, a, c = _apply_block(p, cfg, spec, h, want_cache=return_cache)
        aux = aux + a
        pre_caches.append(c)

    if cfg.ode_depth:
        # the paper's technique: the stacked residual group as a neural ODE
        # (weight-tied, RK4 in pseudo-depth over the original depth)
        group = tree_map(lambda x: x[0], params["stack"])

        def residual(gp, hh):
            out = hh
            for i, spec in enumerate(period):
                out, _, _ = _apply_block(gp[f"b{i}"], cfg, spec, out)
            return out - hh

        h = ContinuousDepthBlock(residual, depth=float(n_periods),
                                 num_steps=cfg.ode_depth)(group, h)
        stack_caches = None
    else:
        period_caches = []
        for n in range(n_periods):
            layer = tree_map(lambda x: x[n], params["stack"])
            caches = {}
            for i, spec in enumerate(period):
                h, a, c = _apply_block(layer[f"b{i}"], cfg, spec, h,
                                       want_cache=return_cache)
                aux = aux + a
                caches[f"b{i}"] = c
            period_caches.append(caches)
        stack_caches = _stack(period_caches) if return_cache else None

    h = rmsnorm(params["final_norm"], h, cfg.norm_eps)
    table = params["embed"] if cfg.tie_embeddings else params["head"]
    logits = unembed(h, table)
    cache = {"prelude": pre_caches, "stack": stack_caches} \
        if return_cache else None
    return logits, aux, cache


# ---------------------------------------------------------------------------
# Decode (single token with pre-allocated caches)
# ---------------------------------------------------------------------------

def init_cache(cfg: ArchConfig, batch: int, max_seq: int,
               device=None) -> Pytree:
    """Zero caches on ``device`` (default ``cuda``): the GQA KV cache (int8
    with per-(token, head) float32 scales under ``kv_cache_quant``), the
    MLA latent cache (ckv, k_rope), the Mamba (ssm, conv) state, the mLSTM
    (c, n, m) state with its -1e30 initial stabiliser and the sLSTM (h,
    c, n, m) state.  Stacked leaves are allocated at their (n_periods,
    ...) shape, never broadcast views."""
    device = resolve_device(device)
    prelude, period, n_periods = block_program(cfg)
    dtype = cfg.torch_dtype

    def zeros(shape, dt=dtype, lead=()):
        return torch.zeros((*lead, *shape), dtype=dt, device=device)

    def block_cache(spec: BlockSpec, lead=()):
        if spec.mixer == "gqa":
            shape = (batch, max_seq, cfg.n_kv, cfg.hd)
            if cfg.kv_cache_quant:
                sshape = (batch, max_seq, cfg.n_kv, 1)
                return {"k": zeros(shape, torch.int8, lead),
                        "v": zeros(shape, torch.int8, lead),
                        "k_scale": zeros(sshape, F32, lead),
                        "v_scale": zeros(sshape, F32, lead)}
            return {"k": zeros(shape, lead=lead),
                    "v": zeros(shape, lead=lead)}
        if spec.mixer == "mla":
            return {"ckv": zeros((batch, max_seq, cfg.mla_kv_lora),
                                 lead=lead),
                    "k_rope": zeros((batch, max_seq, cfg.mla_rope_dim),
                                    lead=lead)}
        if spec.mixer == "mamba":
            mc = cfg.mamba
            return {"ssm": zeros((batch, mc.d_inner, mc.d_state), F32, lead),
                    "conv": zeros((batch, mc.d_conv - 1, mc.d_inner),
                                  lead=lead)}
        if spec.mixer == "mlstm":
            xc = cfg.xlstm_cfg()
            heads, hd = xc.n_heads, xc.head_dim
            return (zeros((batch, heads, hd, hd), F32, lead),
                    zeros((batch, heads, hd), F32, lead),
                    torch.full((*lead, batch, heads), -1e30, dtype=F32,
                               device=device))
        if spec.mixer == "slstm":
            heads = cfg.n_heads
            shape = (batch, heads, cfg.d_model // heads)
            return (zeros(shape, F32, lead), zeros(shape, F32, lead),
                    zeros(shape, F32, lead),
                    torch.full((*lead, *shape), -1e30, dtype=F32,
                               device=device))
        raise ValueError(spec.mixer)

    stack = {f"b{i}": block_cache(spec, (n_periods,))
             for i, spec in enumerate(period)}
    return {"prelude": [block_cache(s) for s in prelude], "stack": stack}


def _decode_block(p, cfg: ArchConfig, spec: BlockSpec, h, pos, cache):
    x = rmsnorm(p["norm1"], h, cfg.norm_eps)
    if spec.mixer == "gqa":
        out, cache = attn_lib.gqa_decode(p["mixer"], attn_config(cfg), x,
                                         pos, cache)
    elif spec.mixer == "mla":
        out, cache = attn_lib.mla_decode(p["mixer"], attn_config(cfg), x,
                                         pos, cache)
    elif spec.mixer == "mamba":
        out, cache = mamba_lib.mamba_decode(p["mixer"], cfg.mamba, x, cache)
    elif spec.mixer == "mlstm":
        out, cache = xlstm_lib.mlstm_decode(p["mixer"], cfg.xlstm_cfg(), x,
                                            cache)
    else:
        out, cache = xlstm_lib.slstm_decode(p["mixer"], cfg.xlstm_cfg(), x,
                                            cache)
    h = h + out
    if spec.ffn is not None:
        x = rmsnorm(p["norm2"], h, cfg.norm_eps)
        if spec.ffn[0] == "mlp":
            h = h + mlp_apply(p["ffn"], x, cfg.mlp_type)
        else:
            y, _ = moe_lib.moe_apply(p["ffn"], cfg.moe, x)
            h = h + y
    return h, cache


def decode_step(params: Pytree, cfg: ArchConfig, tokens: torch.Tensor,
                pos, cache: Pytree):
    """tokens (B, 1); pos: the current position; returns (logits (B, 1, V)
    float32, cache')."""
    if cfg.ode_depth:
        raise NotImplementedError("ODE-depth mode is train/prefill only")
    prelude, period, n_periods = block_program(cfg)
    h = params["embed"][tokens].to(cfg.torch_dtype)
    new_pre = []
    for p, spec, c in zip(params["prelude"], prelude, cache["prelude"]):
        h, c2 = _decode_block(p, cfg, spec, h, pos, c)
        new_pre.append(c2)

    period_caches = []
    for n in range(n_periods):
        layer = tree_map(lambda x: x[n], params["stack"])
        lcache = tree_map(lambda x: x[n], cache["stack"])
        new_cache = {}
        for i, spec in enumerate(period):
            h, new_cache[f"b{i}"] = _decode_block(
                layer[f"b{i}"], cfg, spec, h, pos, lcache[f"b{i}"])
        period_caches.append(new_cache)
    h = rmsnorm(params["final_norm"], h, cfg.norm_eps)
    table = params["embed"] if cfg.tie_embeddings else params["head"]
    logits = unembed(h, table)
    return logits, {"prelude": new_pre, "stack": _stack(period_caches)}
