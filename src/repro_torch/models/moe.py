"""Mixture-of-Experts layer: shared + routed experts, top-k routing,
capacity-bounded scatter dispatch (port of ``repro/models/moe.py``).

Covers Jamba (16 routed, top-2, renormalised gates) and DeepSeek-V2's
MoE (shared + routed, top-6).  Each batch row is its own dispatch group,
as in the JAX package: tokens are sorted by expert (stable), given a
position in their expert, and scattered into an (E * C, d) buffer;
tokens over the capacity C drop.  The expert FFNs run as one batched
einsum over the expert axis, and a Switch-style load-balancing aux loss
is returned.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.models.layers import F32, dense_init, gelu


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff: int                      # per-expert FFN width
    n_shared: int = 0              # always-active shared experts
    capacity_factor: float = 1.25
    norm_topk: bool = False        # renormalise the top-k gates (Mixtral)
    aux_weight: float = 0.01
    mlp_type: str = "swiglu"


def moe_init(gen: torch.Generator, cfg: MoEConfig, d_model: int, dtype=F32,
             *, lead=()) -> dict:
    """The JAX tree; ``dense_init``'s fan_in = shape[0] makes the expert
    weights' std E ** -0.5 (0.25 for Jamba), as in the JAX package."""
    e, f = cfg.n_experts, cfg.d_ff
    p = {
        "router": dense_init(gen, (d_model, e), F32, lead=lead),
        "w_up": dense_init(gen, (e, d_model, f), dtype, lead=lead),
        "w_down": dense_init(gen, (e, f, d_model), dtype, lead=lead),
    }
    if cfg.mlp_type == "swiglu":
        p["w_gate"] = dense_init(gen, (e, d_model, f), dtype, lead=lead)
    if cfg.n_shared:
        fs = cfg.n_shared * f
        p["sh_up"] = dense_init(gen, (d_model, fs), dtype, lead=lead)
        p["sh_down"] = dense_init(gen, (fs, d_model), dtype, lead=lead)
        if cfg.mlp_type == "swiglu":
            p["sh_gate"] = dense_init(gen, (d_model, fs), dtype, lead=lead)
    return p


def _expert_ffn(params, cfg: MoEConfig, x):           # x: (G, E, C, d)
    if cfg.mlp_type == "swiglu":
        h = F.silu(torch.einsum("gecd,edf->gecf", x, params["w_gate"]))
        h = h * torch.einsum("gecd,edf->gecf", x, params["w_up"])
    else:
        h = gelu(torch.einsum("gecd,edf->gecf", x, params["w_up"]))
    return torch.einsum("gecf,efd->gecd", h, params["w_down"])


def _shared_ffn(params, cfg: MoEConfig, x):
    if cfg.mlp_type == "swiglu":
        h = F.silu(x @ params["sh_gate"]) * (x @ params["sh_up"])
    else:
        h = gelu(x @ params["sh_up"])
    return h @ params["sh_down"]


def capacity(tokens: int, cfg: MoEConfig) -> int:
    c = int(tokens * cfg.top_k * cfg.capacity_factor / cfg.n_experts) + 1
    return max(4, -(-c // 4) * 4)   # round up to a multiple of 4


def route(params, cfg: MoEConfig, x: torch.Tensor):
    """Router of :func:`moe_apply`: (probs (B, S, E), gates (B, S, k),
    expert ids (B, S, k)).  The logits are a float32 product of x cast to
    float32 with the float32 router (the JAX einsum's f32 result)."""
    logits = x.to(F32) @ params["router"]                    # (B, S, E)
    probs = torch.softmax(logits, dim=-1)
    gates, idx = torch.topk(probs, cfg.top_k, dim=-1)        # (B, S, k)
    if cfg.norm_topk:
        gates = gates / (gates.sum(-1, keepdim=True) + 1e-9)
    return probs, gates, idx


def moe_apply(params, cfg: MoEConfig, x: torch.Tensor):
    """x: (B, S, d) -> (y, aux_loss).  Grouped dispatch, each batch row
    its own group with capacity ``capacity(S, cfg)``."""
    b, s, d = x.shape
    k, e = cfg.top_k, cfg.n_experts
    c = capacity(s, cfg)
    dev = x.device
    probs, gates, idx = route(params, cfg, x)

    # dispatch: stable sort of the (token, choice) pairs by expert id,
    # position in expert = rank - first rank of that expert (searchsorted,
    # left side), over-capacity pairs sent to a spare row that is dropped
    e_flat = idx.reshape(b, s * k)
    g_flat = gates.reshape(b, s * k)
    tok = torch.arange(s, device=dev).repeat_interleave(k)
    order = torch.argsort(e_flat, dim=-1, stable=True)
    se = torch.gather(e_flat, 1, order)
    st = tok[order]                                          # (B, S*k)
    sg = torch.gather(g_flat, 1, order)
    experts = torch.arange(e, device=dev).expand(b, e).contiguous()
    starts = torch.searchsorted(se.contiguous(), experts)    # (B, E)
    pos = torch.arange(s * k, device=dev) - torch.gather(starts, 1, se)
    valid = pos < c
    slot = torch.where(valid, se * c + pos, torch.full_like(pos, e * c))
    rows = torch.arange(b, device=dev)[:, None]
    buf = torch.zeros((b, e * c + 1, d), dtype=x.dtype, device=dev)
    buf[rows, slot] = x[rows, st]                # the e*c row is "drop"
    out = _expert_ffn(params, cfg, buf[:, :e * c].reshape(b, e, c, d))
    out = out.reshape(b, e * c, d)

    # combine: each pair's expert output times its gate (zero when
    # dropped), scatter-added back onto its token, in x's dtype
    slot_safe = torch.clamp(slot, max=e * c - 1)
    w = (sg * valid).to(x.dtype)
    contrib = out[rows, slot_safe] * w[..., None]
    y = torch.zeros((b, s, d), dtype=x.dtype, device=dev)
    y.scatter_add_(1, st[..., None].expand(b, s * k, d), contrib)

    if cfg.n_shared:
        y = y + _shared_ffn(params, cfg, x)

    # Switch load-balance aux loss: aux_weight * E * sum(me * ce)
    me = probs.reshape(-1, e).mean(dim=0)
    ce = torch.zeros((e,), dtype=F32, device=dev).index_add_(
        0, idx.reshape(-1), torch.ones(idx.numel(), dtype=F32, device=dev))
    ce = ce / (b * s * k)
    aux = cfg.aux_weight * e * torch.sum(me * ce)
    return y, aux
