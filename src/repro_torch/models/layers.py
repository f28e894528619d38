"""Shared transformer layers: norms, RoPE, embeddings, MLPs (port of
``repro/models/layers.py``).

Conventions, as in the JAX package: params are nested dicts of tensors;
matmul weights are (in, out), so ``x @ w`` applies them; the compute
dtype is the param dtype (bf16 for the at-scale configs) with float32
norm and softmax arithmetic.  Initialisers draw from a ``torch.Generator``
on the target device, so their values are not ``jax.random``'s; the
shapes, dtypes and distributions are.  ``lead`` prefixes a leading shape
(the stacked periods of :func:`repro_torch.models.model.init_params`)
without changing the fan-in, as JAX's ``vmap`` over the initialiser does.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

F32 = torch.float32

# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def rmsnorm_init(dim: int, dtype=F32, *, lead=(), device=None) -> dict:
    return {"scale": torch.ones((*lead, dim), dtype=dtype, device=device)}


def rmsnorm(params: dict, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMS norm computed in float32 and cast back to x's dtype."""
    x32 = x.to(F32)
    var = torch.mean(torch.square(x32), dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * params["scale"].to(F32)).to(x.dtype)


def layernorm_init(dim: int, dtype=F32, *, lead=(), device=None) -> dict:
    return {"scale": torch.ones((*lead, dim), dtype=dtype, device=device),
            "bias": torch.zeros((*lead, dim), dtype=dtype, device=device)}


def layernorm(params: dict, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Layer norm computed in float32 (population variance), cast back."""
    x32 = x.to(F32)
    mean = torch.mean(x32, dim=-1, keepdim=True)
    var = torch.var(x32, dim=-1, keepdim=True, correction=0)
    y = (x32 - mean) * torch.rsqrt(var + eps)
    return (y * params["scale"].to(F32)
            + params["bias"].to(F32)).to(x.dtype)


def head_rmsnorm(scale: torch.Tensor, x: torch.Tensor,
                 eps: float = 1e-6) -> torch.Tensor:
    """Per-head qk-norm (qwen3): normalise over head_dim in float32."""
    x32 = x.to(F32)
    var = torch.mean(torch.square(x32), dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * scale.to(F32)).to(x.dtype)


# ---------------------------------------------------------------------------
# Dense / embedding initialisers
# ---------------------------------------------------------------------------

def _normal(gen: torch.Generator, shape, std: float, dtype) -> torch.Tensor:
    """std * N(0, 1) drawn in float32 on the generator's device, then cast."""
    x = torch.randn(shape, generator=gen, dtype=F32, device=gen.device)
    return x.mul_(std).to(dtype)


def dense_init(gen: torch.Generator, shape, dtype=F32,
               scale: float | None = None, *, lead=()) -> torch.Tensor:
    """N(0, std^2) with std = fan_in ** -0.5, fan_in = shape[0] as in the
    JAX package: for stacked experts (E, d, f) that is E, a reference
    quirk the port mirrors."""
    fan_in = shape[0] if len(shape) >= 2 else 1
    std = scale if scale is not None else fan_in ** -0.5
    return _normal(gen, (*lead, *shape), std, dtype)


def embed_init(gen: torch.Generator, vocab: int, dim: int, dtype=F32, *,
               lead=()) -> torch.Tensor:
    return _normal(gen, (*lead, vocab, dim), dim ** -0.5, dtype)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_frequencies(head_dim: int, theta: float = 10000.0,
                     device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=F32, device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0) -> torch.Tensor:
    """x: (..., S, H, hd); positions: (..., S).  Rotates in float32 and
    casts back to x's dtype."""
    hd = x.shape[-1]
    freqs = rope_frequencies(hd, theta, x.device)              # (hd/2,)
    angles = positions[..., :, None].to(F32) * freqs           # (..., S, hd/2)
    cos = torch.cos(angles)[..., :, None, :]
    sin = torch.sin(angles)[..., :, None, :]
    x1, x2 = torch.chunk(x.to(F32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# MLP (dense FFN): SwiGLU / GELU / ReLU
# ---------------------------------------------------------------------------

def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default, the tanh approximation."""
    return F.gelu(x, approximate="tanh")


def mlp_init(gen: torch.Generator, d_model: int, d_ff: int,
             mlp_type: str = "swiglu", dtype=F32, *, lead=()) -> dict:
    p = {"w_up": dense_init(gen, (d_model, d_ff), dtype, lead=lead),
         "w_down": dense_init(gen, (d_ff, d_model), dtype, lead=lead)}
    if mlp_type == "swiglu":
        p["w_gate"] = dense_init(gen, (d_model, d_ff), dtype, lead=lead)
    return p


def mlp_apply(params: dict, x: torch.Tensor, mlp_type: str = "swiglu"):
    if mlp_type == "swiglu":
        h = F.silu(x @ params["w_gate"]) * (x @ params["w_up"])
    elif mlp_type == "gelu":
        h = gelu(x @ params["w_up"])
    elif mlp_type == "relu":
        h = torch.relu(x @ params["w_up"])
    else:
        raise ValueError(mlp_type)
    return h @ params["w_down"]


def mlp_flops(d_model: int, d_ff: int, mlp_type: str = "swiglu") -> int:
    mats = 3 if mlp_type == "swiglu" else 2
    return 2 * mats * d_model * d_ff


def unembed(x: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """(B, S, d) @ (V, d)^T -> float32 logits: the counterpart of the JAX
    einsum's ``preferred_element_type=jnp.float32``.  A bf16
    ``torch.matmul`` would round its output to bf16; bf16 operands on the
    card go through cuBLAS with a float32 output, elsewhere both are
    widened first (exact: every bf16 value is a float32)."""
    if x.is_cuda and x.dtype == table.dtype == torch.bfloat16:
        out = torch.mm(x.reshape(-1, x.shape[-1]), table.t(), out_dtype=F32)
        return out.reshape(*x.shape[:-1], table.shape[0])
    return x.to(F32) @ table.to(F32).t()
