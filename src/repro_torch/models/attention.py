"""GQA attention (llama/qwen/internlm/musicgen/chameleon/jamba), port of
the GQA half of ``repro/models/attention.py``.

Entry points, as in the JAX package:
    gqa_init(gen, cfg)                    -> params
    gqa_prefill(params, cfg, x, pos0)     -> (out, cache)
    gqa_decode(params, cfg, x, pos, cache)-> (out, cache)

Cache layout: {"k": (B, S_max, n_kv, hd), "v": same}, or int8 values
with per-(token, head) float32 scales under ``kv_cache_quant``.  A prefill
longer than ``flash_threshold`` runs the causal attention through
:func:`repro_torch.kernels.ops.flash_attention` (K8); shorter ones, and
every decode step, through the dense :func:`_sdpa`.  MLA (DeepSeek-V2)
is not ported yet.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.kernels import ops
from repro_torch.models.layers import F32, apply_rope, dense_init, head_rmsnorm

NEG_INF = -1e30

#: Where MLA and the multi-part flash schedule wait (ROADMAP.md).
MLA_TODO = ("MLA attention (DeepSeek-V2) and the multi-part flash schedule "
            "of models/flash.py are not ported yet (ROADMAP.md, queue 1 "
            "item 13)")


@dataclasses.dataclass(frozen=True)
class AttnConfig:
    d_model: int
    n_heads: int
    n_kv: int
    head_dim: int
    rope_theta: float = 10000.0
    qk_norm: bool = False           # qwen3
    qkv_bias: bool = False          # qwen1.5
    # MLA-specific
    kv_lora: int = 0                # >0 selects MLA
    q_lora: int = 0                 # 0 = direct q projection
    rope_dim: int = 64
    v_head_dim: int = 0             # defaults to head_dim
    # memory-bounded attention (flash) for long sequences
    flash_threshold: int = 1024
    q_chunk: int = 512
    kv_chunk: int = 512
    causal_skip: bool = False
    score_dtype: str = "float32"
    kv_cache_quant: bool = False   # int8 KV cache (per-token-head scales)


def _causal_mask(sq: int, skv: int, offset, device=None) -> torch.Tensor:
    """(sq, skv) boolean mask; query i attends kv j where j <= i + offset."""
    qi = torch.arange(sq, device=device)[:, None] + offset
    kj = torch.arange(skv, device=device)[None, :]
    return kj <= qi


def _sdpa(q, k, v, mask, scale):
    """q: (B, Sq, Hq, hd), k/v: (B, Skv, Hkv, hd) grouped; float32 scores
    from operands of any dtype (the JAX einsum's f32 result), float32
    softmax, probabilities cast to v's dtype before the P.V product."""
    b, sq, hq, hd = q.shape
    hkv = k.shape[2]
    group = hq // hkv
    q = q.reshape(b, sq, hkv, group, hd)
    scores = torch.einsum("bqhgd,bkhd->bhgqk", q.to(F32), k.to(F32)) * scale
    scores = torch.where(mask[None, None, None], scores,
                         torch.tensor(NEG_INF, dtype=F32, device=q.device))
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs, v)
    return out.reshape(b, sq, hq, v.shape[-1])


def gqa_init(gen: torch.Generator, cfg: AttnConfig, dtype=F32, *,
             lead=()) -> dict:
    d, h, kvh, hd = cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.head_dim
    dev = gen.device
    p = {
        "wq": dense_init(gen, (d, h, hd), dtype, lead=lead),
        "wk": dense_init(gen, (d, kvh, hd), dtype, lead=lead),
        "wv": dense_init(gen, (d, kvh, hd), dtype, lead=lead),
        "wo": dense_init(gen, (h, hd, d), dtype, scale=(h * hd) ** -0.5,
                         lead=lead),
    }
    if cfg.qkv_bias:
        for name, heads in (("bq", h), ("bk", kvh), ("bv", kvh)):
            p[name] = torch.zeros((*lead, heads, hd), dtype=dtype, device=dev)
    if cfg.qk_norm:
        p["q_norm"] = torch.ones((*lead, hd), dtype=dtype, device=dev)
        p["k_norm"] = torch.ones((*lead, hd), dtype=dtype, device=dev)
    return p


def _gqa_qkv(params, cfg: AttnConfig, x, positions):
    """q, k, v of (B, S, heads, hd).  RoPE is applied always, whatever
    the arch config's ``use_rope`` says (Jamba's is False): AttnConfig
    has no such field and JAX's ``_gqa_qkv`` always rotates — a reference
    quirk the port mirrors."""
    q = torch.einsum("bsd,dhk->bshk", x, params["wq"])
    k = torch.einsum("bsd,dhk->bshk", x, params["wk"])
    v = torch.einsum("bsd,dhk->bshk", x, params["wv"])
    if cfg.qkv_bias:
        q = q + params["bq"]
        k = k + params["bk"]
        v = v + params["bv"]
    if cfg.qk_norm:
        q = head_rmsnorm(params["q_norm"], q)
        k = head_rmsnorm(params["k_norm"], k)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def gqa_prefill(params, cfg: AttnConfig, x, *, pos0: int = 0):
    """x: (B, S, d) -> (out, {"k", "v"}).  S > ``flash_threshold`` takes
    the flash branch (K8), otherwise the dense ``_sdpa``, as in JAX."""
    b, s, _ = x.shape
    positions = pos0 + torch.arange(s, device=x.device)[None, :]
    q, k, v = _gqa_qkv(params, cfg, x, positions)
    scale = cfg.head_dim ** -0.5
    if s > cfg.flash_threshold:
        if cfg.score_dtype != "float32":
            raise NotImplementedError(
                f"score_dtype={cfg.score_dtype!r}: K8 keeps float32 scores; "
                f"the bf16 score tiles of the JAX flash schedule are not "
                f"ported (ROADMAP.md, queue 3)")
        qc, kc = min(cfg.q_chunk, s), min(cfg.kv_chunk, s)
        if s % qc or s % kc:
            raise ValueError(
                f"seq {s} not divisible by the flash chunks (q_chunk {qc}, "
                f"kv_chunk {kc})")
        # equal q and kv offsets (pos0): the causal mask is K8's own
        out = ops.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                                  v.transpose(1, 2), scale=scale)
        out = out.transpose(1, 2)
    else:
        mask = _causal_mask(s, s, 0, x.device)
        out = _sdpa(q, k, v, mask, scale)
    return torch.einsum("bshk,hkd->bsd", out, params["wo"]), {"k": k, "v": v}


def _quant_kv(t):
    """(B, 1, H, hd) -> (int8 values, float32 per-(B, 1, H, 1) scales)."""
    scale = torch.amax(torch.abs(t), dim=-1, keepdim=True).to(F32) / 127.0 \
        + 1e-8
    q = torch.clamp(torch.round(t.to(F32) / scale), -127, 127).to(torch.int8)
    return q, scale


def _update(buf, val, pos: int):
    """``dynamic_update_slice_in_dim(buf, val, pos, axis=1)``: a new buffer
    (the old one is left as it was), the start clamped so the slice
    fits."""
    start = min(max(pos, 0), buf.shape[1] - val.shape[1])
    out = buf.clone()
    out[:, start:start + val.shape[1]] = val
    return out


def gqa_decode(params, cfg: AttnConfig, x, pos, cache):
    """x: (B, 1, d); pos: the current index (int or 0-d tensor); cache
    pre-allocated to S_max.  Returns (out, cache')."""
    b = x.shape[0]
    pos = int(pos)
    positions = torch.full((b, 1), pos, dtype=torch.int64, device=x.device)
    q, k, v = _gqa_qkv(params, cfg, x, positions)
    if cfg.kv_cache_quant:
        kq, ks = _quant_kv(k)
        vq, vs = _quant_kv(v)
        cache = {"k": _update(cache["k"], kq, pos),
                 "v": _update(cache["v"], vq, pos),
                 "k_scale": _update(cache["k_scale"], ks, pos),
                 "v_scale": _update(cache["v_scale"], vs, pos)}
        ck = cache["k"].to(q.dtype) * cache["k_scale"].to(q.dtype)
        cv = cache["v"].to(q.dtype) * cache["v_scale"].to(q.dtype)
    else:
        cache = {"k": _update(cache["k"], k, pos),
                 "v": _update(cache["v"], v, pos)}
        ck, cv = cache["k"], cache["v"]
    skv = ck.shape[1]
    mask = torch.arange(skv, device=x.device)[None, :] <= pos    # (1, skv)
    out = _sdpa(q, ck, cv, mask, cfg.head_dim ** -0.5)
    return torch.einsum("bshk,hkd->bsd", out, params["wo"]), cache


def mla_init(*args, **kwargs):
    raise NotImplementedError(MLA_TODO)


def mla_prefill(*args, **kwargs):
    raise NotImplementedError(MLA_TODO)


def mla_decode(*args, **kwargs):
    raise NotImplementedError(MLA_TODO)
