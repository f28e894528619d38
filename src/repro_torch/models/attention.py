"""Attention variants (port of ``repro/models/attention.py``): GQA
(llama/qwen/internlm/musicgen/chameleon/jamba) and MLA (DeepSeek-V2
multi-head latent attention, compressed KV cache).

Both expose the same three entry points, as in the JAX package:
    init(gen, cfg)                    -> params
    prefill(params, cfg, x, pos0)     -> (out, cache)
    decode(params, cfg, x, pos, cache)-> (out, cache)

Cache layouts:
    GQA: {"k": (B, S_max, n_kv, hd), "v": same}, or int8 values with
         per-(token, head) float32 scales under ``kv_cache_quant``;
    MLA: {"ckv": (B, S_max, kv_lora), "k_rope": (B, S_max, rope_dim)},
         the compressed latent.

A prefill longer than ``flash_threshold`` runs the causal attention
through :func:`repro_torch.models.flash.flash_attention` (on the card one
K8 launch; MLA's absorbed form scores [q_lat, q_rope] against [ckv,
k_rope] and reads ckv as the values, so K8 runs at (d, dv) = (kv_lora +
rope_dim, kv_lora)); shorter ones, and every decode step, through the
dense :func:`_sdpa` / :func:`_mla_attend`.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.models.flash import flash_attention
from repro_torch.models.layers import F32, apply_rope, dense_init, head_rmsnorm

NEG_INF = -1e30


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
        out = flash_attention([q], [k], v, scale=scale, q_pos0=pos0,
                              kv_pos0=pos0, q_chunk=cfg.q_chunk,
                              kv_chunk=cfg.kv_chunk,
                              causal_skip=cfg.causal_skip,
                              score_dtype=cfg.score_dtype)
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


# ---------------------------------------------------------------------------
# MLA (DeepSeek-V2)
# ---------------------------------------------------------------------------

def mla_init(gen: torch.Generator, cfg: AttnConfig, dtype=F32, *,
             lead=()) -> dict:
    d, h, hd = cfg.d_model, cfg.n_heads, cfg.head_dim
    vd = cfg.v_head_dim or hd
    p = {
        # KV compression path
        "w_dkv": dense_init(gen, (d, cfg.kv_lora), dtype, lead=lead),
        "w_uk": dense_init(gen, (cfg.kv_lora, h, hd), dtype, lead=lead),
        "w_uv": dense_init(gen, (cfg.kv_lora, h, vd), dtype, lead=lead),
        "w_kr": dense_init(gen, (d, cfg.rope_dim), dtype, lead=lead),
        "wo": dense_init(gen, (h, vd, d), dtype, scale=(h * vd) ** -0.5,
                         lead=lead),
    }
    if cfg.q_lora:
        p["w_dq"] = dense_init(gen, (d, cfg.q_lora), dtype, lead=lead)
        p["w_uq"] = dense_init(gen, (cfg.q_lora, h, hd + cfg.rope_dim),
                               dtype, lead=lead)
    else:
        p["wq"] = dense_init(gen, (d, h, hd + cfg.rope_dim), dtype,
                             lead=lead)
    return p


def _mla_q(params, cfg: AttnConfig, x, positions):
    """(q_nope (B, S, H, hd), q_rope (B, S, H, rope_dim)): the direct
    projection, or the q-LoRA down and up projections."""
    if cfg.q_lora:
        cq = x @ params["w_dq"]
        q = torch.einsum("bsl,lhk->bshk", cq, params["w_uq"])
    else:
        q = torch.einsum("bsd,dhk->bshk", x, params["wq"])
    q_nope, q_rope = q[..., :cfg.head_dim], q[..., cfg.head_dim:]
    return q_nope, apply_rope(q_rope, positions, cfg.rope_theta)


def _mla_kv(params, cfg: AttnConfig, x, positions):
    """The compressed cache entries of x: (ckv (B, S, kv_lora), k_rope
    (B, S, rope_dim)), k_rope rotated as one shared head."""
    ckv = x @ params["w_dkv"]
    k_rope = apply_rope((x @ params["w_kr"])[:, :, None, :], positions,
                        cfg.rope_theta)[:, :, 0, :]
    return ckv, k_rope


def _mla_attend(params, cfg: AttnConfig, q_nope, q_rope, ckv, k_rope, mask):
    """Absorbed-matrix MLA attention: scores against the latent cache
    directly (q_nope absorbed through w_uk), float32 scores from operands
    of any dtype (the JAX einsums' f32 results), float32 softmax, the
    probabilities cast to the cache's dtype before the values."""
    scale = (cfg.head_dim + cfg.rope_dim) ** -0.5
    # absorb W_uk into the query: (B, S, H, hd) x (lora, H, hd) -> (B, S, H, lora)
    q_lat = torch.einsum("bshk,lhk->bshl", q_nope, params["w_uk"])
    s_lat = torch.einsum("bshl,btl->bhst", q_lat.to(F32), ckv.to(F32))
    s_rope = torch.einsum("bshk,btk->bhst", q_rope.to(F32), k_rope.to(F32))
    scores = (s_lat + s_rope) * scale
    scores = torch.where(mask[None, None], scores,
                         torch.tensor(NEG_INF, dtype=F32, device=ckv.device))
    probs = torch.softmax(scores, dim=-1).to(ckv.dtype)
    o_lat = torch.einsum("bhst,btl->bshl", probs, ckv)
    out = torch.einsum("bshl,lhv->bshv", o_lat, params["w_uv"])
    return torch.einsum("bshv,hvd->bsd", out, params["wo"])


def mla_prefill(params, cfg: AttnConfig, x, *, pos0: int = 0):
    """x: (B, S, d) -> (out, {"ckv", "k_rope"}).  S > ``flash_threshold``
    takes the absorbed flash branch (latent + rope scores, latent values;
    K8 on the card), otherwise the dense ``_mla_attend``, as in JAX."""
    b, s, _ = x.shape
    positions = pos0 + torch.arange(s, device=x.device)[None, :]
    q_nope, q_rope = _mla_q(params, cfg, x, positions)
    ckv, k_rope = _mla_kv(params, cfg, x, positions)
    if s > cfg.flash_threshold:
        q_lat = torch.einsum("bshk,lhk->bshl", q_nope, params["w_uk"])
        o_lat = flash_attention(
            [q_lat, q_rope], [ckv[:, :, None, :], k_rope[:, :, None, :]],
            ckv[:, :, None, :], scale=(cfg.head_dim + cfg.rope_dim) ** -0.5,
            q_pos0=pos0, kv_pos0=pos0, q_chunk=cfg.q_chunk,
            kv_chunk=cfg.kv_chunk, causal_skip=cfg.causal_skip,
            score_dtype=cfg.score_dtype)
        out = torch.einsum("bshl,lhv->bshv", o_lat, params["w_uv"])
        out = torch.einsum("bshv,hvd->bsd", out, params["wo"])
    else:
        mask = _causal_mask(s, s, 0, x.device)
        out = _mla_attend(params, cfg, q_nope, q_rope, ckv, k_rope, mask)
    return out, {"ckv": ckv, "k_rope": k_rope}


def mla_decode(params, cfg: AttnConfig, x, pos, cache):
    """x: (B, 1, d); pos: the current index (int or 0-d tensor); the
    latent cache pre-allocated to S_max.  Returns (out, cache')."""
    b = x.shape[0]
    pos = int(pos)
    positions = torch.full((b, 1), pos, dtype=torch.int64, device=x.device)
    q_nope, q_rope = _mla_q(params, cfg, x, positions)
    ckv_new, kr_new = _mla_kv(params, cfg, x, positions)
    ckv = _update(cache["ckv"], ckv_new, pos)
    k_rope = _update(cache["k_rope"], kr_new, pos)
    mask = torch.arange(ckv.shape[1], device=x.device)[None, :] <= pos
    out = _mla_attend(params, cfg, q_nope, q_rope, ckv, k_rope, mask)
    return out, {"ckv": ckv, "k_rope": k_rope}
