"""Memory-bounded causal attention with additive multi-part scores (port of
``repro/models/flash.py``).

:func:`flash_attention` takes the query and the key as lists of parts
whose scores add (MLA's latent and rope parts; GQA passes one of each)
and values of their own width dv.  The two devices run it differently,
each to the same function:

* on the CPU, the JAX package's schedule: for each q chunk an online
  softmax over the kv chunks, in float32, with ``causal_skip`` visiting
  only the kv chunks the q chunk can see, and query and key positions
  offset by ``q_pos0`` / ``kv_pos0``;
* on the card, the parts concatenated along the head dim (their scores
  add, so the concatenation's dot product is their sum) and one launch
  of K8 (:func:`repro_torch.kernels.ops.flash_attention`), which keeps
  every score tile on chip.  K8 takes one sequence at equal offsets, the
  only case a prefill makes; anything else raises there.

``score_dtype`` other than float32 (the JAX schedule's bf16 score tiles)
raises on both devices.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops
from repro_torch.models.layers import F32

NEG_INF = -1e30

#: Where the bf16 score tiles wait (ROADMAP.md).
SCORE_DTYPE_TODO = ("the bf16 score tiles of the JAX flash schedule are not "
                    "ported; K8 keeps float32 scores (ROADMAP.md, queue 1 "
                    "item 13)")


def _part_scores(q, k, scale):
    """q (B, qc, H, d), k (B, kc, Hkv, d) with Hkv | H -> float32
    (B, H, qc, kc) scores times ``scale``."""
    b, qc, h, d = q.shape
    hkv = k.shape[2]
    qg = q.reshape(b, qc, hkv, h // hkv, d)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg.to(F32), k.to(F32))
    return s.reshape(b, h, qc, k.shape[1]) * scale


def _pv(p, v, h):
    """p (B, H, qc, kc), v (B, kc, Hkv, dv) -> float32 (B, qc, H, dv); p is
    cast to v's dtype first, as the JAX schedule does."""
    b, _, qc, kc = p.shape
    hkv = v.shape[2]
    pg = p.reshape(b, hkv, h // hkv, qc, kc).to(v.dtype)
    out = torch.einsum("bhgqk,bkhd->bqhgd", pg.to(F32), v.to(F32))
    return out.reshape(b, qc, h, v.shape[-1])


def _on_card(q_parts, k_parts, v, scale, q_pos0, kv_pos0):
    sq, skv = q_parts[0].shape[1], k_parts[0].shape[1]
    if sq != skv or q_pos0 != kv_pos0:
        raise NotImplementedError(
            f"flash_attention on the card: K8 takes equal query and key "
            f"lengths at equal offsets (got Sq {sq}, Skv {skv}, q_pos0 "
            f"{q_pos0}, kv_pos0 {kv_pos0}; ROADMAP.md, queue 2 A5)")
    if len({p.shape[2] for p in k_parts} | {v.shape[2]}) != 1:
        raise NotImplementedError(
            f"flash_attention on the card: the key parts and the values "
            f"must share one kv head count (got "
            f"{[p.shape[2] for p in k_parts]} and {v.shape[2]})")
    q = torch.cat(q_parts, dim=-1) if len(q_parts) > 1 else q_parts[0]
    k = torch.cat(k_parts, dim=-1) if len(k_parts) > 1 else k_parts[0]
    out = ops.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                              v.transpose(1, 2), scale=scale)
    return out.transpose(1, 2)


def flash_attention(q_parts, k_parts, v, *, scale: float, q_pos0: int = 0,
                    kv_pos0: int = 0, q_chunk: int = 512,
                    kv_chunk: int = 512, causal_skip: bool = False,
                    score_dtype: str = "float32") -> torch.Tensor:
    """Causal attention with additive multi-part scores.

    q_parts: list of (B, Sq, H, d_i); k_parts: list of (B, Skv, Hkv_i, d_i)
    (Hkv_i must divide H); v: (B, Skv, Hkv_v, dv).  Query i (absolute
    position q_pos0 + i) attends key j (absolute kv_pos0 + j) where
    j_abs <= i_abs.  Returns (B, Sq, H, dv) in v's dtype.
    """
    if score_dtype != "float32":
        raise NotImplementedError(f"score_dtype={score_dtype!r}: "
                                  f"{SCORE_DTYPE_TODO}")
    b, sq, h, _ = q_parts[0].shape
    skv = k_parts[0].shape[1]
    dv = v.shape[-1]
    qc, kc = min(q_chunk, sq), min(kv_chunk, skv)
    if sq % qc or skv % kc:
        raise ValueError(
            f"seq {sq} (kv {skv}) not divisible by the flash chunks "
            f"(q_chunk {qc}, kv_chunk {kc})")
    if v.device.type == "cuda":
        return _on_card(q_parts, k_parts, v, scale, q_pos0, kv_pos0)
    nq, nk = sq // qc, skv // kc
    dev = v.device
    kv_pos = kv_pos0 + torch.arange(skv, device=dev).reshape(nk, kc)
    outs = []
    for qi in range(nq):
        rows = slice(qi * qc, (qi + 1) * qc)
        qi_parts = [p[:, rows] for p in q_parts]
        qpos = q_pos0 + torch.arange(qi * qc, (qi + 1) * qc, device=dev)
        # causal_skip: the kv chunks up to the one holding the chunk's last
        # visible key (at least one), as both of JAX's banded loops count
        nk_i = nk if not causal_skip else min(max(
            (q_pos0 + (qi + 1) * qc - 1 - kv_pos0) // kc + 1, 1), nk)
        m = torch.full((b, h, qc), NEG_INF, dtype=F32, device=dev)
        l = torch.zeros((b, h, qc), dtype=F32, device=dev)
        acc = torch.zeros((b, h, qc, dv), dtype=F32, device=dev)
        for ki in range(nk_i):
            cols = slice(ki * kc, (ki + 1) * kc)
            s = sum(_part_scores(qq, kk[:, cols], scale)
                    for qq, kk in zip(qi_parts, k_parts))   # (B, H, qc, kc)
            mask = kv_pos[ki][None, :] <= qpos[:, None]     # (qc, kc)
            s = torch.where(mask[None, None], s,
                            torch.full((), NEG_INF, dtype=F32, device=dev))
            m_new = torch.maximum(m, s.amax(-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(-1)
            acc = acc * corr[..., None] + _pv(p, v[:, cols], h).transpose(1, 2)
            m = m_new
        outs.append((acc / torch.clamp(l, min=1e-30)[..., None])
                    .transpose(1, 2))
    return torch.cat(outs, dim=1).to(v.dtype)
