"""xLSTM blocks (Beck et al. 2024; port of ``repro/models/xlstm.py``):
mLSTM (matrix memory, chunkwise-parallel prefill, O(1) recurrent decode)
and sLSTM (scalar memory, sequential recurrence with exponential gating).

The mLSTM prefill is the chunkwise linear-attention form with log-space
gate stabilisation: L x L products per head inside a chunk and a carried
state (C, n, m) between chunks, a Python loop over the chunks where the
JAX package runs ``lax.scan``.  The sLSTM's gates read h_{t-1}, so its
prefill is a Python loop over the sequence, one small step a token.
Neither runs a kernel of its own: every op is PyTorch's.

Dtypes follow the JAX package: the projections run in the model dtype,
q, k, v and the gates in float32 (``wi``, ``wf`` and the sLSTM bias ``b``
are float32 leaves even in a bfloat16 model), and the recurrent states
are float32.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.models.layers import F32, dense_init, gelu, rmsnorm


@dataclasses.dataclass(frozen=True)
class XLSTMConfig:
    d_model: int
    n_heads: int
    m_proj_factor: float = 2.0     # mLSTM up-projection
    s_proj_factor: float = 4.0 / 3.0
    d_conv: int = 4
    chunk: int = 128

    @property
    def d_inner(self) -> int:
        return int(self.m_proj_factor * self.d_model)

    @property
    def head_dim(self) -> int:
        return self.d_inner // self.n_heads


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------

def mlstm_init(gen: torch.Generator, cfg: XLSTMConfig, dtype=F32, *,
               lead=()) -> dict:
    """JAX's tree and distributions; ``wi`` and ``wf`` stay float32."""
    d, di, h = cfg.d_model, cfg.d_inner, cfg.n_heads
    dev = gen.device
    conv_w = torch.randn((*lead, cfg.d_conv, di), generator=gen, dtype=F32,
                         device=dev)
    return {
        "up": dense_init(gen, (d, 2 * di), dtype, lead=lead),
        "conv_w": (conv_w * cfg.d_conv ** -0.5).to(dtype),
        "conv_b": torch.zeros((*lead, di), dtype=dtype, device=dev),
        "wq": dense_init(gen, (di, di), dtype, lead=lead),
        "wk": dense_init(gen, (di, di), dtype, lead=lead),
        "wv": dense_init(gen, (di, di), dtype, lead=lead),
        "wi": dense_init(gen, (di, h), F32, lead=lead),
        "wf": dense_init(gen, (di, h), F32, lead=lead),
        "gn": torch.ones((*lead, di), dtype=dtype, device=dev),
        "down": dense_init(gen, (di, d), dtype, lead=lead),
    }


def _conv_silu(params, cfg: XLSTMConfig, x: torch.Tensor) -> torch.Tensor:
    """Causal depthwise conv of width ``d_conv``, then SiLU; the taps
    summed in Python's order, 0 + t0 + t1 + ..."""
    k, s = cfg.d_conv, x.shape[1]
    pad = F.pad(x, (0, 0, k - 1, 0))
    out = sum(pad[:, i:i + s, :] * params["conv_w"][i]
              for i in range(k)) + params["conv_b"]
    return F.silu(out)


def _heads(x: torch.Tensor, h: int) -> torch.Tensor:
    b, s, di = x.shape
    return x.reshape(b, s, h, di // h)


def _mlstm_chunk(q, k, v, lgi, lgf, state):
    """One chunk of the stabilised chunkwise mLSTM.

    q, k, v: (B, H, L, dk) float32; lgi / lgf: (B, H, L) log input gate
    preactivation / log forget gate.  state: (c (B, H, dk, dv), n (B, H,
    dk), m (B, H)).  Returns (h, state')."""
    L, dk = q.shape[-2], q.shape[-1]
    cum = torch.cumsum(lgf, dim=-1)                          # (B, H, L)
    # intra-chunk decay matrix D_ij = cum_i - cum_j + lgi_j  (j <= i)
    D = cum[..., :, None] - cum[..., None, :] + lgi[..., None, :]
    mask = torch.tril(torch.ones((L, L), dtype=torch.bool, device=q.device))
    D = torch.where(mask, D, -torch.inf)
    m_intra = torch.amax(D, dim=-1)                          # (B, H, L)
    c_prev, n_prev, m_prev = state
    m_inter = cum + m_prev[..., None]
    m = torch.clamp_min(torch.maximum(m_intra, m_inter), -1e30)

    scale = dk ** -0.5
    qk = (q @ k.transpose(-1, -2)) * scale
    S = qk * torch.exp(D - m[..., :, None])
    inter_w = torch.exp(m_inter - m)                         # (B, H, L)
    qs = q * scale
    num = S @ v + inter_w[..., None] * (qs @ c_prev)
    den = torch.abs(S.sum(-1) + inter_w * (qs @ n_prev[..., None])[..., 0])
    den = torch.maximum(den, torch.exp(-m))
    h = num / den[..., None]

    # state update to the chunk end
    cL = cum[..., -1]                                        # (B, H)
    log_wj = cL[..., None] - cum + lgi                       # (B, H, L)
    m_new = torch.maximum(m_prev + cL, torch.amax(log_wj, dim=-1))
    m_new = torch.clamp_min(m_new, -1e30)
    carry_scale = torch.exp(m_prev + cL - m_new)             # (B, H)
    kv_w = torch.exp(log_wj - m_new[..., None])
    kw = kv_w[..., None] * k
    c_new = carry_scale[..., None, None] * c_prev + kw.transpose(-1, -2) @ v
    n_new = carry_scale[..., None] * n_prev + kw.sum(-2)
    return h, (c_new, n_new, m_new)


def _gates(params, xm: torch.Tensor):
    """(log input gate, log forget gate), float32, (..., H)."""
    x32 = xm.to(F32)
    return x32 @ params["wi"], F.logsigmoid(x32 @ params["wf"])


def mlstm_prefill(params, cfg: XLSTMConfig, x: torch.Tensor):
    """x (B, S, d) -> (y (B, S, d), state (c, n, m) after the last chunk).
    The chunk is ``min(cfg.chunk, S)``; S must be a multiple of it."""
    b, s, _ = x.shape
    h_, hd = cfg.n_heads, cfg.head_dim
    xm, z = torch.chunk(x @ params["up"], 2, dim=-1)
    xc = _conv_silu(params, cfg, xm)

    def heads(t):                          # (B, S, di) -> (B, H, S, hd)
        return _heads(t, h_).transpose(1, 2).to(F32)

    q, k, v = heads(xc @ params["wq"]), heads(xc @ params["wk"]), \
        heads(xm @ params["wv"])
    lgi, lgf = (g.transpose(1, 2) for g in _gates(params, xm))  # (B, H, S)

    L = min(cfg.chunk, s)
    if s % L:
        raise ValueError(f"seq {s} % chunk {L} != 0")
    state = (torch.zeros((b, h_, hd, hd), dtype=F32, device=x.device),
             torch.zeros((b, h_, hd), dtype=F32, device=x.device),
             torch.full((b, h_), -1e30, dtype=F32, device=x.device))
    hs = []
    for c0 in range(0, s, L):
        sl = slice(c0, c0 + L)
        hk, state = _mlstm_chunk(q[:, :, sl], k[:, :, sl], v[:, :, sl],
                                 lgi[:, :, sl], lgf[:, :, sl], state)
        hs.append(hk)
    # JAX's reassembly, mirrored: swapaxes(0, 2) then (1, 2) of the
    # (nc, B, H, L, hd) chunk outputs is not the inverse of its chunk split
    # (that is (1, 2) then (0, 2)), so rows, heads and chunks come back
    # permuted whenever B * H * nc > 1 (ROADMAP.md, queue 3)
    hs = torch.stack(hs).transpose(0, 2).transpose(1, 2)
    hs = hs.reshape(b, h_, s, hd).transpose(1, 2).reshape(b, s, cfg.d_inner)
    hs = rmsnorm({"scale": params["gn"]}, hs.to(x.dtype))   # group-norm-ish
    y = (hs + xc) * F.silu(z)
    return y @ params["down"], state


def mlstm_decode(params, cfg: XLSTMConfig, x: torch.Tensor, state):
    """x (B, 1, d); state (c, n, m) as the prefill leaves it.  As in the
    JAX package, decode drops the short conv's history: only the newest
    tap (``conv_w[-1]``) sees the token."""
    b = x.shape[0]
    h_, hd = cfg.n_heads, cfg.head_dim
    xm, z = torch.chunk(x @ params["up"], 2, dim=-1)
    xc = F.silu(xm * params["conv_w"][-1] + params["conv_b"])
    q = (xc @ params["wq"]).reshape(b, h_, hd).to(F32)
    k = (xc @ params["wk"]).reshape(b, h_, hd).to(F32)
    v = (xm @ params["wv"]).reshape(b, h_, hd).to(F32)
    lgi, lgf = (g.reshape(b, h_) for g in _gates(params, xm))

    c_prev, n_prev, m_prev = state
    m_new = torch.maximum(lgf + m_prev, lgi)
    f_s = torch.exp(lgf + m_prev - m_new)
    i_s = torch.exp(lgi - m_new)
    c = f_s[..., None, None] * c_prev + i_s[..., None, None] * (
        k[..., :, None] * v[..., None, :])
    n = f_s[..., None] * n_prev + i_s[..., None] * k
    qs = q * (hd ** -0.5)
    num = (qs[..., None, :] @ c)[..., 0, :]
    den = torch.maximum(torch.abs((qs * n).sum(-1)), torch.exp(-m_new))
    h = (num / den[..., None]).reshape(b, 1, cfg.d_inner).to(x.dtype)
    h = rmsnorm({"scale": params["gn"]}, h)
    y = (h + xc.reshape(b, 1, -1)) * F.silu(z)
    return y @ params["down"], (c, n, m_new)


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------

def slstm_init(gen: torch.Generator, cfg: XLSTMConfig, dtype=F32, *,
               lead=()) -> dict:
    """JAX's tree and distributions; the gate bias ``b`` stays float32."""
    d, h = cfg.d_model, cfg.n_heads
    hd = d // h
    df = int(cfg.s_proj_factor * d)
    dev = gen.device
    r = torch.randn((*lead, h, hd, 4 * hd), generator=gen, dtype=F32,
                    device=dev)
    return {
        "wx": dense_init(gen, (d, 4 * d), dtype, lead=lead),  # z,i,f,o inputs
        "r": (r * hd ** -0.5).to(dtype),                 # block-diag recur
        "b": torch.zeros((*lead, 4 * d), dtype=F32, device=dev),
        "gn": torch.ones((*lead, d), dtype=dtype, device=dev),
        "up_gate": dense_init(gen, (d, df), dtype, lead=lead),
        "up": dense_init(gen, (d, df), dtype, lead=lead),
        "down": dense_init(gen, (df, d), dtype, lead=lead),
    }


def _slstm_step(params, cfg: XLSTMConfig, carry, wx_t: torch.Tensor):
    """carry: (h, c, n, m), each (B, H, hd) float32; wx_t: (B, 4d), the
    token's input projection.  Returns the next carry."""
    h_prev, c_prev, n_prev, m_prev = carry
    b = h_prev.shape[0]
    nh = cfg.n_heads
    hd = cfg.d_model // nh
    rec = torch.einsum("bhd,hdk->bhk", h_prev,
                       params["r"].to(h_prev.dtype))       # (B, H, 4 hd)
    zifo = (wx_t.reshape(b, nh, 4 * hd) + rec).to(F32) \
        + params["b"].reshape(nh, 4 * hd)
    z, i, f, o = torch.chunk(zifo, 4, dim=-1)                # (B, H, hd)
    lgf = F.logsigmoid(f)
    m = torch.maximum(lgf + m_prev, i)
    i_s = torch.exp(i - m)
    f_s = torch.exp(lgf + m_prev - m)
    c = f_s * c_prev + i_s * torch.tanh(z)
    n = torch.clamp_min(f_s * n_prev + i_s, 1e-6)
    h = torch.sigmoid(o) * c / n
    return (h.to(h_prev.dtype), c, n, m)


def slstm_zero_state(cfg: XLSTMConfig, batch: int, device=None):
    nh = cfg.n_heads
    hd = cfg.d_model // nh

    def zeros():
        return torch.zeros((batch, nh, hd), dtype=F32, device=device)

    return (zeros(), zeros(), zeros(),
            torch.full((batch, nh, hd), -1e30, dtype=F32, device=device))


def _slstm_out(params, h: torch.Tensor) -> torch.Tensor:
    h = rmsnorm({"scale": params["gn"]}, h)
    y = gelu(h @ params["up_gate"]) * (h @ params["up"])
    return y @ params["down"]


def slstm_prefill(params, cfg: XLSTMConfig, x: torch.Tensor):
    """x (B, S, d) -> (y (B, S, d), the carry after the last token)."""
    b, s, d = x.shape
    wx = x @ params["wx"]                                    # (B, S, 4d)
    carry = slstm_zero_state(cfg, b, x.device)
    hs = []
    for t in range(s):
        carry = _slstm_step(params, cfg, carry, wx[:, t])
        hs.append(carry[0])
    hs = torch.stack(hs, dim=1).reshape(b, s, d).to(x.dtype)
    return _slstm_out(params, hs), carry


def slstm_decode(params, cfg: XLSTMConfig, x: torch.Tensor, state):
    b = x.shape[0]
    carry = _slstm_step(params, cfg, state, (x @ params["wx"])[:, 0, :])
    h = carry[0].reshape(b, 1, cfg.d_model).to(x.dtype)
    return _slstm_out(params, h), carry
