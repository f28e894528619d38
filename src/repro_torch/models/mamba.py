"""Mamba selective-SSM block, Jamba's sequence mixer (port of
``repro/models/mamba.py``).

Prefill: the projections and the causal conv in torch, then the whole
selective scan in one call of :func:`repro_torch.kernels.ops.ssm_scan`
(K9 on the card, its sequential plain version on the CPU).  The JAX
package runs a chunked associative scan here; its own test holds the
K9 TPU kernel to it within 1e-4.  Decode: the O(1) recurrent update
carrying (ssm_state, conv_state).
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models.layers import F32, dense_init, rmsnorm


@dataclasses.dataclass(frozen=True)
class MambaConfig:
    d_model: int
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: int = 0          # 0 -> ceil(d_model / 16)
    chunk: int = 128
    scan_dtype: str = "float32"   # only float32 is ported

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def dt_rank_(self) -> int:
        return self.dt_rank or -(-self.d_model // 16)


def mamba_init(gen: torch.Generator, cfg: MambaConfig, dtype=F32, *,
               lead=()) -> dict:
    """JAX's tree and distributions; ``dt_bias`` and ``A_log`` (and ``D``)
    stay float32 whatever the model dtype is."""
    d, di, n, r = cfg.d_model, cfg.d_inner, cfg.d_state, cfg.dt_rank_
    dev = gen.device
    # S4D-real initialisation for A; dt bias for softplus in [1e-3, 1e-1]
    a = torch.arange(1, n + 1, dtype=F32, device=dev).expand(*lead, di, n)
    u = torch.rand((*lead, di), generator=gen, dtype=F32, device=dev)
    dt = torch.exp(u * (math.log(0.1) - math.log(1e-3)) + math.log(1e-3))
    dt_bias = dt + torch.log(-torch.expm1(-dt))   # inverse softplus
    conv_w = torch.randn((*lead, cfg.d_conv, di), generator=gen, dtype=F32,
                         device=dev)

    def ones(width, dt_=dtype):
        return torch.ones((*lead, width), dtype=dt_, device=dev)

    return {
        "in_proj": dense_init(gen, (d, 2 * di), dtype, lead=lead),
        "conv_w": (conv_w * cfg.d_conv ** -0.5).to(dtype),
        "conv_b": torch.zeros((*lead, di), dtype=dtype, device=dev),
        "x_proj": dense_init(gen, (di, r + 2 * n), dtype, lead=lead),
        "dt_proj": dense_init(gen, (r, di), dtype, scale=r ** -0.5,
                              lead=lead),
        "dt_bias": dt_bias.to(F32),
        "A_log": torch.log(a).contiguous(),
        "D": ones(di, dt_=F32),
        "out_proj": dense_init(gen, (di, d), dtype, lead=lead),
        "dt_norm": ones(r),               # Jamba's dt/B/C RMSNorms
        "b_norm": ones(n),
        "c_norm": ones(n),
    }


def _dbc(params, cfg: MambaConfig, xc):
    """Project the conv output to (dt, B, C) with Jamba's RMS norms; all
    three float32 (dt_bias is float32, so dt promotes to it)."""
    n, r = cfg.d_state, cfg.dt_rank_
    dbc = xc @ params["x_proj"]
    dt, b_, c_ = torch.split(dbc, [r, n, n], dim=-1)
    dt = rmsnorm({"scale": params["dt_norm"]}, dt)
    b_ = rmsnorm({"scale": params["b_norm"]}, b_)
    c_ = rmsnorm({"scale": params["c_norm"]}, c_)
    dt = F.softplus(dt @ params["dt_proj"] + params["dt_bias"]).to(F32)
    return dt, b_.to(F32), c_.to(F32)


def _causal_conv(params, cfg: MambaConfig, x):
    """Depthwise causal conv over time, x (B, S, di): the taps summed in
    order i = 0..k-1, then the bias."""
    k = cfg.d_conv
    pad = F.pad(x, (0, 0, k - 1, 0))
    out = sum(pad[:, i:i + x.shape[1], :] * params["conv_w"][i]
              for i in range(k))
    return out + params["conv_b"]


def mamba_prefill(params, cfg: MambaConfig, u: torch.Tensor):
    """u: (B, S, d) -> (y, state) with state for continued decode; the scan
    is one :func:`ops.ssm_scan` call (K9)."""
    b, s, d = u.shape
    if cfg.scan_dtype != "float32":
        raise NotImplementedError(
            f"scan_dtype={cfg.scan_dtype!r}: only the float32 scan is ported "
            f"(K9 is float32, as the TPU kernel)")
    chunk = min(cfg.chunk, s)
    if s % chunk:
        raise ValueError(f"seq {s} not divisible by mamba chunk {chunk}")
    xz = u @ params["in_proj"]
    x, z = torch.chunk(xz, 2, dim=-1)
    xc = F.silu(_causal_conv(params, cfg, x))
    dt, b_, c_ = _dbc(params, cfg, xc)
    a = -torch.exp(params["A_log"])                        # (di, N)
    xc32 = xc.to(F32)
    y, h_last = ops.ssm_scan(dt.contiguous(), b_.contiguous(),
                             c_.contiguous(), xc32.contiguous(),
                             a.contiguous())
    y = y + params["D"] * xc32
    y = y.to(u.dtype) * F.silu(z)
    out = y @ params["out_proj"]
    state = {"ssm": h_last.to(F32),
             "conv": x[:, -(cfg.d_conv - 1):, :].contiguous()}
    return out, state


def mamba_decode(params, cfg: MambaConfig, u: torch.Tensor, state: dict):
    """u: (B, 1, d); state {'ssm': (B, di, N), 'conv': (B, k-1, di)}, the
    conv state being the pre-conv x of the last k-1 steps."""
    xz = u @ params["in_proj"]
    x, z = torch.chunk(xz, 2, dim=-1)                      # (B, 1, di)
    conv_in = torch.cat([state["conv"], x], dim=1)         # (B, k, di)
    xc = sum(conv_in[:, i, :] * params["conv_w"][i]
             for i in range(cfg.d_conv)) + params["conv_b"]
    xc = F.silu(xc)[:, None, :]                            # (B, 1, di)
    dt, b_, c_ = _dbc(params, cfg, xc)

    a = -torch.exp(params["A_log"])
    da = torch.exp(dt[:, 0, :, None] * a)                  # (B, di, N)
    xc32 = xc.to(F32)
    dbx = dt[:, 0, :, None] * b_[:, 0, None, :] * xc32[:, 0, :, None]
    h = da * state["ssm"] + dbx
    y = torch.einsum("bdn,bn->bd", h, c_[:, 0])
    y = y + params["D"] * xc32[:, 0]
    y = y.to(u.dtype)[:, None, :] * F.silu(z)
    out = y @ params["out_proj"]
    return out, {"ssm": h, "conv": conv_in[:, 1:, :]}
