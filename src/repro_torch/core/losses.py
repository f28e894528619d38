"""Losses and metrics used by the paper (port of ``repro/core/losses.py``).

``l1`` and ``mre`` (Eq. 5) are the training objective and the HP
metric; hard DTW (Eq. 6-7) is reported as a metric, computed with the
JAX package's anti-diagonal wavefront.  Soft-DTW, its kernels (K5, K6)
and the Lyapunov helpers are not ported yet (ROADMAP.md, queue 1).
"""
from __future__ import annotations

import torch

BIG = 1e10


def l1(pred: torch.Tensor, true: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.abs(pred - true))


def mre(pred: torch.Tensor, true: torch.Tensor,
        eps: float = 1e-8) -> torch.Tensor:
    """Mean relative error, paper Eq. (5)."""
    return torch.mean(torch.abs((pred - true) / (torch.abs(true) + eps)))


def _pairwise_dist(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """|x_i - y_j| summed over the feature dim (paper Eq. 6 uses 1-D |.|)."""
    if x.ndim == 1:
        x = x[:, None]
    if y.ndim == 1:
        y = y[:, None]
    return torch.sum(torch.abs(x[:, None, :] - y[None, :, :]), dim=-1)


def dtw(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Hard DTW (paper Eq. 6-7) between series of shapes (n, d)/(n,) and
    (m, d)/(m,): the accumulated cost R[n-1, m-1].

    Wavefront over anti-diagonals: diagonal k holds cells (i, k-i), whose
    predecessors (i, j-1) and (i-1, j) lie on diagonal k-1 and (i-1, j-1)
    on k-2, so n+m-1 sequential steps of n-wide vector ops run the DP."""
    D = _pairwise_dist(x, y)
    n, m = D.shape
    rows = torch.arange(n, device=D.device)
    big = torch.full((1,), BIG, dtype=D.dtype, device=D.device)
    r_prev = torch.full((n,), BIG, dtype=D.dtype, device=D.device)
    r_prev[0] = D[0, 0]                                  # diagonal 0
    r_prev2 = torch.full((n,), BIG, dtype=D.dtype, device=D.device)
    for k in range(1, n + m - 1):
        j = k - rows
        valid = (j >= 0) & (j < m)
        d_k = torch.where(valid, D[rows, j.clamp(0, m - 1)], big)
        left = torch.cat([big, r_prev[:-1]])             # (i-1, j)
        diag = torch.cat([big, r_prev2[:-1]])            # (i-1, j-1)
        best = torch.minimum(torch.minimum(r_prev, left), diag)
        r_k = d_k + torch.where(d_k >= BIG, torch.zeros_like(best), best)
        r_k = torch.where(d_k >= BIG, big, r_k)
        r_prev, r_prev2 = r_k, r_prev
    return r_prev[n - 1]


def normalized_dtw(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """DTW / path-length upper bound — scale-comparable across lengths."""
    return dtw(x, y) / (x.shape[0] + y.shape[0])
