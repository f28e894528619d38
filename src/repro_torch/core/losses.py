"""Losses and metrics used by the paper (port of ``repro/core/losses.py``).

``l1`` and ``mre`` (Eq. 5) are the HP objective and metric.  The
Lorenz96 twin is trained on DTW (Methods); since hard DTW is not
differentiable it is trained on soft-DTW (Cuturi & Blondel 2017, the
paper's ref. 64), and hard DTW (Eq. 6-7) is reported as the metric.
``soft_dtw`` / ``soft_dtw_batch`` here are the reference DP
differentiated by autograd, which the digital substrate trains on; the
fused substrate sends soft-DTW through the wavefront kernels K5 and K6
instead (:func:`repro_torch.kernels.ops.soft_dtw`).  The Lyapunov
helpers (paper Methods, Eq. 10) size the Lorenz96 evaluation horizon.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch.core.ode import rk4_step

BIG = 1e10


def l1(pred: torch.Tensor, true: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.abs(pred - true))


def mre(pred: torch.Tensor, true: torch.Tensor,
        eps: float = 1e-8) -> torch.Tensor:
    """Mean relative error, paper Eq. (5)."""
    return torch.mean(torch.abs((pred - true) / (torch.abs(true) + eps)))


def _pairwise_dist(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """|x_i - y_j| summed over the feature dim (paper Eq. 6 uses 1-D |.|):
    (n, d)/(n,) and (m, d)/(m,) -> (n, m); leading batch dims of 3-D or
    deeper series broadcast, (B, n, d) x (B, m, d) -> (B, n, m)."""
    if x.ndim == 1:
        x = x[:, None]
    if y.ndim == 1:
        y = y[:, None]
    return torch.sum(torch.abs(x[..., :, None, :] - y[..., None, :, :]),
                     dim=-1)


def _softmin(a, b, c, gamma):
    return -gamma * torch.logsumexp(-torch.stack([a, b, c]) / gamma, dim=0)


def _hardmin(a, b, c, gamma):
    del gamma
    return torch.minimum(torch.minimum(a, b), c)


def _dtw_scan(D: torch.Tensor, gamma: float, minop: Callable) -> torch.Tensor:
    """Wavefront DP over anti-diagonals of the (..., n, m) cost matrices;
    returns the accumulated costs R[..., n-1, m-1].

    Diagonal k holds cells (i, k-i).  Cell deps: (i-1, j) and (i, j-1) on
    diagonal k-1, (i-1, j-1) on diagonal k-2 — so a loop with a
    2-diagonal carry runs the whole DP in n+m-1 sequential steps of
    n-wide vector ops (the schedule of the kernels K5/K6).  Leading dims
    are a batch of independent pairs.  Differentiable by autograd."""
    n, m = D.shape[-2], D.shape[-1]
    rows = torch.arange(n, device=D.device)
    big = torch.full((*D.shape[:-2], 1), BIG, dtype=D.dtype, device=D.device)
    # R for diagonal 0 is just D[0, 0] at i = 0; "diagonal -1" is all BIG
    r_prev = torch.cat([D[..., 0:1, 0], big.expand(*big.shape[:-1], n - 1)],
                       dim=-1)
    r_prev2 = big.expand(*big.shape[:-1], n)
    for k in range(1, n + m - 1):
        j = k - rows
        valid = (j >= 0) & (j < m)
        d_k = torch.where(valid, D[..., rows, j.clamp(0, m - 1)], big)
        left = torch.cat([big, r_prev[..., :-1]], dim=-1)      # (i-1, j)
        diag = torch.cat([big, r_prev2[..., :-1]], dim=-1)     # (i-1, j-1)
        best = minop(r_prev, left, diag, gamma)                # up = (i, j-1)
        invalid = d_k >= BIG
        r_k = d_k + torch.where(invalid, torch.zeros_like(best), best)
        r_k = torch.where(invalid, big, r_k)
        r_prev, r_prev2 = r_k, r_prev
    return r_prev[..., n - 1]


def soft_dtw(x: torch.Tensor, y: torch.Tensor,
             gamma: float = 1.0) -> torch.Tensor:
    """Differentiable soft-DTW divergence between two (possibly multi-dim)
    time series of shapes (n, d)/(n,) and (m, d)/(m,)."""
    return _dtw_scan(_pairwise_dist(x, y), gamma, _softmin)


def soft_dtw_batch(x: torch.Tensor, y: torch.Tensor,
                   gamma: float = 1.0) -> torch.Tensor:
    """:func:`soft_dtw` of each pair of a batch, (B, n[, d]) x (B, m[, d])
    -> (B,), in one batched DP (the JAX package vmaps the pairs)."""
    if x.ndim == 2:
        x = x[..., None]
    if y.ndim == 2:
        y = y[..., None]
    return _dtw_scan(_pairwise_dist(x, y), gamma, _softmin)


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


# ---------------------------------------------------------------------------
# Lyapunov analysis (paper Methods, Eq. 10)
# ---------------------------------------------------------------------------

def max_lyapunov_exponent(f: Callable, y0: torch.Tensor, params, dt: float,
                          num_steps: int, renorm_every: int = 10,
                          eps: float = 1e-6,
                          generator: Optional[torch.Generator] = None
                          ) -> torch.Tensor:
    """MLE via the tangent-vector rescaling method.

    Integrates the system with RK4 alongside a perturbation direction,
    renormalising every ``renorm_every`` steps and averaging log growth:
    lambda = (1/T) * sum log(|delta_k| / eps).  The start direction is a
    standard normal draw from ``generator`` (default: a CPU generator
    seeded with 0; the JAX package draws from a key), moved to ``y0``'s
    device.  The integration runs in ``y0``'s dtype: keep ``eps`` well
    above the state's ulp (in float32 the default 1e-6 is one or two ulp
    of a state of size ~5, and the estimate then measures rounding)."""
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    direction = torch.randn(y0.shape, generator=generator,
                            dtype=y0.dtype).to(y0.device)
    return _mle_from_direction(f, y0, params, dt, num_steps, renorm_every,
                               eps, direction)


def _mle_from_direction(f: Callable, y0: torch.Tensor, params, dt: float,
                        num_steps: int, renorm_every: int, eps: float,
                        direction: torch.Tensor) -> torch.Tensor:
    """The block loop of :func:`max_lyapunov_exponent` from a given start
    ``direction`` (scaled to length ``eps`` here).  The state and its
    perturbation step as two rows of one batch, so ``f`` must act
    row-wise on a leading axis, as every field of the package does."""
    v0 = eps * direction / (torch.linalg.norm(direction) + 1e-30)
    num_blocks = num_steps // renorm_every
    z = torch.stack([y0, y0 + v0])          # rows: state, perturbed state
    t = torch.zeros((), dtype=y0.dtype, device=y0.device)
    log_acc = torch.zeros((), dtype=y0.dtype, device=y0.device)
    with torch.no_grad():
        for _ in range(num_blocks):
            for _ in range(renorm_every):
                z = rk4_step(f, t, z, dt, params)
                t = t + dt
            delta = z[1] - z[0]
            norm = torch.linalg.norm(delta) + 1e-30
            log_acc = log_acc + torch.log(norm / eps)
            z = torch.stack([z[0], z[0] + delta * (eps / norm)])
    total_time = num_blocks * renorm_every * dt
    return log_acc / total_time


def lyapunov_time(mle: torch.Tensor) -> torch.Tensor:
    """Inverse of the maximal Lyapunov exponent (paper Methods)."""
    return 1.0 / torch.clamp(torch.as_tensor(mle), min=1e-12)
