"""Plain PyTorch versions of the port's kernels (port of ``repro/kernels/ref.py``).

Each function here computes what a hand-written kernel computes, with
stock tensor ops.  The kernel wrappers use them for CPU tensors, the CPU
tests hold them against the JAX package, and ``chip_smoke.py`` holds
each kernel against them on the card.
"""
from __future__ import annotations

from typing import Sequence

import torch


def mlp_fwd(weights: Sequence[torch.Tensor], biases: Sequence[torch.Tensor],
            x: torch.Tensor) -> torch.Tensor:
    """ReLU MLP: dot, then ``+ b``, then ReLU; no ReLU on the last layer."""
    for i, (w, b) in enumerate(zip(weights, biases)):
        x = x @ w + b
        if i < len(weights) - 1:
            x = torch.relu(x)
    return x


def fused_node_rollout_ref(y0: torch.Tensor, u_half: torch.Tensor,
                           weights: Sequence[torch.Tensor],
                           biases: Sequence[torch.Tensor],
                           dt: float) -> torch.Tensor:
    """RK4 rollout of dy/dt = MLP([u(t), y]) (drive optional) — the plain
    version of K1 (``kernels/csrc/fused_ode_mlp.cu``).

    y0: (B, D); u_half: drive sampled at half-steps, (2T+1, Du) shared or
    (B, 2T+1, Du) per twin (Du may be 0); returns (T+1, B, D).  ``dt`` is
    a Python float, so ``dt / 2`` and ``dt / 6`` are rounded once to the
    tensors' float32, as in the JAX kernel.
    """
    B = y0.shape[0]
    per_twin = u_half.ndim == 3
    if per_twin:
        u_half = u_half.transpose(0, 1)            # time-major (2T+1, B, Du)
    T = (u_half.shape[0] - 1) // 2
    du = u_half.shape[-1]

    def f(u, y):
        if du == 0:
            return mlp_fwd(weights, biases, y)
        if not per_twin:
            u = u[None, :].expand(B, du)
        return mlp_fwd(weights, biases, torch.cat([u, y], dim=-1))

    ys, y = [y0], y0
    for t in range(T):
        u0, um, u1 = u_half[2 * t], u_half[2 * t + 1], u_half[2 * t + 2]
        k1 = f(u0, y)
        k2 = f(um, y + dt / 2 * k1)
        k3 = f(um, y + dt / 2 * k2)
        k4 = f(u1, y + dt * k3)
        y = y + dt / 6 * (k1 + 2 * k2 + 2 * k3 + k4)
        ys.append(y)
    return torch.stack(ys)
