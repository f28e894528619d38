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
    u_tm = _time_major(u_half)
    ys, y = [y0], y0
    for t in range(u_tm.shape[0] // 2):
        y = rk4_step_ref(y, u_tm[2 * t], u_tm[2 * t + 1], u_tm[2 * t + 2],
                         weights, biases, dt)
        ys.append(y)
    return torch.stack(ys)


def _time_major(u_half: torch.Tensor) -> torch.Tensor:
    """(2T+1, Du) as it is; a per-twin (B, 2T+1, Du) as (2T+1, B, Du)."""
    return u_half.transpose(0, 1) if u_half.ndim == 3 else u_half


def rk4_step_ref(y, u0, um, u1, weights, biases, dt: float):
    """One RK4 step of dy/dt = MLP([u, y]) from y (B, D), with the drive
    rows u0, um, u1 at t, t + dt/2, t + dt: each (Du,) shared, (B, Du)
    per twin, or of width 0 (autonomous).  The update is
    y + (dt/6) * (((k1 + 2 k2) + 2 k3) + k4), as both kernels compute it."""
    B = y.shape[0]

    def f(u, y):
        if u.shape[-1] == 0:
            return mlp_fwd(weights, biases, y)
        if u.ndim == 1:
            u = u[None, :].expand(B, u.shape[0])
        return mlp_fwd(weights, biases, torch.cat([u, y], dim=-1))

    k1 = f(u0, y)
    k2 = f(um, y + dt / 2 * k1)
    k3 = f(um, y + dt / 2 * k2)
    k4 = f(u1, y + dt * k3)
    return y + dt / 6 * (k1 + 2 * k2 + 2 * k3 + k4)


def fused_node_rollout_bwd_ref(traj: torch.Tensor, u_half: torch.Tensor,
                               weights: Sequence[torch.Tensor],
                               biases: Sequence[torch.Tensor],
                               g: torch.Tensor, dt: float):
    """The VJP of :func:`fused_node_rollout_ref` — the plain version of K2
    (``kernels/csrc/fused_ode_mlp_bwd.cu``).

    traj: the forward trajectory (T+1, B, D); u_half as for the forward;
    g: the cotangent of every trajectory row, (T+1, B, D).  Walks
    t = T-1 .. 0: adds g[t+1] to the adjoint, re-evaluates the RK4 step
    from trajectory row t and pulls the adjoint back through it with
    ``torch.func.vjp``, summing the weight and bias cotangents; g[0] is
    added at the end.  Returns ``(dy0, dweights, dbiases)``.  The drive
    is data and gets no cotangent.
    """
    u_tm = _time_major(u_half)
    weights, biases = list(weights), list(biases)
    a = torch.zeros_like(traj[0])
    dws = [torch.zeros_like(w) for w in weights]
    dbs = [torch.zeros_like(b) for b in biases]
    for t in range(traj.shape[0] - 2, -1, -1):
        a = a + g[t + 1]
        u0, um, u1 = u_tm[2 * t], u_tm[2 * t + 1], u_tm[2 * t + 2]
        _, vjp = torch.func.vjp(
            lambda y_, ws_, bs_: rk4_step_ref(y_, u0, um, u1, ws_, bs_, dt),
            traj[t], weights, biases)
        a, dws_t, dbs_t = vjp(a)
        dws = [acc + d for acc, d in zip(dws, dws_t)]
        dbs = [acc + d for acc, d in zip(dbs, dbs_t)]
    return a + g[0], dws, dbs
