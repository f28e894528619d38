"""Public wrappers around the port's kernels (port of ``repro/kernels/ops.py``).

So far the fused neural-ODE rollout (K1), its fused VJP (K2) and the
time-grid helpers they are fed by.  The crossbar, analogue and soft-DTW
ops come with later slices (ROADMAP.md, queue 2).
"""
from __future__ import annotations

from typing import Callable, Sequence

import numpy as np
import torch

from repro_torch.kernels import fused_ode_mlp as _k1
from repro_torch.kernels import fused_ode_mlp_bwd as _k2

GRADIENT_MODES = ("fused_vjp", "stopgrad")


def fused_node_rollout(params: Sequence[dict], y0: torch.Tensor,
                       u_half: torch.Tensor, dt: float, *,
                       batch_tile: int = 64, gradient: str = "fused_vjp",
                       precision: str | None = None) -> torch.Tensor:
    """Solve the twin's neural ODE with the weights-stationary kernel.

    Args:
      params: the MLP param list ``[{'w': (in, out), 'b': (out,)}, ...]``.
      y0: (B, D) initial conditions, one row per fleet member.
      u_half: drive sampled at RK4 half-steps (:func:`half_step_drive`):
        (2T+1, Du) shared, (B, 2T+1, Du) per twin, or (2T+1, 0).
      dt: RK4 step size (uniform).
      batch_tile: B must divide by it (``FusedCudaBackend`` pads).
      gradient: ``"stopgrad"`` detaches the solve (inference);
        ``"fused_vjp"`` makes it differentiable in ``y0`` and the params
        through the reverse-time kernel K2
        (:func:`repro_torch.kernels.fused_ode_mlp_bwd.fused_node_rollout_vjp`);
        the drive gets a zero cotangent.
      precision: ``None`` or ``"f32"``.

    Returns:
      The (T+1, B, D) float32 trajectory (y0 prepended).
    """
    _k1.resolve_precision(precision)
    if gradient not in GRADIENT_MODES:
        raise ValueError(
            f"unknown gradient mode {gradient!r}; have "
            f"{', '.join(repr(g) for g in GRADIENT_MODES)}")
    named = [("y0", y0), ("u_half", u_half)]
    named += [(f"params[{i}]['w']", p["w"]) for i, p in enumerate(params)]
    named += [(f"params[{i}]['b']", p["b"]) for i, p in enumerate(params)]
    for name, x in named:       # fail HERE with the dict-level input name
        _k1._require_float(name, x)
    weights = [p["w"] for p in params]
    biases = [p["b"] for p in params]
    if gradient == "fused_vjp":
        return _k2.fused_node_rollout_vjp(y0, u_half, weights, biases,
                                          float(dt), batch_tile=batch_tile)
    with torch.no_grad():
        return _k1.fused_node_rollout(y0, u_half, weights, biases, float(dt),
                                      batch_tile=batch_tile,
                                      precision=precision)


def _vmap_drive(drive: Callable, th: torch.Tensor) -> torch.Tensor:
    """``drive`` at every time of ``th`` (any shape), as ``jax.vmap``."""
    flat = th.reshape(-1)
    u = torch.func.vmap(drive)(flat)
    return u.reshape(*th.shape, *u.shape[1:])


def half_step_drive(drive: Callable, ts: torch.Tensor) -> torch.Tensor:
    """Sample a continuous drive u(t) at the RK4 half-step grid (2T+1, Du).

    The grid is a float32 ``linspace`` between the ends of ``ts``; its
    interior points may differ from ``jnp.linspace``'s by an ulp (XLA
    rewrites that arithmetic).  Resumable serving uses the exact
    :func:`half_step_times` instead."""
    T = ts.shape[0] - 1
    th = torch.linspace(float(ts[0]), float(ts[-1]), 2 * T + 1,
                        dtype=torch.float32, device=ts.device)
    u = _vmap_drive(drive, th)
    return u[:, None] if u.ndim == 1 else u


# ---------------------------------------------------------------------------
# Canonical global time grids (the streaming-resume determinism contract)
# ---------------------------------------------------------------------------
#
# Every grid point is an exact float64 function of (t0, dt, global index),
# rounded to float32 once, so any window of any split reproduces the same
# bytes as the uninterrupted grid — and the same bytes as the JAX package.
# ``start_step`` may be an int or an (N,) array of per-twin offsets.

def window_times(t0: float, dt: float, num_steps: int, start_step=0,
                 device=None) -> torch.Tensor:
    """The (num_steps+1,) f32 time grid t_i = t0 + dt*(start_step + i),
    computed in float64; (N, num_steps+1) for an (N,) ``start_step``."""
    start = np.asarray(start_step, dtype=np.int64)
    idx = start[..., None] + np.arange(num_steps + 1, dtype=np.int64)
    t = np.float64(t0) + np.float64(dt) * idx
    return torch.from_numpy(t.astype(np.float32)).to(device)


def half_step_times(t0: float, dt: float, num_steps: int, start_step=0,
                    device=None) -> torch.Tensor:
    """The (2*num_steps+1,) f32 RK4 half-step grid
    t_j = t0 + (dt/2)*(2*start_step + j), computed in float64;
    (N, 2*num_steps+1) for an (N,) ``start_step``."""
    start = np.asarray(start_step, dtype=np.int64)
    idx = 2 * start[..., None] + np.arange(2 * num_steps + 1, dtype=np.int64)
    t = np.float64(t0) + 0.5 * np.float64(dt) * idx
    return torch.from_numpy(t.astype(np.float32)).to(device)


def sample_drive_window(drive: Callable, t0: float, dt: float,
                        num_steps: int, start_step=0,
                        device=None) -> torch.Tensor:
    """Sample u(t) on the canonical half-step window: (2T'+1, Du) for a
    scalar ``start_step``, (N, 2T'+1, Du) per twin for an (N,) one."""
    th = half_step_times(t0, dt, num_steps, start_step, device=device)
    u = _vmap_drive(drive, th)
    return u[..., None] if u.ndim == th.ndim else u
