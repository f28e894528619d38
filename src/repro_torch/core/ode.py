"""Explicit fixed-step ODE integrators (port of ``repro/core/ode.py``).

All steppers share one contract, ``f(t, y, *f_args) -> dy/dt`` on a
state ``y`` that is a tensor of any shape (a fleet is a leading batch
axis) or a tree of tensors (the adjoint's augmented state), and keep the
JAX package's arithmetic order so results agree to float32 rounding.
``odeint`` is a plain Python loop over one time grid, or over one grid per
row of a fleet state (a resumed fleet's windows, which the JAX package
vmaps); the adaptive ``dopri5`` solver is not ported yet (ROADMAP queue
1).
"""
from __future__ import annotations

from typing import Callable, Sequence

import torch

from repro_torch.tree import tree_map

VectorField = Callable[..., torch.Tensor]


def _axpy(a, xs, ys):
    """ys + a * xs over trees."""
    return tree_map(lambda x, y: y + a * x, xs, ys)


def _weighted_sum(coeffs: Sequence[float], trees: Sequence):
    acc = tree_map(lambda x: coeffs[0] * x, trees[0])
    for c, t in zip(coeffs[1:], trees[1:]):
        acc = tree_map(lambda a, x: a + c * x, acc, t)
    return acc


def euler_step(f: VectorField, t, y, dt, *f_args):
    return _axpy(dt, f(t, y, *f_args), y)


def heun_step(f: VectorField, t, y, dt, *f_args):
    k1 = f(t, y, *f_args)
    k2 = f(t + dt, _axpy(dt, k1, y), *f_args)
    return _axpy(dt / 2.0, tree_map(lambda a, b: a + b, k1, k2), y)


def midpoint_step(f: VectorField, t, y, dt, *f_args):
    k1 = f(t, y, *f_args)
    k2 = f(t + dt / 2.0, _axpy(dt / 2.0, k1, y), *f_args)
    return _axpy(dt, k2, y)


def rk4_step(f: VectorField, t, y, dt, *f_args):
    """Classic 4th-order Runge-Kutta — the paper's ODESolve."""
    k1 = f(t, y, *f_args)
    k2 = f(t + dt / 2.0, _axpy(dt / 2.0, k1, y), *f_args)
    k3 = f(t + dt / 2.0, _axpy(dt / 2.0, k2, y), *f_args)
    k4 = f(t + dt, _axpy(dt, k3, y), *f_args)
    incr = _weighted_sum([1 / 6, 1 / 3, 1 / 3, 1 / 6], [k1, k2, k3, k4])
    return _axpy(dt, incr, y)


def rk38_step(f: VectorField, t, y, dt, *f_args):
    """Kutta's 3/8 rule (4th order, slightly better error constant)."""
    k1 = f(t, y, *f_args)
    k2 = f(t + dt / 3.0, _axpy(dt / 3.0, k1, y), *f_args)
    k3 = f(t + 2 * dt / 3.0,
           _axpy(dt, _weighted_sum([-1 / 3, 1.0], [k1, k2]), y), *f_args)
    k4 = f(t + dt,
           _axpy(dt, _weighted_sum([1.0, -1.0, 1.0], [k1, k2, k3]), y),
           *f_args)
    incr = _weighted_sum([1 / 8, 3 / 8, 3 / 8, 1 / 8], [k1, k2, k3, k4])
    return _axpy(dt, incr, y)


STEP_FNS = {
    "euler": euler_step,
    "heun": heun_step,
    "midpoint": midpoint_step,
    "rk4": rk4_step,
    "rk38": rk38_step,
}


def odeint(f: VectorField, y0: torch.Tensor, ts: torch.Tensor, *f_args,
           method: str = "rk4", steps_per_interval: int = 1) -> torch.Tensor:
    """Integrate ``dy/dt = f(t, y)`` and return y at every ``ts``.

    Returns a tensor with a leading axis of ``len(ts)``, ``y[0] == y0``.
    ``steps_per_interval`` sub-divides each [t_i, t_{i+1}] for accuracy
    without densifying the output grid.  As in the JAX package, each
    interval's step is ``(t_{i+1} - t_i) / sub`` in the grid's dtype.

    ``ts`` of shape (T+1, N) gives row n of an (N, D) state its own grid
    ``ts[:, n]``: each row steps with its own ``dt`` and the field sees an
    (N,) time, the arithmetic of N single-row solves.
    """
    if method not in STEP_FNS:
        raise ValueError(f"unknown method {method!r}; have {sorted(STEP_FNS)}")
    step = STEP_FNS[method]
    sub = int(steps_per_interval)
    ts = torch.as_tensor(ts).to(y0.device)
    field = f
    if ts.ndim == 2:            # one grid per row: (T+1, N, 1) broadcasts
        ts = ts[..., None]

        def field(t, y, *a):
            return f(t[..., 0], y, *a)
    ys, y = [y0], y0
    for i in range(ts.shape[0] - 1):
        t0, t1 = ts[i], ts[i + 1]
        dt = (t1 - t0) / sub
        for j in range(sub):
            y = step(field, t0 + j * dt, y, dt, *f_args)
        ys.append(y)
    return torch.stack(ys)
