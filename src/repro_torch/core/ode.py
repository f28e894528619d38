"""Explicit fixed-step ODE integrators (port of ``repro/core/ode.py``).

All steppers share one contract, ``f(t, y, *f_args) -> dy/dt`` on a
state ``y`` that is a tensor of any shape (a fleet is a leading batch
axis) or a tree of tensors (the adjoint's augmented state), and keep the
JAX package's arithmetic order so results agree to float32 rounding.
``odeint`` is a plain Python loop over one time grid, or over one grid per
row of a fleet state (a resumed fleet's windows, which the JAX package
vmaps).  ``odeint_dopri5`` is the adaptive Dormand-Prince 5(4) solver
with one step controller per row of a fleet, the arithmetic of the JAX
package's vmapped ``lax.while_loop``.

On bfloat16 and float16 states the Runge-Kutta steps round each Python
coefficient to the state's dtype before it multiplies the state, as JAX's
weak typing does (torch would hold it in float32); on wider states they
are the plain arithmetic.  ``linspace_from_zero`` builds a grid as
``jnp.linspace`` does.
"""
from __future__ import annotations

import functools
from typing import Callable, Optional, Sequence

import torch

from repro_torch.tree import tree_leaves, tree_map

VectorField = Callable[..., torch.Tensor]


_HALF = (torch.bfloat16, torch.float16)


@functools.lru_cache(maxsize=256)
def _rounded(c: float, dtype: torch.dtype) -> float:
    return float(torch.tensor(c, dtype=torch.float32).to(dtype))


def _coef(a, x: torch.Tensor):
    """A Python coefficient ``a`` as JAX's weak typing makes it before it
    multiplies ``x``: rounded to a 16-bit ``x``'s dtype (through float32).
    Tensors, and every coefficient of a wider ``x``, pass unchanged: torch
    already computes with the scalar in ``x``'s float32 there."""
    if isinstance(a, (int, float)) and x.dtype in _HALF:
        return _rounded(float(a), x.dtype)
    return a


def _axpy(a, xs, ys):
    """ys + a * xs over trees."""
    return tree_map(lambda x, y: y + _coef(a, x) * x, xs, ys)


def _weighted_sum(coeffs: Sequence[float], trees: Sequence):
    acc = tree_map(lambda x: _coef(coeffs[0], x) * x, trees[0])
    for c, t in zip(coeffs[1:], trees[1:]):
        acc = tree_map(lambda a, x: a + _coef(c, x) * x, acc, t)
    return acc


def linspace_from_zero(stop: float, num: int, dtype=torch.float32,
                       device=None) -> torch.Tensor:
    """``jnp.linspace(0.0, stop, num, dtype=dtype)`` bit for bit, for the
    float32 and bfloat16 grids of the package.  XLA folds the division
    into the reciprocal ``r = 1 / (num - 1)``: in float32 point i is
    ``(stop r) i``; in bfloat16 it is ``stop (i r)`` with ``i r`` rounded
    to bfloat16 first.  The last point is ``stop`` itself.
    (``torch.linspace`` steps from both ends and, in bfloat16, lands on
    other values: 1.328125 for JAX's 1.3359375 at (0, 2, 4).)"""
    num = int(num)
    stop_t = torch.tensor(stop, dtype=torch.float32).to(dtype)
    if num == 1:
        return torch.zeros(1, dtype=dtype, device=device)
    inv = torch.tensor(1.0, dtype=torch.float32) / (num - 1)
    i = torch.arange(num - 1, dtype=torch.float32)
    if dtype == torch.bfloat16:
        pts = stop_t * (i * inv).to(dtype)
    else:
        pts = ((stop_t.to(torch.float32) * inv) * i).to(dtype)
    return torch.cat([pts, stop_t.reshape(1)]).to(device)


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


# ---------------------------------------------------------------------------
# Adaptive Dormand-Prince 5(4)
# ---------------------------------------------------------------------------

# Dopri5 tableau (Python floats: each product rounds the coefficient to the
# grid's float32 first, as the JAX package's float32 tableau arrays do).
_DP_C = (0.0, 1 / 5, 3 / 10, 4 / 5, 8 / 9, 1.0, 1.0)
_DP_A = (
    (),
    (1 / 5,),
    (3 / 40, 9 / 40),
    (44 / 45, -56 / 15, 32 / 9),
    (19372 / 6561, -25360 / 2187, 64448 / 6561, -212 / 729),
    (9017 / 3168, -355 / 33, 46732 / 5247, 49 / 176, -5103 / 18656),
    (35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84),
)
_DP_B5 = (35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84, 0.0)
_DP_B4 = (5179 / 57600, 0.0, 7571 / 16695, 393 / 640, -92097 / 339200,
          187 / 2100, 1 / 40)


def _dopri5_step(f: VectorField, t, y, dt, *f_args):
    """One Dormand-Prince step of a (..., D) state from times ``t`` with
    steps ``dt`` (both of the state's leading shape, one per row): the
    fifth-order solution and its difference from the fourth-order one.
    The zero weights of ``_DP_B5`` are added too, as in the JAX package."""
    dtc = dt[..., None]
    ks = []
    for i in range(7):
        yi = y
        for j, a in enumerate(_DP_A[i]):
            yi = yi + (dtc * a) * ks[j]
        ks.append(f(t + _DP_C[i] * dt, yi, *f_args))
    y5 = y4 = y
    for i in range(7):
        y5 = y5 + (dtc * _DP_B5[i]) * ks[i]
        y4 = y4 + (dtc * _DP_B4[i]) * ks[i]
    return y5, y5 - y4


def _error_norm(err, y0, y1, rtol: float, atol: float) -> torch.Tensor:
    """The RMS of the scaled error over each row's D elements."""
    scale = atol + rtol * torch.maximum(torch.abs(y0), torch.abs(y1))
    r = (err / scale) ** 2
    return torch.sqrt(torch.sum(r, dim=-1) / r.shape[-1])


class _NoReverse(torch.autograd.Function):
    """The dopri5 result where an input requires grad: the forward works,
    the backward raises (the JAX package's ``lax.while_loop`` has no
    reverse mode either)."""

    @staticmethod
    def forward(ctx, ys, *inputs):
        return ys.clone()

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError(
            "odeint_dopri5 is not reverse-differentiable (its adaptive "
            "loop has no reverse mode, as in the JAX package); train with "
            "method='rk4' and the continuous adjoint (gradient='adjoint')")


def odeint_dopri5(f: VectorField, y0: torch.Tensor, ts: torch.Tensor,
                  *f_args, rtol: float = 1e-5, atol: float = 1e-6,
                  max_steps: int = 4096, safety: float = 0.9,
                  stats: Optional[dict] = None) -> torch.Tensor:
    """Adaptive Dormand-Prince 5(4) with step-size control; the output
    convention of :func:`odeint`.

    Every row of an (N, D) state has its own controller: its own time,
    step, error norm (RMS over its D elements) and attempt count, as the
    JAX package's ``jax.vmap`` of one ``lax.while_loop`` per twin.  The
    loop runs while any row is active and keeps the old state of a row
    whose own condition ``(t < t1) & (attempts < max_steps)`` is false.
    A 1-D ``y0`` is one row; ``ts`` of shape (T+1, N) gives each row its
    own grid.  The step starts at ``(ts[1] - ts[0]) / 8`` per row and is
    carried across interval boundaries; ``max_steps`` counts attempts per
    interval, and an interval that reaches it ends short of its end, with
    no error, as in the JAX package.

    Each loop iteration reads one device boolean (any row active?): one
    host sync per adaptive step, so the loop is not captured in a CUDA
    graph.  The loop runs without autograd; where ``y0`` or a tensor of
    ``f_args`` requires grad, the result's backward raises
    ``NotImplementedError``.  ``stats``, a dict, receives ``iterations``
    (the loop's count over all intervals) and the per-row ``accepted``
    and ``rejected`` step counts."""
    ts = torch.as_tensor(ts).to(y0.device)
    lead = y0.shape[:-1]
    grad_inputs = [x for x in (y0, *tree_leaves(f_args))
                   if isinstance(x, torch.Tensor) and x.requires_grad]
    with torch.no_grad():
        y = y0.detach()
        dt = ((ts[1] - ts[0]) / 8.0).expand(lead)
        counted = stats is not None
        if counted:
            accepted = torch.zeros(lead, dtype=torch.int64, device=y.device)
            rejected = torch.zeros_like(accepted)
        iterations, ys = 0, [y]
        for i in range(ts.shape[0] - 1):
            t, t1 = ts[i].expand(lead), ts[i + 1].expand(lead)
            nfe = torch.zeros(lead, dtype=torch.int32, device=y.device)
            active = (t < t1) & (nfe < max_steps)
            while bool(active.any()):
                h = torch.minimum(dt, t1 - t)
                y_new, err = _dopri5_step(f, t, y, h, *f_args)
                en = _error_norm(err, y, y_new, rtol, atol)
                accept = en <= 1.0
                factor = torch.clamp(safety * (en + 1e-12) ** -0.2, 0.2, 5.0)
                new_dt = torch.clamp(h * factor, min=1e-12)
                step = active & accept
                t = torch.where(step, t + h, t)
                y = torch.where(step[..., None], y_new, y)
                dt = torch.where(active, new_dt, dt)
                nfe = torch.where(active, nfe + 1, nfe)
                if counted:
                    accepted += step
                    rejected += active & ~accept
                active = (t < t1) & (nfe < max_steps)
                iterations += 1
            ys.append(y)
        out = torch.stack(ys)
    if counted:
        stats.update(iterations=iterations, accepted=accepted,
                     rejected=rejected)
    if grad_inputs and torch.is_grad_enabled():
        return _NoReverse.apply(out, *grad_inputs)
    return out


def make_odeint(method: str = "rk4", **kwargs) -> Callable:
    """Factory returning an odeint with the method baked in."""
    if method == "dopri5":
        return functools.partial(odeint_dopri5, **kwargs)
    return functools.partial(odeint, method=method, **kwargs)
