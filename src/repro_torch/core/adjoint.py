"""O(1)-memory adjoint-state gradients for the neural-ODE twin (port of
``repro/core/adjoint.py``).

The paper (Methods, "Training method of continuous-time digital twin")
trains with the adjoint method of Chen et al. 2018: the gradient of the
loss w.r.t. parameters is obtained by integrating the augmented ODE

    da/dt      = -a(t)^T df/dy
    dgrad_p/dt = -a(t)^T df/dp

backwards in time, so no intermediate activation of the forward solve has
to be stored.  :func:`odeint_adjoint` has the interface of
:func:`repro_torch.core.ode.odeint` and a ``torch.autograd.Function``
whose backward integrates exactly this, interval by interval, with the
same stepper on the augmented state ``(y, a, grad_params)``.
"""
from __future__ import annotations

from typing import Any, Callable

import torch

from repro_torch.core.ode import STEP_FNS, odeint
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten

Params = Any


class _OdeintAdjoint(torch.autograd.Function):
    """apply(f, template, method, sub, ts, y0, *param_leaves) -> ys."""

    @staticmethod
    def forward(ctx, f, template, method, sub, ts, y0, *leaves):
        params = tree_unflatten(template, leaves)
        ys = odeint(f, y0, ts, params, method=method,
                    steps_per_interval=sub)
        ctx.save_for_backward(ys, ts, *leaves)
        ctx.f, ctx.template, ctx.method, ctx.sub = f, template, method, sub
        return ys

    @staticmethod
    def backward(ctx, g):
        ys, ts, *leaves = ctx.saved_tensors
        f, step, sub = ctx.f, STEP_FNS[ctx.method], ctx.sub
        leaves = [x.detach().requires_grad_(True) for x in leaves]
        params = tree_unflatten(ctx.template, leaves)

        def aug_dynamics(t, aug, params):
            """Augmented reverse dynamics on (y, a, grad_params): the
            vector-Jacobian products of f at (t, y) with -a, by autograd
            on the one evaluation's graph."""
            y, a, _ = aug
            y_ = y.detach().requires_grad_(True)
            with torch.enable_grad():
                dy = f(t, y_, params)
                a_dot = torch.autograd.grad(dy, [y_, *leaves], -a,
                                            allow_unused=True)
            a_dot = [torch.zeros_like(x) if d is None else d
                     for d, x in zip(a_dot, [y_, *leaves])]
            a_dot_p = tree_unflatten(ctx.template, a_dot[1:])
            # (dy/dt, da/dt, dgrad/dt); a_dot_* already carry the minus sign
            return (dy.detach(), a_dot[0], a_dot_p)

        a = g[-1]
        grad_p = tree_map(torch.zeros_like, params)
        for idx in range(ts.shape[0] - 2, -1, -1):
            # Each interval re-seeds y from the STORED forward trajectory
            # instead of continuing the reverse re-integration of y: for a
            # chaotic field the reverse solve leaves the forward path
            # exponentially fast, and the stored states pin it for free.
            t1, t0 = ts[idx + 1], ts[idx]
            aug = (ys[idx + 1], a, grad_p)
            dt = (t0 - t1) / sub                     # negative
            for i in range(sub):
                aug = step(aug_dynamics, t1 + i * dt, aug, dt, params)
            _, a, grad_p = aug
            a = a + g[idx]        # the cotangent injected at ts[idx]
        return (None, None, None, None, None, a, *tree_leaves(grad_p))


def odeint_adjoint(f: Callable, y0: torch.Tensor, ts: torch.Tensor,
                   params: Params, method: str = "rk4",
                   steps_per_interval: int = 1) -> torch.Tensor:
    """Like ``odeint(f, y0, ts, params)`` with adjoint gradients.

    ``f(t, y, params) -> dy/dt``.  Differentiable in ``y0`` and the
    tensors of ``params`` (a tree); ``ts`` is treated as
    non-differentiable observation times."""
    if method not in STEP_FNS:
        raise ValueError(f"unknown method {method!r}; have {sorted(STEP_FNS)}")
    ts = torch.as_tensor(ts).to(y0.device)
    return _OdeintAdjoint.apply(f, params, method, int(steps_per_interval),
                                ts, y0, *tree_leaves(params))
