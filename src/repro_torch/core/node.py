"""Neural-ODE modules (port of ``repro/core/node.py``).

* ``dense_linear`` — ``x @ w + b``, the affine map of every layer;
* ``mlp_init`` / ``mlp_apply`` — the small ReLU MLP the paper deploys on
  the memristor crossbars (HP twin: 2->14->14->1; Lorenz96: 6->64->64->6),
  with the JAX package's parameter layout: a list of
  ``{"w": (in, out), "b": (out,)}`` tensors.
* ``MLPVectorField`` — dy/dt = MLP([u(t), y]) or MLP(y).
* ``NeuralODE`` — ties a vector field to an integrator, a gradient mode
  and an execution backend.
* ``ContinuousDepthBlock`` — a weight-tied residual block integrated in
  pseudo-depth (the LM configs' ``ode_depth`` mode).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Optional, Sequence

import torch

from repro_torch.core.ode import linspace_from_zero, odeint
from repro_torch.device import resolve_device

Params = list


def mlp_init(generator: torch.Generator, sizes: Sequence[int], *,
             device=None, dtype=torch.float32) -> Params:
    """He-init MLP parameters: list of {'w': (in,out), 'b': (out,)}.

    Draws from ``generator`` (a CPU ``torch.Generator``) and then moves
    the tensors to ``device`` (default ``cuda``), so one seed gives the
    same weights on every device."""
    device = resolve_device(device)
    params = []
    for din, dout in zip(sizes[:-1], sizes[1:]):
        w = torch.randn((din, dout), generator=generator, dtype=dtype)
        w = w * math.sqrt(2.0 / din)
        params.append({"w": w.to(device),
                       "b": torch.zeros((dout,), dtype=dtype, device=device)})
    return params


def dense_linear(w: torch.Tensor, b: torch.Tensor,
                 x: torch.Tensor) -> torch.Tensor:
    return x @ w + b


def mlp_apply(params: Params, x: torch.Tensor) -> torch.Tensor:
    """ReLU MLP, no activation on the output layer (paper, Methods)."""
    for i, layer in enumerate(params):
        x = dense_linear(layer["w"], layer["b"], x)
        if i < len(params) - 1:
            x = torch.relu(x)
    return x


@dataclasses.dataclass(frozen=True)
class MLPVectorField:
    """dy/dt = MLP([u(t), y]) (driven) or MLP(y) (autonomous).

    ``drive(t)`` returns u(t) as a scalar or (Du,) tensor shared by every
    twin, or (N, Du) with one row per twin of an (N, D) fleet state.  A
    time tensor ``t`` of shape (N,) gives one time per row of an (N, D)
    state (the batch the JAX package forms with ``vmap``); the drive then
    returns (N,) or (N, Du).
    """
    sizes: tuple
    drive: Optional[Callable[[torch.Tensor], torch.Tensor]] = None

    def init(self, generator: torch.Generator, *, device=None) -> Params:
        return mlp_init(generator, self.sizes, device=device)

    def __call__(self, t, y: torch.Tensor, params: Params) -> torch.Tensor:
        return mlp_apply(params, field_input(self.drive, t, y))


def field_input(drive: Optional[Callable], t, y: torch.Tensor) -> torch.Tensor:
    """The MLP input of a vector field: ``[u(t), y]`` (u broadcast over the
    rows of ``y`` when shared), or ``y`` when ``drive`` is None."""
    if drive is None:
        return y
    u = torch.as_tensor(drive(t), dtype=y.dtype, device=y.device)
    t_shape = torch.as_tensor(t).shape
    u = u.reshape(*t_shape, -1) if t_shape else torch.atleast_1d(u)
    if u.ndim < y.ndim:
        u = u.expand(*y.shape[:-1], u.shape[-1])
    return torch.cat([u, y], dim=-1)


@dataclasses.dataclass(frozen=True)
class NeuralODE:
    """The memristive neural-ODE solver's software twin.

    gradient: 'adjoint' (the paper's training method: the continuous
    adjoint, or the fused VJP on the fused backend) or 'direct' (autograd
    through the unrolled solver).
    ``backend`` selects the execution substrate (None -> digital).
    """
    field: Callable  # f(t, y, params) -> dy/dt
    method: str = "rk4"
    steps_per_interval: int = 1
    gradient: str = "adjoint"
    backend: Any = None

    def init(self, generator: torch.Generator, *, device=None) -> Params:
        init = getattr(self.field, "init", None)
        if init is None:
            raise ValueError("vector field has no .init; pass params explicitly")
        return init(generator, device=device)

    def _solver_kw(self) -> dict:
        return dict(method=self.method,
                    steps_per_interval=self.steps_per_interval,
                    gradient=self.gradient)

    def trajectory(self, params: Params, y0: torch.Tensor,
                   ts: torch.Tensor) -> torch.Tensor:
        """Solve the IVP, returning y at every ts (leading axis len(ts))."""
        from repro_torch.core.backends import resolve_backend
        backend = resolve_backend(self.backend)
        state = backend.program(self.field, params)
        return backend.rollout(state, y0, ts, **self._solver_kw())

    def trajectory_batch(self, params: Params, y0s: torch.Tensor,
                         ts: torch.Tensor, *, drive_family=None,
                         drive_params=None, mesh=None) -> torch.Tensor:
        """Fleet solve: N initial conditions (and optionally per-twin
        drive parameters) in one program, (N, len(ts), D).

        ``mesh``: optional twin mesh; splits the fleet dimension across
        its devices, the substrate programmed once (see
        :meth:`repro_torch.core.backends.BaseBackend.rollout_batch`)."""
        from repro_torch.core.backends import resolve_backend
        backend = resolve_backend(self.backend)
        state = backend.program(self.field, params)
        return backend.rollout_batch(state, y0s, ts,
                                     drive_family=drive_family,
                                     drive_params=drive_params, mesh=mesh,
                                     **self._solver_kw())


# ---------------------------------------------------------------------------
# Continuous-depth residual block (paper Eq. 8 <-> Eq. 9 as a feature)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ContinuousDepthBlock:
    """Weight-tied residual block integrated in pseudo-depth.

    A discrete stack ``h <- h + block(h)`` repeated K times is the Euler
    discretisation of ``dh/ds = block(h)`` on s in [0, K]; this module
    integrates that ODE with ``method`` (RK4 by default) in ``num_steps``
    steps instead, with a single block's parameters.  The grid is
    ``jnp.linspace(0, depth, num_steps + 1)`` in ``h``'s dtype, bit for bit
    (:func:`repro_torch.core.ode.linspace_from_zero`).

    ``block_fn(params, h) -> residual`` must be s-independent (weight tied).
    """
    block_fn: Callable[[Any, torch.Tensor], torch.Tensor]
    depth: float = 1.0          # pseudo-time horizon (== #discrete layers)
    num_steps: int = 4          # solver steps across the horizon
    method: str = "rk4"

    def __call__(self, params: Any, h: torch.Tensor) -> torch.Tensor:
        def f(t, y, p):
            del t
            return self.block_fn(p, y)

        ts = linspace_from_zero(self.depth, self.num_steps + 1, h.dtype,
                                device=h.device)
        return odeint(f, h, ts, params, method=self.method)[-1]
