"""Digital-twin façade (port of ``repro/core/twin.py``).

A twin = (vector field, integrator, gradient mode) + a pluggable
execution backend (digital tensor ops, the fused CUDA kernel, or the
analogue crossbars — see :mod:`repro_torch.core.backends`).
``TwinFleet`` scales it to N independent twins in one program, and
resumes each from a carried state for streaming serving.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Any, Callable, Optional

import torch

from repro_torch.core.analogue import AnalogueSpec, program_mlp
from repro_torch.core.backends import AnalogueBackend, resolve_backend
from repro_torch.core.node import MLPVectorField, NeuralODE
from repro_torch.core.ode import odeint

Params = Any


@dataclasses.dataclass(frozen=True)
class DigitalTwin:
    """Continuous-time digital twin of a physical asset."""
    field: Any                       # f(t, y, params)
    node: NeuralODE
    state_dim: int

    @property
    def backend(self):
        return resolve_backend(self.node.backend)

    def init(self, generator: torch.Generator, *, device=None) -> Params:
        return self.field.init(generator, device=device)

    def with_backend(self, backend) -> "DigitalTwin":
        """The same twin executing on another substrate (a Backend
        instance or a registry name: 'digital', 'fused_cuda', 'analogue',
        'analogue_fused_cuda')."""
        backend = resolve_backend(backend)
        return dataclasses.replace(
            self, node=dataclasses.replace(self.node, backend=backend))

    def simulate(self, params: Params, y0: torch.Tensor, ts: torch.Tensor):
        return self.node.trajectory(params, y0, ts)

    def simulate_batch(self, params: Params, y0s: torch.Tensor,
                       ts: torch.Tensor, *,
                       drive_family: Optional[Callable] = None,
                       drive_params: Optional[torch.Tensor] = None,
                       mesh=None):
        """Batched fleet rollout: (N, D) initial conditions -> (N, T+1, D),
        equal to stacking N single-trajectory solves but executed as one
        program (one kernel launch on the fused backend).

        ``mesh``: optional :class:`~repro_torch.launch.mesh.Mesh` with a
        ``"twins"`` axis; splits the fleet dimension across its devices
        (weights copied to each, uneven N padded, padding dropped, one
        launch per shard); ``None`` stays on one device."""
        return self.node.trajectory_batch(params, y0s, ts,
                                          drive_family=drive_family,
                                          drive_params=drive_params,
                                          mesh=mesh)

    def deploy_analogue(self, prog_seed: int, params: Params,
                        spec: AnalogueSpec,
                        read_seed: Optional[int] = None) -> "DigitalTwin":
        """Deprecated: use ``twin.with_backend(AnalogueBackend(spec=spec,
        prog_seed=..., read_seed=...))`` and keep passing ``params``.

        Kept as a thin shim: programs the crossbars now (programming noise
        from a generator seeded with ``prog_seed``) so the legacy
        ``simulate(None, y0, ts)`` call pattern still works."""
        warnings.warn(
            "DigitalTwin.deploy_analogue is deprecated; use "
            "twin.with_backend(AnalogueBackend(...)) instead",
            DeprecationWarning, stacklevel=2)
        progs = tuple(program_mlp(torch.Generator().manual_seed(
            int(prog_seed)), params, spec))
        return self.with_backend(
            AnalogueBackend(spec=spec, read_seed=read_seed, progs=progs))


@dataclasses.dataclass(frozen=True)
class TwinFleet:
    """N independent instances of one trained twin (one per physical
    asset), rolled out in a single program.

    ``drive_family(t, theta) -> u`` is a parametric stimulus family; each
    fleet member i gets ``drive_params[i]``.  Autonomous fleets leave both
    None.
    """
    twin: DigitalTwin
    drive_family: Optional[Callable] = None

    @property
    def backend(self):
        return self.twin.backend

    def with_backend(self, backend) -> "TwinFleet":
        return dataclasses.replace(self, twin=self.twin.with_backend(backend))

    def simulate(self, params: Params, y0s: torch.Tensor, ts: torch.Tensor,
                 drive_params: Optional[torch.Tensor] = None) -> torch.Tensor:
        return self.rollout_batch(params, y0s, ts, drive_params)

    def rollout_batch(self, params: Params, y0s: torch.Tensor,
                      ts: torch.Tensor,
                      drive_params: Optional[torch.Tensor] = None, *,
                      mesh=None) -> torch.Tensor:
        """Fleet rollout -> (N, T+1, D): on the device of ``y0s`` with
        ``mesh=None``, else split over the ``"twins"`` axis of ``mesh``
        (the substrate programmed once and copied to each device, each
        device rolling out its slice; the same trajectories either way).
        See :mod:`repro_torch.launch.fleet_serving` for the serving
        pipeline on top."""
        if (drive_params is None) != (self.drive_family is None):
            raise ValueError(
                "drive_params and drive_family must be given together")
        return self.twin.simulate_batch(params, y0s, ts,
                                        drive_family=self.drive_family,
                                        drive_params=drive_params, mesh=mesh)

    def rollout_batch_resumed(self, params: Params, ys: torch.Tensor, *,
                              dt: float, num_steps: int, t0: float = 0.0,
                              start_steps=None,
                              drive_params: Optional[torch.Tensor] = None,
                              **kw) -> torch.Tensor:
        """Resume-from-state fleet rollout: advance each twin
        ``num_steps`` RK4 steps from its carried state ``ys[i]`` at its
        own global step ``start_steps[i]`` on the canonical grid
        ``t = t0 + dt*k`` -> (N, num_steps+1, D).  The streaming server's
        primitive: a twin served over ``[0, k)`` then ``[k, T)`` through a
        state store gets the trajectory of one request over ``[0, T)``,
        bitwise (see
        :meth:`repro_torch.core.backends.BaseBackend.rollout_batch_resumed`)."""
        if (drive_params is None) != (self.drive_family is None):
            raise ValueError(
                "drive_params and drive_family must be given together")
        node = self.twin.node
        backend = resolve_backend(node.backend)
        state = backend.program(node.field, params)
        return backend.rollout_batch_resumed(
            state, ys, dt=dt, num_steps=num_steps, t0=t0,
            start_steps=start_steps, drive_family=self.drive_family,
            drive_params=drive_params, **{**node._solver_kw(), **kw})


def make_driven_twin(state_dim: int, drive: Callable, hidden: int = 14,
                     n_hidden_layers: int = 2, method: str = "rk4",
                     gradient: str = "adjoint",
                     steps_per_interval: int = 1,
                     backend=None) -> DigitalTwin:
    """HP-memristor-style twin: dy/dt = MLP([u(t), y]).

    Default sizes (2 -> 14 -> 14 -> 1) are the paper's three crossbar
    arrays (2x14, 14x14, 14x1) for state_dim=1.
    """
    sizes = (1 + state_dim,) + (hidden,) * n_hidden_layers + (state_dim,)
    field = MLPVectorField(sizes=sizes, drive=drive)
    node = NeuralODE(field=field, method=method, gradient=gradient,
                     steps_per_interval=steps_per_interval, backend=backend)
    return DigitalTwin(field=field, node=node, state_dim=state_dim)


def make_autonomous_twin(state_dim: int, hidden: int = 64,
                         n_hidden_layers: int = 2, method: str = "rk4",
                         gradient: str = "adjoint",
                         steps_per_interval: int = 1,
                         backend=None) -> DigitalTwin:
    """Lorenz96-style twin: dy/dt = MLP(y) (no external stimulation)."""
    sizes = (state_dim,) + (hidden,) * n_hidden_layers + (state_dim,)
    field = MLPVectorField(sizes=sizes, drive=None)
    node = NeuralODE(field=field, method=method, gradient=gradient,
                     steps_per_interval=steps_per_interval, backend=backend)
    return DigitalTwin(field=field, node=node, state_dim=state_dim)


def simulate_batch(twin: DigitalTwin, params: Params, y0s: torch.Tensor,
                   ts: torch.Tensor, **kw) -> torch.Tensor:
    """Function-style alias for :meth:`DigitalTwin.simulate_batch`."""
    return twin.simulate_batch(params, y0s, ts, **kw)


def reference_trajectory(f: Callable, y0: torch.Tensor, ts: torch.Tensor,
                         *args, steps_per_interval: int = 16) -> torch.Tensor:
    """High-accuracy ground-truth solve (dense RK4) for data generation."""
    return odeint(f, y0, ts, *args, method="rk4",
                  steps_per_interval=steps_per_interval)
