"""Pluggable execution backends (port of ``repro/core/backends.py``).

One trained twin, several substrates, one abstraction:

    Backend.program(field, params) -> ExecState     ("deploy" the weights)
    Backend.apply(state, t, x)     -> dx/dt         (one vector-field eval)
    Backend.rollout(state, y0, ts) -> ys            (full IVP solve)
    Backend.rollout_batch(state, y0s, ts) -> yss    (fleet of N twins)
    Backend.rollout_batch_resumed(state, ys, dt=, num_steps=, start_steps=)
                                   -> yss    (each twin from its own step)

``DigitalBackend`` integrates with plain tensor ops (:func:`repro_torch.core.ode.odeint`);
``FusedCudaBackend`` (``"fused_cuda"``) runs the whole RK4 trajectory of
the fleet in one launch of the hand-written CUDA kernel K1
(:mod:`repro_torch.kernels.fused_ode_mlp`), the counterpart of the JAX
package's ``FusedPallasBackend``.  ``AnalogueBackend`` (``"analogue"``)
deploys the weights on simulated memristor crossbars and integrates
through them with plain tensor ops (large noise-free reads on the
crossbar kernel K7); ``FusedAnalogueCudaBackend``
(``"analogue_fused_cuda"``) runs the same deployment's whole trajectory
in one launch of K4 (:mod:`repro_torch.kernels.fused_analogue`), the
counterpart of ``FusedAnalogueBackend``.  The fleet axis is a batch
dimension written out, where JAX vmaps.  ``rollout_batch(mesh=...)``
splits it over the ``"twins"`` axis of a
:class:`~repro_torch.launch.mesh.Mesh`
(:func:`repro_torch.launch.fleet_serving.shard_rollout_batch`): the
programmed state is copied to each shard's device and each shard runs
``rollout_batch_local``, which is what the backends override.

The adaptive ``dopri5`` solver runs on the digital backend and on the
crossbar simulator (one step controller per twin); the fused backends
integrate RK4 only.
"""
from __future__ import annotations

import dataclasses
from typing import (Any, Callable, NamedTuple, Optional, Protocol,
                    runtime_checkable)

import numpy as np
import torch

from repro_torch.core.adjoint import odeint_adjoint
from repro_torch.core.analogue import (AnalogueMLPVectorField, AnalogueSpec,
                                       VerifyConfig, program_mlp,
                                       program_mlp_with_verify, stage_uint8)
from repro_torch.core.faults import FaultModel, apply_faults_to_mlp
from repro_torch.core.ode import make_odeint
from repro_torch.kernels.ops import (half_step_times, sample_drive_window,
                                     window_times)

Params = Any


class ExecState(NamedTuple):
    """A programmed twin: the executable field plus whatever parameters
    still live off-substrate."""
    field: Callable          # f(t, y, params) -> dy/dt
    params: Params           # threaded to the field, or None
    extra: Any = None        # backend-private staging (e.g. fused operands)


def _solver(method: str, steps_per_interval: int) -> Callable:
    """The integrator of ``method``: dopri5 chooses its own steps, so it
    takes no ``steps_per_interval`` (the JAX package ignores it too)."""
    if method == "dopri5":
        return make_odeint("dopri5")
    return make_odeint(method, steps_per_interval=steps_per_interval)


@runtime_checkable
class Backend(Protocol):
    """Structural type every execution substrate implements.

    Lifecycle: ``program`` once per set of weights, then any number of
    ``apply`` / ``rollout`` / ``rollout_batch`` calls against the returned
    :class:`ExecState`.  :class:`BaseBackend` holds the default
    implementations."""

    name: str

    def program(self, field: Callable, params: Params) -> ExecState:
        """Deploy ``params`` onto the substrate; returns the programmed
        state (digital: identity; analogue: conductances written, frozen;
        fused: float32 operands staged for the kernel)."""
        ...

    def apply(self, state: ExecState, t, x):
        """One vector-field evaluation dx/dt = f(t, x) on the substrate."""
        ...

    def rollout(self, state: ExecState, y0, ts, *, method: str = "rk4",
                steps_per_interval: int = 1,
                gradient: str = "direct") -> torch.Tensor:
        """Solve the IVP from ``y0`` over ``ts`` -> (T+1, D) trajectory."""
        ...

    def rollout_batch(self, state: ExecState, y0s, ts,
                      **kw) -> torch.Tensor:
        """Fleet solve: N initial conditions -> (N, T+1, D) in one
        program; ``mesh=`` splits the fleet axis across devices."""
        ...


def uniform_dt(ts, who: str) -> float:
    """The step of a uniform time grid: ``ts`` is one grid (n,) or a stack
    (S, n) of grids that share one step, each from its own start.

    Uniformity is judged on the grid VALUES, not consecutive diffs:
    float32 linspace diffs wobble by ~eps*t_max, but the values stay
    within float32 rounding of the ideal line.  Raises ``ValueError``
    naming ``who`` otherwise."""
    tsn = np.atleast_2d(np.asarray(torch.as_tensor(ts).detach().cpu(),
                                   dtype=np.float64))
    n = tsn.shape[-1]
    if n > 1:
        dt = float(np.mean(tsn[:, -1] - tsn[:, 0]) / (n - 1))
        drift = np.abs(tsn - (tsn[:, :1] + dt * np.arange(n))).max()
        tol = max(32 * np.finfo(np.float32).eps * np.abs(tsn).max(), 1e-9)
        if dt != 0 and drift <= tol:
            return dt
    raise ValueError(f"{who} needs a uniform time grid")


def _with_drive(state: ExecState, drive: Optional[Callable]) -> ExecState:
    """Re-bind the drive u(t) on a programmed field (fields are frozen
    dataclasses with a ``drive`` attribute)."""
    return state._replace(field=dataclasses.replace(state.field, drive=drive))


def _fleet_drive(drive_family: Callable, drive_params: torch.Tensor):
    """u(t) of every fleet member, (N, Du): ``drive_family(t, theta_i)``
    evaluated over the rows of ``drive_params`` (as ``jax.vmap`` does),
    at one shared time or at an (N,) time, one per member."""
    def drive(t):
        if torch.as_tensor(t).ndim:
            u = torch.func.vmap(drive_family)(t, drive_params)
        else:
            u = torch.func.vmap(lambda th: drive_family(t, th))(drive_params)
        return u.reshape(u.shape[0], -1)
    return drive


def _homogeneous(starts: np.ndarray) -> bool:
    """Whether every twin of a resumed batch sits at the same step."""
    return starts.size > 0 and bool((starts == starts[0]).all())


@dataclasses.dataclass(frozen=True, eq=False)
class BaseBackend:
    """Default implementations shared by the concrete backends."""

    name = "base"

    def program(self, field: Callable, params: Params) -> ExecState:
        return ExecState(field=field, params=params)

    def apply(self, state: ExecState, t, x):
        return state.field(t, x, state.params)

    def rollout(self, state: ExecState, y0, ts, *, method: str = "rk4",
                steps_per_interval: int = 1,
                gradient: str = "direct") -> torch.Tensor:
        """Default: direct odeint over ``apply`` (fixed-step, or the
        adaptive dopri5)."""
        del gradient  # substrate-specific backends decide differentiability
        return _solver(method, steps_per_interval)(state.field, y0, ts,
                                                   state.params)

    def rollout_batch(self, state: ExecState, y0s, ts, *,
                      drive_family: Optional[Callable] = None,
                      drive_params: Optional[torch.Tensor] = None,
                      mesh=None, **kw) -> torch.Tensor:
        """Fleet rollout: N independent twins -> (N, T+1, D), matching
        ``torch.stack([rollout(y0_i) for i])``.  ``drive_family(t, theta)``
        with per-twin ``drive_params`` (N, ...) re-binds each member's
        drive.

        ``mesh``: a :class:`~repro_torch.launch.mesh.Mesh` with a
        ``"twins"`` axis splits the fleet over its devices (the state
        copied to each, N padded up to a multiple of the shard count, the
        padding dropped, the result on the mesh's first device) and each
        shard runs :meth:`rollout_batch_local`; ``mesh=None`` runs the
        whole fleet where ``y0s`` lies.  Sharding changes only where the
        work runs."""
        if mesh is not None:
            from repro_torch.launch.fleet_serving import shard_rollout_batch
            return shard_rollout_batch(self, state, y0s, ts, mesh=mesh,
                                       drive_family=drive_family,
                                       drive_params=drive_params, **kw)
        return self.rollout_batch_local(state, y0s, ts,
                                        drive_family=drive_family,
                                        drive_params=drive_params, **kw)

    def rollout_batch_local(self, state: ExecState, y0s, ts, *,
                            drive_family: Optional[Callable] = None,
                            drive_params: Optional[torch.Tensor] = None,
                            **kw) -> torch.Tensor:
        """Single-device fleet implementation (the shard body): the fleet
        is the leading batch axis of one rollout (the JAX package vmaps N
        rollouts).  Subclasses override THIS, not ``rollout_batch``, so
        the mesh dispatch stays in one place."""
        if drive_family is not None:
            state = _with_drive(state, _fleet_drive(drive_family,
                                                    drive_params))
        return self.rollout(state, y0s, ts, **kw).transpose(0, 1)

    # -- resume-from-state rollouts (streaming serving) ---------------------
    @staticmethod
    def _resume_starts(start_steps, n: int) -> np.ndarray:
        """Normalise ``start_steps`` to a host (N,) int64 vector of
        per-twin global step offsets.  They index the canonical float64
        time grid (:func:`repro_torch.kernels.ops.window_times`), so a
        tensor is read back to the host here, once."""
        if start_steps is None:
            return np.zeros(n, np.int64)
        if isinstance(start_steps, torch.Tensor):
            start_steps = start_steps.detach().cpu().numpy()
        starts = np.asarray(start_steps, np.int64)
        if starts.ndim == 0:
            starts = np.broadcast_to(starts, (n,)).copy()
        if starts.shape != (n,) or (starts < 0).any():
            raise ValueError(
                f"rollout_batch_resumed: start_steps must be {n} "
                f"non-negative per-twin step offsets, got shape "
                f"{starts.shape}")
        return starts

    def rollout_batch_resumed(self, state: ExecState, ys, *, dt: float,
                              num_steps: int, t0: float = 0.0,
                              start_steps=None,
                              drive_family: Optional[Callable] = None,
                              drive_params: Optional[torch.Tensor] = None,
                              **kw) -> torch.Tensor:
        """Fleet rollout resuming each twin from a carried state: twin i
        advances ``num_steps`` steps from its own global step
        ``start_steps[i]`` on the canonical grid ``t = t0 + dt*k``.
        Returns (N, num_steps+1, D) with row 0 the carried states.

        The determinism contract (``docs/serving.md``): every time value
        is derived in float64 from ``(t0, dt, global step)`` and rounded to
        float32 once, so serving ``[0, k)`` then ``[k, T)`` through a state
        store is bitwise serving ``[0, T)`` in one call.  A batch whose
        twins share one step passes it to :meth:`solve_window` as the
        ``step_offset`` that keys a noisy substrate; mixed phases pass 0
        (deterministic per batch, not a replay of the noise stream).
        ``kw`` (``method``, ``steps_per_interval``, ``gradient``) go to
        :meth:`solve_window`.
        """
        starts = self._resume_starts(start_steps, ys.shape[0])
        offset = int(starts[0]) if _homogeneous(starts) else 0
        return self.solve_window(state, ys, dt=dt, num_steps=num_steps,
                                 t0=t0, starts=starts, step_offset=offset,
                                 drive_family=drive_family,
                                 drive_params=drive_params, **kw)

    def solve_window(self, state: ExecState, ys, *, dt: float,
                     num_steps: int, starts: np.ndarray,
                     step_offset: int = 0, t0: float = 0.0,
                     drive_family: Optional[Callable] = None,
                     drive_params: Optional[torch.Tensor] = None,
                     method: str = "rk4", steps_per_interval: int = 1,
                     gradient: str = "direct") -> torch.Tensor:
        """One resumed window: twin i from ``ys[i]`` at host step
        ``starts[i]`` over ``num_steps`` steps -> (N, num_steps+1, D).
        The streaming server calls it with ``step_offset`` 0, as the JAX
        package's window does.  Each row integrates on its own grid (one
        ``odeint`` over an (H+1, N) grid, where the JAX package vmaps;
        under dopri5 each row also has its own step controller); a
        digital or simulated substrate reads no ``step_offset``, and
        gradients, if any, flow by autograd through the unrolled steps
        (the continuous adjoint takes one shared grid), so ``gradient`` is
        not read either.
        """
        del step_offset, gradient
        tss = window_times(t0, dt, int(num_steps), starts, device=ys.device)
        if drive_family is not None:
            state = _with_drive(state, _fleet_drive(drive_family,
                                                    drive_params))
        out = _solver(method, steps_per_interval)(state.field, ys, tss.T,
                                                  state.params)
        return out.transpose(0, 1)


@dataclasses.dataclass(frozen=True, eq=False)
class DigitalBackend(BaseBackend):
    """Plain tensor-op execution: the reference substrate.

    ``gradient="direct"`` backpropagates through the unrolled solver with
    autograd; ``"adjoint"`` (the twins' default) integrates the
    continuous adjoint backwards (:func:`repro_torch.core.adjoint.odeint_adjoint`).
    ``method="dopri5"`` runs the adaptive solver whatever ``gradient``
    says; its result's backward raises, as in the JAX package.
    """

    name = "digital"

    def rollout(self, state: ExecState, y0, ts, *, method: str = "rk4",
                steps_per_interval: int = 1,
                gradient: str = "adjoint") -> torch.Tensor:
        if gradient == "adjoint" and method != "dopri5":
            return odeint_adjoint(state.field, y0, ts, state.params,
                                  method, steps_per_interval)
        return _solver(method, steps_per_interval)(state.field, y0, ts,
                                                   state.params)


@dataclasses.dataclass(frozen=True, eq=False)
class FusedCudaBackend(BaseBackend):
    """Whole-trajectory RK4 in one launch of the hand-written CUDA kernel
    K1, weights resident in shared memory (counterpart of the JAX
    package's ``FusedPallasBackend``).

    ``rollout`` samples the drive on the RK4 half-step grid and hands the
    full solve to :func:`repro_torch.kernels.ops.fused_node_rollout`.  It
    needs a uniform, concrete time grid and ``method='rk4'``.  A fleet
    whose size does not divide ``batch_tile`` is padded up to the next
    multiple (padded rows replicate the last twin and are dropped).

    Gradients: ``gradient="stopgrad"`` detaches the solve; every other
    mode differentiates it through the reverse-time kernel K2
    (:mod:`repro_torch.kernels.fused_ode_mlp_bwd`).  On CPU tensors the
    kernels' plain versions run instead (the tests).

    ``precision`` selects the mixed-precision policy of the substrate
    (``"f32"`` | ``"bf16"`` | ``"bf16_f32acc"``; ``None``:
    :func:`repro_torch.kernels.fused_ode_mlp.default_precision`, f32):
    the bf16 policies store weights, drive and trajectory as bfloat16, so
    a rollout comes back bfloat16, while sums accumulate in float32
    (``bf16_f32acc``) and gradients come back float32.  ``time_chunk``
    (None: planned as the JAX package plans it at its default budget) is
    where a bf16 policy rounds the carry.  Every ``rollout`` /
    ``rollout_batch`` / ``rollout_batch_local`` call takes a per-call
    ``precision=`` override.
    """

    name = "fused_cuda"
    batch_tile: int = 64
    time_chunk: Optional[int] = None
    precision: Optional[str] = None

    def program(self, field: Callable, params: Params) -> ExecState:
        """Stage float32 master weight and bias operands; the precision
        policy rounds them to its storage dtype at solve time, so a
        per-call ``precision="f32"`` on a bf16 backend is the exact
        path."""
        if params is None:
            raise ValueError("FusedCudaBackend needs the MLP params")
        weights = [p["w"].to(torch.float32) for p in params]
        biases = [p["b"].to(torch.float32) for p in params]
        return ExecState(field=field, params=params,
                         extra={"weights": weights, "biases": biases})

    def _grid(self, ts, steps_per_interval: int, device):
        """Validate + densify the time grid; returns (ts_fine, dt, sub)."""
        tsn = np.asarray(torch.as_tensor(ts).detach().cpu(), dtype=np.float64)
        dt0 = uniform_dt(tsn, "FusedCudaBackend")
        sub = int(steps_per_interval)
        T = (tsn.size - 1) * sub
        ts_fine = torch.from_numpy(
            np.linspace(tsn[0], tsn[-1], T + 1).astype(np.float32)).to(device)
        return ts_fine, dt0 / sub, sub

    def _u_half(self, drive: Optional[Callable], ts_fine: torch.Tensor):
        """Sample u(t) on the RK4 half-step grid, (2T+1, Du)."""
        from repro_torch.kernels.ops import half_step_drive
        T = ts_fine.shape[0] - 1
        if drive is None:
            return torch.zeros((2 * T + 1, 0), dtype=torch.float32,
                               device=ts_fine.device)
        return half_step_drive(drive, ts_fine).to(torch.float32)

    def _solve(self, state: ExecState, y0s, uh, dt, bt, gradient,
               precision: Optional[str] = None, step_offset: int = 0):
        """The fused solve: 'stopgrad' detaches, every other mode is the
        fused VJP (K1 forward, K2 backward).  ``precision=None`` falls back
        to the backend's policy.  ``step_offset`` (the global step of
        ``y0s`` in a resumed rollout) does not enter: the RK4 arithmetic
        is time-translation invariant once the drive is sampled.  The
        analogue subclass keys its noise and drift on it."""
        del step_offset
        from repro_torch.kernels import ops
        params = [{"w": w, "b": b} for w, b in
                  zip(state.extra["weights"], state.extra["biases"])]
        mode = "stopgrad" if gradient == "stopgrad" else "fused_vjp"
        return ops.fused_node_rollout(
            params, y0s, uh, dt, batch_tile=bt, time_chunk=self.time_chunk,
            gradient=mode,
            precision=self.precision if precision is None else precision)

    def _u_half_window(self, state: ExecState, t0: float, dt: float,
                       num_steps: int, starts: np.ndarray,
                       drive_family: Optional[Callable],
                       drive_params: Optional[torch.Tensor],
                       device) -> torch.Tensor:
        """The drive on each twin's canonical half-step window: shared
        (2H+1, Du) when every twin sits at one global step with one drive,
        per twin (N, 2H+1, Du) otherwise (mixed phases or a drive family;
        the kernel takes per-twin slabs)."""
        drive = getattr(state.field, "drive", None)
        if drive_family is not None:
            ths = half_step_times(t0, dt, num_steps, starts, device=device)

            def row(ts_row, theta):
                u = torch.func.vmap(lambda t: drive_family(t, theta))(ts_row)
                return u[:, None] if u.ndim == 1 else u

            return torch.func.vmap(row)(ths, drive_params).to(torch.float32)
        if drive is None:
            return torch.zeros((2 * num_steps + 1, 0), dtype=torch.float32,
                               device=device)
        start = int(starts[0]) if _homogeneous(starts) else starts
        return sample_drive_window(drive, t0, dt, num_steps, start,
                                   device=device).to(torch.float32)

    def solve_window(self, state: ExecState, ys, *, dt: float,
                     num_steps: int, starts: np.ndarray,
                     step_offset: int = 0, t0: float = 0.0,
                     drive_family: Optional[Callable] = None,
                     drive_params: Optional[torch.Tensor] = None,
                     method: str = "rk4", steps_per_interval: int = 1,
                     gradient: str = "fused_vjp",
                     precision: Optional[str] = None) -> torch.Tensor:
        """One resumed window in one launch: each twin's drive is sampled
        on the canonical global half-step grid, so a rollout split at any
        step and resumed from the stored row is bitwise the uninterrupted
        one (under "bf16_f32acc" only at a rounding-chunk boundary, as in
        the JAX package).  ``step_offset`` goes to the solve (the analogue
        substrate keys its noise, drift and write path on it)."""
        from repro_torch.kernels.fused_ode_mlp import pad_fleet_to_tile
        if method != "rk4" or steps_per_interval != 1:
            raise ValueError(
                "FusedCudaBackend.rollout_batch_resumed integrates plain "
                "RK4 on the canonical step grid (method='rk4', "
                f"steps_per_interval=1), got method={method!r}, "
                f"steps_per_interval={steps_per_interval}")
        uh = self._u_half_window(state, t0, dt, int(num_steps), starts,
                                 drive_family, drive_params, ys.device)
        y0s, uh, bt, B = pad_fleet_to_tile(ys, uh, self.batch_tile)
        traj = self._solve(state, y0s, uh, float(dt), bt, gradient,
                           precision, step_offset=step_offset)
        return traj[:, :B].transpose(0, 1)

    def rollout(self, state: ExecState, y0, ts, *, method: str = "rk4",
                steps_per_interval: int = 1,
                gradient: str = "fused_vjp",
                precision: Optional[str] = None) -> torch.Tensor:
        if method != "rk4":
            raise ValueError(
                f"FusedCudaBackend integrates RK4 only, got {method!r}")
        ts_fine, dt, sub = self._grid(ts, steps_per_interval, y0.device)
        uh = self._u_half(getattr(state.field, "drive", None), ts_fine)
        traj = self._solve(state, y0[None, :], uh, dt, 1, gradient,
                           precision)
        return traj[::sub, 0, :]

    def rollout_batch_local(self, state: ExecState, y0s, ts, *,
                            drive_family: Optional[Callable] = None,
                            drive_params: Optional[torch.Tensor] = None,
                            method: str = "rk4", steps_per_interval: int = 1,
                            gradient: str = "fused_vjp",
                            precision: Optional[str] = None) -> torch.Tensor:
        """Fleet solve in one kernel launch: per-twin drives sampled on
        the half-step grid as (B, 2T+1, Du), the fleet padded to a tile
        multiple, padding dropped from the (N, T+1, D) result.
        ``precision`` overrides the backend's policy for this call."""
        from repro_torch.kernels.fused_ode_mlp import pad_fleet_to_tile
        if method != "rk4":
            raise ValueError(
                f"FusedCudaBackend integrates RK4 only, got {method!r}")
        ts_fine, dt, sub = self._grid(ts, steps_per_interval, y0s.device)
        if drive_family is None:
            uh = self._u_half(getattr(state.field, "drive", None), ts_fine)
        else:
            uh = torch.func.vmap(
                lambda th_: self._u_half(lambda t: drive_family(t, th_),
                                         ts_fine))(drive_params)
        y0s, uh, bt, B = pad_fleet_to_tile(y0s, uh, self.batch_tile)
        traj = self._solve(state, y0s, uh, dt, bt, gradient, precision)
        return traj[::sub, :B].transpose(0, 1)


def _program_arrays(backend, params):
    """The deployment both analogue backends share: program the crossbars
    from ``params`` with the backend's generator seed, through the
    write-physics simulation (stuck cells, failed pulses, write-verify)
    when ``faults`` or ``verify`` is set.  Returns (progs, reports)."""
    if backend.storage not in ("float", "uint8"):
        raise ValueError(
            f"{type(backend).__name__} storage={backend.storage!r}; have "
            f"'float', 'uint8'")
    if params is None:
        raise ValueError(
            f"{type(backend).__name__} needs params to program the crossbars")
    gen = torch.Generator().manual_seed(int(backend.prog_seed))
    if backend.faults is not None or backend.verify is not None:
        # one code path simulates the write physics: naive faulty
        # programming is write-verify with zero retries
        vc = (backend.verify if backend.verify is not None
              else VerifyConfig(max_retries=0))
        progs, reports = program_mlp_with_verify(
            gen, params, backend.spec, faults=backend.faults, verify=vc)
        return tuple(progs), reports
    return tuple(program_mlp(gen, params, backend.spec)), None


@dataclasses.dataclass(frozen=True, eq=False)
class AnalogueBackend(BaseBackend):
    """Deploys the MLP onto simulated differential crossbar pairs.

    ``program`` performs the paper's deployment (differential conductance
    mapping, 6-bit quantisation, programming noise drawn from a
    ``torch.Generator`` seeded with ``prog_seed``, frozen); ``apply`` and
    ``rollout`` then read through the arrays, re-drawing read noise per
    evaluation from ``read_seed`` and the time stamp (None = noise-free
    reads).  The weights no longer exist as parameters afterwards
    (``ExecState.params is None``).  ``progs`` short-circuits programming
    with already-written crossbars (``deploy_analogue`` uses it).

    ``storage="uint8"`` also stages each array's 6-bit level indices
    (needs ``prog_noise=0``): large noise-free reads then run on K7 with
    the dequantisation in the kernel.  The port's fleet reads are one 2-D
    product over the fleet, so fleets of arrays at or above
    ``KERNEL_DISPATCH_MIN_CELLS`` reach K7 (the JAX package's vmapped
    reads are 1-D and stay on jnp; the results are the same).

    ``faults`` degrades the array with the composed fault model (stuck
    cells, failed pulses, a drift snapshot after ``n_reads`` reads);
    ``verify`` programs through closed-loop write–verify.  Either one
    surfaces the per-layer ``RepairReport`` list through
    ``ExecState.extra["repair_reports"]``.
    """

    name = "analogue"
    spec: AnalogueSpec = AnalogueSpec()
    prog_seed: int = 0
    read_seed: Optional[int] = None
    progs: Optional[tuple] = None
    storage: str = "float"          # "float" | "uint8" level indices
    faults: Optional[FaultModel] = None
    verify: Optional[VerifyConfig] = None
    n_reads: int = 0                # drift snapshot: reads already served

    def program(self, field: Callable, params: Params) -> ExecState:
        if (self.storage == "uint8" and self.faults is not None
                and self.faults.drift is not None):
            raise ValueError(
                "AnalogueBackend: conductance drift moves cells off the "
                "6-bit level grid, so storage='uint8' cannot carry a "
                "drift snapshot — use float storage, or "
                "FusedAnalogueCudaBackend whose kernel drifts in-kernel")
        progs, reports = self.progs, None
        if progs is None:
            progs, reports = _program_arrays(self, params)
            if self.faults is not None and self.faults.drift is not None:
                drift_only = dataclasses.replace(
                    self.faults, stuck=None, write_fail=None)
                progs = tuple(apply_faults_to_mlp(
                    progs, drift_only, self.spec, n_reads=self.n_reads))
        elif self.storage not in ("float", "uint8"):
            raise ValueError(
                f"AnalogueBackend storage={self.storage!r}; have "
                f"'float', 'uint8'")
        if self.storage == "uint8":
            progs = tuple(stage_uint8(p, self.spec) for p in progs)
        a_field = AnalogueMLPVectorField(
            progs=tuple(progs), spec=self.spec,
            drive=getattr(field, "drive", None), read_seed=self.read_seed)
        extra = None if reports is None else {"repair_reports": reports}
        return ExecState(field=a_field, params=None, extra=extra)


@dataclasses.dataclass(frozen=True, eq=False)
class FusedAnalogueCudaBackend(FusedCudaBackend):
    """The analogue substrate on one kernel: K4 runs the whole RK4
    trajectory of the fleet with the crossbar read semantics inside
    (counterpart of the JAX package's ``FusedAnalogueBackend``), while
    ``program`` stays the paper's deployment exactly: the same programming
    as :class:`AnalogueBackend`, so the two hold the same conductances for
    the same ``prog_seed``.

    ``storage="uint8"`` deploys the 6-bit level indices instead of float
    conductances (needs ``prog_noise=0``).  Read noise (``spec.read_noise``)
    is re-drawn per crossbar evaluation from the counter stream keyed on
    ``read_seed``: deterministic and replayable, equal in distribution to
    :class:`AnalogueBackend`'s reads, not the same numbers.  ``faults``
    are baked into the programmed arrays (the physical array) and
    re-derived in the kernel (stuck cells, idempotent) with live drift
    that advances with the step count from ``n_reads``.

    Serving (``trainable=False``) is detached and float32 whatever
    ``gradient`` says.  ``trainable=True`` arms the differentiable training
    mode: ``program`` also stages the float32 master weights, and a
    non-``stopgrad`` rollout passes them through the hardware-aware write
    path (:func:`repro_torch.train.hw_aware.hw_aware_params`, one device
    realisation keyed by ``read_seed`` and the rollout's ``step_offset``)
    and integrates on K1 with K2's reverse-time VJP, so the gradient
    reaches the masters through the straight-through estimator.
    ``apply`` keeps the plain crossbar read of the programmed field.
    """

    name = "analogue_fused_cuda"
    spec: AnalogueSpec = AnalogueSpec()
    prog_seed: int = 0
    read_seed: int = 0
    storage: str = "float"          # "float" | "uint8" level indices
    faults: Optional[FaultModel] = None
    verify: Optional[VerifyConfig] = None
    n_reads: int = 0                # reads already served before t0 (drift)
    trainable: bool = False

    def program(self, field: Callable, params: Params) -> ExecState:
        progs, reports = _program_arrays(self, params)
        staged = {
            "scales": torch.stack([p["scale"] for p in progs]),
            "g_step": None,
            "g_min": self.spec.g_min,
            "g_max": self.spec.g_max,
            "v_clamp": self.spec.v_clamp,
        }
        if self.faults is not None:
            staged["fault"] = self.faults.kernel_args(self.n_reads)
        if reports is not None:
            staged["repair_reports"] = reports
        if self.storage == "uint8":
            progs = tuple(stage_uint8(p, self.spec) for p in progs)
            staged["gps"] = [p["gp_idx"] for p in progs]
            staged["gms"] = [p["gm_idx"] for p in progs]
            staged["g_step"] = self.spec.g_step
        else:
            staged["gps"] = [p["gp"].to(torch.float32) for p in progs]
            staged["gms"] = [p["gm"].to(torch.float32) for p in progs]
        if self.trainable:
            # the differentiable _solve reads the f32 masters
            staged["weights"] = [p["w"].to(torch.float32) for p in params]
            staged["biases"] = [p["b"].to(torch.float32) for p in params]
        a_field = AnalogueMLPVectorField(
            progs=progs, spec=self.spec, drive=getattr(field, "drive", None))
        return ExecState(field=a_field, params=None, extra=staged)

    def _solve(self, state: ExecState, y0s, uh, dt, bt, gradient,
               precision: Optional[str] = None, step_offset: int = 0):
        """The fused analogue solve on K4, detached for every ``gradient``;
        with ``trainable=True`` and a non-``stopgrad`` gradient, the masters
        through the write path on K1/K2 instead.  ``precision`` is ignored,
        as the JAX package's analogue substrate ignores it: the crossbar
        reads and the write path run in float32.  ``step_offset`` (the
        global step of ``y0s``) keys the read noise, the drift and the
        write path, so a resumed rollout whose twins share one step
        replays the uninterrupted one."""
        del precision
        from repro_torch.kernels import ops
        if self.trainable and gradient != "stopgrad":
            from repro_torch.train.hw_aware import (HwAwareConfig,
                                                    hw_aware_params)
            masters = [{"w": w, "b": b} for w, b in
                       zip(state.extra["weights"], state.extra["biases"])]
            eff = hw_aware_params(
                masters, HwAwareConfig.from_backend(self, k_draws=1),
                step_offset)
            return ops.fused_node_rollout(eff, y0s, uh, dt, batch_tile=bt,
                                          gradient="fused_vjp",
                                          precision="f32")
        return ops.fused_analogue_rollout(
            state.extra, y0s, uh, dt, batch_tile=bt,
            read_noise=self.spec.read_noise, noise_seed=self.read_seed,
            step_offset=step_offset)


DEFAULT_BACKEND = DigitalBackend()

#: Registry of substrate names accepted anywhere a Backend is expected.
BACKENDS = {
    "digital": DigitalBackend,
    "fused_cuda": FusedCudaBackend,
    "analogue": AnalogueBackend,
    "analogue_fused_cuda": FusedAnalogueCudaBackend,
}


def resolve_backend(backend):
    """Accept a Backend instance, a registry name, or None (digital)."""
    if backend is None:
        return DEFAULT_BACKEND
    if isinstance(backend, str):
        try:
            return BACKENDS[backend]()
        except KeyError:
            raise ValueError(
                f"unknown backend {backend!r}; have {sorted(BACKENDS)}")
    return backend
