"""Fleet serving: one trained twin, many assets, one or many devices (port of ``repro/launch/fleet_serving.py``).

Layers (bottom-up):

  ``shard_rollout_batch``   the fleet axis split over the ``"twins"`` axis
                            of a :class:`~repro_torch.launch.mesh.Mesh`:
                            the programmed substrate copied once per
                            distinct device, each shard's slice rolled out
                            there by the backend's ``rollout_batch_local``,
                            the results gathered on the mesh's first
                            device (``Backend.rollout_batch(mesh=...)``)
  ``fallback_chain``        degradation tiers of an analogue fleet
                            (primary -> quiet analogue -> digital)
  ``FleetServer``           programmed server: weights placed on the
                            device once, request batches in (split over
                            a mesh when one is given), trajectories out;
                            with a ``ServingSLO``,
                            health probes and retries down the chain
  ``serve_fleet``           end-to-end pipeline: checkpoint -> server ->
                            streamed request batches -> results, in order
  ``StreamingFleetServer``  continuous batching over a resident twin
                            population: per-twin state carried between
                            requests in a host-paged ``TwinStateStore``,
                            one fused launch per batch, admission
                            control, SLO fallback and quarantine; with a
                            ``durability_dir``, a write-ahead journal,
                            snapshots and ``recover``

On the ``fused_cuda`` backend each request batch is one launch of the
hand-written CUDA kernel K1 (:mod:`repro_torch.kernels.fused_ode_mlp`); on
``analogue_fused_cuda`` the twin is deployed on memristor crossbars and
each batch is one launch of K4 (:mod:`repro_torch.kernels.fused_analogue`).
On a mesh each shard of a batch is one such launch on its shard's device.
The JAX package's ``shard_map`` is single-controller, and so is this: one
process walks the shards, with no process group.

CLI (Lorenz96 fleet over the twin mesh of every visible card;
``--device cpu`` runs the kernel's plain version on one CPU shard):

  PYTHONPATH=src python -m repro_torch.launch.fleet_serving --device cpu \\
      --fleet 16 --horizon 20
"""
from __future__ import annotations

import argparse
import copy
import dataclasses
import os
import tempfile
import time
from typing import Any, Iterable, Iterator, Optional, Union

import numpy as np
import torch

from repro_torch.core.backends import (AnalogueBackend, DigitalBackend,
                                      FusedAnalogueCudaBackend,
                                      FusedCudaBackend, resolve_backend)
from repro_torch.device import resolve_device
from repro_torch.launch import chaos
from repro_torch.launch import journal as journal_lib
from repro_torch.launch.mesh import (TWIN_AXIS, make_twin_mesh, twin_devices,
                                     twin_shard_count)
from repro_torch.launch.sharding import Placed, replicate
from repro_torch.launch.state_store import StoreStats, TwinStateStore
from repro_torch.train import checkpoint as ckpt_lib

Params = Any
Request = Union[torch.Tensor, tuple]


# ---------------------------------------------------------------------------
# Front-door input validation
# ---------------------------------------------------------------------------

def validate_fleet_request(caller: str, y0s=None, ts=None,
                           drive_params=None) -> None:
    """Reject malformed serving inputs with errors naming the offending
    argument — a NaN initial condition or a backwards time grid would
    otherwise propagate silently through the whole rollout."""
    for name, x in (("y0s", y0s), ("drive_params", drive_params)):
        if x is None:
            continue
        x = torch.as_tensor(x)
        if not torch.is_floating_point(x):
            raise ValueError(
                f"{caller}: {name} has non-floating dtype {x.dtype}")
        bad = int((~torch.isfinite(x)).sum())
        if bad:
            raise ValueError(
                f"{caller}: {name} contains {bad} non-finite "
                f"(NaN/Inf) value(s) — rejecting the request instead of "
                f"rolling garbage through the fleet")
    if ts is not None:
        tsn = np.asarray(torch.as_tensor(ts).detach().cpu())
        if tsn.ndim != 1 or tsn.size < 2:
            raise ValueError(
                f"{caller}: ts must be a 1-D time grid with >= 2 points, "
                f"got shape {tsn.shape}")
        if not bool(np.isfinite(tsn).all()):
            raise ValueError(f"{caller}: ts contains non-finite values")
        if not bool((np.diff(tsn) > 0).all()):
            raise ValueError(
                f"{caller}: ts must be strictly increasing (non-monotone "
                f"time grids silently break the fixed-step integrators)")


# ---------------------------------------------------------------------------
# Uneven-N padding
# ---------------------------------------------------------------------------

def padded_size(n: int, n_shards: int) -> int:
    """Smallest multiple of ``n_shards`` >= n."""
    return -(-n // n_shards) * n_shards


def pad_fleet_inputs(y0s: torch.Tensor,
                     drive_params: Optional[torch.Tensor], n_shards: int):
    """Pad the fleet axis up to a multiple of the shard count.

    Padding rows replicate the LAST real asset (in-distribution values).
    Returns ``(y0s_padded, drive_params_padded, mask)`` where ``mask`` is
    a length-``padded_size`` bool numpy vector marking the real rows.
    """
    n = y0s.shape[0]
    if drive_params is not None and drive_params.shape[0] != n:
        raise ValueError(
            f"drive_params batch {drive_params.shape[0]} != y0s batch {n}")
    np_ = padded_size(n, n_shards)
    mask = np.arange(np_) < n

    def pad(x):
        if x is None or np_ == n:
            return x
        return torch.cat([x, x[-1:].expand(np_ - n, *x.shape[1:])])

    return pad(y0s), pad(drive_params), mask


# ---------------------------------------------------------------------------
# The sharded rollout (the Backend.rollout_batch(mesh=...) implementation)
# ---------------------------------------------------------------------------

def shard_rollout_batch(backend, state, y0s: torch.Tensor, ts, *, mesh,
                        drive_family=None,
                        drive_params: Optional[torch.Tensor] = None,
                        **solver_kw) -> torch.Tensor:
    """Split a fleet rollout over the twin axis of ``mesh``.

    ``backend`` / ``state``: a programmed execution substrate (see
    :mod:`repro_torch.core.backends`).  The state is copied once to each
    distinct device of the mesh and never programmed again, so every
    shard reads the same conductances (and programming noise); a state
    already placed on ``mesh`` by
    :func:`repro_torch.launch.sharding.replicate` is used as it is.  ``y0s`` (N, D) and the
    optional ``drive_params`` (N, ...) are padded up to a multiple of the
    shard count (:func:`pad_fleet_inputs`), split along dim 0, and each
    shard calls ``backend.rollout_batch_local`` on its slice on its
    device, so a shard runs exactly the single-device program.  The
    results are gathered on the mesh's first device, padding dropped:
    (N, T+1, D).

    ``solver_kw`` goes verbatim to every shard's ``rollout_batch_local``,
    the fused backend's per-call ``precision=`` included.
    """
    validate_fleet_request("shard_rollout_batch", y0s=y0s, ts=ts,
                           drive_params=drive_params)
    devices = twin_devices(mesh)
    n = y0s.shape[0]
    y0s_p, dp_p, _ = pad_fleet_inputs(y0s, drive_params, len(devices))
    states = state if isinstance(state, Placed) else replicate(state, mesh)
    if len(states) != len(devices):
        raise ValueError(
            f"shard_rollout_batch: the state is placed on {len(states)} "
            f"position(s), the mesh has {len(devices)}")
    rows = y0s_p.shape[0] // len(devices)
    outs = []
    for k, dev in enumerate(devices):
        part = slice(k * rows, (k + 1) * rows)
        outs.append(backend.rollout_batch_local(
            states[k], y0s_p[part].to(dev), ts,
            drive_family=drive_family,
            drive_params=None if dp_p is None else dp_p[part].to(dev),
            **solver_kw))
    return torch.cat([o.to(devices[0]) for o in outs])[:n]


# ---------------------------------------------------------------------------
# Serving SLO + graceful degradation
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ServingSLO:
    """Correctness contract for analogue serving.

    ``max_rel_error``: worst tolerated deviation of a health probe from
    the digital reference, relative to the reference's peak magnitude.
    ``probe_every``: probe every this many requests (1 = every one).
    ``probe_horizon`` / ``probe_fleet``: the probe rolls the request's
    first ``probe_fleet`` rows over its first ``probe_horizon`` grid
    points.  ``max_retries``: extra tiers one request may fall through
    when its output comes back non-finite.  ``timeout_s``: wall-clock
    budget per attempt (None = unbounded); overruns are counted, not
    killed.
    """
    max_rel_error: float = 0.05
    probe_every: int = 8
    probe_horizon: int = 11
    probe_fleet: int = 2
    max_retries: int = 2
    timeout_s: Optional[float] = None

    def __post_init__(self):
        if self.max_rel_error <= 0:
            raise ValueError(f"ServingSLO.max_rel_error must be > 0, "
                             f"got {self.max_rel_error}")
        for f in ("probe_every", "probe_horizon", "probe_fleet"):
            if getattr(self, f) < 1:
                raise ValueError(f"ServingSLO.{f} must be >= 1, "
                                 f"got {getattr(self, f)}")
        if self.max_retries < 0:
            raise ValueError(f"ServingSLO.max_retries must be >= 0, "
                             f"got {self.max_retries}")
        if self.timeout_s is not None and self.timeout_s <= 0:
            raise ValueError(f"ServingSLO.timeout_s must be > 0 or None, "
                             f"got {self.timeout_s}")


@dataclasses.dataclass
class ServingStats:
    """Counters the degradation machinery maintains (one per server)."""
    requests: int = 0
    probes: int = 0
    probe_demotions: int = 0
    probe_recoveries: int = 0
    nan_rescues: int = 0
    retries: int = 0
    transient_retries: int = 0
    timeouts: int = 0
    served_by: dict = dataclasses.field(default_factory=dict)
    probe_errors: dict = dataclasses.field(default_factory=dict)

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


def fallback_chain(fleet) -> list:
    """Ordered degradation tiers ``[(name, fleet_variant), ...]``: the
    primary substrate, then the noise-free fused analogue substrate (the
    same programmed array and faults, read noise off) on K4, then the
    digital reference.  Each tier strips one failure mode; the last
    cannot be degraded by array health at all."""
    primary = resolve_backend(fleet.backend)
    tiers = [(primary.name, fleet)]
    if isinstance(primary, (AnalogueBackend, FusedAnalogueCudaBackend)):
        spec = primary.spec
        if spec.read_noise > 0.0 or isinstance(primary, AnalogueBackend):
            clean_spec = dataclasses.replace(spec, read_noise=0.0)
            if isinstance(primary, FusedAnalogueCudaBackend):
                clean = dataclasses.replace(primary, spec=clean_spec)
            else:
                # simulator primary: the quiet tier is the fused substrate
                # with the same programming physics
                clean = FusedAnalogueCudaBackend(
                    spec=clean_spec, prog_seed=primary.prog_seed,
                    storage=primary.storage, faults=primary.faults,
                    verify=primary.verify, n_reads=primary.n_reads)
            tiers.append((f"{clean.name}_clean", fleet.with_backend(clean)))
    if not isinstance(primary, DigitalBackend):
        tiers.append(("digital", fleet.with_backend(DigitalBackend())))
    return tiers


def _primary_tier(fleet) -> list:
    return [(getattr(resolve_backend(fleet.backend), "name", "primary"),
             fleet)]


def _program_tiers(tiers, params) -> list:
    """Program every tier once (the "write the crossbars" step):
    ``[(backend, ExecState), ...]``."""
    out = []
    for _, tier_fleet in tiers:
        backend = resolve_backend(tier_fleet.backend)
        out.append((backend, backend.program(tier_fleet.twin.node.field,
                                             params)))
    return out


def _same_device(a: torch.device, b: torch.device) -> bool:
    """Whether two devices are one (``cuda`` is the current card)."""
    def index(d):
        if d.type == "cuda" and d.index is None:
            return torch.cuda.current_device()
        return d.index
    return a.type == b.type and index(a) == index(b)


def _params_to(params, device) -> list:
    """The weights whole on ``device``: a list of layers, or a placement
    (``load_twin(shardings=)``) gathered there (its first copy, when it
    is replicated and already there)."""
    if isinstance(params, Placed):
        params = params.gather(device)
    return [{k: torch.as_tensor(v).to(device) for k, v in layer.items()}
            for layer in params]


def _bump(counter: dict, key: str) -> None:
    counter[key] = counter.get(key, 0) + 1


def _rel_err(out: torch.Tensor, ref: torch.Tensor, scale: float) -> float:
    return float((out - ref).abs().max()) / scale


# ---------------------------------------------------------------------------
# Programmed fleet server
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class FleetServer:
    """A twin fleet programmed for serving on one device or a twin mesh.

    Construction places ``params`` (a list of layers, or a placement
    from ``load_twin(shardings=)``) on ``device`` (default ``cuda``, or
    the mesh's first device) once and freezes the time grid; each
    :meth:`serve` call validates a request batch, rolls it out without
    autograd and returns the (N, T+1, D) trajectories on that device.
    Without an SLO each batch is served through ``fleet.rollout_batch``,
    which programs the substrate per batch (as the JAX package's jitted
    path does).

    ``mesh`` (a :class:`~repro_torch.launch.mesh.Mesh` with a
    ``"twins"`` axis; None = ``device`` alone) splits every batch over
    its shards (:func:`shard_rollout_batch`): uneven batches are padded
    and the padding dropped, and each shard runs the single-device
    program on its slice.  A mesh whose first device is not ``device``
    raises.

    Passing a :class:`ServingSLO` arms graceful degradation: the
    :func:`fallback_chain` tiers are programmed once, here; every
    ``probe_every`` requests a short golden rollout of the request's own
    leading rows on each tier is held against the digital reference, and
    requests are served from the first tier that meets the SLO (probing
    restarts from the primary, so a recovered array is promoted back).  A
    request whose trajectories come back non-finite is retried down the
    chain; ``RuntimeError`` only when even the digital tier fails.  The
    tiers are programmed once, on ``device``, and copied once to each
    other distinct device of the mesh; probes run on ``device`` alone.
    ``stats`` counts what happened.
    """
    fleet: Any                        # repro_torch.core.twin.TwinFleet
    params: Params
    ts: Any                           # concrete uniform time grid
    device: Any = None                # None -> cuda (or the mesh's first)
    slo: Optional[ServingSLO] = None  # None -> no degradation machinery
    mesh: Any = None                  # None -> device alone

    def __post_init__(self):
        if self.mesh is not None:
            first = twin_devices(self.mesh)[0]
            if self.device is None:
                self.device = first
            elif not _same_device(resolve_device(self.device), first):
                raise ValueError(
                    f"FleetServer: device={self.device!s} but the mesh's "
                    f"first device is {first!s}; results are gathered "
                    f"there, so give one or make them agree")
        self.device = resolve_device(self.device)
        self.ts = torch.as_tensor(self.ts).detach().cpu()
        validate_fleet_request("FleetServer", ts=self.ts)
        self.params = _params_to(self.params, self.device)
        self.stats = ServingStats()
        self._tiers = (_primary_tier(self.fleet) if self.slo is None
                       else fallback_chain(self.fleet))
        self._programs = (None if self.slo is None
                          else _program_tiers(self._tiers, self.params))
        self._placed = (None if self._programs is None or self.mesh is None
                        else [replicate(state, self.mesh)
                              for _, state in self._programs])
        self._active = 0

    @property
    def n_shards(self) -> int:
        return 1 if self.mesh is None else twin_shard_count(self.mesh)

    @property
    def active_tier(self) -> str:
        """Name of the tier requests are currently served from."""
        return self._tiers[self._active][0]

    def _rollout(self, i: int, y0s, ts, thetas,
                 sharded: bool = True) -> torch.Tensor:
        """Tier ``i``'s programmed rollout: over the mesh with the copies
        placed at construction, or on ``device`` alone (``sharded=False``,
        the probes)."""
        backend, state = self._programs[i]
        tier_fleet = self._tiers[i][1]
        kw = tier_fleet.twin.node._solver_kw()
        if sharded and self._placed is not None:
            kw["mesh"] = self.mesh
            state = self._placed[i]
        with torch.inference_mode():
            return backend.rollout_batch(
                state, y0s, ts, drive_family=tier_fleet.drive_family,
                drive_params=thetas, **kw)

    def _probe(self, y0s, thetas) -> None:
        """Golden-trajectory health check: roll the request's first
        ``probe_fleet`` rows over ``ts[:probe_horizon]`` on each tier and
        activate the first whose worst deviation from the digital
        reference (the last tier) meets the SLO."""
        s = self.slo
        self.stats.probes += 1
        h = min(s.probe_horizon, int(self.ts.shape[0]))
        ts_p = self.ts[:h]
        yp = y0s[: s.probe_fleet]
        tp = None if thetas is None else thetas[: s.probe_fleet]
        ref = self._rollout(len(self._tiers) - 1, yp, ts_p, tp,
                            sharded=False)
        scale = float(ref.abs().max()) + 1e-9
        prev, chosen = self._active, len(self._tiers) - 1
        for i, (name, _) in enumerate(self._tiers[:-1]):
            err = _rel_err(self._rollout(i, yp, ts_p, tp, sharded=False),
                           ref, scale)
            self.stats.probe_errors[name] = err
            if np.isfinite(err) and err <= s.max_rel_error:
                chosen = i
                break
        if chosen > prev:
            self.stats.probe_demotions += 1
        elif chosen < prev:
            self.stats.probe_recoveries += 1
        self._active = chosen

    def serve(self, y0s: torch.Tensor,
              drive_params: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Roll out one request batch -> (N, T+1, D) trajectories."""
        y0s = torch.as_tensor(y0s, device=self.device)
        if drive_params is not None:
            drive_params = torch.as_tensor(drive_params, device=self.device)
        validate_fleet_request("FleetServer.serve", y0s=y0s,
                               drive_params=drive_params)
        s = self.slo
        if s is None:
            with torch.inference_mode():
                out = self.fleet.rollout_batch(self.params, y0s, self.ts,
                                               drive_params, mesh=self.mesh)
            self.stats.requests += 1
            _bump(self.stats.served_by, "primary")
            return out

        if len(self._tiers) > 1 and self.stats.requests % s.probe_every == 0:
            self._probe(y0s, drive_params)
        self.stats.requests += 1
        first = self._active
        last = min(first + s.max_retries, len(self._tiers) - 1)
        for i in range(first, last + 1):
            if i > first:
                self.stats.retries += 1
            t0 = time.perf_counter()
            out = self._rollout(i, y0s, self.ts, drive_params)
            finite = bool(torch.isfinite(out).all())     # syncs the device
            if (s.timeout_s is not None
                    and time.perf_counter() - t0 > s.timeout_s):
                self.stats.timeouts += 1
            if finite:
                if i > first:
                    self.stats.nan_rescues += 1
                _bump(self.stats.served_by, self._tiers[i][0])
                return out
        raise RuntimeError(
            "FleetServer: every fallback tier (including digital) "
            "returned non-finite trajectories — the request itself is "
            "pathological, not the substrate")


def serve_fleet(ckpt_dir: str, fleet, ts, requests: Iterable[Request], *,
                step: Optional[int] = None, mesh=None,
                params_template: Optional[Params] = None,
                device=None) -> Iterator[torch.Tensor]:
    """End-to-end serving pipeline over a stream of request batches.

    checkpoint load (:func:`repro_torch.train.checkpoint.load_twin`, which
    also reads the JAX package's checkpoints) -> weights placed on
    ``device`` once (:class:`FleetServer`) -> each request batch rolled
    out, split over ``mesh`` when one is given (``device`` then defaults
    to its first device) -> trajectories yielded in order.

    ``requests`` yields either ``y0s`` tensors (autonomous fleets) or
    ``(y0s, drive_params)`` tuples (driven fleets).  ``params_template``
    gives the weight structure for the restore; by default it is built
    with ``fleet.twin.init`` on the CPU (the values are overwritten).
    """
    if device is None and mesh is not None:
        device = twin_devices(mesh)[0]
    device = resolve_device(device)
    if params_template is None:
        params_template = fleet.twin.init(torch.Generator().manual_seed(0),
                                          device="cpu")
    params = ckpt_lib.load_twin(ckpt_dir, params_template, step=step,
                                device=device)
    server = FleetServer(fleet, params, ts, device=device, mesh=mesh)
    for req in requests:
        y0s, thetas = req if isinstance(req, tuple) else (req, None)
        yield server.serve(y0s, thetas)


# ---------------------------------------------------------------------------
# Streaming stateful serving: continuous batching over a resident population
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class StreamRequest:
    """One queued streaming request: advance ``twin_id`` by ``horizon``
    RK4 steps from its carried state.  ``seq`` is the server-assigned
    arrival index; ``remaining`` counts the steps still unserved (a request
    longer than the server's window is split across batches).
    ``deadline`` is the latest virtual time the request may still be
    started; a request that has begun runs to completion."""
    seq: int
    twin_id: Any
    horizon: int
    remaining: int
    t_arrival: float = 0.0
    deadline: Optional[float] = None


@dataclasses.dataclass(frozen=True)
class Completed:
    """A finished request: ``trajectory`` is the (horizon+1, D) host array
    with row 0 the state the request started from; ``tier`` names the
    substrate that served its final window."""
    seq: int
    twin_id: Any
    trajectory: np.ndarray
    start_step: int
    tier: str
    t_arrival: float
    t_done: float


@dataclasses.dataclass
class StreamStats:
    """Continuous-batching counters.  Conservation: every submitted
    request lands in exactly one terminal bucket, ``enqueued == served +
    failed + shed + expired + quarantined + pending``."""
    enqueued: int = 0
    served: int = 0
    failed: int = 0
    shed: int = 0            # load-shedding victims (bounded queue)
    expired: int = 0         # deadline passed before assembly
    quarantined: int = 0     # poison requests parked with a diagnostic
    batches: int = 0
    twin_steps: int = 0      # real (unpadded) RK4 steps served
    padded_steps: int = 0    # max_batch * H - twin_steps, summed
    splits: int = 0          # requests split across serving windows

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass(frozen=True)
class Quarantined:
    """A poison request, parked instead of served: even the digital tier
    produced non-finite output for its batch.  ``reason`` records what
    every tier said; the twin's carried state is untouched."""
    seq: int
    twin_id: Any
    horizon: int
    remaining: int
    t_arrival: float
    reason: str


@dataclasses.dataclass
class RecoveryStats:
    """What :meth:`StreamingFleetServer.recover` did and how long each
    part took (host seconds): reading the journal, building the server
    (programming its tiers), loading and restoring the snapshot, and
    replaying the records after it, ``commits`` of them windows re-run."""
    snapshot_lsn: Optional[int] = None
    records: int = 0
    commits: int = 0
    journal_read_s: float = 0.0
    build_s: float = 0.0
    snapshot_load_s: float = 0.0
    replay_s: float = 0.0

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class ServerStats:
    """One observability snapshot (:meth:`StreamingFleetServer.stats`):
    stream, degradation and paging counters under one ``as_dict``."""
    stream: StreamStats
    serving: ServingStats
    store: StoreStats

    def as_dict(self) -> dict:
        return {"stream": self.stream.as_dict(),
                "serving": self.serving.as_dict(),
                "store": self.store.as_dict()}


class StreamingFleetServer:
    """Continuous batching for a resident twin population.

    Where :class:`FleetServer` rolls fixed request batches from t0, this
    server keeps each twin's ODE state alive between requests: sensor
    windows (``submit``) feed a queue; each ``pump`` assembles the longest
    admissible batch (one request per twin: a twin's next window starts
    from its previous one's end state), fetches the carried states from
    the :class:`TwinStateStore` (host-paged, LRU), pads the batch to
    ``max_batch`` rows and its ragged horizons to one window of H steps
    (``horizon_quantum`` multiples up to ``max_window``), solves it in one
    launch on a fused tier (K1 on ``fused_cuda``, K4 on the analogue
    tiers), scatters the end states back and advances each twin's global
    step.

    Determinism contract (``docs/serving.md``): every time value a twin
    sees is the canonical float64 grid ``t0 + dt*k`` rounded to float32
    once, keyed by the twin's own global step, so what a twin accumulates
    over any sequence of windows is bitwise one uninterrupted rollout,
    however the scheduler batched, split or paged it.  On the fused tiers
    a window's solve passes ``step_offset`` 0, as the JAX package's does:
    a noisy analogue window is deterministic per batch, not a replay of
    one uninterrupted noise stream.

    Passing a :class:`ServingSLO` arms the degradation machinery of
    :class:`FleetServer`: the :func:`fallback_chain` tiers are programmed
    once, at construction; a golden window probe re-picks the healthiest
    tier every ``probe_every`` batches, and a batch whose trajectories
    come back non-finite is retried down the chain.  A request that even
    the digital tier cannot serve is quarantined with a per-tier
    diagnostic, its carried state left untouched.

    Admission control: ``max_queue`` bounds the queue; an arrival past it
    is shed per ``shed_policy``: ``"reject_new"`` (``submit`` returns
    None) or ``"drop_oldest"`` (the twin's oldest unstarted request
    goes).  Deadlines are checked at assembly; a tier that raises a
    :class:`~repro_torch.launch.chaos.TransientFault` is retried
    ``transient_retries`` times with exponential backoff before the batch
    falls down the chain.  Any other exception, such as a kernel that
    fails to build or launch, raises out of ``pump``.
    ``REPRO_STORE_AUDIT=1`` audits the store after every pump.  One
    device.

    Durability: ``durability_dir`` arms the write-ahead journal and the
    snapshots (:mod:`repro_torch.launch.journal`): every externally
    visible event is fsync'd before it is acknowledged (``fsync=False``
    trades that for latency), the pump's records are one group commit, a
    snapshot is published every ``snapshot_every`` pumps (0: only by
    :meth:`snapshot`) and the newest ``snapshot_keep`` are kept.
    :meth:`recover` rebuilds the server from the directory after a crash
    at any point, bitwise (float32) the crash-free run: it replays the
    journal's windows through the same tier solve that served them.  The
    journal holds no device, so a directory recovers on any device (and
    in the JAX package: the formats are the same).  Twin ids must be
    JSON-serialisable scalars when durability is armed.
    """

    def __init__(self, fleet, params, *, dt: float, t0: float = 0.0,
                 hot_capacity: int = 64, max_batch: int = 32,
                 max_window: int = 64, horizon_quantum: int = 8,
                 slo: Optional[ServingSLO] = None,
                 max_queue: Optional[int] = None,
                 shed_policy: str = "reject_new",
                 transient_retries: int = 2,
                 backoff_base_s: float = 0.01,
                 durability_dir: Optional[str] = None,
                 snapshot_every: int = 16, snapshot_keep: int = 3,
                 fsync: bool = True, device=None):
        if dt <= 0:
            raise ValueError(f"StreamingFleetServer: dt must be > 0, "
                             f"got {dt}")
        if not 1 <= max_batch <= hot_capacity:
            raise ValueError(
                f"StreamingFleetServer: need 1 <= max_batch <= "
                f"hot_capacity, got max_batch={max_batch}, "
                f"hot_capacity={hot_capacity}")
        if max_window < 1 or horizon_quantum < 1:
            raise ValueError(
                "StreamingFleetServer: max_window and horizon_quantum "
                "must be >= 1")
        if max_queue is not None and max_queue < 1:
            raise ValueError(f"StreamingFleetServer: max_queue must be "
                             f">= 1 or None, got {max_queue}")
        if shed_policy not in ("reject_new", "drop_oldest"):
            raise ValueError(
                f"StreamingFleetServer: shed_policy must be 'reject_new'"
                f" or 'drop_oldest', got {shed_policy!r}")
        if transient_retries < 0 or backoff_base_s < 0:
            raise ValueError(
                "StreamingFleetServer: transient_retries and "
                "backoff_base_s must be >= 0")
        if snapshot_every < 0 or snapshot_keep < 1:
            raise ValueError(
                "StreamingFleetServer: need snapshot_every >= 0 "
                "(0 = manual snapshots only) and snapshot_keep >= 1")
        self.device = resolve_device(device)
        self.fleet = fleet
        self.params = _params_to(params, self.device)
        self.dt = float(dt)
        self.t0 = float(t0)
        self.max_batch = int(max_batch)
        self.max_window = int(max_window)
        self.horizon_quantum = int(horizon_quantum)
        self.slo = slo
        self.max_queue = None if max_queue is None else int(max_queue)
        self.shed_policy = shed_policy
        self.transient_retries = int(transient_retries)
        self.backoff_base_s = float(backoff_base_s)
        self.snapshot_every = int(snapshot_every)
        self.snapshot_keep = int(snapshot_keep)
        self.store = TwinStateStore(fleet.twin.state_dim, hot_capacity,
                                    device=self.device)
        self.stream_stats = StreamStats()
        self.serving_stats = ServingStats()
        self.quarantine: dict = {}             # seq -> Quarantined
        self._audit = os.environ.get("REPRO_STORE_AUDIT", "") == "1"
        self._journal: Optional[journal_lib.Journal] = None
        self._serve_dir: Optional[str] = None
        self._pumps_since_snapshot = 0
        self.recovery: Optional[RecoveryStats] = None   # set by recover
        self._tiers = (fallback_chain(fleet) if slo is not None
                       else _primary_tier(fleet))
        self._programs = _program_tiers(self._tiers, self.params)
        self._active = 0
        self._queue: list = []                 # FIFO of StreamRequest
        self._partial: dict = {}               # seq -> list of row blocks
        self._seq = 0
        if durability_dir is not None:
            self._attach_durability(durability_dir, fsync=fsync,
                                    resume=False)

    # -- population / ingest -------------------------------------------------
    @property
    def active_tier(self) -> str:
        return self._tiers[self._active][0]

    @property
    def pending(self) -> int:
        return len(self._queue)

    def stats(self) -> ServerStats:
        """One snapshot of the stream, serving and store counters (deep
        copies: mutating it cannot touch the live counters)."""
        return ServerStats(stream=copy.deepcopy(self.stream_stats),
                           serving=copy.deepcopy(self.serving_stats),
                           store=copy.deepcopy(self.store.stats))

    def register_twin(self, twin_id, y0, *, theta=None) -> None:
        """Admit a twin with its initial condition (and its drive
        parameters for a driven fleet), host-side.  Non-finite or
        mis-shaped ``y0`` and ``theta`` raise naming the argument."""
        if (theta is None) != (self.fleet.drive_family is None):
            raise ValueError(
                "register_twin: theta must be given exactly when the "
                "fleet has a drive_family")
        if theta is not None:
            th = np.asarray(theta)
            if not np.issubdtype(th.dtype, np.floating):
                raise ValueError(
                    f"register_twin: theta has non-floating dtype "
                    f"{th.dtype}")
            if not np.isfinite(th).all():
                raise ValueError(
                    f"register_twin: theta for twin {twin_id!r} contains "
                    f"non-finite (NaN/Inf) values")
        self.store.register(twin_id, y0, theta=theta)
        if self._journal is not None:
            rec = {"t": "register", "id": twin_id,
                   "y0": journal_lib.json_floats(
                       self.store.peek(twin_id)[0])}
            if theta is not None:
                th32 = np.asarray(theta, np.float32)
                rec["theta"] = journal_lib.json_floats(th32)
                rec["tshape"] = list(th32.shape)
            self._journal.append(rec)

    def submit(self, twin_id, horizon: int, t_arrival: float = 0.0, *,
               deadline: Optional[float] = None) -> Optional[int]:
        """Enqueue a request to advance ``twin_id`` by ``horizon`` RK4
        steps; returns its ``seq``, or None if the bounded queue shed it
        (``shed_policy="reject_new"``).  Per-twin FIFO order holds.
        ``deadline`` (the clock of ``t_arrival`` and ``pump(now)``) is
        the latest the request may still be started.  Malformed arguments
        raise ``ValueError`` naming the argument."""
        if twin_id not in self.store:
            raise KeyError(f"submit: twin {twin_id!r} is not registered")
        if isinstance(horizon, bool) or not isinstance(
                horizon, (int, np.integer)):
            raise ValueError(
                f"submit: horizon must be an integer step count, got "
                f"{type(horizon).__name__} {horizon!r}")
        horizon = int(horizon)
        if horizon < 1:
            raise ValueError(f"submit: horizon must be >= 1, got {horizon}")
        t_arrival = float(t_arrival)
        if not np.isfinite(t_arrival):
            raise ValueError(
                f"submit: t_arrival must be finite, got {t_arrival}")
        if deadline is not None:
            deadline = float(deadline)
            if not np.isfinite(deadline):
                raise ValueError(
                    f"submit: deadline must be finite (omit it for "
                    f"no deadline), got {deadline}")
            if deadline < t_arrival:
                raise ValueError(
                    f"submit: deadline {deadline} precedes t_arrival "
                    f"{t_arrival} — the request is dead on arrival")
        seq = self._seq
        self._seq += 1
        self.stream_stats.enqueued += 1
        jrec = {"t": "submit", "seq": seq, "id": twin_id, "h": horizon,
                "ta": t_arrival, "dl": deadline}
        if (self.max_queue is not None
                and len(self._queue) >= self.max_queue):
            victim = None
            if self.shed_policy == "drop_oldest":
                # this twin's oldest unstarted request: a half-served
                # continuation is never shed
                victim = next(
                    (r for r in self._queue if r.twin_id == twin_id
                     and r.remaining == r.horizon), None)
            if victim is None:
                self.stream_stats.shed += 1
                if self._journal is not None:
                    self._journal.append({**jrec, "shed": True})
                return None
            self._queue.remove(victim)
            self.stream_stats.shed += 1
            if self._journal is not None:
                self._journal.append({"t": "shed", "seq": victim.seq},
                                     sync=False)
        self._queue.append(StreamRequest(
            seq=seq, twin_id=twin_id, horizon=horizon, remaining=horizon,
            t_arrival=t_arrival, deadline=deadline))
        if self._journal is not None:
            self._journal.append(jrec)
        return seq

    # -- batch assembly ------------------------------------------------------
    def _assemble(self):
        """Pop the next batch: the FIRST queued request of each twin, in
        FIFO order, up to ``max_batch`` (a twin's later requests wait for
        its start state).  Returns the requests and the window length H."""
        picked, skipped, seen = [], [], set()
        for req in self._queue:
            if req.twin_id in seen or len(picked) == self.max_batch:
                skipped.append(req)
            else:
                seen.add(req.twin_id)
                picked.append(req)
        self._queue = skipped
        if not picked:
            return [], 0
        h_max = min(self.max_window, max(r.remaining for r in picked))
        q = self.horizon_quantum
        return picked, min(self.max_window, -(-h_max // q) * q)

    def _run_tier(self, tier_idx: int, ys, starts: np.ndarray, thetas,
                  H: int) -> torch.Tensor:
        """Serve one assembled window on one tier: the backend's
        :meth:`solve_window` at ``step_offset`` 0, as the JAX package's
        window does.  A fused tier launches its kernel once; the digital
        and simulator tiers integrate each row on its own grid."""
        backend, state = self._programs[tier_idx]
        tier_fleet = self._tiers[tier_idx][1]
        kw = {**tier_fleet.twin.node._solver_kw(), "gradient": "stopgrad"}
        with torch.no_grad():
            return backend.solve_window(
                state, ys, dt=self.dt, num_steps=H, t0=self.t0,
                starts=starts, step_offset=0,
                drive_family=tier_fleet.drive_family, drive_params=thetas,
                **kw)

    def _probe(self, ys, starts, thetas, H: int) -> None:
        """Golden-window health check: roll the batch's first
        ``probe_fleet`` rows over a short window on every non-digital
        tier, compare with the digital reference (the last tier) and
        activate the first tier that meets the SLO.  The probe goes
        through ``rollout_batch_resumed``, as the JAX package's does: a
        probe whose rows share one step keys a noisy tier's draws at that
        step, where the served window keys them at 0."""
        s = self.slo
        self.serving_stats.probes += 1
        nf = min(s.probe_fleet, int(ys.shape[0]))
        h = min(s.probe_horizon - 1, H)
        yp, sp = ys[:nf], starts[:nf]
        tp = None if thetas is None else thetas[:nf]

        def window(i):
            backend, state = self._programs[i]
            with torch.no_grad():
                return backend.rollout_batch_resumed(
                    state, yp, dt=self.dt, num_steps=h, t0=self.t0,
                    start_steps=sp,
                    drive_family=self._tiers[i][1].drive_family,
                    drive_params=tp, gradient="stopgrad")

        ref = window(len(self._tiers) - 1)
        scale = float(ref.abs().max()) + 1e-9
        prev, chosen = self._active, len(self._tiers) - 1
        for i, (name, _) in enumerate(self._tiers[:-1]):
            err = _rel_err(window(i), ref, scale)
            self.serving_stats.probe_errors[name] = err
            if np.isfinite(err) and err <= s.max_rel_error:
                chosen = i
                break
        if chosen > prev:
            self.serving_stats.probe_demotions += 1
        elif chosen < prev:
            self.serving_stats.probe_recoveries += 1
        self._active = chosen

    # -- the serving loop ----------------------------------------------------
    def _fetch_padded(self, ids):
        """Fetch a batch's carried state and pad it to ``max_batch`` rows
        (the last row replicated; results are sliced back).  Returns
        ``(ys, starts, thetas, n)`` with ``n`` the real row count."""
        ys, starts, thetas = self.store.fetch(ids)
        n = len(ids)
        pad = self.max_batch - n
        if pad:
            ys = torch.cat([ys, ys[-1:].expand(pad, *ys.shape[1:])])
            starts = np.concatenate([starts, np.repeat(starts[-1:], pad)])
            if thetas is not None:
                thetas = torch.cat(
                    [thetas, thetas[-1:].expand(pad, *thetas.shape[1:])])
        return ys, starts, thetas, n

    def _expire(self, now: float) -> None:
        """Drop queued requests whose deadline passed before they were
        started.  A split continuation is exempt: its state has already
        advanced, so it runs to completion."""
        stale = {r.seq for r in self._queue
                 if r.deadline is not None and r.remaining == r.horizon
                 and now > r.deadline}
        if stale:
            self._queue = [r for r in self._queue if r.seq not in stale]
            self.stream_stats.expired += len(stale)
            if self._journal is not None:
                self._journal.append({"t": "expire", "seqs": sorted(stale)},
                                     sync=False)

    def _attempt_tier(self, tier_idx: int, ys, starts, thetas, H: int):
        """One tier's solve, retried with exponential backoff on a
        :class:`~repro_torch.launch.chaos.TransientFault`.  Any other
        exception (a kernel that fails to build or launch) and an injected
        ``SimulatedCrash`` pass straight through.  Raises the last fault
        when the retries run out."""
        s = self.slo
        delay = self.backoff_base_s
        last_exc: Optional[chaos.TransientFault] = None
        for attempt in range(self.transient_retries + 1):
            if attempt:
                time.sleep(delay)
                delay *= 2.0
                self.serving_stats.transient_retries += 1
            try:
                chaos.fault_point("pump:run_tier")
                t_start = time.perf_counter()
                out = self._run_tier(tier_idx, ys, starts, thetas, H)
                if out.is_cuda:
                    torch.cuda.synchronize(out.device)
                if (s is not None and s.timeout_s is not None
                        and time.perf_counter() - t_start > s.timeout_s):
                    self.serving_stats.timeouts += 1
                return out
            except chaos.TransientFault as e:
                last_exc = e
        raise last_exc

    def _solve_batch(self, ys, starts, thetas, H: int, n: int):
        """Run the fallback chain over one window.  Returns ``(traj,
        tier_idx, diags)``; ``traj is None`` when even the last tier gave
        non-finite output, ``diags`` naming what each tier said.  A tier
        whose attempts all raise a transient fault falls through to the
        next; the last tier re-raises (infrastructure failure, not a
        poison request), and every other exception propagates at once."""
        s = self.slo
        first = self._active
        last = (len(self._tiers) - 1 if s is None
                else min(first + s.max_retries, len(self._tiers) - 1))
        diags = []
        for i in range(first, last + 1):
            name = self._tiers[i][0]
            if i > first:
                self.serving_stats.retries += 1
            try:
                out = self._attempt_tier(i, ys, starts, thetas, H)
            except chaos.TransientFault as e:
                if i == last:
                    raise
                diags.append(f"{name}: raised {type(e).__name__}: {e}")
                continue
            if bool(torch.isfinite(out[:n]).all()):
                if i > first:
                    self.serving_stats.nan_rescues += 1
                return out, i, diags
            diags.append(f"{name}: non-finite output")
        return None, None, diags

    def _commit_batch(self, picked, ids, traj, starts, n: int, H: int,
                      tier_idx: int, now: float) -> list:
        """Apply one solved window: scatter the end states into the store,
        advance the step counters, stitch the requests' trajectories (one
        device-to-host copy of the window) and re-queue split
        continuations at the front.  The live pump and journal replay
        share it, which is what makes a replayed window the crash-free
        state transition."""
        tier_name = self._tiers[tier_idx][0]
        # float32 on the host whatever the substrate's storage dtype
        # (numpy has no bfloat16), as the JAX package's completions are
        traj_h = traj[:n].cpu().to(torch.float32).numpy()
        served = [min(r.remaining, H) for r in picked]
        rows = torch.arange(n, device=traj.device)
        end_states = traj[rows, torch.as_tensor(served, device=traj.device)]
        self.store.commit(ids, end_states, starts[:n] + np.asarray(served))
        chaos.kill_point("pump:post_commit")
        self.stream_stats.twin_steps += int(sum(served))
        self.stream_stats.padded_steps += int(
            self.max_batch * H - sum(served))
        self.serving_stats.requests += 1
        _bump(self.serving_stats.served_by, tier_name)
        done = []
        for i, req in enumerate(picked):
            h = served[i]
            blocks = self._partial.setdefault(req.seq, [])
            blocks.append(traj_h[i, : h + 1] if not blocks
                          else traj_h[i, 1: h + 1])
            if h < req.remaining:
                self.stream_stats.splits += 1
                self._queue.insert(0, dataclasses.replace(
                    req, remaining=req.remaining - h))
                continue
            done.append(Completed(
                seq=req.seq, twin_id=req.twin_id,
                trajectory=np.concatenate(self._partial.pop(req.seq)),
                start_step=int(starts[i]) - (req.horizon - h),
                tier=tier_name, t_arrival=req.t_arrival, t_done=now))
            self.stream_stats.served += 1
        return done

    def pump(self, now: float = 0.0) -> list:
        """Assemble and serve ONE batch; returns the :class:`Completed`
        requests it finished (possibly none: a window that only partly
        serves long requests completes nothing)."""
        done = self._pump(now)
        if self._audit:
            self.store.check_invariants()
        if self._journal is not None and self.snapshot_every:
            self._pumps_since_snapshot += 1
            if self._pumps_since_snapshot >= self.snapshot_every:
                self.snapshot()
        return done

    def _pump(self, now: float) -> list:
        self._expire(now)
        picked, H = self._assemble()
        if not picked:
            if self._journal is not None:
                self._journal.sync()        # any expire records
            return []
        ids = [r.twin_id for r in picked]
        ys, starts, thetas, n = self._fetch_padded(ids)
        s = self.slo
        if (s is not None and len(self._tiers) > 1
                and self.stream_stats.batches % s.probe_every == 0):
            self._probe(ys[:n], starts[:n],
                        None if thetas is None else thetas[:n], H)
        self.stream_stats.batches += 1
        traj, tier_idx, diags = self._solve_batch(ys, starts, thetas, H, n)
        chaos.kill_point("pump:pre_commit")
        if traj is None:
            # even the digital tier is non-finite: the requests themselves
            # are poison; park them, carried states untouched
            reason = "; ".join(diags) or "non-finite on every tier"
            for req in picked:
                self.stream_stats.quarantined += 1
                self._partial.pop(req.seq, None)
                self.quarantine[req.seq] = Quarantined(
                    seq=req.seq, twin_id=req.twin_id, horizon=req.horizon,
                    remaining=req.remaining, t_arrival=req.t_arrival,
                    reason=reason)
            if self._journal is not None:
                self._journal.append(
                    {"t": "quarantine", "seqs": [r.seq for r in picked],
                     "reason": reason}, sync=False)
                self._journal.sync()
            return []
        done = self._commit_batch(picked, ids, traj, starts, n, H,
                                  tier_idx, now)
        if self._journal is not None:
            # one group commit: the window's decision and its completions
            self._journal.append(
                {"t": "commit", "seqs": [r.seq for r in picked],
                 "tier": tier_idx, "H": H,
                 "served": [min(r.remaining, H) for r in picked],
                 "now": now}, sync=False)
            for c in done:
                self._journal.append({"t": "complete", "seq": c.seq},
                                     sync=False)
            self._journal.sync()
        return done

    # -- durability: journal, snapshots, crash recovery ----------------------
    def _config(self) -> dict:
        """The constructor arguments the journal's header pins, so that
        :meth:`recover` rebuilds the same scheduler.  No device: a journal
        is not tied to the machine that wrote it."""
        return {"dt": self.dt, "t0": self.t0,
                "hot_capacity": self.store.hot_capacity,
                "max_batch": self.max_batch,
                "max_window": self.max_window,
                "horizon_quantum": self.horizon_quantum,
                "max_queue": self.max_queue,
                "shed_policy": self.shed_policy,
                "transient_retries": self.transient_retries,
                "backoff_base_s": self.backoff_base_s,
                "snapshot_every": self.snapshot_every,
                "snapshot_keep": self.snapshot_keep}

    def _attach_durability(self, serve_dir: str, *, fsync: bool,
                           resume: bool) -> None:
        os.makedirs(serve_dir, exist_ok=True)
        jrnl = journal_lib.Journal(journal_lib.journal_path(serve_dir),
                                   fsync=fsync)
        if jrnl.lsn and not resume:
            jrnl.close()
            raise ValueError(
                f"StreamingFleetServer: {serve_dir!r} already holds a "
                f"journal with {jrnl.lsn} record(s) — use "
                f"StreamingFleetServer.recover() to resume it (a fresh "
                f"server writing over live state would fork history)")
        self._serve_dir = serve_dir
        self._journal = jrnl
        if jrnl.lsn == 0:
            jrnl.append({"t": "config",
                         "schema": journal_lib.JOURNAL_SCHEMA,
                         "cfg": self._config()})

    def close(self) -> None:
        """Flush and close the journal (a no-op without durability)."""
        if self._journal is not None:
            self._journal.close()

    def snapshot(self) -> str:
        """Atomically publish a full-state snapshot covering every journal
        record so far: the store (one device-to-host copy of the hot
        slab), the queue, partial trajectories, quarantine and every
        counter.  Returns its path.  The pump calls it every
        ``snapshot_every`` pumps."""
        if self._journal is None:
            raise RuntimeError(
                "snapshot: durability is not armed — construct with "
                "durability_dir=")
        self._journal.sync()
        lsn = self._journal.lsn
        ids, ys, steps, thetas = self.store.export_state()
        arrays = {"store_ys": ys, "store_steps": steps}
        if thetas is not None:
            arrays["store_thetas"] = thetas
        for seq, blocks in self._partial.items():
            for i, b in enumerate(blocks):
                arrays[f"partial/{seq}/{i}"] = np.asarray(b, np.float32)
        extra = {
            "ids": list(ids),
            "seq": self._seq,
            "active": self._active,
            "queue": [[r.seq, r.twin_id, r.horizon, r.remaining,
                       r.t_arrival, r.deadline] for r in self._queue],
            "partial": {str(s): len(b) for s, b in self._partial.items()},
            "quarantine": [dataclasses.asdict(q)
                           for q in self.quarantine.values()],
            "stream_stats": self.stream_stats.as_dict(),
            "serving_stats": self.serving_stats.as_dict(),
            "store_stats": self.store.stats.as_dict(),
        }
        path = journal_lib.write_snapshot(self._serve_dir, lsn, arrays,
                                          extra, keep=self.snapshot_keep)
        self._pumps_since_snapshot = 0
        return path

    def _restore_snapshot(self, arrays: dict, extra: dict) -> None:
        ys, steps = arrays["store_ys"], arrays["store_steps"]
        thetas = arrays.get("store_thetas")
        for i, tid in enumerate(extra["ids"]):
            self.store.register(
                tid, ys[i], theta=None if thetas is None else thetas[i],
                step=int(steps[i]))
        self._seq = int(extra["seq"])
        self._active = int(extra["active"])
        self._queue = [
            StreamRequest(seq=q[0], twin_id=q[1], horizon=q[2],
                          remaining=q[3], t_arrival=q[4], deadline=q[5])
            for q in extra["queue"]]
        self._partial = {
            int(s): [arrays[f"partial/{s}/{i}"] for i in range(nb)]
            for s, nb in extra["partial"].items()}
        self.quarantine = {q["seq"]: Quarantined(**q)
                           for q in extra["quarantine"]}
        self.stream_stats = StreamStats(**extra["stream_stats"])
        self.serving_stats = ServingStats(**extra["serving_stats"])
        self.store.stats = StoreStats(**extra["store_stats"])

    def _drop_seqs(self, seqs) -> list:
        want = set(seqs)
        dropped = [r for r in self._queue if r.seq in want]
        if len(dropped) != len(want):
            have = {r.seq for r in dropped}
            raise ValueError(
                f"recover: journal references request seq(s) "
                f"{sorted(want - have)} that are not pending — the "
                f"journal is inconsistent beyond its torn tail")
        self._queue = [r for r in self._queue if r.seq not in want]
        return dropped

    def _replay(self, rec: dict) -> list:
        """Apply one journal record during recovery.  Decision records
        (register, submit, shed, expire, quarantine) are applied as they
        stand; a ``commit`` re-runs its window on the recorded tier.
        Returns the completions the record (re)produces."""
        t = rec["t"]
        if t == "register":
            theta = None
            if "theta" in rec:
                theta = journal_lib.from_json_floats(rec["theta"],
                                                     rec["tshape"])
            self.store.register(
                rec["id"],
                journal_lib.from_json_floats(rec["y0"],
                                             (self.store.state_dim,)),
                theta=theta)
            return []
        if t == "submit":
            self.stream_stats.enqueued += 1
            self._seq = max(self._seq, rec["seq"] + 1)
            if rec.get("shed"):
                self.stream_stats.shed += 1
                return []
            self._queue.append(StreamRequest(
                seq=rec["seq"], twin_id=rec["id"], horizon=rec["h"],
                remaining=rec["h"], t_arrival=rec["ta"],
                deadline=rec["dl"]))
            return []
        if t == "shed":
            self._drop_seqs([rec["seq"]])
            self.stream_stats.shed += 1
            return []
        if t == "expire":
            self._drop_seqs(rec["seqs"])
            self.stream_stats.expired += len(rec["seqs"])
            return []
        if t == "quarantine":
            for req in self._drop_seqs(rec["seqs"]):
                self.stream_stats.quarantined += 1
                self._partial.pop(req.seq, None)
                self.quarantine[req.seq] = Quarantined(
                    seq=req.seq, twin_id=req.twin_id,
                    horizon=req.horizon, remaining=req.remaining,
                    t_arrival=req.t_arrival, reason=rec["reason"])
            return []
        if t == "commit":
            return self._replay_commit(rec)
        if t == "complete":
            return []                   # checked by recover()
        raise ValueError(f"recover: unknown journal record type {t!r}")

    def _replay_commit(self, rec: dict) -> list:
        """Re-run one journalled window: the recorded requests, fetched
        and padded as the pump did, through :meth:`_run_tier` on the
        recorded tier (the solve the live pump's :meth:`_solve_batch`
        makes), then :meth:`_commit_batch`."""
        by_seq = {r.seq: r for r in self._queue}
        missing = [s for s in rec["seqs"] if s not in by_seq]
        if missing:
            raise ValueError(
                f"recover: commit record references seq(s) {missing} "
                f"that are not pending — the journal is inconsistent")
        picked = [by_seq[s] for s in rec["seqs"]]
        taken = set(rec["seqs"])
        self._queue = [r for r in self._queue if r.seq not in taken]
        ids = [r.twin_id for r in picked]
        ys, starts, thetas, n = self._fetch_padded(ids)
        H, tier_idx = int(rec["H"]), int(rec["tier"])
        served = [min(r.remaining, H) for r in picked]
        if served != [int(x) for x in rec["served"]]:
            raise ValueError(
                "recover: replayed window disagrees with the journalled "
                "served step counts — scheduler state diverged")
        self.stream_stats.batches += 1
        traj = self._run_tier(tier_idx, ys, starts, thetas, H)
        if not bool(torch.isfinite(traj[:n]).all()):
            raise ValueError(
                "recover: a journalled commit re-executed to non-finite "
                "output — the substrate changed since the crash")
        return self._commit_batch(picked, ids, traj, starts, n, H,
                                  tier_idx, float(rec.get("now", 0.0)))

    @classmethod
    def recover(cls, serve_dir: str, fleet, params, *,
                slo: Optional[ServingSLO] = None, fsync: bool = True,
                device=None):
        """Rebuild a crashed server from its serving directory on
        ``device`` (default ``cuda``).

        Builds the server from the journal's config header (its tiers
        programmed again, from their seeds), loads the newest loadable
        snapshot (a damaged one is skipped for an older one), replays the
        journal after it through the recorded tiers, and reopens the
        journal (torn tail truncated) so serving appends where the crash
        left off.  With an SLO, the active tier is the snapshot's:
        probes are not replayed, as in the JAX package.

        Returns ``(server, redelivered)``: ``redelivered`` holds the
        :class:`Completed` results that replayed commits produce again,
        which the caller may or may not have received before the crash
        (at-least-once delivery; the state advances exactly once).  The
        server's store, queue, partials and counters are bitwise
        (float32) a crash-free run's; ``server.recovery`` says what the
        recovery did and what each part cost.
        """
        stats = RecoveryStats()
        t_0 = time.perf_counter()
        records, _, _ = journal_lib.read_journal(
            journal_lib.journal_path(serve_dir))
        if not records or records[0].get("t") != "config":
            raise ValueError(
                f"recover: {serve_dir!r} has no usable journal (missing "
                f"or torn config header) — nothing to recover")
        if records[0].get("schema") != journal_lib.JOURNAL_SCHEMA:
            raise ValueError(
                f"recover: journal schema {records[0].get('schema')!r} "
                f"!= supported {journal_lib.JOURNAL_SCHEMA}")
        t_1 = time.perf_counter()
        server = cls(fleet, params, slo=slo, device=device,
                     **records[0]["cfg"])
        t_2 = time.perf_counter()
        snap = journal_lib.load_latest_snapshot(serve_dir)
        start = 1                       # past the config header
        if snap is not None:
            lsn, arrays, extra = snap
            server._restore_snapshot(arrays, extra)
            start = stats.snapshot_lsn = lsn
        t_3 = time.perf_counter()
        redelivered, completed_seqs = [], set()
        for rec in records[start:]:
            out = server._replay(rec)
            stats.commits += rec["t"] == "commit"
            completed_seqs.update(c.seq for c in out)
            redelivered.extend(out)
            if rec["t"] == "complete" and rec["seq"] not in completed_seqs:
                raise ValueError(
                    f"recover: journal records completion of seq "
                    f"{rec['seq']} that replay never produced — the "
                    f"journal is inconsistent beyond its torn tail")
        if server.device.type == "cuda":
            torch.cuda.synchronize(server.device)
        t_4 = time.perf_counter()
        stats.records = len(records) - start
        stats.journal_read_s = t_1 - t_0
        stats.build_s = t_2 - t_1
        stats.snapshot_load_s = t_3 - t_2
        stats.replay_s = t_4 - t_3
        server._attach_durability(serve_dir, fsync=fsync, resume=True)
        server.recovery = stats
        return server, redelivered

    def drain(self, now: float = 0.0) -> list:
        """Pump until the queue is empty; returns all completions (also
        right after :meth:`recover`: replay leaves the queue as the
        crash-free schedule would have)."""
        done = []
        while self._queue:
            done.extend(self.pump(now))
        return done

    def serve_trace(self, trace, *, y0_of, theta_of=None,
                    auto_register: bool = True, start: int = 0,
                    sink: Optional[list] = None) -> list:
        """Replay an arrival trace (:mod:`repro_torch.launch.traffic`):
        arrivals are submitted in order, a batch is pumped whenever the
        queue can fill one, and the tail is drained at the end.
        ``y0_of(twin_id)`` (and ``theta_of`` for driven fleets) registers
        first-contact twins.  Returns the completions in service order.

        ``start`` skips the first ``start`` arrivals: a recovered server
        holds every arrival its journal acknowledged, so the caller feeds
        the trace again from ``server.stream_stats.enqueued`` (an arrival
        whose submit never reached the journal is submitted again, the
        client-retry contract).  ``sink``, a list, also receives each
        pump's completions as the pump returns them, so a consumer that
        may die mid-trace keeps what it got before the death (the JAX
        package's ``serve_trace`` hands over the final drain's completions
        only when the drain ends, so a crash in the drain loses those of
        its earlier pumps: covered by a snapshot, they are not
        redelivered either)."""
        done = [] if sink is None else sink
        for arrival in trace[start:]:
            if auto_register and arrival.twin_id not in self.store:
                theta = None if theta_of is None else theta_of(
                    arrival.twin_id)
                self.register_twin(arrival.twin_id, y0_of(arrival.twin_id),
                                   theta=theta)
            self.submit(arrival.twin_id, arrival.horizon,
                        t_arrival=arrival.time,
                        deadline=getattr(arrival, "deadline", None))
            if self.pending >= self.max_batch:
                done.extend(self.pump(now=arrival.time))
        t_end = trace[-1].time if trace else 0.0
        while self._queue:
            # pump by pump, not drain(): a crash in a later pump must not
            # take the completions of the earlier ones with it
            done.extend(self.pump(now=t_end))
        return done


# ---------------------------------------------------------------------------
# CLI: the Lorenz96 fleet workload over the local twin mesh
# ---------------------------------------------------------------------------

def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Serve a Lorenz96 twin fleet over the local twin mesh")
    ap.add_argument("--fleet", type=int, default=256,
                    help="assets per request batch")
    ap.add_argument("--horizon", type=int, default=100,
                    help="RK4 steps per rollout")
    ap.add_argument("--batches", type=int, default=2,
                    help="request batches to stream")
    ap.add_argument("--backend", default="fused_cuda",
                    choices=["digital", "fused_cuda", "analogue_fused_cuda"],
                    help="analogue_fused_cuda serves on K4 with the "
                         "paper's device statistics (6-bit levels, 4.36%% "
                         "programming noise)")
    ap.add_argument("--precision", default=None,
                    choices=["f32", "bf16", "bf16_f32acc"],
                    help="fused-substrate mixed-precision policy "
                         "(default: f32, fused_ode_mlp.default_precision)")
    ap.add_argument("--ckpt-dir", default="",
                    help="trained-twin checkpoint (default: untrained "
                         "weights saved to a temp dir — substrate smoke)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (cpu runs the plain PyTorch path)")
    args = ap.parse_args(argv)

    from repro_torch.train import recipes
    backend = args.backend
    if args.precision is not None:
        if backend != "fused_cuda":
            ap.error("--precision is a fused-substrate policy; it does "
                     f"not apply to --backend {backend}")
        backend = FusedCudaBackend(batch_tile=recipes.FLEET.batch_tile,
                                   precision=args.precision)
    mesh = make_twin_mesh(device=args.device)
    device = twin_devices(mesh)[0]
    fleet = recipes.make_l96_fleet(backend=backend)
    ts = recipes.l96_fleet_ts(horizon=args.horizon)
    print(f"mesh: {twin_shard_count(mesh)} device(s) on axis '{TWIN_AXIS}'; "
          f"backend {args.backend} precision "
          f"{'n/a' if args.backend != 'fused_cuda' else args.precision or 'f32'}")

    with tempfile.TemporaryDirectory(prefix="l96_fleet_ckpt_") as tmp:
        ckpt_dir = args.ckpt_dir
        if not ckpt_dir:
            ckpt_dir = tmp
            params = fleet.twin.init(torch.Generator().manual_seed(0),
                                     device="cpu")
            ckpt_lib.save_twin(ckpt_dir, params)
            print("no --ckpt-dir: serving an untrained twin (seed 0)")
        reqs = recipes.l96_fleet_requests(fleet_size=args.fleet,
                                          num_batches=args.batches,
                                          device=device)
        t0 = time.perf_counter()
        outs = []
        for i, traj in enumerate(serve_fleet(ckpt_dir, fleet, ts, reqs,
                                             mesh=mesh)):
            if device.type == "cuda":
                for d in dict.fromkeys(twin_devices(mesh)):
                    torch.cuda.synchronize(d)
            outs.append(traj)
            dt_s = time.perf_counter() - t0
            rate = (i + 1) * args.fleet * args.horizon / dt_s
            print(f"  batch {i}: {tuple(traj.shape)} trajectories "
                  f"({rate:,.0f} twin-steps/s cumulative)")
    if not all(bool(torch.isfinite(o).all()) for o in outs):
        raise RuntimeError("served trajectories contain non-finite values")
    print(f"served {args.batches} x {args.fleet} twins x {args.horizon} "
          f"steps in {time.perf_counter() - t0:.2f}s")
    return outs


if __name__ == "__main__":
    main()
