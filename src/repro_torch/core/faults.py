"""Composable device-fault models for the analogue substrate (port of ``repro/core/faults.py``).

Real memristor crossbars have stuck cells (pinned at G_on or G_off),
conductances that relax as they are read, and programming pulses that
fail.  This module is the single source of truth for those mechanisms,
shared by three consumers that must agree bitwise on *which* cells are
faulty:

* program-time injection: :func:`apply_faults_to_prog` degrades a
  programmed pair as the physical array would (``AnalogueBackend``);
* closed-loop repair: :func:`repro_torch.core.analogue.program_with_verify`
  writes against the same simulated physics;
* in-kernel injection: K7 (``kernels/csrc/crossbar_vmm.cu``) and K4
  (``kernels/csrc/fused_analogue.cu``) re-derive the same stuck masks from
  the counter stream (K3) inside the kernel, so a faulty array costs no
  extra device-memory traffic.

A cell (layer l, pair p, row k, col n) is stuck iff
``hash(seed, salt(l, p), k * N + n) < rate``: a pure function of
coordinates, replayable from ``seed``, the JAX package's masks bit for
bit.  Write failures are the one stochastic mechanism (each attempt
redraws); they come from the programming ``torch.Generator``, equal in
distribution to the JAX package's ``jax.random`` draws, not bitwise.

    model = make_fault_model(("stuck", dict(rate=0.01)), ("drift", {}),
                             seed=7)
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.kernels.noise import stuck_cell_masks as stuck_masks
from repro_torch.kernels.noise import stuck_cell_masks_many
from repro_torch.kernels.ref import FAULT_SALT_BASE


def fault_salt(layer: int, pair: int) -> int:
    """Salt of device array (layer, pair): pair 0 = G+, 1 = G-."""
    return FAULT_SALT_BASE + 2 * int(layer) + int(pair)


# ---------------------------------------------------------------------------
# Fault mechanisms (the registry entries)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class StuckCells:
    """Hard faults: a fraction ``rate`` of cells is pinned, ``on_frac`` of
    them at G_on (= g_max) and the rest at G_off (= g_min).  Stuck cells
    ignore programming writes; repair can only compensate through the
    partner device of the differential pair."""
    rate: float = 0.01
    on_frac: float = 0.5

    def __post_init__(self):
        if not 0.0 <= self.rate <= 1.0:
            raise ValueError(f"StuckCells.rate must be in [0, 1], "
                             f"got {self.rate}")
        if not 0.0 <= self.on_frac <= 1.0:
            raise ValueError(f"StuckCells.on_frac must be in [0, 1], "
                             f"got {self.on_frac}")


@dataclasses.dataclass(frozen=True)
class ConductanceDrift:
    """Read-disturb relaxation: after ``n`` reads every conductance has
    decayed to ``g * (1 + n / tau) ** -nu``.  Both halves of the pair drift
    together, so the realised weight scales by the same factor."""
    nu: float = 0.01
    tau: float = 1e4

    def __post_init__(self):
        if self.nu < 0:
            raise ValueError(f"ConductanceDrift.nu must be >= 0, "
                             f"got {self.nu}")
        if self.tau <= 0:
            raise ValueError(f"ConductanceDrift.tau must be > 0, "
                             f"got {self.tau}")


@dataclasses.dataclass(frozen=True)
class WriteFailures:
    """Stochastic programming failures: each write attempt leaves the cell
    at its previous value with probability ``rate``, redrawn per attempt."""
    rate: float = 0.1

    def __post_init__(self):
        if not 0.0 <= self.rate <= 1.0:
            raise ValueError(f"WriteFailures.rate must be in [0, 1], "
                             f"got {self.rate}")


#: Registry of fault mechanisms by name (the composable vocabulary).
FAULTS = {
    "stuck": StuckCells,
    "drift": ConductanceDrift,
    "write_fail": WriteFailures,
}


@dataclasses.dataclass(frozen=True)
class FaultModel:
    """A composition of fault mechanisms over one device (any subset
    active; ``seed`` keys every counter-derived mask)."""
    stuck: Optional[StuckCells] = None
    drift: Optional[ConductanceDrift] = None
    write_fail: Optional[WriteFailures] = None
    seed: int = 0

    @property
    def stuck_rate(self) -> float:
        return 0.0 if self.stuck is None else self.stuck.rate

    @property
    def write_fail_rate(self) -> float:
        return 0.0 if self.write_fail is None else self.write_fail.rate

    def kernel_args(self, n_reads: int = 0) -> dict:
        """The scalars the kernels consume for in-kernel fault injection:
        stuck mask parameters and the drift schedule."""
        return {
            "stuck_rate": self.stuck_rate,
            "stuck_on_frac": (self.stuck.on_frac if self.stuck else 0.5),
            "fault_seed": int(self.seed),
            "salt_base": FAULT_SALT_BASE,
            "drift_nu": (self.drift.nu if self.drift else 0.0),
            "drift_tau": (self.drift.tau if self.drift else 1.0),
            "drift_n0": int(n_reads),
        }


def make_fault_model(*mechanisms, seed: int = 0) -> FaultModel:
    """Compose a :class:`FaultModel` from registry names: each mechanism a
    name from :data:`FAULTS` or a ``(name, kwargs)`` pair."""
    fields = {}
    for m in mechanisms:
        name, kw = (m, {}) if isinstance(m, str) else m
        if name not in FAULTS:
            raise ValueError(
                f"unknown fault mechanism {name!r}; have {sorted(FAULTS)}")
        if name in fields:
            raise ValueError(f"fault mechanism {name!r} given twice")
        fields[name] = FAULTS[name](**kw)
    return FaultModel(seed=seed, **fields)


# ---------------------------------------------------------------------------
# Counter-derived stuck masks and drift
# ---------------------------------------------------------------------------

def apply_stuck(g: torch.Tensor, seed, salt, rate: float, on_frac: float,
                g_on: float, g_off: float, *, row0=0, col0=0,
                ncols: Optional[int] = None) -> torch.Tensor:
    """Pin the stuck cells of one device array (2-D ``g``) to their fault
    values, in conductance space (``g_on = spec.g_max``, ``g_off =
    spec.g_min``) or level-index space (``levels - 1``, 0).  Idempotent.
    The masks are computed on ``g``'s device (K3's fill kernel on CUDA)."""
    if rate <= 0.0:
        return g
    masks = stuck_masks(seed, salt, tuple(g.shape), rate, on_frac, row0=row0,
                        col0=col0, ncols=ncols, device=g.device)
    return pin_stuck(g, masks, g_on, g_off)


def pin_stuck(g: torch.Tensor, masks, g_on: float,
              g_off: float) -> torch.Tensor:
    """``g`` with the cells of ``masks = (is_stuck, stuck_on)`` pinned at
    ``g_on`` / ``g_off``."""
    is_stuck, stuck_on = masks
    on = torch.tensor(g_on, dtype=torch.float32, device=g.device)
    off = torch.tensor(g_off, dtype=torch.float32, device=g.device)
    return torch.where(is_stuck, torch.where(stuck_on, on, off).to(g.dtype),
                       g)


def stuck_masks_of(model: Optional[FaultModel], shapes, device,
                   layer0: int = 0) -> Optional[list]:
    """The stuck masks of both pairs of layers ``layer0, layer0 + 1, ...``
    with array shapes ``shapes``: ``[(masks of G+, masks of G-), ...]``,
    drawn for all of them at once (one K3 launch on CUDA); None when the
    model has no stuck cells."""
    if model is None or model.stuck_rate <= 0.0:
        return None
    arrays = [(fault_salt(layer0 + i, pair), tuple(shape))
              for i, shape in enumerate(shapes) for pair in (0, 1)]
    masks = stuck_cell_masks_many(model.seed, arrays, model.stuck.rate,
                                  model.stuck.on_frac, device=device)
    return [(masks[2 * i], masks[2 * i + 1]) for i in range(len(shapes))]


def drift_factor(model: Optional[FaultModel], n_reads) -> torch.Tensor:
    """Multiplicative conductance decay after ``n_reads`` evaluations,
    ``(1 + n / tau) ** -nu`` in float32 (1.0 without a drift mechanism)."""
    if model is None or model.drift is None or model.drift.nu == 0.0:
        return torch.tensor(1.0, dtype=torch.float32)
    n = torch.tensor(float(n_reads), dtype=torch.float32)
    return (1.0 + n / torch.tensor(model.drift.tau, dtype=torch.float32)) \
        ** torch.tensor(-model.drift.nu, dtype=torch.float32)


# ---------------------------------------------------------------------------
# Program-time fault application (the simulator path)
# ---------------------------------------------------------------------------

def apply_faults_to_prog(prog: dict, model: Optional[FaultModel], spec,
                         layer: int = 0, *, n_reads: int = 0) -> dict:
    """Degrade a programmed pair as the physical array would: stuck cells
    pinned at g_max/g_min (and their uint8 level indices, when staged, at
    ``levels - 1`` / 0, from the same masks), then the drift snapshot after
    ``n_reads`` evaluations scales both halves.  ``model=None`` is the
    identity."""
    if model is None:
        return prog
    masks = stuck_masks_of(model, [prog["gp"].shape], prog["gp"].device,
                           layer0=layer)
    return _apply_faults(prog, model, spec, None if masks is None
                         else masks[0], n_reads)


def _apply_faults(prog: dict, model: FaultModel, spec, masks,
                  n_reads: int) -> dict:
    """:func:`apply_faults_to_prog` with the pair's stuck masks given."""
    out = dict(prog)
    if masks is not None:
        for key_, pair_masks in zip(("gp", "gm"), masks):
            out[key_] = pin_stuck(out[key_], pair_masks, spec.g_max,
                                  spec.g_min)
            idx_key = key_ + "_idx"
            if idx_key in out:
                out[idx_key] = pin_stuck(out[idx_key].to(torch.float32),
                                         pair_masks, spec.levels - 1,
                                         0).to(torch.uint8)
    if model.drift is not None and model.drift.nu > 0.0:
        if "gp_idx" in out:
            raise ValueError(
                "drift moves conductances off the 6-bit level grid; "
                "uint8-staged programs cannot carry a drift snapshot — "
                "apply drift in-kernel (FusedAnalogueCudaBackend(faults=...))"
                " or use float storage")
        factor = drift_factor(model, n_reads).to(out["gp"].device)
        out["gp"] = out["gp"] * factor
        out["gm"] = out["gm"] * factor
    return out


def apply_faults_to_mlp(progs, model: Optional[FaultModel], spec, *,
                        n_reads: int = 0) -> list:
    """Per-layer :func:`apply_faults_to_prog` over a programmed MLP, with
    every layer's and pair's stuck masks drawn at once."""
    if model is None:
        return list(progs)
    progs = list(progs)
    masks = stuck_masks_of(model, [p["gp"].shape for p in progs],
                           progs[0]["gp"].device if progs else "cpu")
    return [_apply_faults(p, model, spec, None if masks is None else masks[i],
                          n_reads) for i, p in enumerate(progs)]
