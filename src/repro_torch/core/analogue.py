"""Simulation of the paper's analogue memristor crossbars (port of ``repro/core/analogue.py``).

Models, with the paper's measured device statistics:

* differential-pair weight mapping W -> (G+, G-), G in [20, 100] uS;
* 6-bit analogue conductance (64 levels): uniform quantisation;
* programming noise: multiplicative Gaussian, sigma = 4.36%, frozen at
  programming time;
* read noise: multiplicative Gaussian per crossbar evaluation;
* peripheral clamp: output voltage protection.

Biases fold into the crossbar as an extra row driven by a constant 1-V
line.  :func:`analogue_mlp_apply` mirrors :func:`repro_torch.core.node.mlp_apply`,
so a trained twin deploys onto the simulated arrays unchanged.

Randomness: where the JAX package takes ``jax.random`` keys, the port
takes CPU ``torch.Generator``s (programming noise, write failures) or an
integer seed (per-read noise), and moves the draws to the weights'
device.  The draws are equal in distribution to the JAX package's, not
bitwise; the counter-derived streams (stuck cells, the fused kernel's
read noise) are bitwise.

Large noise-free 2-D reads (``KERNEL_DISPATCH_MIN_CELLS``) run on the
hand-written crossbar kernel K7 (:mod:`repro_torch.kernels.crossbar_vmm`).
Measured device constants load from a calibration file
(:func:`spec_from_calibration`, :func:`drift_from_calibration`; the repo's
reference file is ``calibration/paper_device.json``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.core.faults import ConductanceDrift, pin_stuck, stuck_masks_of
from repro_torch.core.node import field_input
from repro_torch.kernels import crossbar_vmm as _k7

F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class AnalogueSpec:
    g_min: float = 20e-6          # S  (paper: 20 uS)
    g_max: float = 100e-6         # S  (paper: 100 uS)
    levels: int = 64              # 6-bit analogue conductance
    prog_noise: float = 0.0436    # relative sigma, Fig. 2k
    read_noise: float = 0.0       # relative sigma per read
    v_clamp: Optional[float] = None  # output clamp (model units), None = off
    quantize: bool = True

    def __post_init__(self):
        if not self.g_max > self.g_min:
            raise ValueError(
                f"AnalogueSpec: g_max ({self.g_max}) must exceed g_min "
                f"({self.g_min}); the differential range g_max - g_min "
                f"is the weight-mapping denominator")
        if self.levels < 2:
            raise ValueError(
                f"AnalogueSpec: levels must be >= 2, got {self.levels}")
        if self.prog_noise < 0 or self.read_noise < 0:
            raise ValueError(
                f"AnalogueSpec: noise sigmas must be >= 0, got "
                f"prog_noise={self.prog_noise} read_noise={self.read_noise}")

    @property
    def g_step(self) -> float:
        """Conductance between neighbouring levels."""
        return (self.g_max - self.g_min) / (self.levels - 1)


def _normal(generator: Optional[torch.Generator],
            like: torch.Tensor) -> torch.Tensor:
    """Standard normals of ``like``'s shape from a CPU generator (a fresh
    default-seeded one when None), placed on ``like``'s device."""
    gen = generator if generator is not None else torch.Generator()
    return torch.randn(like.shape, generator=gen, dtype=F32).to(like.device)


def weight_scale(w: torch.Tensor, spec: AnalogueSpec) -> torch.Tensor:
    """Per-tensor scale mapping max|w| to the full differential range."""
    g_range = spec.g_max - spec.g_min
    return g_range / torch.clamp(torch.max(torch.abs(w)), min=1e-12)


def _require_floating(w: torch.Tensor, name: str) -> torch.Tensor:
    """Refuse integer weights, naming the input: conductances are
    continuous.  Reads nothing back from the device."""
    if not torch.is_floating_point(w):
        raise ValueError(
            f"analogue programming: {name} has non-floating dtype "
            f"{w.dtype}; crossbar conductances are continuous — cast "
            f"{name} to a floating dtype first")
    return w


def _require_programmable(w: torch.Tensor, name: str) -> torch.Tensor:
    """Refuse integer or NaN weights, naming the input: conductances are
    continuous, and a NaN weight would poison every read.  The NaN check
    reads back from the device, so the training write path
    (:mod:`repro_torch.train.hw_aware`) keeps only the dtype check."""
    w = _require_floating(torch.as_tensor(w), name)
    if bool(torch.isnan(w).any()):
        raise ValueError(
            f"analogue programming: {name} contains NaN — a NaN weight "
            f"has no conductance representation and would propagate "
            f"through every crossbar read")
    return w


def conductance_pair(w: torch.Tensor, spec: AnalogueSpec, name: str = "w"):
    """Map weights to a differential pair: w >= 0 puts the value on G+
    with G- parked at g_min (and vice versa), so G+ - G- = scale * w."""
    w = _require_programmable(w, name).to(F32)
    scale = weight_scale(w, spec)
    mag = torch.abs(w) * scale
    g_min = torch.tensor(spec.g_min, dtype=F32, device=w.device)
    gp = torch.where(w >= 0, spec.g_min + mag, g_min)
    gm = torch.where(w >= 0, g_min, spec.g_min + mag)
    return gp, gm, scale


def quantize_conductance(g: torch.Tensor, spec: AnalogueSpec) -> torch.Tensor:
    """Snap to the device's discrete analogue levels (64 = 6-bit)."""
    if not spec.quantize:
        return g
    q = torch.round((g - spec.g_min) / spec.g_step)
    return spec.g_min + torch.clamp(q, 0, spec.levels - 1) * spec.g_step


def program_tensor(generator: Optional[torch.Generator], w: torch.Tensor,
                   spec: AnalogueSpec, name: str = "w") -> dict:
    """Program a weight tensor: quantisation, then multiplicative
    programming noise (G+ draws first, then G-), frozen."""
    gp, gm, scale = conductance_pair(w, spec, name)
    gp = quantize_conductance(gp, spec)
    gm = quantize_conductance(gm, spec)
    if spec.prog_noise > 0:
        gp = gp * (1.0 + spec.prog_noise * _normal(generator, gp))
        gm = gm * (1.0 + spec.prog_noise * _normal(generator, gm))
        gp = torch.clamp(gp, 0.0, spec.g_max * 1.5)
        gm = torch.clamp(gm, 0.0, spec.g_max * 1.5)
    return {"gp": gp, "gm": gm, "scale": scale}


def programming_error(prog: dict, w: torch.Tensor, spec: AnalogueSpec):
    """Relative error between target and realised differential conductance."""
    target = w * prog["scale"]
    realised = prog["gp"] - prog["gm"]
    return torch.abs(realised - target) / (spec.g_max - spec.g_min)


#: Crossbar reads with at least this many cells (K x N) run on the
#: hand-written crossbar kernel K7 instead of two plain matmuls: HP-sized
#: arrays (15 x 14) stay plain, hidden >= 128 twins dispatch.
KERNEL_DISPATCH_MIN_CELLS = 16384


def _kernel_dispatchable(prog: dict, x: torch.Tensor, spec: AnalogueSpec,
                         generator) -> bool:
    """Noise-free 2-D reads of large arrays run on K7.  Noisy reads stay on
    the plain path: their noise comes from the read generator (the
    kernel's counter stream is a different sequence)."""
    if spec.read_noise > 0 and generator is not None:
        return False
    if x.ndim != 2:
        return False
    K, N = prog["gp"].shape
    return K * N >= KERNEL_DISPATCH_MIN_CELLS


def analogue_matmul(prog: dict, x: torch.Tensor, spec: AnalogueSpec,
                    generator: Optional[torch.Generator] = None
                    ) -> torch.Tensor:
    """x @ W through the differential crossbar, I = V G+ - V G- (Ohm and
    Kirchhoff), rescaled back to weight units.

    Large noise-free reads run on K7 (uint8 level indices with the dequant
    fused when the program was staged with ``gp_idx``, float conductances
    otherwise); small or noisy reads take two plain matmuls with the same
    semantics.  ``generator`` draws the read noise (``spec.read_noise``)."""
    if _kernel_dispatchable(prog, x, spec, generator):
        if "gp_idx" in prog:
            y = _k7.crossbar_matmul(x, prog["gp_idx"], prog["gm_idx"],
                                    inv_scale=1.0,
                                    g_step=float(spec.g_step)) / prog["scale"]
        else:
            y = _k7.crossbar_matmul(x, prog["gp"], prog["gm"],
                                    inv_scale=1.0) / prog["scale"]
        # the clamp acts in post-scale units and the scale is a tensor, so
        # it stays outside the kernel, as in the JAX package
        if spec.v_clamp is not None:
            y = torch.clamp(y, -spec.v_clamp, spec.v_clamp)
        return y
    gp, gm = prog["gp"], prog["gm"]
    if spec.read_noise > 0 and generator is not None:
        gp = gp * (1.0 + spec.read_noise * _normal(generator, gp))
        gm = gm * (1.0 + spec.read_noise * _normal(generator, gm))
    y = (x @ gp - x @ gm) / prog["scale"]
    if spec.v_clamp is not None:
        y = torch.clamp(y, -spec.v_clamp, spec.v_clamp)
    return y


# ---------------------------------------------------------------------------
# Whole-MLP programming / execution (bias folded as constant-input row)
# ---------------------------------------------------------------------------

def _fold_bias(layer: dict) -> torch.Tensor:
    return torch.cat([layer["w"], layer["b"][None, :]], dim=0)


def program_mlp(generator: Optional[torch.Generator], params: list,
                spec: AnalogueSpec) -> list:
    """Program every layer (bias folded as the last row), drawing from one
    generator in layer order."""
    return [program_tensor(generator, _fold_bias(layer), spec,
                           name=f"params[{i}] (w|b folded)")
            for i, layer in enumerate(params)]


def level_indices(g: torch.Tensor, spec: AnalogueSpec) -> torch.Tensor:
    """The uint8 level index of each conductance (nearest level)."""
    q = torch.round((g - spec.g_min) / spec.g_step)
    return torch.clamp(q, 0, spec.levels - 1).to(torch.uint8)


def stage_uint8(prog: dict, spec: AnalogueSpec) -> dict:
    """Add uint8 level-index storage (``gp_idx``/``gm_idx``) to a noise-free
    quantised program: the device's native 6-bit state, dequantised inside
    the kernel.  Exact only while the conductances sit on the level grid,
    so programming noise must be off."""
    if spec.prog_noise > 0:
        raise ValueError(
            "uint8 staging requires prog_noise=0: programming noise "
            "moves conductances off the 6-bit level grid, so level "
            "indices cannot represent them")
    if not spec.quantize:
        raise ValueError("uint8 staging requires quantize=True")
    return dict(prog, gp_idx=level_indices(prog["gp"], spec),
                gm_idx=level_indices(prog["gm"], spec))


# ---------------------------------------------------------------------------
# Closed-loop write–verify programming (read-back, retry, repair report)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class VerifyConfig:
    """Write–verify loop knobs: ``tol`` is the per-cell acceptance threshold
    on the differential read-back error in units of the full conductance
    range (default one 6-bit step); ``backoff`` shrinks the write noise
    sigma each retry (later pulses land more precisely)."""
    tol: float = 1.0 / 63.0
    max_retries: int = 6
    backoff: float = 0.5

    def __post_init__(self):
        if self.tol <= 0:
            raise ValueError(f"VerifyConfig.tol must be > 0, got {self.tol}")
        if self.max_retries < 0:
            raise ValueError(f"VerifyConfig.max_retries must be >= 0, "
                             f"got {self.max_retries}")
        if not 0.0 < self.backoff <= 1.0:
            raise ValueError(f"VerifyConfig.backoff must be in (0, 1], "
                             f"got {self.backoff}")


@dataclasses.dataclass(frozen=True)
class RepairReport:
    """What write–verify could and could not fix for one tensor.

    ``unrepairable`` marks cells still outside tolerance after the last
    retry; ``projected_rollout_error`` is ``||W_realised - W||_F /
    ||W||_F``.  The counts and errors stay 0-dim tensors on the array's
    device, so programming reads nothing back; :meth:`summary` converts
    them."""
    name: str
    attempts: int
    tol: float
    unrepairable: torch.Tensor     # bool, weight-shaped
    n_cells: int
    n_unrepairable: torch.Tensor   # int64, 0-dim
    max_error: torch.Tensor        # float32, 0-dim, programming_error units
    mean_error: torch.Tensor
    projected_rollout_error: torch.Tensor

    def summary(self) -> dict:
        """Plain Python scalars for logs (one host read per field)."""
        return {
            "name": self.name,
            "attempts": int(self.attempts),
            "n_cells": int(self.n_cells),
            "n_unrepairable": int(self.n_unrepairable),
            "max_error": float(self.max_error),
            "mean_error": float(self.mean_error),
            "projected_rollout_error": float(self.projected_rollout_error),
        }


def _simulate_write(generator, current: torch.Tensor, target: torch.Tensor,
                    sigma: float, spec: AnalogueSpec, faults,
                    masks) -> torch.Tensor:
    """One programming pulse against the simulated faulty physics:
    quantise the target, land with multiplicative noise ``sigma``, keep
    the previous state where the pulse failed, and pin stuck cells
    (``masks``, the array's stuck masks from the counter stream the kernels
    re-derive; None without stuck cells)."""
    g = quantize_conductance(target, spec)
    if sigma > 0:
        g = g * (1.0 + sigma * _normal(generator, g))
        g = torch.clamp(g, 0.0, spec.g_max * 1.5)
    if faults is not None and faults.write_fail_rate > 0:
        gen = generator if generator is not None else torch.Generator()
        u = torch.rand(g.shape, generator=gen, dtype=F32).to(g.device)
        g = torch.where(u < faults.write_fail_rate, current, g)
    if masks is not None:
        g = pin_stuck(g, masks, spec.g_max, spec.g_min)
    return g


def program_with_verify(generator: Optional[torch.Generator],
                        w: torch.Tensor, spec: AnalogueSpec, *, faults=None,
                        verify: VerifyConfig = VerifyConfig(),
                        name: str = "w", layer: int = 0):
    """Closed-loop programming: write, read back, retry out-of-tolerance
    cells, report what stayed broken.

    Each retry rewrites only the failing cells, alternating the side of
    the pair it corrects (G+ on even retries, G- on odd) and retargeting
    it against its partner's actual value, so a stuck G+ is compensated by
    moving G- (clipped to the device range; where the clip bites the cell
    is unrepairable).  Write noise backs off as ``prog_noise *
    backoff**k``.  The loop ends as soon as every cell verifies.  Returns
    ``(prog, report)``."""
    masks = stuck_masks_of(faults, [tuple(w.shape)], w.device, layer0=layer)
    return _program_with_verify(generator, w, spec, faults, verify, name,
                                None if masks is None else masks[0])


def _program_with_verify(generator, w, spec, faults, verify, name, masks):
    """:func:`program_with_verify` with the pair's stuck masks given
    (``(masks of G+, masks of G-)`` or None)."""
    gp_t, gm_t, scale = conductance_pair(w, spec, name)
    gp_t = quantize_conductance(gp_t, spec)
    gm_t = quantize_conductance(gm_t, spec)
    target = gp_t - gm_t
    g_range = spec.g_max - spec.g_min
    mask_p, mask_m = (None, None) if masks is None else masks

    pristine = torch.full_like(gp_t, spec.g_min)
    gp = _simulate_write(generator, pristine, gp_t, spec.prog_noise, spec,
                         faults, mask_p)
    gm = _simulate_write(generator, pristine, gm_t, spec.prog_noise, spec,
                         faults, mask_m)

    attempts = 1
    for k in range(verify.max_retries):
        err = torch.abs((gp - gm) - target) / g_range
        need = err > verify.tol
        if not bool(need.any()):
            break
        attempts += 1
        sigma = spec.prog_noise * verify.backoff ** (k + 1)
        if k % 2 == 0:
            want = torch.clamp(gm + target, spec.g_min, spec.g_max)
            wrote = _simulate_write(generator, gp, want, sigma, spec, faults,
                                    mask_p)
            gp = torch.where(need, wrote, gp)
        else:
            want = torch.clamp(gp - target, spec.g_min, spec.g_max)
            wrote = _simulate_write(generator, gm, want, sigma, spec, faults,
                                    mask_m)
            gm = torch.where(need, wrote, gm)

    err = torch.abs((gp - gm) - target) / g_range
    unrepairable = err > verify.tol
    w = w.to(F32)
    w_realised = (gp - gm) / scale
    w_norm = torch.clamp(torch.linalg.norm(w.reshape(-1)), min=1e-12)
    report = RepairReport(
        name=name, attempts=attempts, tol=verify.tol,
        unrepairable=unrepairable, n_cells=int(w.numel()),
        n_unrepairable=unrepairable.sum(), max_error=err.max(),
        mean_error=err.mean(),
        projected_rollout_error=(
            torch.linalg.norm((w_realised - w).reshape(-1)) / w_norm))
    return {"gp": gp, "gm": gm, "scale": scale}, report


def program_mlp_with_verify(generator: Optional[torch.Generator],
                            params: list, spec: AnalogueSpec, *,
                            faults=None,
                            verify: VerifyConfig = VerifyConfig()):
    """Per-layer :func:`program_with_verify` over an MLP (bias folded as
    the constant-1 row), every layer's stuck masks drawn at once (one K3
    launch on CUDA).  Returns ``(progs, reports)``."""
    folded = [_fold_bias(layer) for layer in params]
    masks = stuck_masks_of(faults, [tuple(f.shape) for f in folded],
                           folded[0].device if folded else "cpu")
    progs, reports = [], []
    for i, f in enumerate(folded):
        prog, rep = _program_with_verify(
            generator, f, spec, faults, verify, f"params[{i}] (w|b folded)",
            None if masks is None else masks[i])
        progs.append(prog)
        reports.append(rep)
    return progs, reports


def analogue_mlp_apply(progs: list, x: torch.Tensor, spec: AnalogueSpec,
                       generator: Optional[torch.Generator] = None,
                       activation=torch.relu) -> torch.Tensor:
    """Forward through the programmed arrays; the ReLU between layers is
    the peripheral dual-diode circuit."""
    for i, prog in enumerate(progs):
        ones = torch.ones(x.shape[:-1] + (1,), dtype=x.dtype, device=x.device)
        x = analogue_matmul(prog, torch.cat([x, ones], dim=-1), spec,
                            generator)
        if i < len(progs) - 1:
            x = activation(x)
    return x


def _read_ticks(t) -> np.ndarray:
    """The 1 ns ticks of the time stamps ``t`` (a scalar or one per row),
    as int64 on the host: the tick the JAX package folds into each
    evaluation's read key.  Read on the host, so with ``t`` on a card
    every noisy evaluation synchronises once."""
    t = torch.as_tensor(t, dtype=F32).detach().reshape(-1).cpu()
    tick = torch.remainder(torch.abs(t) * 1e6,
                           torch.tensor(2 ** 31 - 1, dtype=F32))
    return tick.to(torch.int64).numpy()


def _read_generator(read_seed: int, tick: int) -> torch.Generator:
    """The read-noise generator of the evaluations at one tick: seeded from
    ``read_seed`` and the tick, so read noise is i.i.d. per evaluation time
    and replays from the seed.  Its normals are drawn on the CPU and copied
    to the reads' device (a known cost of the simulator's noisy path,
    ROADMAP.md queue 3; the fused backend draws in-kernel)."""
    seed = (int(read_seed) * 0x9E37_79B9_7F4A_7C15 + int(tick)) % (2 ** 63)
    return torch.Generator().manual_seed(seed)


@dataclasses.dataclass(frozen=True)
class AnalogueMLPVectorField:
    """Analogue-deployed counterpart of ``MLPVectorField``: wraps the
    programmed crossbars; read noise is re-drawn per evaluation from
    ``read_seed`` and the time stamp's tick (None = noise-free reads).

    An (N, D) state evaluated at an (N,) time (a dopri5 fleet, per-row
    grids) reads each group of rows that shares a tick through that tick's
    draw, as the JAX package's vmapped field folds each twin's own tick
    into its key: a row's noise depends only on ``(read_seed, its tick)``,
    so rows at equal ticks read the same noise and a fleet reads as its
    rows would alone."""
    progs: tuple
    spec: AnalogueSpec
    drive: Optional[Any] = None
    read_seed: Optional[int] = None

    def __call__(self, t, y, params=None):
        del params  # weights live in the (frozen) crossbar programs
        inp = field_input(self.drive, t, y)
        progs = list(self.progs)
        if self.read_seed is None or self.spec.read_noise <= 0:
            return analogue_mlp_apply(progs, inp, self.spec, None)
        ticks = _read_ticks(t)
        if (ticks == ticks[0]).all():
            return analogue_mlp_apply(
                progs, inp, self.spec,
                _read_generator(self.read_seed, ticks[0]))
        if ticks.shape[0] != inp.shape[0] or inp.ndim != 2:
            raise ValueError(
                f"analogue read noise: {ticks.shape[0]} time stamps for an "
                f"input of shape {tuple(inp.shape)}; per-row times need an "
                f"(N, D) state with one time per row")
        out = None
        for tick in np.unique(ticks):
            rows = torch.from_numpy(np.flatnonzero(ticks == tick)).to(
                inp.device)
            part = analogue_mlp_apply(progs, inp[rows], self.spec,
                                      _read_generator(self.read_seed, tick))
            if out is None:
                out = part.new_empty((inp.shape[0],) + part.shape[1:])
            out[rows] = part
        return out


# ---------------------------------------------------------------------------
# Device calibration: measured constants in, AnalogueSpec / drift out
# ---------------------------------------------------------------------------

CALIBRATION_SCHEMA = 1

#: field name -> (required, constraint) per section; constraints are
#: "pos" (> 0), "nonneg" (>= 0), "int" (integer >= 2) or None
_CALIBRATION_FIELDS = {
    "device": {
        "g_off_S": (True, "pos"),
        "g_on_S": (True, "pos"),
        "levels": (True, "int"),
        "prog_noise_sigma": (True, "nonneg"),
        "read_noise_sigma": (True, "nonneg"),
        "v_clamp": (False, "pos"),          # null = no clamp
    },
    "drift": {
        "nu": (True, "nonneg"),
        "tau": (True, "pos"),
    },
    "energy": {
        "t_settle_us": (False, "pos"),
        "p_base_w": (False, "pos"),
        "p_int_w": (False, "pos"),
        "v_read": (False, "pos"),
        "g_mean_s": (False, "pos"),
    },
}


def _check_calibration_field(sec: str, key: str, value, constraint):
    where = f"calibration: {sec}.{key}"
    if constraint == "int":
        if isinstance(value, bool) or not isinstance(value, int):
            raise ValueError(f"{where} must be an integer, got {value!r}")
        if value < 2:
            raise ValueError(f"{where} must be >= 2, got {value}")
        return value
    if isinstance(value, bool) or not isinstance(value, (int, float)):
        raise ValueError(f"{where} must be a number, got {value!r}")
    v = float(value)
    if constraint == "pos" and not v > 0:
        raise ValueError(f"{where} must be > 0, got {value}")
    if constraint == "nonneg" and v < 0:
        raise ValueError(f"{where} must be >= 0, got {value}")
    return v


def load_calibration(source) -> dict:
    """Load and validate a measured device-constants file.

    ``source`` is a path to a JSON file or an already-parsed dict.  Returns
    the validated dict (numbers as float, ``levels`` as int).  Schema 1: a
    required ``device`` section (``g_off_S``, ``g_on_S``, ``levels``,
    ``prog_noise_sigma``, ``read_noise_sigma``, optional ``v_clamp``), and
    optional ``drift`` (``nu``, ``tau``) and ``energy`` sections.  Every
    error names the field (``calibration: device.g_on_S must be > 0, got
    ...``); unknown sections and fields are refused by name."""
    import json
    import os

    if isinstance(source, (str, os.PathLike)):
        with open(source) as fh:
            try:
                cal = json.load(fh)
            except json.JSONDecodeError as e:
                raise ValueError(
                    f"calibration file {os.fspath(source)}: invalid JSON "
                    f"({e})") from e
    elif isinstance(source, dict):
        cal = source
    else:
        raise TypeError(
            f"load_calibration takes a path or a dict, got "
            f"{type(source).__name__}")
    if not isinstance(cal, dict):
        raise ValueError("calibration: top level must be a JSON object")

    schema = cal.get("schema")
    if schema != CALIBRATION_SCHEMA:
        raise ValueError(
            f"calibration: schema must be {CALIBRATION_SCHEMA}, "
            f"got {schema!r}")

    known = set(_CALIBRATION_FIELDS) | {"schema", "source"}
    for sec in cal:
        if sec not in known:
            raise ValueError(f"calibration: unknown section {sec!r}")
    if "device" not in cal:
        raise ValueError("calibration: missing required section 'device'")

    out = {"schema": CALIBRATION_SCHEMA}
    if "source" in cal:
        out["source"] = str(cal["source"])
    for sec, fields in _CALIBRATION_FIELDS.items():
        if sec not in cal:
            continue
        raw = cal[sec]
        if not isinstance(raw, dict):
            raise ValueError(
                f"calibration: section {sec!r} must be an object, "
                f"got {raw!r}")
        for key in raw:
            if key not in fields:
                raise ValueError(f"calibration: unknown field {sec}.{key}")
        parsed = {}
        for key, (required, constraint) in fields.items():
            if key not in raw or raw[key] is None:
                if required:
                    raise ValueError(
                        f"calibration: missing field {sec}.{key}")
                continue
            parsed[key] = _check_calibration_field(sec, key, raw[key],
                                                   constraint)
        out[sec] = parsed

    dev = out["device"]
    if not dev["g_on_S"] > dev["g_off_S"]:
        raise ValueError(
            f"calibration: device.g_on_S ({dev['g_on_S']}) must exceed "
            f"device.g_off_S ({dev['g_off_S']}) — the differential range "
            f"is the weight-mapping denominator")
    return out


def spec_from_calibration(source, **overrides) -> AnalogueSpec:
    """An :class:`AnalogueSpec` from a measured calibration file;
    ``overrides`` replace single fields after the measured values (e.g.
    ``read_noise=0.0``)."""
    dev = load_calibration(source)["device"]
    kw = dict(g_min=dev["g_off_S"], g_max=dev["g_on_S"],
              levels=dev["levels"],
              prog_noise=dev["prog_noise_sigma"],
              read_noise=dev["read_noise_sigma"],
              v_clamp=dev.get("v_clamp"))
    kw.update(overrides)
    return AnalogueSpec(**kw)


def drift_from_calibration(source) -> Optional[ConductanceDrift]:
    """The measured drift law as a
    :class:`repro_torch.core.faults.ConductanceDrift` (None when the file
    has no ``drift`` section)."""
    cal = load_calibration(source)
    if "drift" not in cal:
        return None
    return ConductanceDrift(nu=cal["drift"]["nu"], tau=cal["drift"]["tau"])
