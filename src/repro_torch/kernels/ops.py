"""Public wrappers around the port's kernels (port of ``repro/kernels/ops.py``).

The fused neural-ODE rollout (K1), its fused VJP (K2), the time-grid
helpers they are fed by, the crossbar reads (K7), the fused analogue
rollout (K4), soft-DTW with its E-matrix backward (K5, K6) and the
hard DTW metric (K5), and the LM layers' causal GQA flash attention (K8)
and selective-SSM scan (K9).
"""
from __future__ import annotations

from typing import Callable, Sequence

import numpy as np
import torch

from repro_torch.core.analogue import (AnalogueSpec, conductance_pair,
                                       level_indices)
from repro_torch.core.losses import _pairwise_dist
from repro_torch.kernels import crossbar_vmm as _k7
from repro_torch.kernels import flash_attention as _k8
from repro_torch.kernels import fused_analogue as _k4
from repro_torch.kernels import fused_ode_mlp as _k1
from repro_torch.kernels import fused_ode_mlp_bwd as _k2
from repro_torch.kernels import ref
from repro_torch.kernels import softdtw as _k5
from repro_torch.kernels import ssm_scan as _k9

GRADIENT_MODES = ("fused_vjp", "stopgrad")


def fused_node_rollout(params: Sequence[dict], y0: torch.Tensor,
                       u_half: torch.Tensor, dt: float, *,
                       batch_tile: int = 64, time_chunk: int | None = None,
                       gradient: str = "fused_vjp",
                       precision: str | None = None) -> torch.Tensor:
    """Solve the twin's neural ODE with the weights-stationary kernel.

    Args:
      params: the MLP param list ``[{'w': (in, out), 'b': (out,)}, ...]``.
      y0: (B, D) initial conditions, one row per fleet member.
      u_half: drive sampled at RK4 half-steps (:func:`half_step_drive`):
        (2T+1, Du) shared, (B, 2T+1, Du) per twin, or (2T+1, 0).
      dt: RK4 step size (uniform).
      batch_tile: B must divide by it (``FusedCudaBackend`` pads).
      time_chunk: under a bf16 policy, the steps after which the carry is
        rounded through bf16; ``None`` plans it as the JAX kernel does
        (``fused_ode_mlp.plan_time_chunk`` for ``"stopgrad"``, the
        backward planner for ``"fused_vjp"``, both at
        ``fused_ode_mlp.DEFAULT_VMEM_BUDGET``).  Under f32 it changes no
        bit.
      gradient: ``"stopgrad"`` detaches the solve (inference);
        ``"fused_vjp"`` makes it differentiable in ``y0`` and the params
        through the reverse-time kernel K2
        (:func:`repro_torch.kernels.fused_ode_mlp_bwd.fused_node_rollout_vjp`);
        the drive gets a zero cotangent.
      precision: ``"f32"``, ``"bf16_f32acc"`` or ``"bf16"`` (``None``:
        ``fused_ode_mlp.default_precision()``, f32): the bf16 policies
        store weights, drive and trajectory as bfloat16; gradients come
        back float32.

    Returns:
      The (T+1, B, D) trajectory (y0 prepended), at the policy's storage
      dtype.
    """
    precision = _k1.resolve_precision(precision)
    if gradient not in GRADIENT_MODES:
        raise ValueError(
            f"unknown gradient mode {gradient!r}; have "
            f"{', '.join(repr(g) for g in GRADIENT_MODES)}")
    named = [("y0", y0), ("u_half", u_half)]
    named += [(f"params[{i}]['w']", p["w"]) for i, p in enumerate(params)]
    named += [(f"params[{i}]['b']", p["b"]) for i, p in enumerate(params)]
    for name, x in named:       # fail HERE with the dict-level input name
        _k1._require_float(name, x, precision)
    weights = [p["w"] for p in params]
    biases = [p["b"] for p in params]
    if gradient == "fused_vjp":
        return _k2.fused_node_rollout_vjp(
            y0, u_half, weights, biases, float(dt), batch_tile=batch_tile,
            time_chunk=time_chunk, precision=precision)
    with torch.no_grad():
        return _k1.fused_node_rollout(
            y0, u_half, weights, biases, float(dt), batch_tile=batch_tile,
            time_chunk=time_chunk, precision=precision)


def fused_node_rollout_ref(params: Sequence[dict], y0: torch.Tensor,
                           u_half: torch.Tensor, dt: float) -> torch.Tensor:
    """K1's plain version on an MLP's ``[{"w", "b"}, ...]`` params, every
    operand in float32: (T+1, B, D)."""
    return ref.fused_node_rollout_ref(
        y0.to(torch.float32), u_half.to(torch.float32),
        [p["w"].to(torch.float32) for p in params],
        [p["b"].to(torch.float32) for p in params], float(dt))


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


# ---------------------------------------------------------------------------
# Crossbar VMM (K7)
# ---------------------------------------------------------------------------

def _require_2d_float(op: str, name: str, x: torch.Tensor) -> None:
    if x.ndim != 2:
        raise ValueError(f"{op}: {name} must be 2-D, got shape "
                         f"{tuple(x.shape)}")
    if not torch.is_floating_point(x):
        raise ValueError(
            f"{op}: {name} has non-floating dtype {x.dtype}; cast it to "
            f"a floating dtype first")


def _fault_kernel_kwargs(fault: dict | None, spec: AnalogueSpec,
                         layer: int) -> dict:
    """A ``FaultModel.kernel_args()`` dict as K7's arguments: the
    (layer, pair) stuck salts of the core convention, plus the drift
    snapshot factor (one VMM has a fixed read count, so the power law
    collapses to one multiplier; only the fused rollout advances it
    live)."""
    if not fault:
        return {}
    drift = 1.0
    if fault.get("drift_nu", 0.0) > 0.0:
        drift = (1.0 + fault.get("drift_n0", 0)
                 / fault["drift_tau"]) ** (-fault["drift_nu"])
    base = fault.get("salt_base", 0)
    return {
        "stuck_rate": fault.get("stuck_rate", 0.0),
        "stuck_on_frac": fault.get("stuck_on_frac", 0.5),
        "fault_seed": fault.get("fault_seed", 0),
        "fault_salts": (base + 2 * layer, base + 2 * layer + 1),
        "drift": drift,
        "g_max": spec.g_max,
    }


def crossbar_vmm(prog: dict, x: torch.Tensor, spec: AnalogueSpec, *,
                 read_noise: float | None = None, noise_seed: int = 0,
                 fault: dict | None = None, layer: int = 0) -> torch.Tensor:
    """Analogue crossbar read of float conductances through K7.

    ``read_noise`` overrides ``spec.read_noise`` (None = the spec's) with
    the deterministic counter stream keyed on ``noise_seed``; ``fault`` (a
    ``FaultModel.kernel_args()`` dict) injects stuck cells and a drift
    snapshot at the device array addressed by ``layer``.  The rescale by
    ``prog["scale"]`` (a tensor) and the clamp, which acts in post-scale
    units, happen outside the kernel, as in the JAX package."""
    _require_2d_float("crossbar_vmm", "x", x)
    _require_2d_float("crossbar_vmm", "prog['gp']", prog["gp"])
    _require_2d_float("crossbar_vmm", "prog['gm']", prog["gm"])
    sigma = spec.read_noise if read_noise is None else read_noise
    y = _k7.crossbar_matmul(
        x, prog["gp"], prog["gm"], inv_scale=1.0, g_step=None, clamp=None,
        read_noise=float(sigma), noise_seed=noise_seed, g_min=spec.g_min,
        **_fault_kernel_kwargs(fault, spec, layer)) / prog["scale"]
    if spec.v_clamp is not None:
        y = torch.clamp(y, -spec.v_clamp, spec.v_clamp)
    return y


def crossbar_vmm_quantized(x: torch.Tensor, gp_idx: torch.Tensor,
                           gm_idx: torch.Tensor, spec: AnalogueSpec, scale,
                           *, read_noise: float | None = None,
                           noise_seed: int = 0, fault: dict | None = None,
                           layer: int = 0) -> torch.Tensor:
    """Quantised-storage read through K7: uint8 level indices, dequantised
    in the kernel; noisy or faulty reads rebuild the absolute conductances
    from ``spec.g_min`` there.  Same noise and fault contract as
    :func:`crossbar_vmm`."""
    _require_2d_float("crossbar_vmm_quantized", "x", x)
    for name, idx in (("gp_idx", gp_idx), ("gm_idx", gm_idx)):
        if idx.ndim != 2 or idx.dtype != torch.uint8:
            raise ValueError(
                f"crossbar_vmm_quantized: {name} must be 2-D uint8 level "
                f"indices, got shape {tuple(idx.shape)} dtype {idx.dtype}")
    sigma = spec.read_noise if read_noise is None else read_noise
    y = _k7.crossbar_matmul(
        x, gp_idx, gm_idx, inv_scale=1.0, g_step=float(spec.g_step),
        clamp=None, read_noise=float(sigma), noise_seed=noise_seed,
        g_min=spec.g_min, **_fault_kernel_kwargs(fault, spec, layer)) / scale
    if spec.v_clamp is not None:
        y = torch.clamp(y, -spec.v_clamp, spec.v_clamp)
    return y


def quantize_to_levels(w: torch.Tensor, spec: AnalogueSpec):
    """Map weights to (gp_idx, gm_idx, scale) uint8 level tensors."""
    gp, gm, scale = conductance_pair(w, spec)
    return level_indices(gp, spec), level_indices(gm, spec), scale


# ---------------------------------------------------------------------------
# Fused analogue rollout (K4)
# ---------------------------------------------------------------------------

def fused_analogue_rollout(staged: dict, y0: torch.Tensor,
                           u_half: torch.Tensor, dt: float, *,
                           batch_tile: int = 64, read_noise: float = 0.0,
                           noise_seed: int = 0,
                           step_offset: int = 0) -> torch.Tensor:
    """Whole-trajectory analogue RK4 solve on K4.

    ``staged`` is the deployment dict that ``FusedAnalogueCudaBackend.program``
    builds (or one assembled by hand): ``gps``/``gms`` per-layer (K_l+1,
    N_l) pairs, float32 or uint8 level indices (bias row last); ``scales``
    (L,); ``g_step`` (None = float storage); ``g_min``, ``g_max``,
    ``v_clamp``; optional ``fault`` (``FaultModel.kernel_args()``).

    Inference only: every input is detached and the trajectory carries no
    gradient (train digitally, deploy analogue).  ``step_offset`` (the
    global step of ``y0``) makes a resumed noisy or drifting rollout
    replay the uninterrupted one."""
    _require_2d_float("fused_analogue_rollout", "y0", y0)
    if not torch.is_floating_point(u_half):
        raise ValueError(
            f"fused_analogue_rollout: u_half has non-floating dtype "
            f"{u_half.dtype}; cast it to a floating dtype")
    with torch.no_grad():
        out = _k4.fused_analogue_rollout(
            [g.detach() for g in staged["gps"]],
            [g.detach() for g in staged["gms"]],
            torch.as_tensor(staged["scales"]).detach(), y0.detach(),
            u_half.detach(), float(dt), g_step=staged.get("g_step"),
            g_min=staged.get("g_min", 0.0), g_max=staged.get("g_max", 0.0),
            fault=staged.get("fault"), v_clamp=staged.get("v_clamp"),
            read_noise=float(read_noise), noise_seed=int(noise_seed),
            step_offset=int(step_offset), batch_tile=batch_tile)
    return out.detach()


# ---------------------------------------------------------------------------
# soft-DTW (K5 forward, K6 E-matrix backward)
# ---------------------------------------------------------------------------

class SoftDTW(torch.autograd.Function):
    """Batched soft-DTW of a (B, n, m) cost matrix: forward K5 with R,
    backward K6, both on the row-major matrix.  ``apply(D, gamma[, store])``
    returns (B,) float32; both kernels read D at the storage dtype
    ``store`` (float32 by default, bfloat16 under a bf16 policy), which the
    residual keeps too, and R, E stay float32.  The gradient is
    ``g[:, None, None] * E`` in D's dtype, E the E-matrix: it goes back
    to the unrounded costs, as the JAX package's ``_sdtw_bwd`` does."""

    @staticmethod
    def forward(ctx, D, gamma, store=torch.float32):
        Ds = D.to(store).contiguous()
        ans, R = _k5.softdtw_rowmajor(Ds, gamma=gamma, return_r=True)
        ctx.save_for_backward(Ds, R)
        ctx.gamma = gamma
        ctx.d_dtype = D.dtype
        return ans

    @staticmethod
    def backward(ctx, g):
        Ds, R = ctx.saved_tensors
        E = _k5.softdtw_rowmajor_bwd(Ds, R, gamma=ctx.gamma)
        return (g[:, None, None] * E).to(ctx.d_dtype), None, None


def soft_dtw(x: torch.Tensor, y: torch.Tensor, gamma: float = 1.0,
             precision: str | None = None) -> torch.Tensor:
    """Batched soft-DTW((B, n, d), (B, m, d)) -> (B,) through the
    wavefront kernels on the row-major (B, n, m) cost matrix: K5 forward,
    K6 backward, differentiable in ``x`` and ``y``.  The pairwise
    |x_i - y_j| cost stays in plain autograd outside the kernels, as the
    JAX package leaves it to ``jax.vjp``; the TPU kernels' diagonal
    layout is not built.  ``precision`` (``None``: f32): under
    ``"bf16"`` and ``"bf16_f32acc"`` the cost matrix goes to the kernels
    as bfloat16 (R, E and the answer stay float32)."""
    store = _k1.precision_dtypes(_k1.resolve_precision(precision))[0]
    return SoftDTW.apply(_pairwise_dist(x, y), float(gamma), store)


def dtw_distance(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Batched hard-DTW metric, (B, n, d) x (B, m, d) -> (B,), through K5
    with ``hard=True``.  Not differentiable (a metric)."""
    with torch.no_grad():
        D = _pairwise_dist(x, y).to(torch.float32).contiguous()
        return _k5.softdtw_rowmajor(D, hard=True)


# ---------------------------------------------------------------------------
# LM layers: causal GQA flash attention (K8), selective-SSM scan (K9)
# ---------------------------------------------------------------------------

def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    scale: float | None = None) -> torch.Tensor:
    """Causal GQA attention through K8: q (B, H, S, d), k (B, Hkv, S, d)
    and v (B, Hkv, S, dv) with Hkv | H -> (B, H, S, dv) in q's dtype
    (:func:`repro_torch.kernels.flash_attention.flash_attention`)."""
    return _k8.flash_attention(q, k, v, scale=scale)


def ssm_scan(dt: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
             x: torch.Tensor, a: torch.Tensor):
    """Mamba's selective scan through K9 -> (y (B, S, DI), h_final
    (B, DI, N)) (:func:`repro_torch.kernels.ssm_scan.ssm_scan`)."""
    return _k9.ssm_scan(dt, b, c, x, a)
