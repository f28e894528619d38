"""Weights-stationary fused analogue neural-ODE solve (port of ``repro/kernels/fused_analogue.py``).

:func:`fused_analogue_rollout` runs the whole RK4 trajectory of a fleet
through memristor crossbar pairs in ONE launch of the hand-written Hopper
kernel ``csrc/fused_analogue.cu`` (K4), the crossbar read semantics of
:func:`repro_torch.core.analogue.analogue_mlp_apply` inside the kernel:

* each layer is a differential pair (G+, G-) of (K+1, N) arrays, float32
  conductances or uint8 6-bit level indices, the bias as the last row,
  resident in shared memory for the whole solve, with a per-layer
  ``1/scale`` and an optional clamp;
* noise-free, each pair is combined once into effective weights, so the
  inner loop is K1's; with ``read_noise > 0`` every evaluation re-draws
  the read noise of both halves from the counter stream (K3), salted by
  (global step, RK4 stage, layer, pair), so a noisy rollout replays
  bitwise from ``noise_seed`` and, through ``step_offset``, a split
  rollout replays the unsplit one;
* device faults in-kernel: stuck cells at their global ids (bitwise the
  program-time masks of :mod:`repro_torch.core.faults`) and live drift.

The solve is inference-only (train digitally, deploy analogue) and always
float32.  Device rule: the plain version
:func:`repro_torch.kernels.ref.fused_analogue_rollout_ref` runs only for
CPU tensors; CUDA tensors launch the kernel or raise.
"""
from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.crossbar_vmm import stored_operand
from repro_torch.kernels.fused_ode_mlp import MAX_LAYERS, SMEM_LIMIT_BYTES

#: Twins per CUDA block of K4 (1024 twins -> 128 blocks on the H100's 132
#: SMs).  Each twin's arithmetic is independent, so this does not change
#: results.
ROWS_PER_BLOCK = 8

#: Fault scalars the kernel understands (subset optional); produced by
#: ``FaultModel.kernel_args()`` in :mod:`repro_torch.core.faults`.
FAULT_DEFAULTS = {
    "stuck_rate": 0.0, "stuck_on_frac": 0.5, "fault_seed": 0,
    "salt_base": 0, "drift_nu": 0.0, "drift_tau": 1.0, "drift_n0": 0,
}

#: Static shared memory of a K4 block (its per-layer 1/scale array).
_STATIC_SMEM = 4 * MAX_LAYERS

#: Launches of the CUDA kernel in this process (one per kernel launch).
LAUNCHES = 0


class _K4Read(ctypes.Structure):
    """The kernel's ``K4Read`` argument struct (same field order)."""
    _fields_ = [("dt", ctypes.c_float), ("dt2", ctypes.c_float),
                ("dt6", ctypes.c_float), ("u8", ctypes.c_int),
                ("g_step", ctypes.c_float), ("g_min", ctypes.c_float),
                ("g_max", ctypes.c_float), ("has_clamp", ctypes.c_int),
                ("v_clamp", ctypes.c_float), ("read_noise", ctypes.c_float),
                ("noise_seed", ctypes.c_uint), ("stuck_rate", ctypes.c_float),
                ("stuck_on_frac", ctypes.c_float),
                ("fault_seed", ctypes.c_uint),
                ("salt_base", ctypes.c_longlong),
                ("drift_nu", ctypes.c_float), ("drift_tau", ctypes.c_float),
                ("drift_n0", ctypes.c_longlong),
                ("step_offset", ctypes.c_longlong)]


def smem_bytes_analogue(sizes: Sequence[int], noisy: bool,
                        rows: int = ROWS_PER_BLOCK) -> int:
    """Dynamic shared memory of one K4 block for MLP widths ``sizes``: the
    resident arrays (combined W per layer noise-free; G+ and G- per layer
    plus a scratch of the largest layer with read noise) and K1's
    activation buffers."""
    n = [(a + 1) * b for a, b in zip(sizes[:-1], sizes[1:])]
    arrays = 2 * sum(n) + max(n) if noisy else sum(n)
    hidden = max(sizes[1:-1], default=0)
    hstride = (hidden | 1) if hidden else 0
    D = sizes[-1]
    return 4 * (arrays + rows * (3 * D + (sizes[0] | 1) + 2 * hstride))


def check_smem_fit(sizes: Sequence[int], noisy: bool,
                   rows: int = ROWS_PER_BLOCK) -> int:
    """Raise a ``ValueError`` when one K4 block's working set exceeds the
    227 KB a Hopper block may use; returns the dynamic bytes otherwise."""
    need = smem_bytes_analogue(sizes, noisy, rows)
    if need + _STATIC_SMEM > SMEM_LIMIT_BYTES:
        mode = "noisy (G+, G- and a scratch)" if noisy else "noise-free"
        raise ValueError(
            f"fused_analogue_rollout: MLP {tuple(sizes)} needs {need:,} B of "
            f"shared memory per block ({rows} twins, {mode} reads), over the "
            f"227 KB ({SMEM_LIMIT_BYTES:,} B) per-block limit of sm_90; the "
            f"arrays must stay resident, so this width needs a cluster or a "
            f"split across blocks")
    return need


def _launch(y0, u_half, scales, gps, gms, rd: _K4Read, per_twin, T, du,
            sizes, smem):
    """Launch K4 on the current stream; returns (T+1, B, D) float32."""
    global LAUNCHES
    from repro_torch.kernels import _build
    fn = _build.load("fused_analogue").k4_fused_analogue_rollout_f32
    fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int]
                   + [ctypes.c_void_p] + [ctypes.c_int] * 4
                   + [ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong,
                      ctypes.c_void_p])
    fn.restype = ctypes.c_int
    B, D = y0.shape
    L = len(gps)
    out = torch.empty((T + 1, B, D), dtype=torch.float32, device=y0.device)
    gp_ptrs = (ctypes.c_void_p * L)(*[g.data_ptr() for g in gps])
    gm_ptrs = (ctypes.c_void_p * L)(*[g.data_ptr() for g in gms])
    c_sizes = (ctypes.c_int * (L + 1))(*sizes)
    u_ptr = u_half.data_ptr() if du > 0 else None
    u_twin_stride = (2 * T + 1) * du if per_twin else 0
    with torch.cuda.device(y0.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(y0.data_ptr(), u_ptr, out.data_ptr(), scales.data_ptr(),
                 ctypes.addressof(gp_ptrs), ctypes.addressof(gm_ptrs),
                 ctypes.addressof(c_sizes), L, ctypes.addressof(rd), B, T, D,
                 du, u_twin_stride, ROWS_PER_BLOCK, smem, stream)
    if err != 0:
        raise RuntimeError(
            f"fused_analogue_rollout: CUDA kernel launch failed with "
            f"cudaError_t {err} (B={B}, T={T}, sizes={tuple(sizes)}, "
            f"smem={smem} B)")
    LAUNCHES += 1
    return out


def fused_analogue_rollout(
    gps: Sequence[torch.Tensor],  # per layer (K_l + 1, N_l): conductances
    gms: Sequence[torch.Tensor],  # (f32) or uint8 level indices; bias row last
    scales: torch.Tensor,         # (L,) per-tensor programming scales
    y0: torch.Tensor,             # (B, D)
    u_half: torch.Tensor,         # (2T+1, Du) shared or (B, 2T+1, Du)
    dt: float,
    *,
    g_step: float | None = None,  # set => uint8 level-index storage
    g_min: float = 0.0,           # conductance floor (noisy quantised reads)
    g_max: float = 0.0,           # conductance ceiling (stuck overrides)
    v_clamp: float | None = None,
    read_noise: float = 0.0,
    noise_seed: int = 0,
    step_offset: int = 0,         # global step index of y0 (resume replay)
    fault: dict | None = None,    # FaultModel.kernel_args(); None = healthy
    batch_tile: int = 64,
) -> torch.Tensor:
    """Full-trajectory analogue RK4 solve; returns (T+1, B, D) float32.

    Same drive contract as K1 (half-step drive, shared or per twin, Du may
    be 0; B must divide by ``batch_tile``).  ``fault`` injects stuck cells
    and live read-disturb drift in the kernel.  ``step_offset`` declares
    the global RK4 step of ``y0``: a rollout resumed at step k with
    ``step_offset=k`` continues the same noise salts and drift exponents,
    so split-and-resume is bitwise the unsplit rollout.  Raises
    ``ValueError`` for noisy uint8 reads without ``g_min > 0``, stuck
    cells without ``g_max > g_min``, unknown fault keys, and shapes the
    kernel does not take.
    """
    if read_noise > 0.0 and g_step is not None and g_min <= 0.0:
        raise ValueError(
            "fused_analogue_rollout: noisy quantised reads need the "
            "absolute conductance floor — pass g_min > 0 (spec.g_min)")
    fa = dict(FAULT_DEFAULTS, **(fault or {}))
    if set(fa) != set(FAULT_DEFAULTS):
        raise ValueError(
            f"fused_analogue_rollout: unknown fault keys "
            f"{sorted(set(fa) - set(FAULT_DEFAULTS))}; have "
            f"{sorted(FAULT_DEFAULTS)}")
    if fa["stuck_rate"] > 0.0 and not g_max > g_min:
        raise ValueError(
            "fused_analogue_rollout: stuck-cell injection pins cells to "
            "the absolute G_on/G_off values — pass g_max > g_min "
            "(spec.g_max/spec.g_min)")
    for name, x in (("y0", y0), ("u_half", u_half)):
        if not torch.is_floating_point(x):
            raise ValueError(
                f"fused_analogue_rollout: {name} has non-floating dtype "
                f"{x.dtype}; cast it to a floating dtype")
    gps, gms = list(gps), list(gms)
    L = len(gps)
    quant = g_step is not None
    for name, arrays in (("gps", gps), ("gms", gms)):
        for li, g in enumerate(arrays):
            if quant != (g.dtype == torch.uint8):
                raise ValueError(
                    f"fused_analogue_rollout: {name}[{li}] is {g.dtype}; "
                    f"uint8 level indices go with g_step and float "
                    f"conductances without it")
    scales = torch.as_tensor(scales)
    if L != len(gms) or tuple(scales.shape) != (L,):
        raise ValueError(
            f"fused_analogue_rollout: {len(gps)} G+ and {len(gms)} G- arrays "
            f"with scales of shape {tuple(scales.shape)}; need one of each "
            f"per layer")

    B, D = y0.shape
    per_twin = u_half.ndim == 3
    if per_twin and u_half.shape[0] != B:
        raise ValueError(
            f"per-twin drive batch {u_half.shape[0]} != y0 batch {B}")
    if per_twin and u_half.shape[-1] == 0:
        per_twin, u_half = False, u_half[0]
    T = (u_half.shape[1 if per_twin else 0] - 1) // 2
    du = u_half.shape[-1]
    if B == 0:
        raise ValueError("fused_analogue_rollout: empty fleet (y0 has 0 rows)")
    bt = min(batch_tile, B)
    if B % bt:
        raise ValueError(f"batch {B} not divisible by tile {bt}")
    sizes = [gps[0].shape[0] - 1] + [g.shape[1] for g in gps]
    if any(g.shape != (a + 1, b) or m.shape != g.shape
           for g, m, a, b in zip(gps, gms, sizes[:-1], sizes[1:])):
        raise ValueError(
            f"fused_analogue_rollout: the arrays "
            f"{[tuple(g.shape) for g in gps]} do not chain as (K+1, N) "
            f"layers of one MLP, or G- differs from G+ in shape")
    if sizes[0] != du + D or sizes[-1] != D:
        raise ValueError(
            f"fused_analogue_rollout: MLP {tuple(sizes)} does not map "
            f"[u (Du={du}), y (D={D})] to dy/dt (D={D})")
    smem = check_smem_fit(sizes, read_noise > 0.0)

    devices = {x.device for x in [y0, u_half, scales, *gps, *gms]}
    if len(devices) != 1:
        raise ValueError(
            f"fused_analogue_rollout: inputs lie on several devices "
            f"{sorted(str(d) for d in devices)}; put them on one")
    device = devices.pop()
    y0 = y0.to(torch.float32).contiguous()
    u_half = u_half.to(torch.float32).contiguous()
    scales = scales.to(torch.float32).contiguous()
    gps = [stored_operand(g) for g in gps]
    gms = [stored_operand(g) for g in gms]
    if device.type == "cpu":
        return ref.fused_analogue_rollout_ref(
            gps, gms, scales, y0, u_half, float(dt), fault=fa, g_step=g_step,
            g_min=g_min, g_max=g_max, v_clamp=v_clamp, read_noise=read_noise,
            noise_seed=noise_seed, step_offset=step_offset)
    if device.type != "cuda":
        raise ValueError(
            f"fused_analogue_rollout: tensors on {device} — the kernel runs "
            f"on CUDA and its plain version on the CPU")
    if L > MAX_LAYERS:
        raise ValueError(
            f"fused_analogue_rollout: {L} layers, the kernel takes at most "
            f"{MAX_LAYERS}")
    dt64 = float(dt)
    mask = ref.U32_MASK
    rd = _K4Read(dt=dt64, dt2=dt64 / 2, dt6=dt64 / 6, u8=int(quant),
                 g_step=float(g_step or 0.0), g_min=float(g_min),
                 g_max=float(g_max), has_clamp=int(v_clamp is not None),
                 v_clamp=float(v_clamp or 0.0), read_noise=float(read_noise),
                 noise_seed=int(noise_seed) & mask,
                 stuck_rate=float(fa["stuck_rate"]),
                 stuck_on_frac=float(fa["stuck_on_frac"]),
                 fault_seed=int(fa["fault_seed"]) & mask,
                 salt_base=int(fa["salt_base"]),
                 drift_nu=float(fa["drift_nu"]),
                 drift_tau=float(fa["drift_tau"]),
                 drift_n0=int(fa["drift_n0"]), step_offset=int(step_offset))
    return _launch(y0, u_half, scales, gps, gms, rd, per_twin, T, du, sizes,
                   smem)
