"""Differential-pair crossbar VMM (port of ``repro/kernels/crossbar_vmm.py``).

:func:`crossbar_matmul` computes ``y = clip((x @ G) * inv_scale)`` where G
is one read of a memristor pair (G+, G-), in one launch of the
hand-written Hopper kernel ``csrc/crossbar_vmm.cu`` (K7): float32
conductances or uint8 6-bit level indices (dequantised in the kernel),
deterministic read noise from the counter stream (K3), stuck cells at
their global ids, a drift factor, and exact zeros past the array.  The
kernel's design, and what bounds it, are in the source's header.

Device rule: the plain version :func:`repro_torch.kernels.ref.crossbar_matmul_ref`
runs only for CPU tensors; CUDA tensors launch the kernel or raise.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import ref

#: Launches of the CUDA kernel in this process (one per kernel launch).
LAUNCHES = 0


class _K7Read(ctypes.Structure):
    """The kernel's ``K7Read`` argument struct (same field order)."""
    _fields_ = [("u8", ctypes.c_int), ("g_step", ctypes.c_float),
                ("g_min", ctypes.c_float), ("g_max", ctypes.c_float),
                ("read_noise", ctypes.c_float), ("noise_seed", ctypes.c_uint),
                ("stuck_rate", ctypes.c_float),
                ("stuck_on_frac", ctypes.c_float),
                ("fault_seed", ctypes.c_uint), ("salt_p", ctypes.c_uint),
                ("salt_m", ctypes.c_uint), ("drift", ctypes.c_float),
                ("inv_scale", ctypes.c_float), ("has_clamp", ctypes.c_int),
                ("clamp", ctypes.c_float)]


def stored_operand(g: torch.Tensor) -> torch.Tensor:
    """A conductance array as K4 and K7 read it: uint8 level indices as
    they are, any other dtype as float32 (the kernels read the bytes of a
    float array as float32); contiguous either way."""
    if g.dtype != torch.uint8:
        g = g.to(torch.float32)
    return g.contiguous()


def pad_accumulator_neutral(x: torch.Tensor, mult: int,
                            axis: int) -> torch.Tensor:
    """Pad ``axis`` up to a multiple of ``mult`` with zeros, the values
    that add nothing to the product in either storage mode (0 - 0 = 0 and
    (0 - 0) * g_step = 0).  Reads that rebuild absolute conductances mask
    by the true extent as well, as K7 and its plain version do."""
    pad = (-x.shape[axis]) % mult
    if pad == 0:
        return x
    widths = [0, 0] * x.ndim
    widths[2 * (x.ndim - 1 - axis) + 1] = pad
    return torch.nn.functional.pad(x, widths)


def _launch(x, gp, gm, rd: _K7Read) -> torch.Tensor:
    global LAUNCHES
    from repro_torch.kernels import _build
    fn = _build.load("crossbar_vmm").k7_crossbar_matmul_f32
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 3
                   + [ctypes.c_void_p] * 2)
    fn.restype = ctypes.c_int
    M, K = x.shape
    N = gp.shape[1]
    y = torch.empty((M, N), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(x.data_ptr(), gp.data_ptr(), gm.data_ptr(), y.data_ptr(),
                 M, K, N, ctypes.addressof(rd), stream)
    if err != 0:
        raise RuntimeError(
            f"crossbar_matmul: CUDA kernel launch failed with cudaError_t "
            f"{err} (M={M}, K={K}, N={N})")
    LAUNCHES += 1
    return y


def crossbar_matmul(
    x: torch.Tensor,          # (M, K)
    gp: torch.Tensor,         # (K, N) float conductances or uint8 level indices
    gm: torch.Tensor,         # (K, N)
    *,
    inv_scale: float,
    g_step: float | None = None,   # set => uint8 level-index storage
    clamp: float | None = None,
    read_noise: float = 0.0,
    noise_seed: int = 0,
    g_min: float = 0.0,            # needed for noisy quantised reconstruction
    g_max: float = 0.0,            # needed for stuck-cell overrides
    stuck_rate: float = 0.0,
    stuck_on_frac: float = 0.5,
    fault_seed: int = 0,
    fault_salts: tuple[int, int] = (0, 1),   # (G+ salt, G- salt)
    drift: float = 1.0,
) -> torch.Tensor:
    """Fused differential-pair VMM -> (M, N) float32.

    ``read_noise > 0`` perturbs each conductance of the read with the
    deterministic counter stream keyed on ``noise_seed`` (per 128 x 128
    tile, as the JAX kernel draws it); ``stuck_rate > 0`` pins that
    fraction of cells to ``g_max``/``g_min`` at their global ids (bitwise
    the masks :mod:`repro_torch.core.faults` bakes at programming time);
    ``drift`` scales the whole read.  M, K and N are arbitrary.  CPU
    tensors take the plain version, CUDA tensors the kernel.
    """
    if x.ndim != 2 or gp.ndim != 2 or gp.shape != gm.shape:
        raise ValueError(
            f"crossbar_matmul: x must be (M, K) and gp, gm (K, N), got "
            f"{tuple(x.shape)}, {tuple(gp.shape)}, {tuple(gm.shape)}")
    M, K = x.shape
    if gp.shape[0] != K:
        raise ValueError(
            f"crossbar_matmul: x has K={K} columns, the arrays {gp.shape[0]} "
            f"rows")
    quant = g_step is not None
    for name, g in (("gp", gp), ("gm", gm)):
        if quant != (g.dtype == torch.uint8):
            raise ValueError(
                f"crossbar_matmul: {name} is {g.dtype}; uint8 level indices "
                f"go with g_step and float conductances without it")
    if read_noise > 0.0 and quant and g_min <= 0.0:
        raise ValueError(
            "crossbar_matmul: noisy quantised reads need the absolute "
            "conductance floor — pass g_min > 0 (spec.g_min)")
    if stuck_rate > 0.0 and not g_max > g_min:
        raise ValueError(
            "crossbar_matmul: stuck-cell injection pins cells to the "
            "absolute G_on/G_off values — pass g_max > g_min "
            "(spec.g_max/spec.g_min)")
    devices = {x.device, gp.device, gm.device}
    if len(devices) != 1:
        raise ValueError(
            f"crossbar_matmul: inputs lie on several devices "
            f"{sorted(str(d) for d in devices)}; put them on one")
    device = devices.pop()
    gp, gm = stored_operand(gp), stored_operand(gm)
    read = dict(g_step=g_step, g_min=g_min, g_max=g_max,
                read_noise=read_noise, noise_seed=noise_seed,
                stuck_rate=stuck_rate, stuck_on_frac=stuck_on_frac,
                fault_seed=fault_seed, fault_salts=fault_salts, drift=drift)
    if device.type == "cpu":
        return ref.crossbar_matmul_ref(x, gp, gm, inv_scale=inv_scale,
                                       clamp=clamp, **read)
    if device.type != "cuda":
        raise ValueError(
            f"crossbar_matmul: tensors on {device} — the kernel runs on CUDA "
            f"and its plain version on the CPU")
    mask = ref.U32_MASK
    rd = _K7Read(u8=int(quant), g_step=float(g_step or 0.0),
                 g_min=float(g_min), g_max=float(g_max),
                 read_noise=float(read_noise),
                 noise_seed=int(noise_seed) & mask,
                 stuck_rate=float(stuck_rate),
                 stuck_on_frac=float(stuck_on_frac),
                 fault_seed=int(fault_seed) & mask,
                 salt_p=int(fault_salts[0]) & mask,
                 salt_m=int(fault_salts[1]) & mask, drift=float(drift),
                 inv_scale=float(inv_scale), has_clamp=int(clamp is not None),
                 clamp=float(clamp or 0.0))
    return _launch(x.to(torch.float32).contiguous(), gp, gm, rd)
