"""Differential-pair crossbar VMM (port of ``repro/kernels/crossbar_vmm.py``).

:func:`crossbar_matmul` computes ``y = clip((x @ G) * inv_scale)`` where G
is one read of a memristor pair (G+, G-), through the hand-written
Hopper kernels of ``csrc/crossbar_vmm.cu`` (K7).  The read pass
(:func:`effective_g`, counted in ``READ_LAUNCHES``) writes G once as
float32: float32 conductances or uint8 6-bit level indices (dequantised
in the kernel), deterministic read noise from the counter stream (K3),
stuck cells at their global ids, a drift factor.  A 3xTF32 tensor-core
GEMM (counted in ``LAUNCHES``) then multiplies by it, with exact zeros
past the array.  The kernels' design, and
what bounds them, are in the source's header.

Device rule: the plain version :func:`repro_torch.kernels.ref.crossbar_matmul_ref`
runs only for CPU tensors; CUDA tensors launch the kernel or raise.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import ref, work

#: Launches of the CUDA GEMM in this process (one per ``crossbar_matmul``).
LAUNCHES = 0
#: Launches of the CUDA read pass in this process (one per read: per
#: ``crossbar_matmul`` or ``effective_g`` call).
READ_LAUNCHES = 0


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


_ARGTYPES = {
    # gp, gm, g, K, N, read, stream
    "k7_crossbar_read": [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2
    + [ctypes.c_void_p] * 2,
    # x, g, y, M, K, N, read, stream
    "k7_crossbar_matmul_f32": [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3
    + [ctypes.c_void_p] * 2,
}


@functools.cache
def _fn(name: str):
    from repro_torch.kernels import _build
    fn = getattr(_build.load("crossbar_vmm"), name)
    fn.argtypes = _ARGTYPES[name]
    fn.restype = ctypes.c_int
    return fn


def _k7(gp, gm, rd: _K7Read, x=None) -> torch.Tensor:
    """K7 on CUDA tensors, in one device context on the current stream:
    the read pass into a new float32 G (K, N), returned when ``x`` is
    None; else the GEMM of ``x`` by it, returning y (M, N)."""
    global LAUNCHES, READ_LAUNCHES
    K, N = gp.shape
    g = torch.empty((K, N), dtype=torch.float32, device=gp.device)
    with torch.cuda.device(gp.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _fn("k7_crossbar_read")(gp.data_ptr(), gm.data_ptr(),
                                      g.data_ptr(), K, N,
                                      ctypes.addressof(rd), stream)
        if err != 0:
            raise RuntimeError(
                f"K7: CUDA read pass failed with cudaError_t "
                f"{err} (K={K}, N={N})")
        READ_LAUNCHES += 1
        if x is None:
            return g
        M = x.shape[0]
        y = torch.empty((M, N), dtype=torch.float32, device=x.device)
        err = _fn("k7_crossbar_matmul_f32")(x.data_ptr(), g.data_ptr(),
                                            y.data_ptr(), M, K, N,
                                            ctypes.addressof(rd), stream)
        if err != 0:
            raise RuntimeError(
                f"K7: CUDA GEMM launch failed with "
                f"cudaError_t {err} (M={M}, K={K}, N={N})")
        LAUNCHES += 1
    return y


def _read_args(caller: str, gp: torch.Tensor, gm: torch.Tensor, *,
               g_step: float | None = None, g_min: float = 0.0,
               g_max: float = 0.0, read_noise: float = 0.0,
               noise_seed: int = 0, stuck_rate: float = 0.0,
               stuck_on_frac: float = 0.5, fault_seed: int = 0,
               fault_salts: tuple[int, int] = (0, 1),
               drift: float = 1.0) -> dict:
    """The read arguments of :func:`crossbar_matmul` and
    :func:`effective_g`, defaults filled in, after the rules every read
    keeps.

    ``g_step`` set means uint8 level-index storage (float conductances
    without it); ``read_noise > 0`` perturbs each conductance with the
    deterministic counter stream keyed on ``noise_seed`` (per 128 x 128
    tile, as the JAX kernel draws it), and on uint8 storage needs the
    absolute floor ``g_min > 0``; ``stuck_rate > 0`` pins that fraction of
    cells to ``g_max``/``g_min`` at their global ids (bitwise the masks
    :mod:`repro_torch.core.faults` bakes at programming time), with
    ``fault_salts`` the (G+, G-) salts; ``drift`` scales the whole read.
    """
    quant = g_step is not None
    for name, g in (("gp", gp), ("gm", gm)):
        if quant != (g.dtype == torch.uint8):
            raise ValueError(
                f"{caller}: {name} is {g.dtype}; uint8 level indices go "
                f"with g_step and float conductances without it")
    if read_noise > 0.0 and quant and g_min <= 0.0:
        raise ValueError(
            f"{caller}: noisy quantised reads need the absolute conductance "
            f"floor — pass g_min > 0 (spec.g_min)")
    if stuck_rate > 0.0 and not g_max > g_min:
        raise ValueError(
            f"{caller}: stuck-cell injection pins cells to the absolute "
            f"G_on/G_off values — pass g_max > g_min (spec.g_max/spec.g_min)")
    return dict(g_step=g_step, g_min=g_min, g_max=g_max,
                read_noise=read_noise, noise_seed=noise_seed,
                stuck_rate=stuck_rate, stuck_on_frac=stuck_on_frac,
                fault_seed=fault_seed, fault_salts=fault_salts, drift=drift)


def _k7_read(inv_scale, clamp, *, g_step, g_min, g_max, read_noise,
             noise_seed, stuck_rate, stuck_on_frac, fault_seed, fault_salts,
             drift) -> _K7Read:
    mask = ref.U32_MASK
    return _K7Read(u8=int(g_step is not None), g_step=float(g_step or 0.0),
                   g_min=float(g_min), g_max=float(g_max),
                   read_noise=float(read_noise),
                   noise_seed=int(noise_seed) & mask,
                   stuck_rate=float(stuck_rate),
                   stuck_on_frac=float(stuck_on_frac),
                   fault_seed=int(fault_seed) & mask,
                   salt_p=int(fault_salts[0]) & mask,
                   salt_m=int(fault_salts[1]) & mask, drift=float(drift),
                   inv_scale=float(inv_scale),
                   has_clamp=int(clamp is not None),
                   clamp=float(clamp or 0.0))


def effective_g(gp: torch.Tensor, gm: torch.Tensor, **read) -> torch.Tensor:
    """The (K, N) float32 G one read of the pair gives, with the read
    arguments of :func:`crossbar_matmul` (:func:`_read_args`): K7's read
    pass on CUDA tensors (bitwise
    :func:`repro_torch.kernels.ref.crossbar_effective_g`), that plain
    version on CPU tensors."""
    if gp.ndim != 2 or gp.shape != gm.shape or gp.device != gm.device:
        raise ValueError(
            f"effective_g: gp and gm must be (K, N) on one device, got "
            f"{tuple(gp.shape)} on {gp.device}, {tuple(gm.shape)} on "
            f"{gm.device}")
    read = _read_args("effective_g", gp, gm, **read)
    gp, gm = stored_operand(gp), stored_operand(gm)
    if gp.device.type == "cpu":
        return ref.crossbar_effective_g(gp, gm, **read)
    if gp.device.type != "cuda":
        raise ValueError(f"effective_g: tensors on {gp.device} — the kernel "
                         f"runs on CUDA and its plain version on the CPU")
    return _k7(gp, gm, _k7_read(1.0, None, **read))


def crossbar_matmul(
    x: torch.Tensor,          # (M, K)
    gp: torch.Tensor,         # (K, N) float conductances or uint8 level indices
    gm: torch.Tensor,         # (K, N)
    *,
    inv_scale: float,
    clamp: float | None = None,
    **read,
) -> torch.Tensor:
    """Fused differential-pair VMM -> (M, N) float32.

    ``read`` holds the read arguments (``g_step``, ``g_min``, ``g_max``,
    ``read_noise``, ``noise_seed``, ``stuck_rate``, ``stuck_on_frac``,
    ``fault_seed``, ``fault_salts``, ``drift``); their defaults and rules
    are :func:`_read_args`'s.  M, K and N are arbitrary.  CPU tensors take
    the plain version, CUDA tensors the read pass and the GEMM.
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
    read = _read_args("crossbar_matmul", gp, gm, **read)
    devices = {x.device, gp.device, gm.device}
    if len(devices) != 1:
        raise ValueError(
            f"crossbar_matmul: inputs lie on several devices "
            f"{sorted(str(d) for d in devices)}; put them on one")
    device = devices.pop()
    gp, gm = stored_operand(gp), stored_operand(gm)
    N = gp.shape[1]
    work.report("K7", 2.0 * M * K * N,
                4.0 * (M * K + M * N) + 2.0 * gp.numel() * gp.element_size())
    if device.type == "cpu":
        with work.uncounted():
            return ref.crossbar_matmul_ref(x, gp, gm, inv_scale=inv_scale,
                                           clamp=clamp, **read)
    if device.type != "cuda":
        raise ValueError(
            f"crossbar_matmul: tensors on {device} — the kernel runs on CUDA "
            f"and its plain version on the CPU")
    return _k7(gp, gm, _k7_read(inv_scale, clamp, **read),
               x.to(torch.float32).contiguous())
