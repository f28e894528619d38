"""Counter-derived noise for the analogue kernels (port of ``repro/kernels/noise.py``).

Read noise and device faults are keyed by coordinates, not by a generator
carried through the solve: every (seed, salt, element) triple is hashed
independently (splitmix32) to a uniform (an exponent bitcast) or a normal
(Box-Muller over two chained hashes).  So a noisy analogue rollout replays
bitwise from its seed, a resumed chunk regenerates the same stream, and a
stuck cell is a property of the physical array, not of the tile reading it.

This stream is K3.  On the card it lives in ``csrc/counter_noise.cuh``:
inline device helpers that K4 (``csrc/fused_analogue.cu``) and K7
(``csrc/crossbar_vmm.cu``) include, plus one fill kernel compiled into K4's
library that the functions below launch for CUDA tensors (``LAUNCHES``
counts those launches).  For CPU tensors they run the plain versions in
:mod:`repro_torch.kernels.ref`, which hold uint32 values in int64 tensors.
Hash bits, uniforms and masks are the JAX package's bit for bit; normals
agree to ~5e-7 (``log``/``cos`` rounding).

The functions that take a ``shape`` take ``device=`` too (default
``cuda``, which raises without a card; pass ``"cpu"`` for the plain path).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.device import resolve_device
from repro_torch.kernels import ref

U32_MASK = ref.U32_MASK
POLARITY_SALT_OFFSET = ref.POLARITY_SALT_OFFSET
global_cell_index = ref.global_cell_index
_bits_to_unit = ref.bits_to_unit_ref

#: Launches of the K3 fill kernel in this process.
LAUNCHES = 0

_MODE_SPLITMIX, _MODE_UNIFORM, _MODE_NORMAL, _MODE_STUCK = range(4)


def _placed(caller: str, device) -> torch.device:
    device = torch.device(device)
    if device.type not in ("cpu", "cuda"):
        raise ValueError(
            f"{caller}: tensors on {device} — the kernel runs on CUDA and "
            f"its plain version on the CPU")
    return device


def _fill(mode: int, seed: int, salt: int, n: int, device, *, inp=None,
          cols: int = 1, row0: int = 0, col0: int = 0, ncols: int = 0,
          rate: float = 0.0, on_frac: float = 0.0):
    """Launch the K3 fill kernel; returns its output tensor(s)."""
    global LAUNCHES
    from repro_torch.kernels import _build
    fn = _build.load("fused_analogue").k3_counter_fill
    fn.argtypes = ([ctypes.c_int, ctypes.c_uint, ctypes.c_uint,
                    ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int]
                   + [ctypes.c_uint] * 3 + [ctypes.c_float] * 2
                   + [ctypes.c_void_p] * 3)
    fn.restype = ctypes.c_int
    if mode == _MODE_SPLITMIX:
        outs = [torch.empty(n, dtype=torch.int64, device=device)]
    elif mode == _MODE_STUCK:
        outs = [torch.empty(n, dtype=torch.bool, device=device)
                for _ in range(2)]
    else:
        outs = [torch.empty(n, dtype=torch.float32, device=device)]
    ptrs = [o.data_ptr() for o in outs] + [None] * (2 - len(outs))
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(mode, int(seed) & U32_MASK, int(salt) & U32_MASK,
                 None if inp is None else inp.data_ptr(), n, cols,
                 int(row0) & U32_MASK, int(col0) & U32_MASK,
                 int(ncols) & U32_MASK, float(rate), float(on_frac),
                 ptrs[0], ptrs[1], stream)
    if err != 0:
        raise RuntimeError(
            f"counter noise: CUDA fill kernel (mode {mode}, n={n}) failed "
            f"with cudaError_t {err}")
    LAUNCHES += 1
    return outs


def _as_u32(x: torch.Tensor) -> torch.Tensor:
    """Integer ids as uint32 values held in contiguous int64."""
    if x.dtype.is_floating_point or x.dtype == torch.bool:
        raise ValueError(f"counter noise: ids must be integers, got {x.dtype}")
    return (x.to(torch.int64) & U32_MASK).contiguous()


def splitmix32(x: torch.Tensor) -> torch.Tensor:
    """Splitmix32 finaliser over uint32 values (held in an int64 tensor;
    bits above 32 are dropped), elementwise."""
    x = _as_u32(torch.as_tensor(x))
    if _placed("splitmix32", x.device).type == "cpu":
        return ref.splitmix32_ref(x)
    return _fill(_MODE_SPLITMIX, 0, 0, x.numel(), x.device,
                 inp=x)[0].reshape(x.shape)


def counter_uniform_at(seed: int, salt: int,
                       idx: torch.Tensor) -> torch.Tensor:
    """Uniform (0, 1] float32 samples at caller-chosen (typically global)
    element ids, so a blocked kernel and an unblocked caller draw the same
    sample for the same logical element."""
    idx = _as_u32(torch.as_tensor(idx))
    if _placed("counter_uniform_at", idx.device).type == "cpu":
        return ref.counter_uniform_at_ref(seed, salt, idx)
    return _fill(_MODE_UNIFORM, seed, salt, idx.numel(), idx.device,
                 inp=idx)[0].reshape(idx.shape)


def counter_normal(seed: int, salt: int, shape, *,
                   device=None) -> torch.Tensor:
    """Standard-normal float32 samples indexed by the row-major flat
    position in ``shape``."""
    device = _placed("counter_normal", resolve_device(device))
    shape = tuple(int(s) for s in shape)
    if device.type == "cpu":
        return ref.counter_normal_ref(seed, salt, shape, device)
    n = 1
    for s in shape:
        n *= s
    return _fill(_MODE_NORMAL, seed, salt, n, device)[0].reshape(shape)


def stuck_cell_masks(seed: int, salt: int, shape, rate: float,
                     on_frac: float = 0.5, *, row0=0, col0=0, ncols=None,
                     device=None):
    """(is_stuck, stuck_on) boolean fields of one device array, a pure
    function of (seed, salt, global cell coordinates): the (row0, col0)
    block of a logically (?, ncols) array sees the same masks as the slice
    of the whole array's."""
    device = _placed("stuck_cell_masks", resolve_device(device))
    shape = (int(shape[0]), int(shape[1]))
    ncols = shape[1] if ncols is None else int(ncols)
    if device.type == "cpu":
        return ref.stuck_cell_masks_ref(seed, salt, shape, rate, on_frac,
                                        row0=row0, col0=col0, ncols=ncols,
                                        device=device)
    is_stuck, stuck_on = _fill(_MODE_STUCK, seed, salt, shape[0] * shape[1],
                               device, cols=max(shape[1], 1), row0=row0,
                               col0=col0, ncols=ncols, rate=rate,
                               on_frac=on_frac)
    return is_stuck.reshape(shape), stuck_on.reshape(shape)
