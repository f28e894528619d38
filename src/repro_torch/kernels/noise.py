"""Counter-derived noise for the analogue kernels (port of ``repro/kernels/noise.py``).

Read noise and device faults are keyed by coordinates, not by a generator
carried through the solve: every (seed, salt, element) triple is hashed
independently (splitmix32) to a uniform (an exponent bitcast) or a normal
(Box-Muller over two chained hashes).  So a noisy analogue rollout replays
bitwise from its seed, a resumed chunk regenerates the same stream, and a
stuck cell is a property of the physical array, not of the tile reading it.

This stream is K3.  On the card it lives in ``csrc/counter_noise.cuh``,
inline device helpers that K4 (``csrc/fused_analogue.cu``) and K7
(``csrc/crossbar_vmm.cu``) include, and in K3's own library
``csrc/counter_noise.cu``, which the functions below launch for CUDA
tensors: a fill of one array (``LAUNCHES``), the stuck masks of a whole
programming in one launch (:func:`stuck_cell_masks_many`,
``MASK_LAUNCHES``), and the hardware-aware write path of every layer and
draw of a training step in one launch (:func:`hw_write_path`,
``WRITE_LAUNCHES``).
Each entry point is bound once per process.  For CPU tensors they run the
plain versions in :mod:`repro_torch.kernels.ref`, which hold uint32 values
in int64 tensors.  Hash bits, uniforms and masks are the JAX package's bit
for bit; normals agree to ~5e-7 (``log``/``cos`` rounding).

The functions that take a ``shape`` take ``device=`` too (default
``cuda``, which raises without a card; pass ``"cpu"`` for the plain path).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.device import resolve_device
from repro_torch.kernels import ref

U32_MASK = ref.U32_MASK
POLARITY_SALT_OFFSET = ref.POLARITY_SALT_OFFSET
global_cell_index = ref.global_cell_index
_bits_to_unit = ref.bits_to_unit_ref

#: Launches of K3's fill kernel in this process.
LAUNCHES = 0
#: Launches of K3's batched stuck-mask kernel in this process.
MASK_LAUNCHES = 0
#: Launches of K3's hardware-aware write-path kernel in this process.
WRITE_LAUNCHES = 0

_MODE_SPLITMIX, _MODE_UNIFORM, _MODE_NORMAL, _MODE_STUCK = range(4)
#: Arrays per batched-mask launch, layers and draws per write-path launch
#: (the kernel's CN_MAX_ARRAYS, HW_MAX_LAYERS, HW_MAX_DRAWS); longer lists
#: take one launch per chunk.
MAX_ARRAYS, MAX_LAYERS, MAX_DRAWS = 32, 8, 32


class _CnArray(ctypes.Structure):
    _fields_ = [("salt", ctypes.c_uint), ("rows", ctypes.c_int),
                ("cols", ctypes.c_int), ("off", ctypes.c_longlong)]


class _CnArrays(ctypes.Structure):
    """The kernel's ``CnArrays`` descriptor table (same field order)."""
    _fields_ = [("a", _CnArray * MAX_ARRAYS), ("count", ctypes.c_int)]


class _HwLayer(ctypes.Structure):
    _fields_ = [("w", ctypes.c_void_p), ("b", ctypes.c_void_p),
                ("rows", ctypes.c_int), ("cols", ctypes.c_int),
                ("out", ctypes.c_longlong)]


class _HwWrite(ctypes.Structure):
    """The kernel's ``HwWrite`` argument struct (same field order)."""
    _fields_ = ([("layer", _HwLayer * MAX_LAYERS),
                 ("dfac", ctypes.c_float * MAX_DRAWS)]
                + [(k, ctypes.c_int) for k in ("num_layers", "layer0",
                                               "salt_layers", "draw0",
                                               "ndraws")]
                + [(k, ctypes.c_uint) for k in (
                    "step", "k_draws", "noise_seed", "fault_seed",
                    "salt_base", "fault_salt_base")]
                + [(k, ctypes.c_int) for k in ("ensemble", "quantize",
                                               "stuck", "ste")]
                + [(k, ctypes.c_float) for k in (
                    "g_min", "g_max", "g_step", "g_range", "clip_hi",
                    "levels_m1", "prog_noise", "read_sigma", "stuck_rate",
                    "on_frac")]
                + [("draw_stride", ctypes.c_longlong),
                   ("step_ptr", ctypes.c_void_p)])


_ARGTYPES = {
    # mode, seed, salt, in, n, cols, row0, col0, ncols, rate, on_frac,
    # out0, out1, stream
    "k3_counter_fill": ([ctypes.c_int, ctypes.c_uint, ctypes.c_uint,
                         ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int]
                        + [ctypes.c_uint] * 3 + [ctypes.c_float] * 2
                        + [ctypes.c_void_p] * 3),
    # arrays, seed, rate, on_frac, is_stuck, stuck_on, stream
    "k3_stuck_masks": ([ctypes.c_void_p, ctypes.c_uint] + [ctypes.c_float] * 2
                       + [ctypes.c_void_p] * 3),
    # params, out, stream
    "k3_hw_write_path": [ctypes.c_void_p] * 3,
}


@functools.cache
def _fn(name: str):
    """An entry point of K3's library, built, loaded and bound once."""
    from repro_torch.kernels import _build
    fn = getattr(_build.load("counter_noise"), name)
    fn.argtypes = _ARGTYPES[name]
    fn.restype = ctypes.c_int
    return fn


def _launch(name: str, device: torch.device, *args) -> None:
    """Call entry point ``name`` with ``args`` on the current stream of
    ``device`` (a launch goes to the current device, so another device is
    made current for it); raises on a non-zero ``cudaError_t``."""
    current = torch.cuda.current_device()
    if device.index is not None and device.index != current:
        with torch.cuda.device(device):
            return _launch(name, torch.device("cuda"), *args)
    err = _fn(name)(*args, torch._C._cuda_getCurrentRawStream(current))
    if err != 0:
        raise RuntimeError(
            f"counter noise: CUDA kernel {name} failed with cudaError_t {err}")


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
    dtype = {_MODE_SPLITMIX: torch.int64,
             _MODE_STUCK: torch.bool}.get(mode, torch.float32)
    out = torch.empty(2 * n if mode == _MODE_STUCK else n, dtype=dtype,
                      device=device)
    ptr = out.data_ptr()
    _launch("k3_counter_fill", device, mode, int(seed) & U32_MASK,
            int(salt) & U32_MASK, None if inp is None else inp.data_ptr(), n,
            cols, int(row0) & U32_MASK, int(col0) & U32_MASK,
            int(ncols) & U32_MASK, float(rate), float(on_frac), ptr,
            ptr + n if mode == _MODE_STUCK else None)
    LAUNCHES += 1
    return (out[:n], out[n:]) if mode == _MODE_STUCK else (out,)


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
    return _fill(_MODE_NORMAL, seed, salt, n, device)[0].view(*shape)


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
    return is_stuck.view(*shape), stuck_on.view(*shape)


@functools.lru_cache(maxsize=256)
def _mask_tables(arrays: tuple) -> tuple:
    """The descriptor tables of ``arrays`` ((salt, (rows, cols)), ...), one
    per launch of at most MAX_ARRAYS, with the flat offsets; the total
    number of cells; the arrays' sizes twice (is_stuck, then stuck_on)."""
    tables, off = [], 0
    for c in range(0, len(arrays), MAX_ARRAYS):
        t = _CnArrays()
        chunk = arrays[c:c + MAX_ARRAYS]
        t.count = len(chunk)
        for i, (salt, (rows, cols)) in enumerate(chunk):
            t.a[i] = _CnArray(int(salt) & U32_MASK, rows, cols, off)
            off += rows * cols
        tables.append(t)
    sizes = [rows * cols for _, (rows, cols) in arrays]
    return tuple(tables), off, sizes + sizes


def stuck_cell_masks_many(seed: int, arrays, rate: float,
                          on_frac: float = 0.5, *, device=None) -> list:
    """The (is_stuck, stuck_on) masks of several whole arrays, ``arrays`` a
    list of ``(salt, (rows, cols))``, each as :func:`stuck_cell_masks` draws
    it: on CUDA one K3 launch writes them all into one flat buffer (a
    programming's 2 L arrays), and the masks are views of it."""
    device = _placed("stuck_cell_masks_many", resolve_device(device))
    arrays = tuple((salt, tuple(shape)) for salt, shape in arrays)
    if device.type == "cpu":
        return ref.stuck_cell_masks_many_ref(seed, arrays, rate, on_frac,
                                             device=device)
    global MASK_LAUNCHES
    tables, total, sizes = _mask_tables(arrays)
    buf = torch.empty(2 * total, dtype=torch.bool, device=device)
    ptr = buf.data_ptr()
    if total:
        for t in tables:
            _launch("k3_stuck_masks", device, ctypes.addressof(t),
                    int(seed) & U32_MASK, float(rate), float(on_frac), ptr,
                    ptr + total)
            MASK_LAUNCHES += 1
    parts = buf.split_with_sizes(sizes)
    A = len(arrays)
    return [(parts[i].view(*shape), parts[A + i].view(*shape))
            for i, (_, shape) in enumerate(arrays)]


@functools.lru_cache(maxsize=64)
def _write_params(wp: ref.WritePath, shapes: tuple, draw0: int,
                  ndraws: int, layer0: int, ste: bool) -> tuple:
    """The launch struct of one write-path call, all but its pointers and
    step (``shapes`` are the layers' (rows, cols)); and the sizes that
    split its output into each draw's and layer's w rows and b row."""
    p = _HwWrite()
    off = 0
    for i, (rows, cols) in enumerate(shapes):
        p.layer[i].rows, p.layer[i].cols, p.layer[i].out = rows, cols, off
        off += (rows + 1) * cols
    for d in range(ndraws):
        p.dfac[d] = wp.drift[draw0 + d] if wp.drift else 1.0
    p.num_layers, p.layer0, p.salt_layers = len(shapes), layer0, wp.num_layers
    p.draw0, p.ndraws = draw0, ndraws
    p.k_draws = wp.k_draws & U32_MASK
    p.noise_seed = wp.noise_seed & U32_MASK
    p.fault_seed = wp.fault_seed & U32_MASK
    p.salt_base, p.fault_salt_base = ref.HW_SALT_BASE, ref.FAULT_SALT_BASE
    p.ensemble, p.quantize = int(wp.fault_ensemble), int(wp.quantize)
    p.stuck, p.ste = int(wp.stuck_rate > 0), int(ste)
    p.g_min, p.g_max, p.g_step = wp.g_min, wp.g_max, wp.g_step
    p.g_range = wp.g_max - wp.g_min
    p.clip_hi = wp.g_max * 1.5
    p.levels_m1 = wp.levels - 1
    p.prog_noise, p.read_sigma = wp.prog_noise, wp.read_sigma
    p.stuck_rate, p.on_frac = wp.stuck_rate, wp.on_frac
    p.draw_stride = off
    sizes = [n for rows, cols in shapes for n in (rows * cols, cols)]
    return p, sizes * ndraws


def hw_write_path(weights, biases, wp: ref.WritePath, step, draws, *,
                  layer0: int = 0, ste: bool = False) -> list:
    """Every layer's folded weights ``[w; b]`` through the hardware-aware
    write path for each draw of ``draws`` (a ``range``), at training step
    ``step``: a list (per draw) of lists (per layer) of ``(w_hw, b_hw)``,
    the rows and the last row of the ``(K + 1, N)`` float32 result; ``ste``
    gives the straight-through value ``folded + (w_hw - folded)``.  On
    CUDA one K3 launch computes them all into one buffer (chunks of
    MAX_LAYERS layers and MAX_DRAWS draws past those sizes) and nothing is
    read back to the host.

    ``step`` is a Python int or a 0-dim int32 tensor on the weights'
    device, read as uint32 (-1 is step 2^32 - 1): the training engines'
    step counter, which the kernel reads from device memory, so that a
    CUDA graph of the step draws each replay's noise at the counter's
    value rather than at the capture's."""
    device = _placed("hw_write_path", weights[0].device)
    draws = range(draws.start, draws.stop)
    if isinstance(step, torch.Tensor) and (
            step.dtype != torch.int32 or step.ndim != 0
            or step.device != device):
        raise ValueError(
            f"hw_write_path: a tensor step must be a 0-dim int32 tensor on "
            f"{device}, got {step.dtype} {tuple(step.shape)} on "
            f"{step.device}")
    if device.type == "cpu":
        return ref.hw_write_path_ref(weights, biases, wp, step, draws,
                                     layer0=layer0, ste=ste)
    if len(weights) > MAX_LAYERS:
        head = hw_write_path(weights[:MAX_LAYERS], biases[:MAX_LAYERS], wp,
                             step, draws, layer0=layer0, ste=ste)
        tail = hw_write_path(weights[MAX_LAYERS:], biases[MAX_LAYERS:], wp,
                             step, draws, layer0=layer0 + MAX_LAYERS, ste=ste)
        return [h + t for h, t in zip(head, tail)]
    if len(draws) > MAX_DRAWS:
        mid = draws.start + MAX_DRAWS
        return (hw_write_path(weights, biases, wp, step,
                              range(draws.start, mid), layer0=layer0, ste=ste)
                + hw_write_path(weights, biases, wp, step,
                                range(mid, draws.stop), layer0=layer0,
                                ste=ste))
    global WRITE_LAUNCHES
    ws = [_f32(w) for w in weights]
    bs = [_f32(b) for b in biases]
    shapes = tuple(tuple(w.shape) for w in ws)
    p, sizes = _write_params(wp, shapes, draws.start, len(draws), layer0,
                             ste)
    for i, (w, b) in enumerate(zip(ws, bs)):
        p.layer[i].w, p.layer[i].b = w.data_ptr(), b.data_ptr()
    if isinstance(step, torch.Tensor):
        p.step, p.step_ptr = 0, step.data_ptr()
    else:
        p.step, p.step_ptr = int(step) & U32_MASK, None
    out = torch.empty(len(draws) * p.draw_stride, dtype=torch.float32,
                      device=device)
    _launch("k3_hw_write_path", device, ctypes.addressof(p), out.data_ptr())
    WRITE_LAUNCHES += 1
    parts = out.split_with_sizes(sizes)
    L = len(shapes)
    return [[(parts[2 * j].view(*shape), parts[2 * j + 1])
             for j, shape in enumerate(shapes, d * L)]
            for d in range(len(draws))]


def _f32(x: torch.Tensor) -> torch.Tensor:
    """``x`` as contiguous float32 (itself when it is already)."""
    if x.dtype is torch.float32 and x.is_contiguous():
        return x
    return x.to(torch.float32).contiguous()
