"""Weights-stationary fused neural-ODE solve (port of ``repro/kernels/fused_ode_mlp.py``).

:func:`fused_node_rollout` runs the whole RK4 trajectory of
dy/dt = ReLU-MLP([u(t), y]) for a fleet of twins in ONE launch of the
hand-written Hopper kernel ``csrc/fused_ode_mlp.cu`` (K1): the MLP
weights sit in shared memory for all 4*T evaluations, and the only
device-memory traffic is y0 and the drive in, the trajectory out.  The
kernel's design, and what bounds it, are in the source's header.

Device rule: the plain version :func:`repro_torch.kernels.ref.fused_node_rollout_ref`
runs only for CPU tensors.  CUDA tensors launch the kernel or raise; no
path swaps in the plain version.

Only the float32 policy is ported.  The TPU planning knobs
(``time_chunk``, ``vmem_budget_bytes``, ``interpret``) have no
counterpart: f32 results do not depend on them.
"""
from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from repro_torch.kernels import ref

#: Precision policies of the JAX kernel; only "f32" is ported.
PRECISIONS = ("f32", "bf16", "bf16_f32acc")

#: Shared memory a Hopper block may use (227 KB of the SM's 256 KB).
SMEM_LIMIT_BYTES = 232_448

#: Twins per CUDA block.  Each twin's arithmetic is independent, so this
#: does not change results; 8 gives the 1024-twin request 128 blocks on
#: the H100's 132 SMs (64, the JAX batch tile, would fill only 16).
ROWS_PER_BLOCK = 8

#: Layers the kernels' argument structs hold (K1_MAX_LAYERS and
#: K2_MAX_LAYERS in the sources).
MAX_LAYERS = 8

#: Launches of the CUDA kernel in this process (one per kernel launch).
LAUNCHES = 0


def resolve_precision(precision: str | None,
                      what: str = "the fused kernel") -> str:
    """``None`` or ``"f32"``; the bf16 policies of ``what`` are not ported
    yet."""
    if precision is None or precision == "f32":
        return "f32"
    if precision in PRECISIONS:
        raise NotImplementedError(
            f"precision={precision!r}: the bf16 policies of {what} are not "
            f"ported yet (ROADMAP.md, queue 1 item 7); use 'f32'")
    raise ValueError(
        f"unknown precision {precision!r}; have {list(PRECISIONS)}")


def _require_float(name: str, x: torch.Tensor) -> None:
    """A non-floating input raises here, naming the input."""
    if not torch.is_floating_point(x):
        raise ValueError(
            f"fused_node_rollout: {name} has non-floating dtype {x.dtype}; "
            f"the precision='f32' policy stores float32 — cast {name} to a "
            f"floating dtype first")


def smem_bytes(sizes: Sequence[int], rows: int = ROWS_PER_BLOCK) -> int:
    """Dynamic shared memory of one K1 block for MLP layer widths
    ``sizes`` (in_0, ..., out_{L-1}): the weights and biases, plus per
    twin the state, the RK4 sum, the stage output, the MLP input and two
    hidden buffers, activation rows padded to an odd stride."""
    params = sum(a * b + b for a, b in zip(sizes[:-1], sizes[1:]))
    hidden = max(sizes[1:-1], default=0)
    hstride = (hidden | 1) if hidden else 0
    D = sizes[-1]
    return 4 * (params + rows * (3 * D + (sizes[0] | 1) + 2 * hstride))


def check_smem_fit(sizes: Sequence[int], rows: int = ROWS_PER_BLOCK) -> int:
    """Raise a ``ValueError`` when one block's working set exceeds the
    227 KB a Hopper block may use; returns the bytes otherwise."""
    need = smem_bytes(sizes, rows)
    if need > SMEM_LIMIT_BYTES:
        raise ValueError(
            f"fused kernel: MLP {tuple(sizes)} needs {need:,} B of shared "
            f"memory per block ({rows} twins), over the 227 KB "
            f"({SMEM_LIMIT_BYTES:,} B) per-block limit of sm_90; the "
            f"weights must stay resident, so this width needs a cluster or "
            f"a split across blocks")
    return need


def pad_fleet_to_tile(y0s: torch.Tensor, uh: torch.Tensor, batch_tile: int):
    """Pad the fleet axis up to a multiple of the batch tile.

    Padded rows replicate the last twin (in-distribution values, no NaN
    risk) and per-twin drive slabs (``uh.ndim == 3``) are replicated
    alongside; the caller slices the result back to the real fleet.
    Returns ``(y0s_padded, uh_padded, bt, B)`` with ``B`` the original
    fleet size.
    """
    B = y0s.shape[0]
    bt = min(batch_tile, B)
    pad = (-B) % bt
    if pad:
        y0s = torch.cat([y0s, y0s[-1:].expand(pad, *y0s.shape[1:])])
        if uh.ndim == 3:
            uh = torch.cat([uh, uh[-1:].expand(pad, *uh.shape[1:])])
    return y0s, uh, bt, B


def drive_window(u_half: torch.Tensor, start_step: int,
                 num_steps: int) -> torch.Tensor:
    """Slice a pre-sampled half-step drive to a resume window: rows
    ``[2*start_step, 2*(start_step + num_steps)]`` inclusive of the
    (2T+1, Du) shared or (B, 2T+1, Du) per-twin drive."""
    axis = 1 if u_half.ndim == 3 else 0
    lo, hi = 2 * start_step, 2 * (start_step + num_steps) + 1
    if not (0 <= lo < hi <= u_half.shape[axis]):
        raise ValueError(
            f"drive_window: steps [{start_step}, {start_step + num_steps})"
            f" fall outside the (2T+1)={u_half.shape[axis]} half-step grid")
    return u_half[:, lo:hi] if axis == 1 else u_half[lo:hi]


def _launch(y0, u_half, weights, biases, dt, per_twin, T, du,
            sizes, smem):
    """Launch K1 on the current stream; returns (T+1, B, D) float32."""
    global LAUNCHES
    from repro_torch.kernels import _build
    fn = _build.load("fused_ode_mlp").k1_fused_node_rollout_f32
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 5
                   + [ctypes.c_longlong] + [ctypes.c_float] * 3
                   + [ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    B, D = y0.shape
    L = len(weights)
    out = torch.empty((T + 1, B, D), dtype=torch.float32, device=y0.device)
    w_ptrs = (ctypes.c_void_p * L)(*[w.data_ptr() for w in weights])
    b_ptrs = (ctypes.c_void_p * L)(*[b.data_ptr() for b in biases])
    c_sizes = (ctypes.c_int * (L + 1))(*sizes)
    u_ptr = u_half.data_ptr() if du > 0 else None
    u_twin_stride = (2 * T + 1) * du if per_twin else 0
    dt64 = float(dt)
    with torch.cuda.device(y0.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(y0.data_ptr(), u_ptr, out.data_ptr(),
                 ctypes.addressof(w_ptrs), ctypes.addressof(b_ptrs),
                 ctypes.addressof(c_sizes), L, B, T, D, du, u_twin_stride,
                 dt64, dt64 / 2, dt64 / 6, ROWS_PER_BLOCK, smem, stream)
    if err != 0:
        raise RuntimeError(
            f"fused_node_rollout: CUDA kernel launch failed with "
            f"cudaError_t {err} (B={B}, T={T}, sizes={tuple(sizes)}, "
            f"smem={smem} B)")
    LAUNCHES += 1
    return out


def fused_node_rollout(
    y0: torch.Tensor,                 # (B, D) float
    u_half: torch.Tensor,             # (2T+1, Du) shared or (B, 2T+1, Du)
    weights: Sequence[torch.Tensor],
    biases: Sequence[torch.Tensor],
    dt: float,
    *,
    batch_tile: int = 64,
    precision: str | None = None,
) -> torch.Tensor:
    """Full-trajectory RK4 solve; returns (T+1, B, D) float32, row 0 = y0.

    ``u_half`` is the drive sampled at RK4 half-steps: (2T+1, Du) shared
    by the whole fleet, or (B, 2T+1, Du) with one stimulus per twin; Du
    may be 0 (autonomous).  B must divide by ``batch_tile``
    (:func:`pad_fleet_to_tile` pads a fleet up to it).  Floating inputs
    are cast to float32; a non-floating input raises a ``ValueError``
    naming it.  CPU tensors take the plain version, CUDA tensors the
    kernel; any other placement raises.
    """
    resolve_precision(precision)
    _require_float("y0", y0)
    _require_float("u_half", u_half)
    for li, (w, b) in enumerate(zip(weights, biases)):
        _require_float(f"weights[{li}]", w)
        _require_float(f"biases[{li}]", b)
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
        raise ValueError("fused_node_rollout: empty fleet (y0 has 0 rows)")
    bt = min(batch_tile, B)
    if B % bt:
        raise ValueError(f"batch {B} not divisible by tile {bt}")
    sizes = [weights[0].shape[0]] + [w.shape[1] for w in weights]
    if sizes[0] != du + D or sizes[-1] != D:
        raise ValueError(
            f"fused_node_rollout: MLP {tuple(sizes)} does not map "
            f"[u (Du={du}), y (D={D})] to dy/dt (D={D})")
    smem = check_smem_fit(sizes)

    L = len(weights)
    device, (y0, u_half, *wb) = placed_f32(
        "fused_node_rollout", [y0, u_half, *weights, *biases], L)
    weights, biases = wb[:L], wb[L:]
    if device.type == "cpu":
        return ref.fused_node_rollout_ref(y0, u_half, weights, biases,
                                          float(dt))
    return _launch(y0, u_half, weights, biases, dt, per_twin, T, du, sizes,
                   smem)


def placed_f32(caller: str, tensors: Sequence[torch.Tensor],
               num_layers: int):
    """The one device all ``tensors`` lie on, and the tensors as
    contiguous float32.  The CPU (plain versions) and CUDA (kernels) are
    accepted; inputs on several devices, on any other device, or an MLP
    deeper than the kernels' argument struct on CUDA raise."""
    devices = {x.device for x in tensors}
    if len(devices) != 1:
        raise ValueError(
            f"{caller}: inputs lie on several devices "
            f"{sorted(str(d) for d in devices)}; put them on one")
    device = devices.pop()
    if device.type not in ("cpu", "cuda"):
        raise ValueError(
            f"{caller}: tensors on {device} — the kernel runs on CUDA and "
            f"its plain version on the CPU")
    if device.type == "cuda" and num_layers > MAX_LAYERS:
        raise ValueError(
            f"{caller}: {num_layers} layers, the kernel takes at most "
            f"{MAX_LAYERS}")
    return device, [x.to(torch.float32).contiguous() for x in tensors]
