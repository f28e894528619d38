"""Reverse-time fused neural-ODE solve — training on the serving substrate
(port of ``repro/kernels/fused_ode_mlp_bwd.py``).

:func:`fused_node_rollout_bwd` pulls the cotangent of a K1 trajectory
back to ``(dL/dy0, dL/dW, dL/db)`` in one call of the hand-written Hopper
kernel ``csrc/fused_ode_mlp_bwd.cu`` (K2): each block walks its twins'
steps in reverse with the weights resident in shared memory and its
threads' gradient tiles in registers, reading every step's state straight
from the forward trajectory, and a second small kernel sums the blocks'
partial gradients in block order (no atomics, so a repeated call is
bitwise identical).  The launch geometry is K1's
(:func:`repro_torch.kernels.fused_ode_mlp.launch_geometry` with
``backward=True``).
The kernel's design, and what bounds it, are in the source's header.

:class:`FusedNodeRollout` is the differentiable rollout: its forward
launches K1 and keeps the trajectory, its backward launches K2.  The
drive is data and gets a zero cotangent; gradients come back in the
primal dtypes.

Under a bf16 policy (see :mod:`repro_torch.kernels.fused_ode_mlp`) the
trajectory's rows inside a rounding chunk are bf16 roundings of a float32
carry, not the states K1 continued from, so K2's bf16 variant replays
each chunk forward from its start row at the carry dtype, then sweeps it
in reverse, as the JAX kernel's ``fwd_body`` does; the replayed states sit
in shared memory where they fit beside the rest of the block, else in a
float32 scratch the wrapper allocates.  Both
passes of :class:`FusedNodeRollout` use one chunk, :func:`shared_chunk`
(the backward planner's pick, or the caller's), so the forward inside
autograd is bitwise a plain call with that chunk.

Device rule: the plain versions :func:`repro_torch.kernels.ref.fused_node_rollout_bwd_ref`
and :func:`repro_torch.kernels.ref.fused_node_rollout_bf16_bwd_ref` run
only for CPU tensors.  CUDA tensors launch the kernel or raise.
"""
from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from repro_torch.kernels import fused_ode_mlp as _k1
from repro_torch.kernels import ref

#: K2 calls in this process under the f32 policy: one per launch of the
#: reverse-sweep kernel (each is followed by one launch of its fixed-order
#: reduction); the bf16 policies count in ``LAUNCHES_BF16`` and
#: ``LAUNCHES_BF16_F32ACC``.
LAUNCHES = 0
LAUNCHES_BF16 = 0
LAUNCHES_BF16_F32ACC = 0


def plan_bwd_time_chunk(T: int, bt: int, D: int, du: int,
                        per_tile_drive: bool, sizes: Sequence[int],
                        vmem_budget_bytes: int = _k1.DEFAULT_VMEM_BUDGET,
                        time_chunk: int | None = None,
                        precision: str = "f32") -> _k1.ChunkPlan:
    """The JAX backward planner (``repro/kernels/fused_ode_mlp_bwd.py``)
    over the MLP widths ``sizes``: as
    :func:`repro_torch.kernels.fused_ode_mlp.plan_time_chunk`, with the
    weights counted three times (operands at the storage itemsize, two
    float32 accumulators), two (C, bt, D) slabs per chunk (replayed
    states at the carry itemsize, cotangents at the storage one), twice
    the activation slack, and the boundary row, adjoint and dy0 block."""
    sb, ab, cb = _k1._itemsizes(precision)
    u_width = max(du, 1) * (bt if per_tile_drive else 1)
    wsize = _k1._param_count(sizes)
    fixed = (sb * wsize + 2 * 4 * wsize
             + 2 * _k1._rk4_activation_bytes(bt, D, sizes, ab)
             + sb * bt * D + 2 * 4 * bt * D)
    per_step = (cb + sb) * bt * D + 2 * sb * u_width
    C = _k1._plan(T, per_step, fixed, sb * u_width, vmem_budget_bytes,
                  time_chunk, "fused backward: weights + one reverse RK4 step")
    need = fixed + (cb + sb) * C * bt * D + sb * (2 * C + 1) * u_width
    if need > vmem_budget_bytes:
        raise ValueError(
            f"backward time_chunk={C} needs ~{need / 2 ** 20:.1f} MiB VMEM "
            f"(budget {vmem_budget_bytes / 2 ** 20:.1f}); shrink "
            f"time_chunk or batch_tile")
    return _k1.ChunkPlan(C, -(-T // C), need)


def shared_chunk(y0: torch.Tensor, u_half: torch.Tensor,
                 sizes: Sequence[int], batch_tile: int,
                 time_chunk: int | None,
                 precision: str | None) -> int | None:
    """The rounding chunk both passes of the fused VJP use (JAX's
    ``_shared_chunk``): the caller's ``time_chunk``, or the backward
    planner's pick at ``DEFAULT_VMEM_BUDGET``.  Under f32 the chunk changes no bit and is not
    planned (None)."""
    precision = _k1.resolve_precision(precision)
    if precision == "f32" or time_chunk is not None:
        return time_chunk
    B, D = y0.shape
    T = (u_half.shape[1 if u_half.ndim == 3 else 0] - 1) // 2
    du = u_half.shape[-1]
    per_tile = u_half.ndim == 3 and du > 0
    return plan_bwd_time_chunk(T, min(batch_tile, B), D, du, per_tile,
                               sizes, precision=precision).time_chunk


def smem_bytes_bwd(sizes: Sequence[int], twins_per_block: int = 1) -> int:
    """Dynamic shared memory of one K2 block for MLP layer widths
    ``sizes`` (:func:`repro_torch.kernels.fused_ode_mlp.smem_bytes_k2` at
    the time chunk the geometry picks).  Raises a ``ValueError`` when it
    exceeds the 227 KB a Hopper block may use."""
    return _k1.launch_geometry(1, sizes, backward=True,
                               twins_per_block=twins_per_block).smem_bytes


def _launch(traj, u_half, g, weights, biases, dt, per_twin, T, du, sizes,
            geom):
    """Launch K2 on the current stream at ``geom``; returns (dy0, flat
    grads (P,))."""
    global LAUNCHES
    from repro_torch.kernels import _build
    fn = _build.load("fused_ode_mlp_bwd").k2_fused_node_rollout_bwd_f32
    fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 5
                   + [ctypes.c_longlong] + [ctypes.c_float] * 3
                   + [ctypes.c_int] * 3 + [ctypes.c_longlong, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    B, D = traj.shape[1], traj.shape[2]
    L = len(weights)
    P = sum(a * b + b for a, b in zip(sizes[:-1], sizes[1:]))
    dev = traj.device
    dy0 = torch.empty((B, D), dtype=torch.float32, device=dev)
    partial = torch.empty((geom.blocks, P), dtype=torch.float32, device=dev)
    grads = torch.empty((P,), dtype=torch.float32, device=dev)
    w_ptrs = (ctypes.c_void_p * L)(*[w.data_ptr() for w in weights])
    b_ptrs = (ctypes.c_void_p * L)(*[b.data_ptr() for b in biases])
    c_sizes = (ctypes.c_int * (L + 1))(*sizes)
    u_ptr = u_half.data_ptr() if du > 0 else None
    u_twin_stride = (2 * T + 1) * du if per_twin else 0
    dt64 = float(dt)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(traj.data_ptr(), u_ptr, g.data_ptr(), dy0.data_ptr(),
                 partial.data_ptr(), grads.data_ptr(),
                 ctypes.addressof(w_ptrs), ctypes.addressof(b_ptrs),
                 ctypes.addressof(c_sizes), L, B, T, D, du, u_twin_stride,
                 dt64, dt64 / 2, dt64 / 6, geom.twins_per_block,
                 geom.threads, geom.time_chunk, geom.smem_bytes, stream)
    if err != 0:
        raise RuntimeError(
            f"fused_node_rollout_bwd: CUDA kernel launch failed with "
            f"cudaError_t {err} (B={B}, T={T}, sizes={tuple(sizes)}, "
            f"{geom})")
    LAUNCHES += 1
    return dy0, grads


def _split_grads(flat: torch.Tensor, sizes: Sequence[int]):
    """(P,) in the kernel's order dW_0, db_0, dW_1, ... -> (dws, dbs)."""
    dws, dbs, off = [], [], 0
    for a, b in zip(sizes[:-1], sizes[1:]):
        dws.append(flat[off:off + a * b].view(a, b))
        off += a * b
        dbs.append(flat[off:off + b])
        off += b
    return dws, dbs


def fused_node_rollout_bwd(
    traj: torch.Tensor,               # (T+1, B, D) forward trajectory
    u_half: torch.Tensor,             # (2T+1, Du) shared or (B, 2T+1, Du)
    weights: Sequence[torch.Tensor],
    biases: Sequence[torch.Tensor],
    g: torch.Tensor,                  # (T+1, B, D) cotangent of every row
    dt: float,
    *,
    precision: str | None = None,
    time_chunk: int | None = None,
    _force_scratch: bool = False,
) -> tuple:
    """The VJP of the fused rollout; returns ``(dy0, dweights, dbiases)``,
    all float32.

    ``traj`` must be the trajectory the forward produced from these
    weights, drive and ``dt`` (under f32 its rows are the states each
    reverse step starts from); ``g`` is the cotangent of all T+1 rows, row
    0 included.  Any strides are taken (a trainer's cotangent arrives
    sliced and transposed); floating inputs are cast to the policy's
    dtypes.  Under a bf16 ``precision`` the forward must have run with the
    same ``time_chunk`` (required): each chunk is replayed from its start
    row, the cotangent rows 1..T enter as bf16 and row 0 as float32, as in
    the JAX kernel.  CPU tensors take the plain version, CUDA tensors the
    kernel; any other placement raises.  ``_force_scratch`` (bf16 on CUDA,
    for a check) keeps the replayed states in device memory where shared
    memory would hold them.
    """
    precision = _k1.resolve_precision(precision)
    traj, u_half, g, per_twin, T, du, sizes = _bwd_args(
        traj, u_half, weights, biases, g, precision)
    geom = _k1.launch_geometry(traj.shape[1], sizes, backward=True)
    if precision != "f32":
        if time_chunk is None or int(time_chunk) < 1:
            raise ValueError(
                f"fused_node_rollout_bwd: precision={precision!r} needs the "
                f"forward's time_chunk (got {time_chunk!r})")
        return _bwd_bf16(traj, u_half, weights, biases, g, dt, per_twin, T,
                         du, sizes, geom, precision, int(time_chunk),
                         _force_scratch)

    L = len(weights)
    device, (traj, u_half, g, *wb) = _k1.placed_f32(
        "fused_node_rollout_bwd", [traj, u_half, g, *weights, *biases], L)
    weights, biases = wb[:L], wb[L:]
    if device.type == "cpu":
        return ref.fused_node_rollout_bwd_ref(traj, u_half, weights, biases,
                                              g, float(dt))
    dy0, flat = _launch(traj, u_half, g, weights, biases, dt, per_twin, T,
                        du, sizes, geom)
    dws, dbs = _split_grads(flat, sizes)
    return dy0, dws, dbs


def _bwd_bf16(traj, u_half, weights, biases, g, dt, per_twin, T, du, sizes,
              geom, precision: str, C: int, force_scratch: bool = False):
    """K2 under a bf16 policy with rounding chunk ``C``: the plain version
    for CPU tensors, the kernel for CUDA tensors."""
    device, (_, u_half, weights, biases) = _k1.placed_bf16(
        "fused_node_rollout_bwd", traj[0], u_half, weights, biases)
    traj = traj.to(torch.bfloat16).contiguous()
    if device.type == "cpu":
        return ref.fused_node_rollout_bf16_bwd_ref(
            traj, u_half, weights, biases, g, float(dt), precision, C)
    g0 = g[0].to(torch.float32).contiguous()
    gs = g.to(torch.bfloat16).contiguous()
    return _launch_bf16(traj, u_half, gs, g0, weights, biases, dt, per_twin,
                        T, du, sizes, geom, precision, C,
                        _force_scratch=force_scratch)


def _launch_bf16(traj, u_half, gs, g0, weights, biases, dt, per_twin, T, du,
                 sizes, geom, precision: str, C: int, *,
                 _force_scratch: bool = False):
    """Launch K2's bf16 variant on the current stream at ``geom``: the
    bf16 trajectory, drive, weights and cotangent rows, the float32 g0;
    returns (dy0, dweights, dbiases), float32.  A chunk's replayed float32
    states sit in the block's shared memory when ``min(C, T) * round4(D)
    * twins`` floats fit beside the rest of the block, else in a float32
    scratch in device memory; ``_force_scratch`` takes the scratch where
    shared memory would do (for the check that both agree)."""
    global LAUNCHES_BF16, LAUNCHES_BF16_F32ACC
    from repro_torch.kernels import _build
    fn = _build.load("fused_ode_mlp_bwd").k2_fused_node_rollout_bwd_bf16
    fn.argtypes = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 5
                   + [ctypes.c_longlong] + [ctypes.c_float] * 3
                   + [ctypes.c_int] * 6 + [ctypes.c_longlong, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    B, D = traj.shape[1], traj.shape[2]
    L = len(weights)
    P = sum(a * b + b for a, b in zip(sizes[:-1], sizes[1:]))
    dev = traj.device
    dy0 = torch.empty((B, D), dtype=torch.float32, device=dev)
    partial = torch.empty((geom.blocks, P), dtype=torch.float32, device=dev)
    grads = torch.empty((P,), dtype=torch.float32, device=dev)
    # the replayed float32 states of one chunk: in shared memory where they
    # fit, else (min(C, T), B, D) in device memory
    rows = max(1, min(C, T))
    rep_bytes = 4 * rows * _k1._round4(D) * geom.twins_per_block
    rep_smem = (not _force_scratch
                and geom.smem_bytes + rep_bytes <= _k1.SMEM_LIMIT_BYTES)
    smem = geom.smem_bytes + (rep_bytes if rep_smem else 0)
    rep = torch.empty((1,) if rep_smem else (rows, B, D),
                      dtype=torch.float32, device=dev)
    w_ptrs = (ctypes.c_void_p * L)(*[w.data_ptr() for w in weights])
    b_ptrs = (ctypes.c_void_p * L)(*[b.data_ptr() for b in biases])
    c_sizes = (ctypes.c_int * (L + 1))(*sizes)
    u_ptr = u_half.data_ptr() if du > 0 else None
    u_twin_stride = (2 * T + 1) * du if per_twin else 0
    pure = precision == "bf16"
    c2, c1, c6 = ref.rk4_consts(float(dt), pure)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(traj.data_ptr(), u_ptr, gs.data_ptr(), g0.data_ptr(),
                 rep.data_ptr(), dy0.data_ptr(), partial.data_ptr(),
                 grads.data_ptr(), ctypes.addressof(w_ptrs),
                 ctypes.addressof(b_ptrs), ctypes.addressof(c_sizes), L, B,
                 T, D, du, u_twin_stride, c1, c2, c6, int(pure), C,
                 int(rep_smem), geom.twins_per_block, geom.threads,
                 geom.time_chunk, smem, stream)
    if err != 0:
        raise RuntimeError(
            f"fused_node_rollout_bwd: CUDA kernel launch failed with "
            f"cudaError_t {err} (precision={precision!r}, B={B}, T={T}, "
            f"sizes={tuple(sizes)}, {geom})")
    if pure:
        LAUNCHES_BF16 += 1
    else:
        LAUNCHES_BF16_F32ACC += 1
    dws, dbs = _split_grads(grads, sizes)
    return dy0, dws, dbs


def _bwd_args(traj, u_half, weights, biases, g, precision: str = "f32"):
    """Validate a VJP's inputs; returns ``(traj, u_half, g, per_twin, T,
    du, sizes)`` with a zero-width per-twin drive folded to a shared one."""
    for name, x in [("traj", traj), ("u_half", u_half), ("g", g),
                    *[(f"weights[{i}]", w) for i, w in enumerate(weights)],
                    *[(f"biases[{i}]", b) for i, b in enumerate(biases)]]:
        _k1._require_float(name, x, precision)
    if traj.ndim != 3 or tuple(g.shape) != tuple(traj.shape):
        raise ValueError(
            f"fused_node_rollout_bwd: traj {tuple(traj.shape)} and g "
            f"{tuple(g.shape)} must both be (T+1, B, D)")
    T, B, D = traj.shape[0] - 1, traj.shape[1], traj.shape[2]
    per_twin = u_half.ndim == 3
    if per_twin and u_half.shape[0] != B:
        raise ValueError(
            f"per-twin drive batch {u_half.shape[0]} != trajectory batch {B}")
    if per_twin and u_half.shape[-1] == 0:
        per_twin, u_half = False, u_half[0]
    if u_half.shape[1 if per_twin else 0] != 2 * T + 1:
        raise ValueError(
            f"fused_node_rollout_bwd: drive has "
            f"{u_half.shape[1 if per_twin else 0]} half-steps, the "
            f"trajectory's T={T} steps need 2T+1 = {2 * T + 1}")
    du = u_half.shape[-1]
    sizes = [weights[0].shape[0]] + [w.shape[1] for w in weights]
    if sizes[0] != du + D or sizes[-1] != D:
        raise ValueError(
            f"fused_node_rollout_bwd: MLP {tuple(sizes)} does not map "
            f"[u (Du={du}), y (D={D})] to dy/dt (D={D})")
    return traj, u_half, g, per_twin, T, du, sizes


def fused_node_rollout_bwd_at(geom, traj: torch.Tensor,
                              u_half: torch.Tensor,
                              weights: Sequence[torch.Tensor],
                              biases: Sequence[torch.Tensor],
                              g: torch.Tensor, dt: float) -> tuple:
    """K2 on CUDA tensors at an explicit ``geom`` (from
    :func:`repro_torch.kernels.fused_ode_mlp.launch_geometry` with
    ``backward=True``, e.g. ``twins_per_block=1``): for checks that dy0
    does not depend on the launch geometry."""
    traj, u_half, g, per_twin, T, du, sizes = _bwd_args(traj, u_half,
                                                        weights, biases, g)
    L = len(weights)
    device, (traj, u_half, g, *wb) = _k1.placed_f32(
        "fused_node_rollout_bwd_at", [traj, u_half, g, *weights, *biases], L)
    if device.type != "cuda":
        raise ValueError("fused_node_rollout_bwd_at: the kernel runs on CUDA")
    dy0, flat = _launch(traj, u_half, g, wb[:L], wb[L:], dt, per_twin, T,
                        du, sizes, geom)
    dws, dbs = _split_grads(flat, sizes)
    return dy0, dws, dbs


class FusedNodeRollout(torch.autograd.Function):
    """The fused rollout with the fused VJP: forward K1, backward K2.

    ``apply(y0, u_half, dt, batch_tile, precision, time_chunk, *weights,
    *biases)`` returns the (T+1, B, D) trajectory at the policy's storage
    dtype.  The trajectory is the only residual: every state the backward
    starts a step (f32) or a replayed chunk (bf16) from is one of its
    rows.  ``time_chunk`` is the resolved :func:`shared_chunk`."""

    @staticmethod
    def forward(ctx, y0, u_half, dt, batch_tile, precision, time_chunk,
                *params):
        L = len(params) // 2
        traj = _k1.fused_node_rollout(y0, u_half, params[:L], params[L:],
                                      dt, batch_tile=batch_tile,
                                      time_chunk=time_chunk,
                                      precision=precision)
        ctx.save_for_backward(traj, u_half, *params)
        ctx.dt = dt
        ctx.precision = precision
        ctx.time_chunk = time_chunk
        ctx.y0_dtype = y0.dtype
        return traj

    @staticmethod
    def backward(ctx, g):
        traj, u_half, *params = ctx.saved_tensors
        L = len(params) // 2
        dy0, dws, dbs = fused_node_rollout_bwd(
            traj, u_half, params[:L], params[L:], g, ctx.dt,
            precision=ctx.precision, time_chunk=ctx.time_chunk)
        # the drive is data, not a parameter: zero cotangent
        du = torch.zeros_like(u_half) if ctx.needs_input_grad[1] else None
        grads = [d.to(p.dtype) for d, p in zip(dws + dbs, params)]
        return (dy0.to(ctx.y0_dtype), du, None, None, None, None, *grads)


def fused_node_rollout_vjp(y0: torch.Tensor, u_half: torch.Tensor,
                           weights: Sequence[torch.Tensor],
                           biases: Sequence[torch.Tensor], dt: float, *,
                           batch_tile: int = 64,
                           time_chunk: int | None = None,
                           precision: str | None = None) -> torch.Tensor:
    """:func:`repro_torch.kernels.fused_ode_mlp.fused_node_rollout` with
    gradients that never leave the fused substrate: K1 forward, K2
    backward.  Differentiable in ``y0``, ``weights`` and ``biases``; the
    gradients come back at the primal dtypes.  Both passes use
    :func:`shared_chunk`'s rounding chunk, so the forward inside autograd
    is bitwise :func:`fused_node_rollout` with that chunk."""
    precision = _k1.resolve_precision(precision)
    sizes = [weights[0].shape[0]] + [w.shape[1] for w in weights]
    C = shared_chunk(y0, u_half, sizes, batch_tile, time_chunk, precision)
    return FusedNodeRollout.apply(y0, u_half, float(dt), batch_tile,
                                  precision, C, *weights, *biases)
