"""Anti-diagonal wavefront soft-DTW, forward and backward (port of
``repro/kernels/softdtw.py``).

:func:`softdtw_rowmajor` is K5 (replaces ``softdtw_pallas``): the
accumulated (soft-)DTW cost of each pair of a batch, or hard DTW with
``hard=True``, and with ``return_r=True`` the accumulated-cost matrix R
that the backward needs.  :func:`softdtw_rowmajor_bwd` is K6 (replaces
``softdtw_bwd_pallas``): the closed-form E-matrix dSDTW/dD of Cuturi &
Blondel 2017 by the reverse wavefront.  Both run in one launch each of
the hand-written Hopper kernels in ``csrc/softdtw.cu``, one block per
series pair, one thread per row; the kernels' design, and what bounds
them, are in the source's header.

Layout: the kernels read the costs D, and K6 also R, in the caller's
row-major (B, n, m) float32 layout, and write R and E in it.  The TPU
kernel's diagonal-major slab ``dd[b, k, i] = D[b, i, k-i]`` (of shape
(B, n+m-1, n), BIG where k-i falls outside [0, m);
:func:`repro_torch.kernels.ref.diag_layout`) only made each wavefront
row one contiguous vector row of VMEM; on the card a thread that owns a
row reads it contiguously as the wavefront moves, so the slab is not
built.  :func:`softdtw_wavefront` and :func:`softdtw_wavefront_bwd` keep
the slab's signature, as the counterparts of ``softdtw_pallas`` /
``softdtw_bwd_pallas`` that the parity tests call: on CUDA they gather
the matrix out of the slab, run the row-major kernel and lay its result
out again (the slab's in-matrix entries only; no padding to a k-chunk).

Device rule: the plain versions (``ref.softdtw_rowmajor_ref``,
``ref.softdtw_rowmajor_bwd_ref`` and the diagonal-layout
``ref.softdtw_wavefront_ref`` / ``ref.softdtw_wavefront_bwd_ref``) run
only for CPU tensors.  CUDA tensors launch the kernels or raise.

Costs may be float32 or bfloat16 (the JAX package's bf16 cost slab under
the ``"bf16"`` and ``"bf16_f32acc"`` policies, which halves the only
O(n m) operand): the kernels' bfloat16 instantiations read each cost
once and widen it to float32; R, E and the answer are float32 either
way.  A padded cell (the layout's BIG, 1e10) rounds to 9.9992e9 in bf16,
still above the half-BIG threshold that marks it invalid.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import ref

#: Rows of one pair the kernels take (bands of at most 256 rows, one a
#: thread, run one after another).
MAX_ROWS = 4096
#: Warps of a block: a band of 32 x warps rows is one sweep.
MAX_WARPS = 8

#: K5 launches in this process (forward, soft or hard) on float32 costs;
#: ``LAUNCHES_BF16`` on bfloat16 costs.
LAUNCHES = 0
LAUNCHES_BF16 = 0
#: K6 launches in this process (E-matrix backward) on float32 costs;
#: ``BWD_LAUNCHES_BF16`` on bfloat16 costs.
BWD_LAUNCHES = 0
BWD_LAUNCHES_BF16 = 0

#: Dtypes the kernels take for the costs (R is always float32).
COST_DTYPES = (torch.float32, torch.bfloat16)


def band_warps(n: int) -> int:
    """Warps a block for n rows: one row a thread, a single band wherever
    n <= 256 (the other counts timed slower, PERF.md)."""
    return min(MAX_WARPS, -(-n // 32))


def _device_of(caller: str, gamma: float, tensors: dict):
    """Check dtype, contiguity, shared shape and device of the operands and
    gamma; returns their device.  The costs (``D``, ``dd``) may be float32
    or bfloat16, every other operand is float32."""
    if not gamma > 0:
        raise ValueError(f"{caller}: gamma={gamma} must be > 0")
    want = None
    for name, x in tensors.items():
        cost = name in ("D", "dd")
        if x.dtype not in (COST_DTYPES if cost else (torch.float32,)):
            raise ValueError(
                f"{caller}: {name} has dtype {x.dtype}; the kernels take "
                + ("float32 or bfloat16 costs" if cost else "float32"))
        if not x.is_contiguous():
            raise ValueError(f"{caller}: {name} must be contiguous")
        if want is None:
            want = x
        elif x.device != want.device or x.shape != want.shape:
            raise ValueError(
                f"{caller}: operands differ in shape or device "
                f"({tuple(want.shape)} on {want.device}, {tuple(x.shape)} "
                f"on {x.device})")
    device = want.device
    if device.type not in ("cpu", "cuda"):
        raise ValueError(
            f"{caller}: tensors on {device} — the kernel runs on CUDA and "
            f"its plain version on the CPU")
    return device


def _check_rows(caller: str, n: int, device):
    if device.type == "cuda" and n > MAX_ROWS:
        raise ValueError(
            f"{caller}: series of n={n} rows; the kernel takes at most "
            f"{MAX_ROWS} rows per pair — put the longer series second (m is "
            f"unbounded)")


def _check(caller: str, n: int, m: int, gamma: float,
           **slabs: torch.Tensor):
    """Validate gamma and the diagonal-layout operands; returns their
    device."""
    if n < 1 or m < 1:
        raise ValueError(f"{caller}: n={n}, m={m} must both be >= 1")
    for name, x in slabs.items():
        if x.ndim != 3 or x.shape[1:] != (n + m - 1, n) or x.shape[0] < 1:
            raise ValueError(
                f"{caller}: {name} has shape {tuple(x.shape)}, the diagonal "
                f"layout of {n} x {m} costs is (B >= 1, n+m-1 = "
                f"{n + m - 1}, n = {n})")
    device = _device_of(caller, gamma, slabs)
    _check_rows(caller, n, device)
    return device


def _check_matrices(caller: str, gamma: float, **mats: torch.Tensor):
    """Validate gamma and the row-major (B, n, m) operands; returns their
    device."""
    for name, x in mats.items():
        if x.ndim != 3 or min(x.shape) < 1:
            raise ValueError(
                f"{caller}: {name} has shape {tuple(x.shape)}; the kernels "
                f"take (B, n, m) cost matrices, each size >= 1")
    device = _device_of(caller, gamma, mats)
    _check_rows(caller, next(iter(mats.values())).shape[1], device)
    return device


def _geometry(n: int, m: int, B: int, device):
    """(warps, edge buffer or None) of a launch: more than one band of
    32 x warps rows hands its last row on through a (B, 2, m) buffer."""
    warps = band_warps(n)
    edge = (torch.empty((B, 2, m), dtype=torch.float32, device=device)
            if n > 32 * warps else None)
    return warps, edge


def _stream(device):
    return torch.cuda.current_stream(device).cuda_stream


def _raise(caller: str, err: int, B: int, n: int, m: int):
    if err != 0:
        raise RuntimeError(
            f"{caller}: CUDA kernel launch failed with cudaError_t {err} "
            f"(B={B}, n={n}, m={m})")


def softdtw_rowmajor(D: torch.Tensor, *, gamma: float = 1.0,
                     hard: bool = False, return_r: bool = False):
    """Batched accumulated (soft-)DTW of (B, n, m) float32 or bfloat16
    costs -> (B,) float32; with ``return_r`` also R, (B, n, m) float32.
    ``gamma`` is ignored when ``hard``."""
    global LAUNCHES, LAUNCHES_BF16
    gamma = float(gamma)
    device = _check_matrices("softdtw_rowmajor", gamma, D=D)
    bf16 = D.dtype == torch.bfloat16
    if device.type == "cpu":
        return ref.softdtw_rowmajor_ref(D.to(torch.float32), gamma=gamma,
                                        hard=hard, return_r=return_r)
    from repro_torch.kernels import _build
    lib = _build.load("softdtw")
    fn = lib.k5_softdtw_bf16 if bf16 else lib.k5_softdtw_f32
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 3
                   + [ctypes.c_float] * 2 + [ctypes.c_int] * 2
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    B, n, m = D.shape
    warps, edge = _geometry(n, m, B, device)
    out = torch.empty((B,), dtype=torch.float32, device=device)
    R = torch.empty(D.shape, dtype=torch.float32,
                    device=device) if return_r else None
    with torch.cuda.device(device):
        err = fn(D.data_ptr(), out.data_ptr(),
                 R.data_ptr() if return_r else None,
                 None if edge is None else edge.data_ptr(), B, n, m, gamma,
                 1.0 / gamma, int(bool(hard)), warps, _stream(device))
    _raise("softdtw_rowmajor", err, B, n, m)
    if bf16:
        LAUNCHES_BF16 += 1
    else:
        LAUNCHES += 1
    return (out, R) if return_r else out


def softdtw_rowmajor_bwd(D: torch.Tensor, R: torch.Tensor, *,
                         gamma: float = 1.0) -> torch.Tensor:
    """The E-matrix dSDTW/dD, (B, n, m) float32, from the costs ``D``
    (float32 or bfloat16) and the forward's float32 R, both (B, n, m)."""
    global BWD_LAUNCHES, BWD_LAUNCHES_BF16
    gamma = float(gamma)
    device = _check_matrices("softdtw_rowmajor_bwd", gamma, D=D, R=R)
    bf16 = D.dtype == torch.bfloat16
    if device.type == "cpu":
        return ref.softdtw_rowmajor_bwd_ref(D.to(torch.float32), R,
                                            gamma=gamma)
    from repro_torch.kernels import _build
    lib = _build.load("softdtw")
    fn = lib.k6_softdtw_bwd_bf16 if bf16 else lib.k6_softdtw_bwd_f32
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 3
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    B, n, m = D.shape
    warps, edge = _geometry(n, m, B, device)
    E = torch.empty_like(R)
    with torch.cuda.device(device):
        err = fn(D.data_ptr(), R.data_ptr(), E.data_ptr(),
                 None if edge is None else edge.data_ptr(), B, n, m,
                 1.0 / gamma, warps, _stream(device))
    _raise("softdtw_rowmajor_bwd", err, B, n, m)
    if bf16:
        BWD_LAUNCHES_BF16 += 1
    else:
        BWD_LAUNCHES += 1
    return E


def softdtw_wavefront(dd: torch.Tensor, n: int, m: int, *,
                      gamma: float = 1.0, hard: bool = False,
                      return_r: bool = False):
    """Batched accumulated (soft-)DTW from diagonal-layout costs -> (B,)
    float32; with ``return_r`` also R, (B, n+m-1, n) float32 in the same
    layout.  ``gamma`` is ignored when ``hard``."""
    gamma = float(gamma)
    device = _check("softdtw_wavefront", n, m, gamma, dd=dd)
    if device.type == "cpu":
        return ref.softdtw_wavefront_ref(dd.to(torch.float32), n, m,
                                         gamma=gamma, hard=hard,
                                         return_r=return_r)
    got = softdtw_rowmajor(ref.undiag_layout(dd, n, m), gamma=gamma,
                           hard=hard, return_r=return_r)
    if not return_r:
        return got
    return got[0], ref.diag_layout(got[1]).contiguous()


def softdtw_wavefront_bwd(dd: torch.Tensor, rd: torch.Tensor, n: int, m: int,
                          *, gamma: float = 1.0) -> torch.Tensor:
    """The E-matrix dSDTW/dD, (B, n+m-1, n) float32 in the diagonal layout,
    from the costs ``dd`` and the forward's R ``rd`` (same layout)."""
    gamma = float(gamma)
    device = _check("softdtw_wavefront_bwd", n, m, gamma, dd=dd, rd=rd)
    if device.type == "cpu":
        return ref.softdtw_wavefront_bwd_ref(dd.to(torch.float32), rd, n,
                                             m, gamma=gamma)
    E = softdtw_rowmajor_bwd(ref.undiag_layout(dd, n, m),
                             ref.undiag_layout(rd, n, m), gamma=gamma)
    return ref.diag_layout(E, fill=0.0).contiguous()
