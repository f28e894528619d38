"""Anti-diagonal wavefront soft-DTW, forward and backward (port of
``repro/kernels/softdtw.py``).

:func:`softdtw_wavefront` is K5 (replaces ``softdtw_pallas``): the
accumulated (soft-)DTW cost of each pair of a batch, or hard DTW with
``hard=True``, and with ``return_r=True`` the accumulated-cost matrix R
that the backward needs.  :func:`softdtw_wavefront_bwd` is K6 (replaces
``softdtw_bwd_pallas``): the closed-form E-matrix dSDTW/dD of Cuturi &
Blondel 2017 by the reverse wavefront.  Both run in one launch each of
the hand-written Hopper kernels in ``csrc/softdtw.cu``, one block per
series pair walking all n+m-1 diagonals; the kernels' design, and what
bounds them, are in the source's header.

Layout: the costs arrive diagonal-major, ``dd[b, k, i] = D[b, i, k-i]``,
of shape (B, n+m-1, n), BIG where k-i falls outside [0, m)
(:func:`repro_torch.kernels.ref.diag_layout`); R and E come back in the
same layout.  Unlike the JAX package's, the layout is not padded to a
multiple of a k-chunk: the TPU kernel's chunk grid (``_sdtw_chunk``) only
kept long series inside VMEM, and here one block owns the whole sweep.

Device rule: the plain versions
:func:`repro_torch.kernels.ref.softdtw_wavefront_ref` and
:func:`~repro_torch.kernels.ref.softdtw_wavefront_bwd_ref` run only for
CPU tensors.  CUDA tensors launch the kernels or raise.  Float32 only:
the bf16 cost slab of the JAX package is not ported.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import ref

#: Rows of one pair the kernels hold (4 per thread, 1024 threads).
MAX_ROWS = 4096

#: K5 launches in this process (forward, soft or hard).
LAUNCHES = 0
#: K6 launches in this process (E-matrix backward).
BWD_LAUNCHES = 0


def _check(caller: str, n: int, m: int, gamma: float,
           **slabs: torch.Tensor):
    """Validate gamma and the diagonal-layout operands; returns their
    device."""
    if n < 1 or m < 1:
        raise ValueError(f"{caller}: n={n}, m={m} must both be >= 1")
    if not gamma > 0:
        raise ValueError(f"{caller}: gamma={gamma} must be > 0")
    want = None
    for name, x in slabs.items():
        if x.ndim != 3 or x.shape[1:] != (n + m - 1, n) or x.shape[0] < 1:
            raise ValueError(
                f"{caller}: {name} has shape {tuple(x.shape)}, the diagonal "
                f"layout of {n} x {m} costs is (B >= 1, n+m-1 = "
                f"{n + m - 1}, n = {n})")
        if x.dtype != torch.float32:
            raise ValueError(
                f"{caller}: {name} has dtype {x.dtype}; the kernels take "
                f"float32 (the bf16 cost slab is not ported)")
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
    if device.type == "cuda" and n > MAX_ROWS:
        raise ValueError(
            f"{caller}: series of n={n} rows; the kernel holds at most "
            f"{MAX_ROWS} rows per pair (4 per thread of a 1024-thread "
            f"block) — put the longer series second (m is unbounded)")
    return device


def _stream(device):
    return torch.cuda.current_stream(device).cuda_stream


def softdtw_wavefront(dd: torch.Tensor, n: int, m: int, *,
                      gamma: float = 1.0, hard: bool = False,
                      return_r: bool = False):
    """Batched accumulated (soft-)DTW from diagonal-layout costs -> (B,)
    float32; with ``return_r`` also R, (B, n+m-1, n) float32 in the same
    layout.  ``gamma`` is ignored when ``hard``."""
    global LAUNCHES
    gamma = float(gamma)
    device = _check("softdtw_wavefront", n, m, gamma, dd=dd)
    if device.type == "cpu":
        return ref.softdtw_wavefront_ref(dd, n, m, gamma=gamma, hard=hard,
                                         return_r=return_r)
    from repro_torch.kernels import _build
    fn = _build.load("softdtw").k5_softdtw_f32
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 3
                   + [ctypes.c_float] * 2 + [ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    B = dd.shape[0]
    out = torch.empty((B,), dtype=torch.float32, device=device)
    rd = torch.empty_like(dd) if return_r else None
    with torch.cuda.device(device):
        err = fn(dd.data_ptr(), out.data_ptr(),
                 rd.data_ptr() if return_r else None, B, n, m, gamma,
                 1.0 / gamma, int(bool(hard)), _stream(device))
    if err != 0:
        raise RuntimeError(
            f"softdtw_wavefront: CUDA kernel launch failed with cudaError_t "
            f"{err} (B={B}, n={n}, m={m})")
    LAUNCHES += 1
    return (out, rd) if return_r else out


def softdtw_wavefront_bwd(dd: torch.Tensor, rd: torch.Tensor, n: int, m: int,
                          *, gamma: float = 1.0) -> torch.Tensor:
    """The E-matrix dSDTW/dD, (B, n+m-1, n) float32 in the diagonal layout,
    from the costs ``dd`` and the forward's R ``rd`` (same layout)."""
    global BWD_LAUNCHES
    gamma = float(gamma)
    device = _check("softdtw_wavefront_bwd", n, m, gamma, dd=dd, rd=rd)
    if device.type == "cpu":
        return ref.softdtw_wavefront_bwd_ref(dd, rd, n, m, gamma=gamma)
    from repro_torch.kernels import _build
    fn = _build.load("softdtw").k6_softdtw_bwd_f32
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 3
                   + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    B = dd.shape[0]
    e_dd = torch.empty_like(dd)
    with torch.cuda.device(device):
        err = fn(dd.data_ptr(), rd.data_ptr(), e_dd.data_ptr(), B, n, m,
                 1.0 / gamma, _stream(device))
    if err != 0:
        raise RuntimeError(
            f"softdtw_wavefront_bwd: CUDA kernel launch failed with "
            f"cudaError_t {err} (B={B}, n={n}, m={m})")
    BWD_LAUNCHES += 1
    return e_dd
