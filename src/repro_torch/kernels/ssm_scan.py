"""State-resident selective-SSM scan (port of ``repro/kernels/legacy/ssm_scan.py``).

:func:`ssm_scan` is K9 and replaces
``src/repro/kernels/legacy/ssm_scan.py:51 ssm_scan``: Mamba's recurrence
h_t = exp(dt_t A) h_{t-1} + (dt_t x_t) B_t, y_t = <h_t, C_t> over the
whole sequence, in one launch of the hand-written Hopper kernel
``csrc/ssm_scan.cu``.  Each (batch row, channel) is a team of 4 lanes,
each holding N / 4 of its N <= 16 states in registers from the
first step to the last; a block of 64 channels stages chunks of 32 steps
of dt, x, B and C in shared memory by double-buffered cp.async, and y
leaves in whole rows.  The kernel's design, and what bounds it, are in
the source's header.  Each state is computed in the plain version's
order (precise expf, no contracted FMAs), so the final state matches
:func:`repro_torch.kernels.ref.ssm_scan_ref` to the bit where the card's
exp is expf; y sums a lane's states in order and the team in a fixed
butterfly.  The stated tolerance is 1e-5 of the peak of y and of the
final state.

Device rule: the plain version runs only for CPU tensors; CUDA tensors
launch the kernel or raise.  Float32 only, as the TPU kernel.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import ref

#: States per channel the kernel holds in registers.
MAX_STATE = 16

#: Launches of the CUDA kernel in this process (one per kernel launch).
LAUNCHES = 0


def _check(dt, b, c, x, a):
    if dt.ndim != 3 or a.ndim != 2:
        raise ValueError(f"ssm_scan: dt {tuple(dt.shape)}, a "
                         f"{tuple(a.shape)}; want dt (B, S, DI), a (DI, N)")
    bsz, s, di = dt.shape
    n = a.shape[1]
    want = {"dt": (bsz, s, di), "x": (bsz, s, di), "b": (bsz, s, n),
            "c": (bsz, s, n), "a": (di, n)}
    for name, t in (("dt", dt), ("b", b), ("c", c), ("x", x), ("a", a)):
        if tuple(t.shape) != want[name]:
            raise ValueError(f"ssm_scan: {name} has shape {tuple(t.shape)}, "
                             f"want {want[name]}")
        if t.dtype != torch.float32:
            raise ValueError(f"ssm_scan: {name} has dtype {t.dtype}; the "
                             f"scan takes float32")
        if not t.is_contiguous():
            raise ValueError(f"ssm_scan: {name} must be contiguous")
        if t.device != dt.device:
            raise ValueError(f"ssm_scan: {name} on {t.device}, dt on "
                             f"{dt.device}")
    if dt.device.type not in ("cpu", "cuda"):
        raise ValueError(f"ssm_scan: tensors on {dt.device} — the kernel "
                         f"runs on CUDA and its plain version on the CPU")
    return bsz, s, di, n


def ssm_scan(dt: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
             x: torch.Tensor, a: torch.Tensor):
    """Selective scan.  dt, x (B, S, DI); b, c (B, S, N); a (DI, N); all
    float32 and contiguous.  Returns (y (B, S, DI), h_final (B, DI, N))."""
    global LAUNCHES
    bsz, s, di, n = _check(dt, b, c, x, a)
    if dt.device.type == "cpu":
        return ref.ssm_scan_ref(dt, b, c, x, a)
    if n > MAX_STATE:
        raise ValueError(f"ssm_scan: N = {n} states; the kernel holds at "
                         f"most {MAX_STATE} per channel")
    y = torch.empty_like(dt)
    h = torch.empty((bsz, di, n), dtype=torch.float32, device=dt.device)
    from repro_torch.kernels import _build
    fn = _build.load("ssm_scan").k9_ssm_scan_f32
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(dt.device):
        err = fn(dt.data_ptr(), b.data_ptr(), c.data_ptr(), x.data_ptr(),
                 a.data_ptr(), y.data_ptr(), h.data_ptr(), bsz, s, di, n,
                 torch.cuda.current_stream(dt.device).cuda_stream)
    if err != 0:
        raise RuntimeError(
            f"ssm_scan: CUDA kernel launch failed with cudaError_t {err} "
            f"(B={bsz}, S={s}, DI={di}, N={n})")
    LAUNCHES += 1
    return y, h
