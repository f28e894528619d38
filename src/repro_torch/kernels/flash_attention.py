"""Causal GQA flash attention (port of ``repro/kernels/legacy/flash_attention.py``).

:func:`flash_attention` is K8 and replaces
``src/repro/kernels/legacy/flash_attention.py:65 flash_attention_pallas``:
softmax(q k^T * scale, causal) v for every query head, its kv head being
``h // (H / Hkv)``, in one launch of the hand-written Hopper kernel
``csrc/flash_attention.cu``.  q and k have head dim d, v and the output
dv: d = dv for GQA, and (d, dv) = (kv_lora + rope_dim, kv_lora) for
DeepSeek-V2's absorbed MLA.  One block per (q tile, head, batch) walks
the kv tiles up to the diagonal and skips the rest, with the running
max, denominator and accumulator in float32 registers.  bfloat16 inputs
go to the tensor-core kernels (``mma.sync`` on bf16 tiles that
``cp.async`` double-buffers; P split into bf16 hi + lo for the P.V
product; at (576, 512) a layout of its own, with Q read from shared
memory and dv split between two warpgroups); float32 inputs to the
CUDA-core kernel.  The kernels' design, and what bounds them, are in the
source's header.  Against its plain version
(:func:`repro_torch.kernels.ref.flash_attention_ref`, dense causal
softmax in float32) it agrees within 2e-5 of the peak |out| in float32
and 2e-2 in bfloat16, the tolerances of the JAX package's own test.

Device rule: the plain version runs only for CPU tensors; CUDA tensors
launch the kernel or raise.  Inputs are float32 or bfloat16 with a
contiguous last dimension, (d, dv) one of :data:`PAIRS`; any strides of
the other dimensions are read in place (the model hands in its (B, S, H,
d) activations transposed, without a copy), and the output is laid out
as q is, with dv columns.  The bf16 kernels copy 16 bytes at a time, so
a bf16 input whose address or (batch, head, row) strides are not
multiples of 16 bytes is copied to a fresh contiguous tensor first (the
model's activations never are).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import ref

#: The (d, dv) pairs the kernel is compiled for: every GQA config's d = dv,
#: and DeepSeek-V2's absorbed MLA at full width (576, 512) and in the smoke
#: configs (48, 32).
PAIRS = ((16, 16), (32, 32), (64, 64), (128, 128), (48, 32), (576, 512))
#: Launches of the CUDA kernel in this process (one per kernel launch).
LAUNCHES = 0

_DTYPES = (torch.float32, torch.bfloat16)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.ndim != 4:
            raise ValueError(f"flash_attention: {name} has shape "
                             f"{tuple(t.shape)}; want 4-D (B, heads, S, d)")
        if t.dtype not in _DTYPES:
            raise ValueError(f"flash_attention: {name} has dtype {t.dtype}; "
                             f"the kernel takes float32 or bfloat16")
    b, h, s, d = q.shape
    hkv = k.shape[1]
    if (k.shape != (b, hkv, s, d) or v.shape[:3] != k.shape[:3] or hkv < 1
            or h % hkv):
        raise ValueError(
            f"flash_attention: q {tuple(q.shape)}, k {tuple(k.shape)}, v "
            f"{tuple(v.shape)}; want q (B, H, S, d), k (B, Hkv, S, d) and v "
            f"(B, Hkv, S, dv) with Hkv dividing H")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_attention: dtypes differ ({q.dtype}, "
                         f"{k.dtype}, {v.dtype})")
    if k.device != q.device or v.device != q.device:
        raise ValueError(f"flash_attention: devices differ ({q.device}, "
                         f"{k.device}, {v.device})")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"flash_attention: tensors on {q.device} — the "
                         f"kernel runs on CUDA and its plain version on "
                         f"the CPU")


def check_pair(d: int, dv: int) -> None:
    """Raise unless the kernel is compiled for head dims (d, dv)."""
    if (d, dv) not in PAIRS:
        raise ValueError(
            f"flash_attention: (d, dv) = {(d, dv)}; the kernel is compiled "
            f"for {PAIRS} (other pairs: ROADMAP.md, queue 2 A5)")


def _aligned16(t: torch.Tensor) -> bool:
    """Whether the bf16 kernel's 16-byte copies can read ``t`` in place."""
    step = 16 // t.element_size()
    return t.data_ptr() % 16 == 0 and all(t.stride(i) % step == 0
                                          for i in range(3))


def _out_like(q: torch.Tensor, dv: int) -> torch.Tensor:
    """An empty (B, H, S, dv) output laid out as q is: its (batch, head,
    row) dimensions in the order of q's strides, dv contiguous."""
    order = sorted(range(3), key=lambda i: -q.stride(i))
    out = torch.empty([q.shape[i] for i in order] + [dv], dtype=q.dtype,
                      device=q.device)
    return out.permute(*[order.index(i) for i in range(3)], 3)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    scale: float | None = None) -> torch.Tensor:
    """Causal GQA attention: q (B, H, S, d), k (B, Hkv, S, d) and v (B,
    Hkv, S, dv) with Hkv | H -> (B, H, S, dv) in q's dtype and layout.
    ``scale`` defaults to d ** -0.5."""
    global LAUNCHES
    _check(q, k, v)
    b, h, s, d = q.shape
    dv = v.shape[-1]
    scale = float(scale) if scale is not None else d ** -0.5
    if q.device.type == "cpu":
        return ref.flash_attention_ref(q, k, v, scale=scale)
    check_pair(d, dv)
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("flash_attention: the last dimension of q, k and v "
                         "must be contiguous")
    if q.dtype == torch.bfloat16:
        q, k, v = (t if _aligned16(t) else t.clone(
            memory_format=torch.contiguous_format) for t in (q, k, v))
    out = _out_like(q, dv)
    strides = (ctypes.c_longlong * 12)(
        *[t.stride(i) for t in (q, k, v, out) for i in range(3)])
    from repro_torch.kernels import _build
    fn = _build.load("flash_attention").k8_flash_attention
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
                   + [ctypes.c_void_p, ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 int(q.dtype == torch.bfloat16), b, h, k.shape[1], s, d, dv,
                 strides, scale,
                 torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(
            f"flash_attention: CUDA kernel launch failed with cudaError_t "
            f"{err} (B={b}, H={h}, Hkv={k.shape[1]}, S={s}, d={d}, dv={dv}, "
            f"{q.dtype})")
    LAUNCHES += 1
    return out


def hbm_traffic_bytes(b, h, hkv, s, d, dv, dtype_bytes=2) -> dict:
    """The kernel's device-memory contract: Q, K and V read once and O
    written once (the port of the TPU kernel's DMA contract, which counts
    V at d; here V is counted at its own dv, the same where d = dv)."""
    q_io = b * h * s * d * dtype_bytes
    kv_io = b * hkv * s * (d + dv) * dtype_bytes
    o_io = b * h * s * dv * dtype_bytes
    return {"q": q_io, "kv": kv_io, "out": o_io,
            "total": q_io + kv_io + o_io}
