"""Weights-stationary fused analogue neural-ODE solve (port of ``repro/kernels/fused_analogue.py``).

:func:`fused_analogue_rollout` runs the whole RK4 trajectory of a fleet
through memristor crossbar pairs on the hand-written Hopper kernel
``csrc/fused_analogue.cu`` (K4), the crossbar read semantics of
:func:`repro_torch.core.analogue.analogue_mlp_apply` inside the kernel:

* each layer is a differential pair (G+, G-) of (K+1, N) arrays, float32
  conductances or uint8 6-bit level indices, the bias as the last row,
  with a per-layer ``1/scale`` and an optional clamp;
* noise-free, each pair is combined once per block into effective
  weights, and every evaluation is K1's (``csrc/fused_mlp_eval.cuh``) at
  K1's launch geometry (:func:`launch_geometry`);
* with ``read_noise > 0`` every evaluation reads a fresh noisy pair drawn
  from the counter stream (K3), salted by (global step, RK4 stage,
  layer, pair).  The noise is the same for every twin, so a pre-pass
  kernel draws each evaluation's pair once for the fleet
  (``NOISE_LAUNCHES``; plain version
  :func:`repro_torch.kernels.ref.fused_analogue_noisy_pairs_ref`) and
  the rollout streams it into shared memory one evaluation ahead: two
  launches per noisy rollout of up to :func:`noise_chunk_steps` steps.
  A noisy rollout replays bitwise from ``noise_seed`` and, through
  ``step_offset``, a split rollout replays the unsplit one;
* device faults in-kernel: stuck cells at their global ids (bitwise the
  program-time masks of :mod:`repro_torch.core.faults`) and live drift;
* widths whose pairs do not fit one block (the paper's 6->512->512->6
  scorecard twin) run K4w (``csrc/fused_wide.cu``), a thread-block
  cluster whose CTAs split every layer, at the cluster launch of
  :func:`repro_torch.kernels.fused_ode_mlp.wide_geometry`; under read
  noise it streams the same pre-pass's pairs, chunk by chunk.

The solve is inference-only (train digitally, deploy analogue) and always
float32.  Device rule: the plain version
:func:`repro_torch.kernels.ref.fused_analogue_rollout_ref` runs only for
CPU tensors; CUDA tensors launch the kernel or raise.
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import Sequence

import torch

from repro_torch.kernels import fused_ode_mlp, ref, work
from repro_torch.kernels.crossbar_vmm import stored_operand
from repro_torch.kernels.fused_ode_mlp import MAX_LAYERS, Geometry

#: Fault scalars the kernel understands (subset optional); produced by
#: ``FaultModel.kernel_args()`` in :mod:`repro_torch.core.faults`.
FAULT_DEFAULTS = {
    "stuck_rate": 0.0, "stuck_on_frac": 0.5, "fault_seed": 0,
    "salt_base": 0, "drift_nu": 0.0, "drift_tau": 1.0, "drift_n0": 0,
}

#: Device memory of one time chunk's noisy pairs: under half the H100's
#: 50 MB L2, so the pre-pass's writes are still there when the rollout
#: reads them (the 1024 x 200 Lorenz96 request's 16.4 MB is one chunk).
NOISE_CHUNK_BYTES = 24 * 2 ** 20

#: Evaluations one pre-pass launch covers at most (its grid's y extent).
_MAX_CHUNK_EVALS = 65535

#: Launches of the rollout kernel in this process (one per rollout, or
#: per time chunk of a noisy rollout longer than one chunk).
LAUNCHES = 0

#: Launches of the read-noise pre-pass (one per noisy rollout chunk).
NOISE_LAUNCHES = 0

#: Launches of K4w, the wide cluster rollout (one per rollout, or per time
#: chunk of a noisy rollout longer than one chunk).
WIDE_LAUNCHES = 0


class _K4Read(ctypes.Structure):
    """The kernel's ``K4Read`` argument struct (same field order)."""
    _fields_ = [("dt", ctypes.c_float), ("dt2", ctypes.c_float),
                ("dt6", ctypes.c_float), ("u8", ctypes.c_int),
                ("g_step", ctypes.c_float), ("g_min", ctypes.c_float),
                ("g_max", ctypes.c_float), ("has_clamp", ctypes.c_int),
                ("v_clamp", ctypes.c_float), ("read_noise", ctypes.c_float),
                ("noise_seed", ctypes.c_uint), ("stuck_rate", ctypes.c_float),
                ("stuck_on_frac", ctypes.c_float),
                ("fault_seed", ctypes.c_uint),
                ("salt_base", ctypes.c_longlong),
                ("drift_nu", ctypes.c_float), ("drift_tau", ctypes.c_float),
                ("drift_n0", ctypes.c_longlong),
                ("step_offset", ctypes.c_longlong)]


def launch_geometry(B: int, sizes: Sequence[int], noisy: bool, *,
                    twins_per_block: int | None = None) -> Geometry:
    """K4's launch for ``B`` twins of MLP widths ``sizes``: K1's
    (:func:`repro_torch.kernels.fused_ode_mlp.launch_geometry`), with a
    second weight block for the double-buffered noisy pairs under read
    noise.  ``twins_per_block`` (1 or 4) forces the tile.  Where no
    resident choice fits the 227 KB a block may use, K4w's cluster launch
    (the same clean and noisy); a ``ValueError`` above its limit."""
    return fused_ode_mlp.launch_geometry(
        B, sizes, twins_per_block=twins_per_block,
        weight_blocks=2 if noisy else 1, what="fused_analogue_rollout")


def check_smem_fit(sizes: Sequence[int], noisy: bool) -> int:
    """Raise a ``ValueError`` when one resident K4 block (one twin)
    exceeds the 227 KB a Hopper block may use; returns its dynamic bytes
    otherwise.  (Such widths run K4w, whose launch has its own check.)"""
    geom, need, tile = fused_ode_mlp._resident_geometry(
        1, sizes, False, None, 2 if noisy else 1)
    if geom is None:
        raise fused_ode_mlp._over_limit(sizes, need, tile, False,
                                        "fused_analogue_rollout")
    return geom.smem_bytes


def noise_eval_floats(sizes: Sequence[int]) -> int:
    """Floats of one evaluation's noisy pairs in the kernels' weight layout
    (rows padded to 4 floats, then the bias row; no op table)."""
    return fused_ode_mlp.weight_floats(sizes, False) - fused_ode_mlp.OPS_WORDS


def noise_chunk_steps(sizes: Sequence[int]) -> int:
    """RK4 steps of one noisy time chunk: as many as keep its 4 evaluations
    a step within ``NOISE_CHUNK_BYTES`` (at least one)."""
    per_step = 4 * 4 * noise_eval_floats(sizes)
    return max(1, min(NOISE_CHUNK_BYTES // per_step, _MAX_CHUNK_EVALS // 4))


def _layer_offsets(sizes: Sequence[int]) -> list[int]:
    """Where each layer's (in + 1) rows start in one evaluation's pairs."""
    offs, off = [], 0
    for a, b in zip(sizes[:-1], sizes[1:]):
        offs.append(off)
        off += (a + 1) * fused_ode_mlp._round4(b)
    return offs


@dataclasses.dataclass
class _Call:
    """A validated call: float32 contiguous tensors on one device and the
    scalars of the read."""
    gps: list
    gms: list
    scales: torch.Tensor
    y0: torch.Tensor
    u_half: torch.Tensor
    dt: float
    fault: dict
    g_step: float | None
    g_min: float
    g_max: float
    v_clamp: float | None
    read_noise: float
    noise_seed: int
    step_offset: int
    per_twin: bool
    T: int
    du: int
    sizes: list
    device: torch.device

    def read(self, step_offset: int) -> _K4Read:
        """The kernels' ``K4Read`` with ``y0`` at global step
        ``step_offset``."""
        dt64, fa, mask = float(self.dt), self.fault, ref.U32_MASK
        return _K4Read(
            dt=dt64, dt2=dt64 / 2, dt6=dt64 / 6,
            u8=int(self.g_step is not None),
            g_step=float(self.g_step or 0.0), g_min=float(self.g_min),
            g_max=float(self.g_max), has_clamp=int(self.v_clamp is not None),
            v_clamp=float(self.v_clamp or 0.0),
            read_noise=float(self.read_noise),
            noise_seed=int(self.noise_seed) & mask,
            stuck_rate=float(fa["stuck_rate"]),
            stuck_on_frac=float(fa["stuck_on_frac"]),
            fault_seed=int(fa["fault_seed"]) & mask,
            salt_base=int(fa["salt_base"]), drift_nu=float(fa["drift_nu"]),
            drift_tau=float(fa["drift_tau"]), drift_n0=int(fa["drift_n0"]),
            step_offset=int(step_offset))

    def arrays(self):
        """(G+ pointers, G- pointers, sizes) as the C entry points take
        them."""
        L = len(self.gps)
        return ((ctypes.c_void_p * L)(*[g.data_ptr() for g in self.gps]),
                (ctypes.c_void_p * L)(*[g.data_ptr() for g in self.gms]),
                (ctypes.c_int * (L + 1))(*self.sizes))


def _validate(gps, gms, scales, y0, u_half, dt, *, g_step, g_min, g_max,
              v_clamp, read_noise, noise_seed, step_offset, fault,
              batch_tile) -> _Call:
    if read_noise > 0.0 and g_step is not None and g_min <= 0.0:
        raise ValueError(
            "fused_analogue_rollout: noisy quantised reads need the "
            "absolute conductance floor — pass g_min > 0 (spec.g_min)")
    fa = dict(FAULT_DEFAULTS, **(fault or {}))
    if set(fa) != set(FAULT_DEFAULTS):
        raise ValueError(
            f"fused_analogue_rollout: unknown fault keys "
            f"{sorted(set(fa) - set(FAULT_DEFAULTS))}; have "
            f"{sorted(FAULT_DEFAULTS)}")
    if fa["stuck_rate"] > 0.0 and not g_max > g_min:
        raise ValueError(
            "fused_analogue_rollout: stuck-cell injection pins cells to "
            "the absolute G_on/G_off values — pass g_max > g_min "
            "(spec.g_max/spec.g_min)")
    for name, x in (("y0", y0), ("u_half", u_half)):
        if not torch.is_floating_point(x):
            raise ValueError(
                f"fused_analogue_rollout: {name} has non-floating dtype "
                f"{x.dtype}; cast it to a floating dtype")
    gps, gms = list(gps), list(gms)
    L = len(gps)
    quant = g_step is not None
    for name, arrays in (("gps", gps), ("gms", gms)):
        for li, g in enumerate(arrays):
            if quant != (g.dtype == torch.uint8):
                raise ValueError(
                    f"fused_analogue_rollout: {name}[{li}] is {g.dtype}; "
                    f"uint8 level indices go with g_step and float "
                    f"conductances without it")
    scales = torch.as_tensor(scales)
    if L != len(gms) or tuple(scales.shape) != (L,):
        raise ValueError(
            f"fused_analogue_rollout: {len(gps)} G+ and {len(gms)} G- arrays "
            f"with scales of shape {tuple(scales.shape)}; need one of each "
            f"per layer")

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
        raise ValueError("fused_analogue_rollout: empty fleet (y0 has 0 rows)")
    bt = min(batch_tile, B)
    if B % bt:
        raise ValueError(f"batch {B} not divisible by tile {bt}")
    sizes = [gps[0].shape[0] - 1] + [g.shape[1] for g in gps]
    if any(g.shape != (a + 1, b) or m.shape != g.shape
           for g, m, a, b in zip(gps, gms, sizes[:-1], sizes[1:])):
        raise ValueError(
            f"fused_analogue_rollout: the arrays "
            f"{[tuple(g.shape) for g in gps]} do not chain as (K+1, N) "
            f"layers of one MLP, or G- differs from G+ in shape")
    if sizes[0] != du + D or sizes[-1] != D:
        raise ValueError(
            f"fused_analogue_rollout: MLP {tuple(sizes)} does not map "
            f"[u (Du={du}), y (D={D})] to dy/dt (D={D})")
    launch_geometry(1, sizes, read_noise > 0.0)

    devices = {x.device for x in [y0, u_half, scales, *gps, *gms]}
    if len(devices) != 1:
        raise ValueError(
            f"fused_analogue_rollout: inputs lie on several devices "
            f"{sorted(str(d) for d in devices)}; put them on one")
    device = devices.pop()
    if device.type not in ("cpu", "cuda"):
        raise ValueError(
            f"fused_analogue_rollout: tensors on {device} — the kernel runs "
            f"on CUDA and its plain version on the CPU")
    if device.type == "cuda" and L > MAX_LAYERS:
        raise ValueError(
            f"fused_analogue_rollout: {L} layers, the kernel takes at most "
            f"{MAX_LAYERS}")
    return _Call(
        gps=[stored_operand(g) for g in gps],
        gms=[stored_operand(g) for g in gms],
        scales=scales.to(torch.float32).contiguous(),
        y0=y0.to(torch.float32).contiguous(),
        u_half=u_half.to(torch.float32).contiguous(), dt=float(dt),
        fault=fa, g_step=g_step, g_min=g_min, g_max=g_max, v_clamp=v_clamp,
        read_noise=read_noise, noise_seed=noise_seed,
        step_offset=step_offset, per_twin=per_twin, T=T, du=du, sizes=sizes,
        device=device)


def _noise_pass(c: _Call, rd: _K4Read, steps: int) -> torch.Tensor:
    """Launch the pre-pass: the noisy pairs of ``steps`` steps from global
    step ``rd.step_offset``, (4 steps, noise_eval_floats) float32."""
    global NOISE_LAUNCHES
    from repro_torch.kernels import _build
    fn = _build.load("fused_analogue").k4_noise_pass_f32
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_void_p]
                   + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 2)
    fn.restype = ctypes.c_int
    ev = noise_eval_floats(c.sizes)
    noise = torch.empty((4 * steps, ev), dtype=torch.float32, device=c.device)
    gp_ptrs, gm_ptrs, c_sizes = c.arrays()
    with torch.cuda.device(c.device):
        err = fn(ctypes.addressof(gp_ptrs), ctypes.addressof(gm_ptrs),
                 ctypes.addressof(c_sizes), len(c.gps), ctypes.addressof(rd),
                 4 * steps, ev, noise.data_ptr(),
                 torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(
            f"fused_analogue_rollout: the read-noise pre-pass failed to "
            f"launch with cudaError_t {err} (sizes={tuple(c.sizes)}, "
            f"{steps} steps)")
    NOISE_LAUNCHES += 1
    return noise


def _rollout(c: _Call, geom: Geometry) -> torch.Tensor:
    """K4 (K4w for a cluster ``geom``) on the current stream at ``geom``:
    one launch, or under read noise a pre-pass and a launch per time
    chunk; (T+1, B, D) float32."""
    global LAUNCHES, WIDE_LAUNCHES
    from repro_torch.kernels import _build
    wide = geom.cluster > 1
    if wide:
        fn = _build.load("fused_wide").k4w_fused_analogue_rollout_f32
    else:
        fn = _build.load("fused_analogue").k4_fused_analogue_rollout_f32
    fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int]
                   + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 4
                   + [ctypes.c_longlong] + [ctypes.c_int] * (4 if wide else 3)
                   + [ctypes.c_longlong, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    B, D = c.y0.shape
    T, du = c.T, c.du
    out = torch.empty((T + 1, B, D), dtype=torch.float32, device=c.device)
    gp_ptrs, gm_ptrs, c_sizes = c.arrays()
    noisy = c.read_noise > 0.0
    chunk = noise_chunk_steps(c.sizes) if noisy else max(T, 1)
    u_twin_stride = (2 * T + 1) * du if c.per_twin else 0
    t0 = 0
    while True:
        steps = min(chunk, T - t0)
        rd = c.read(c.step_offset + t0)
        noise = _noise_pass(c, rd, steps) if noisy and steps > 0 else None
        y0 = c.y0 if t0 == 0 else out[t0]
        u_ptr = c.u_half.data_ptr() + 4 * 2 * t0 * du if du > 0 else None
        shape = ([geom.cluster] if wide else []) + [
            geom.twins_per_block, geom.threads, geom.time_chunk,
            geom.smem_bytes]
        with torch.cuda.device(c.device):
            err = fn(y0.data_ptr(), u_ptr, out[t0].data_ptr(),
                     c.scales.data_ptr(), ctypes.addressof(gp_ptrs),
                     ctypes.addressof(gm_ptrs), ctypes.addressof(c_sizes),
                     len(c.gps), ctypes.addressof(rd),
                     None if noise is None else noise.data_ptr(), B, steps,
                     D, du, u_twin_stride, *shape,
                     torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(
                f"fused_analogue_rollout: CUDA kernel "
                f"{'K4w (wide cluster) ' if wide else ''}launch failed with "
                f"cudaError_t {err} (B={B}, T={T}, sizes={tuple(c.sizes)}, "
                f"{geom})")
        if wide:
            WIDE_LAUNCHES += 1
        else:
            LAUNCHES += 1
        t0 += steps
        if t0 >= T:
            return out


def fused_analogue_rollout(
    gps: Sequence[torch.Tensor],  # per layer (K_l + 1, N_l): conductances
    gms: Sequence[torch.Tensor],  # (f32) or uint8 level indices; bias row last
    scales: torch.Tensor,         # (L,) per-tensor programming scales
    y0: torch.Tensor,             # (B, D)
    u_half: torch.Tensor,         # (2T+1, Du) shared or (B, 2T+1, Du)
    dt: float,
    *,
    g_step: float | None = None,  # set => uint8 level-index storage
    g_min: float = 0.0,           # conductance floor (noisy quantised reads)
    g_max: float = 0.0,           # conductance ceiling (stuck overrides)
    v_clamp: float | None = None,
    read_noise: float = 0.0,
    noise_seed: int = 0,
    step_offset: int = 0,         # global step index of y0 (resume replay)
    fault: dict | None = None,    # FaultModel.kernel_args(); None = healthy
    batch_tile: int = 64,
) -> torch.Tensor:
    """Full-trajectory analogue RK4 solve; returns (T+1, B, D) float32.

    Same drive contract as K1 (half-step drive, shared or per twin, Du may
    be 0; B must divide by ``batch_tile``).  ``fault`` injects stuck cells
    and live read-disturb drift in the kernel.  ``step_offset`` declares
    the global RK4 step of ``y0``: a rollout resumed at step k with
    ``step_offset=k`` continues the same noise salts and drift exponents,
    so split-and-resume is bitwise the unsplit rollout.  Raises
    ``ValueError`` for noisy uint8 reads without ``g_min > 0``, stuck
    cells without ``g_max > g_min``, unknown fault keys, and shapes the
    kernel does not take.
    """
    c = _validate(gps, gms, scales, y0, u_half, dt, g_step=g_step,
                  g_min=g_min, g_max=g_max, v_clamp=v_clamp,
                  read_noise=read_noise, noise_seed=noise_seed,
                  step_offset=step_offset, fault=fault,
                  batch_tile=batch_tile)
    geom = launch_geometry(c.y0.shape[0], c.sizes, read_noise > 0.0)
    work.report("K4w" if geom.cluster > 1 else "K4", *rollout_work(c))
    if c.device.type == "cpu":
        with work.uncounted():
            return ref.fused_analogue_rollout_ref(
                c.gps, c.gms, c.scales, c.y0, c.u_half, c.dt, fault=c.fault,
                g_step=g_step, g_min=g_min, g_max=g_max, v_clamp=v_clamp,
                read_noise=read_noise, noise_seed=noise_seed,
                step_offset=step_offset)
    return _rollout(c, geom)


def rollout_work(c: _Call):
    """(FLOP, bytes) of one validated rollout: the MLP's products for every
    twin and evaluation (the read's noise draws, like any elementwise work,
    are not counted); the pairs, scales, y0 and the drive read once, the
    trajectory written once."""
    B, D = c.y0.shape
    flops, nbytes = fused_ode_mlp.rollout_work(c.sizes, B, c.T,
                                               c.u_half.numel())
    params = sum((a + 1) * b for a, b in zip(c.sizes[:-1], c.sizes[1:]))
    pairs = sum(g.numel() * g.element_size() for g in [*c.gps, *c.gms])
    return flops, nbytes - 4.0 * params + pairs + 4.0 * len(c.gps)


def fused_analogue_rollout_at(geom: Geometry, gps, gms, scales, y0, u_half,
                              dt: float, **kw) -> torch.Tensor:
    """K4 on CUDA tensors at an explicit ``geom`` (from
    :func:`launch_geometry`, e.g. with ``twins_per_block=1``), keywords as
    :func:`fused_analogue_rollout`'s: for checks that a trajectory does
    not depend on the launch geometry."""
    c = _validate(gps, gms, scales, y0, u_half, dt,
                  **dict(dict(g_step=None, g_min=0.0, g_max=0.0, v_clamp=None,
                              read_noise=0.0, noise_seed=0, step_offset=0,
                              fault=None, batch_tile=y0.shape[0]), **kw))
    if c.device.type != "cuda":
        raise ValueError("fused_analogue_rollout_at: the kernel runs on CUDA")
    return _rollout(c, geom)


def noisy_pairs(gps: Sequence[torch.Tensor], gms: Sequence[torch.Tensor],
                T: int, *, read_noise: float, noise_seed: int,
                step_offset: int = 0, g_step: float | None = None,
                g_min: float = 0.0, g_max: float = 0.0,
                fault: dict | None = None) -> list[torch.Tensor]:
    """The noisy pairs S that the evaluations of a T-step noisy rollout
    read, per layer (T, 4, in_l + 1, out_l) float32: on CUDA one launch of
    K4's pre-pass, unpacked from its layout; on the CPU the plain version
    :func:`repro_torch.kernels.ref.fused_analogue_noisy_pairs_ref`."""
    if not read_noise > 0.0 or T < 1:
        raise ValueError(f"noisy_pairs: read_noise={read_noise}, T={T}; "
                         f"want read noise over at least one step")
    # shape-only stand-ins for the rollout's other inputs (no kernel runs)
    dev = gps[0].device
    sizes = [gps[0].shape[0] - 1] + [g.shape[1] for g in gps]
    c = _validate(gps, gms, torch.empty(len(gps), device=dev),
                  torch.empty((1, sizes[-1]), device=dev),
                  torch.empty((2 * T + 1, sizes[0] - sizes[-1]), device=dev),
                  0.0, g_step=g_step, g_min=g_min, g_max=g_max, v_clamp=None,
                  read_noise=read_noise, noise_seed=noise_seed,
                  step_offset=step_offset, fault=fault, batch_tile=1)
    if c.device.type == "cpu":
        return ref.fused_analogue_noisy_pairs_ref(
            c.gps, c.gms, T, fault=c.fault, g_step=g_step, g_min=g_min,
            g_max=g_max, read_noise=read_noise, noise_seed=noise_seed,
            step_offset=step_offset)
    noise = _noise_pass(c, c.read(step_offset), T).view(T, 4, -1)
    out = []
    for off, a, b in zip(_layer_offsets(sizes), sizes[:-1], sizes[1:]):
        w = fused_ode_mlp._round4(b)
        out.append(noise[..., off:off + (a + 1) * w].view(T, 4, a + 1, w)
                   [..., :b])
    return out
