"""Plain PyTorch versions of the port's kernels (port of ``repro/kernels/ref.py``).

Each function here computes what a hand-written kernel computes, with
stock tensor ops on whatever device its tensors lie on.  The kernel
wrappers use them for CPU tensors, the CPU tests hold them against the
JAX package, and ``chip_smoke.py`` holds each kernel against them on the
card.  Sections: the fused RK4 rollout and its VJP (K1, K2), the counter
noise stream (K3, with its batched masks and the hardware-aware write
path), the crossbar VMM (K7), the fused analogue rollout
(K4), the soft-DTW wavefront pair (K5, K6), and the LM kernels: causal
GQA flash attention (K8) and the selective-SSM scan (K9).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.core.losses import BIG, _dtw_scan, _hardmin, _softmin

F32 = torch.float32


def mlp_fwd(weights: Sequence[torch.Tensor], biases: Sequence[torch.Tensor],
            x: torch.Tensor) -> torch.Tensor:
    """ReLU MLP: dot, then ``+ b``, then ReLU; no ReLU on the last layer."""
    for i, (w, b) in enumerate(zip(weights, biases)):
        x = x @ w + b
        if i < len(weights) - 1:
            x = torch.relu(x)
    return x


def fused_node_rollout_ref(y0: torch.Tensor, u_half: torch.Tensor,
                           weights: Sequence[torch.Tensor],
                           biases: Sequence[torch.Tensor],
                           dt: float) -> torch.Tensor:
    """RK4 rollout of dy/dt = MLP([u(t), y]) (drive optional) — the plain
    version of K1 (``kernels/csrc/fused_ode_mlp.cu``).

    y0: (B, D); u_half: drive sampled at half-steps, (2T+1, Du) shared or
    (B, 2T+1, Du) per twin (Du may be 0); returns (T+1, B, D).  ``dt`` is
    a Python float, so ``dt / 2`` and ``dt / 6`` are rounded once to the
    tensors' float32, as in the JAX kernel.
    """
    u_tm = _time_major(u_half)
    ys, y = [y0], y0
    for t in range(u_tm.shape[0] // 2):
        y = rk4_step_ref(y, u_tm[2 * t], u_tm[2 * t + 1], u_tm[2 * t + 2],
                         weights, biases, dt)
        ys.append(y)
    return torch.stack(ys)


def _time_major(u_half: torch.Tensor) -> torch.Tensor:
    """(2T+1, Du) as it is; a per-twin (B, 2T+1, Du) as (2T+1, B, Du)."""
    return u_half.transpose(0, 1) if u_half.ndim == 3 else u_half


def rk4_step_ref(y, u0, um, u1, weights, biases, dt: float):
    """One RK4 step of dy/dt = MLP([u, y]) from y (B, D), with the drive
    rows u0, um, u1 at t, t + dt/2, t + dt: each (Du,) shared, (B, Du)
    per twin, or of width 0 (autonomous).  The update is
    y + (dt/6) * (((k1 + 2 k2) + 2 k3) + k4), as both kernels compute it."""
    B = y.shape[0]

    def f(u, y):
        if u.shape[-1] == 0:
            return mlp_fwd(weights, biases, y)
        if u.ndim == 1:
            u = u[None, :].expand(B, u.shape[0])
        return mlp_fwd(weights, biases, torch.cat([u, y], dim=-1))

    k1 = f(u0, y)
    k2 = f(um, y + dt / 2 * k1)
    k3 = f(um, y + dt / 2 * k2)
    k4 = f(u1, y + dt * k3)
    return y + dt / 6 * (k1 + 2 * k2 + 2 * k3 + k4)


def fused_node_rollout_bwd_ref(traj: torch.Tensor, u_half: torch.Tensor,
                               weights: Sequence[torch.Tensor],
                               biases: Sequence[torch.Tensor],
                               g: torch.Tensor, dt: float):
    """The VJP of :func:`fused_node_rollout_ref` — the plain version of K2
    (``kernels/csrc/fused_ode_mlp_bwd.cu``).

    traj: the forward trajectory (T+1, B, D); u_half as for the forward;
    g: the cotangent of every trajectory row, (T+1, B, D).  Walks
    t = T-1 .. 0: adds g[t+1] to the adjoint, re-evaluates the RK4 step
    from trajectory row t and pulls the adjoint back through it with
    ``torch.func.vjp``, summing the weight and bias cotangents; g[0] is
    added at the end.  Returns ``(dy0, dweights, dbiases)``.  The drive
    is data and gets no cotangent.
    """
    u_tm = _time_major(u_half)
    weights, biases = list(weights), list(biases)
    a = torch.zeros_like(traj[0])
    dws = [torch.zeros_like(w) for w in weights]
    dbs = [torch.zeros_like(b) for b in biases]
    for t in range(traj.shape[0] - 2, -1, -1):
        a = a + g[t + 1]
        u0, um, u1 = u_tm[2 * t], u_tm[2 * t + 1], u_tm[2 * t + 2]
        _, vjp = torch.func.vjp(
            lambda y_, ws_, bs_: rk4_step_ref(y_, u0, um, u1, ws_, bs_, dt),
            traj[t], weights, biases)
        a, dws_t, dbs_t = vjp(a)
        dws = [acc + d for acc, d in zip(dws, dws_t)]
        dbs = [acc + d for acc, d in zip(dbs, dbs_t)]
    return a + g[0], dws, dbs


# ---------------------------------------------------------------------------
# the bf16 policies of K1 and K2
# ---------------------------------------------------------------------------
#
# Values are held in float32 tensors; ``rnd`` rounds to the nearest bfloat16
# (ties to even) and back, as the kernels' __float2bfloat16_rn does.  Under
# "bf16_f32acc" every layer input is rounded and the products of two bf16
# values are summed in float32; bias, ReLU and the RK4 combination run in
# float32, the carry is float32 and is rounded once every ``time_chunk``
# steps.  Under "bf16" the dot's sum, the bias add and every RK4 operation
# (its constants dt/2, dt, dt/6 too) are rounded as well, so the carry is
# bf16.  This is the JAX kernel's make_rk4_step term by term.

BF16 = torch.bfloat16


def rnd(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to bfloat16, held as float32."""
    return x.to(BF16).to(F32)


def bf16_const(c: float) -> float:
    """A Python float as the bfloat16 that JAX's weak typing makes of it
    (through float32)."""
    return float(torch.tensor(c, dtype=F32).to(BF16).to(F32))


def _mlp_bf16(x, weights, biases, pure: bool):
    """One MLP evaluation on the bf16-valued layer input ``x`` (B, in_0):
    returns the output and every layer's input (bf16 values, the hidden
    ones post-ReLU)."""
    xs = [x]
    L = len(weights)
    for i, (w, b) in enumerate(zip(weights, biases)):
        z = xs[-1] @ w
        v = rnd(rnd(z) + b) if pure else z + b
        if i == L - 1:
            return v, xs
        xs.append(rnd(torch.relu(v)))


def _stage_input(u, y, B: int):
    """The MLP input [u, y] of one RK4 stage (u shared, per twin or of
    width 0)."""
    if u.shape[-1] == 0:
        return y
    if u.ndim == 1:
        u = u[None, :].expand(B, u.shape[0])
    return torch.cat([u, y], dim=-1)


def rk4_consts(dt: float, pure: bool):
    """(dt/2, dt, dt/6) as the policy's step uses them: float32 values
    (Python floats the kernels round once), bf16-rounded under "bf16"."""
    cs = (dt / 2, dt, dt / 6)
    return tuple(bf16_const(c) for c in cs) if pure else cs


def _rk4_step_bf16(y, u0, um, u1, weights, biases, dt: float, pure: bool,
                   keep: bool = False):
    """One RK4 step under a bf16 policy from the carry ``y`` (B, D): the
    stage inputs [u, y + c k] rounded to bf16, the MLP of
    :func:`_mlp_bf16`, the update y + (dt/6) (((k1 + 2 k2) + 2 k3) + k4)
    in float32, or rounded op by op under "bf16".  With ``keep`` also
    returns each stage's layer inputs (for the VJP)."""
    B = y.shape[0]
    c2, c1, c6 = rk4_consts(dt, pure)
    r = rnd if pure else (lambda x: x)
    ks, stages, yin = [], [], y
    for s, (u, c) in enumerate(((u0, None), (um, c2), (um, c2), (u1, c1))):
        if s:
            yin = r(y + r(c * ks[-1]))
        k, xs = _mlp_bf16(rnd(_stage_input(u, yin, B)), weights, biases,
                          pure)
        ks.append(k)
        stages.append(xs)
    k1, k2, k3, k4 = ks
    y = r(y + r(c6 * r(r(r(k1 + 2 * k2) + 2 * k3) + k4)))
    return (y, stages) if keep else y


def _bf16_operands(u_half, weights, biases):
    """The drive, weights and biases rounded to bf16 (as float32), the
    storage of the bf16 policies."""
    return (rnd(u_half.to(F32)), [rnd(w.to(F32)) for w in weights],
            [rnd(b.to(F32)) for b in biases])


def fused_node_rollout_bf16_ref(y0: torch.Tensor, u_half: torch.Tensor,
                                weights: Sequence[torch.Tensor],
                                biases: Sequence[torch.Tensor], dt: float,
                                precision: str,
                                time_chunk: int) -> torch.Tensor:
    """The plain version of K1 under ``precision`` "bf16" or "bf16_f32acc":
    returns the (T+1, B, D) bfloat16 trajectory.  The carry starts from y0
    rounded to bf16 and is rounded again after every ``time_chunk`` steps,
    counted from step 0 of the call (a no-op under "bf16")."""
    pure = precision == "bf16"
    u_half, weights, biases = _bf16_operands(u_half, weights, biases)
    u_tm = _time_major(u_half)
    y = rnd(y0.to(F32))
    ys = [y]
    for t in range(u_tm.shape[0] // 2):
        y = _rk4_step_bf16(y, u_tm[2 * t], u_tm[2 * t + 1], u_tm[2 * t + 2],
                           weights, biases, dt, pure)
        if (t + 1) % time_chunk == 0:
            y = rnd(y)
        ys.append(rnd(y))
    return torch.stack(ys).to(BF16)


def _mlp_bf16_vjp(delta, xs, weights, dws, dbs, pure: bool):
    """Pull the cotangent ``delta`` of one MLP output back through the
    layers whose inputs are ``xs``: adds x^T delta and sum(delta) to
    ``dws`` / ``dbs`` in float32 and returns the cotangent of the layer-0
    input, each input cotangent rounded to bf16 (the transpose of the
    rounded layer input), the hidden ones masked by their ReLU."""
    for li in range(len(weights) - 1, -1, -1):
        dws[li] += xs[li].transpose(0, 1) @ delta
        dbs[li] += delta.sum(0)
        d = rnd(delta @ weights[li].transpose(0, 1))
        if li == 0:
            return d
        delta = torch.where(xs[li] > 0, d, torch.zeros_like(d))


def fused_node_rollout_bf16_bwd_ref(traj: torch.Tensor, u_half: torch.Tensor,
                                    weights: Sequence[torch.Tensor],
                                    biases: Sequence[torch.Tensor],
                                    g: torch.Tensor, dt: float,
                                    precision: str, time_chunk: int):
    """The plain version of K2 under ``precision`` "bf16" or "bf16_f32acc":
    the VJP of :func:`fused_node_rollout_bf16_ref` with the same
    ``time_chunk``.  Returns ``(dy0, dweights, dbiases)``, float32.

    Each chunk is replayed at the carry dtype from its start row (the
    bf16 rows inside a chunk are roundings of the float32 carry, not the
    states the forward continued from), then swept in reverse.  The
    cotangent rows enter as bf16 (row 0 as float32), the adjoint runs at
    the carry dtype (every operation rounded under "bf16"), an input
    cotangent of a layer is rounded to bf16, and the weight and bias
    cotangents are summed in float32 over twins, stages and steps.  The
    forward's roundings of the carry at chunk starts are not transposed
    (the JAX kernel's VJP replays from the rows and carries its adjoint
    across them)."""
    pure = precision == "bf16"
    u_half, weights, biases = _bf16_operands(u_half, weights, biases)
    u_tm = _time_major(u_half)
    T = traj.shape[0] - 1
    rows = traj.to(F32)
    gs = rnd(g.to(F32))
    c2, c1, c6 = rk4_consts(dt, pure)
    r = rnd if pure else (lambda x: x)
    a = torch.zeros_like(rows[0])
    dws = [torch.zeros_like(w) for w in weights]
    dbs = [torch.zeros_like(b) for b in biases]
    for j0 in range(((T - 1) // time_chunk) * time_chunk, -1, -time_chunk):
        j1 = min(j0 + time_chunk, T)
        states, y = [], rows[j0]
        for t in range(j0, j1):
            states.append(y)
            if t + 1 < j1:
                y = _rk4_step_bf16(y, u_tm[2 * t], u_tm[2 * t + 1],
                                   u_tm[2 * t + 2], weights, biases, dt,
                                   pure)
        for t in range(j1 - 1, j0 - 1, -1):
            a = r(a + gs[t + 1])
            _, stages = _rk4_step_bf16(states[t - j0], u_tm[2 * t],
                                       u_tm[2 * t + 1], u_tm[2 * t + 2],
                                       weights, biases, dt, pure, keep=True)
            cst = r(c6 * a)
            gk = [cst, 2 * cst, 2 * cst, cst]
            D = a.shape[1]
            for s in range(3, -1, -1):
                gx = _mlp_bf16_vjp(gk[s], stages[s], weights, dws, dbs,
                                   pure)[:, -D:]
                a = r(a + gx)
                if s:
                    gk[s - 1] = r(gk[s - 1] + r((c1 if s == 3 else c2) * gx))
    return a + g[0].to(F32), dws, dbs


# ---------------------------------------------------------------------------
# counter noise (K3): uint32 streams held in int64
# ---------------------------------------------------------------------------
#
# PyTorch has no full uint32 arithmetic, so a uint32 value lives in an int64
# tensor masked to 32 bits; each product by a 32-bit constant is split in
# 16-bit halves so that no intermediate passes 2^63.  The results are the
# JAX package's bit for bit (``repro/kernels/noise.py``).

U32_MASK = 0xFFFF_FFFF
#: Offset separating a stuck-cell decision draw from its polarity draw.
POLARITY_SALT_OFFSET = 0x0080_0000
_GOLDEN = 0x9E37_79B9
_MIX1, _MIX2 = 0x7FEB_352D, 0x846C_A68B
_H2_SALT = 0x85EB_CA6B
#: Box-Muller's 2*pi as JAX forms it (rounded to float32 where used).
TWO_PI = 2.0 * 3.14159265358979
#: Tile of the reference crossbar kernel: its read-noise salt is per
#: 128 x 128 tile of G, with element ids local to the tile.
CROSSBAR_TILE = 128


def _mul32(x, c: int):
    """(x * c) mod 2^32 for x in [0, 2^32): a Python int or an int64 tensor."""
    if isinstance(x, int):
        return (x * c) & U32_MASK
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & U32_MASK


def splitmix32_ref(x):
    """Splitmix32 finaliser on uint32 values (a Python int or an int64
    tensor; bits above 32 are dropped first)."""
    x = x & U32_MASK
    x = _mul32(x ^ (x >> 16), _MIX1)
    x = _mul32(x ^ (x >> 15), _MIX2)
    return x ^ (x >> 16)


def stream_base(seed, salt):
    """The stream's key ``splitmix32(seed * 0x9E3779B9 + splitmix32(salt))``;
    ``seed`` and ``salt`` Python ints or int64 tensors (a seed or salt that
    depends on a device-side step counter)."""
    seed = (seed if isinstance(seed, torch.Tensor) else int(seed)) & U32_MASK
    mixed = _mul32(seed, _GOLDEN) + splitmix32_ref(salt)
    return splitmix32_ref(mixed & U32_MASK)


def bits_to_unit_ref(bits: torch.Tensor) -> torch.Tensor:
    """uint32 (in int64) -> float32 uniform in (0, 1]: the exponent bitcast
    ``2 - float((bits >> 9) | 0x3F800000)``, exact."""
    f = ((bits >> 9) | 0x3F80_0000).to(torch.int32).view(F32)
    return 2.0 - f


def counter_uniform_at_ref(seed: int, salt, idx: torch.Tensor) -> torch.Tensor:
    """Uniform (0, 1] float32 samples at explicit element ids ``idx``."""
    idx = idx.to(torch.int64) & U32_MASK
    return bits_to_unit_ref(splitmix32_ref(stream_base(seed, salt) ^ idx))


def counter_normal_at_ref(seed: int, salt, idx: torch.Tensor) -> torch.Tensor:
    """Standard normal float32 samples at element ids ``idx``: Box-Muller
    over two chained hashes, ``sqrt(-2 log u1) * cos(2 pi u2)``."""
    idx = idx.to(torch.int64) & U32_MASK
    h1 = splitmix32_ref(stream_base(seed, salt) ^ idx)
    h2 = splitmix32_ref(h1 ^ _H2_SALT)
    u1, u2 = bits_to_unit_ref(h1), bits_to_unit_ref(h2)
    two_pi = torch.full((), TWO_PI, dtype=F32, device=u2.device)
    return torch.sqrt(-2.0 * torch.log(u1)) * torch.cos(two_pi * u2)


def counter_normal_ref(seed: int, salt: int, shape, device) -> torch.Tensor:
    """``counter_normal_at_ref`` at the row-major flat ids of ``shape``."""
    n = 1
    for s in shape:
        n *= int(s)
    idx = torch.arange(n, dtype=torch.int64, device=device).reshape(shape)
    return counter_normal_at_ref(seed, salt, idx)


def global_cell_index(shape, row0=0, col0=0, ncols=None,
                      device=None) -> torch.Tensor:
    """Global flat ids (uint32 in int64) of a 2-D block at (row0, col0) of
    a logically (?, ncols) array: ``(row0 + r) * ncols + (col0 + c)``."""
    ncols = int(shape[1] if ncols is None else ncols) & U32_MASK
    rr = (torch.arange(shape[0], dtype=torch.int64, device=device)
          + int(row0)) & U32_MASK
    cc = (torch.arange(shape[1], dtype=torch.int64, device=device)
          + int(col0)) & U32_MASK
    return (_mul32(rr, ncols)[:, None] + cc[None, :]) & U32_MASK


def stuck_cell_masks_ref(seed: int, salt: int, shape, rate: float,
                         on_frac: float = 0.5, *, row0=0, col0=0, ncols=None,
                         device=None):
    """(is_stuck, stuck_on) boolean fields of one device array, keyed by
    the global cell ids: a cell is stuck where its uniform is below
    ``rate`` (both rounded to float32), and stuck at G_on where its
    polarity draw is below ``on_frac``."""
    idx = global_cell_index(shape, row0, col0, ncols, device)
    r = torch.full((), rate, dtype=F32, device=device)
    f = torch.full((), on_frac, dtype=F32, device=device)
    is_stuck = counter_uniform_at_ref(seed, salt, idx) < r
    stuck_on = counter_uniform_at_ref(
        seed, int(salt) + POLARITY_SALT_OFFSET, idx) < f
    return is_stuck, stuck_on


def pin_stuck_ref(g: torch.Tensor, seed: int, salt: int, rate: float,
                  on_frac: float, g_on: float, g_off: float) -> torch.Tensor:
    """``g`` (a whole 2-D array) with its stuck cells pinned at ``g_on`` or
    ``g_off``."""
    is_stuck, stuck_on = stuck_cell_masks_ref(seed, salt, tuple(g.shape),
                                              rate, on_frac, device=g.device)
    on = torch.full((), g_on, dtype=F32, device=g.device)
    off = torch.full((), g_off, dtype=F32, device=g.device)
    val = torch.where(stuck_on, on, off)
    return torch.where(is_stuck, val.to(g.dtype), g)


def stuck_cell_masks_many_ref(seed: int, arrays, rate: float,
                              on_frac: float = 0.5, *, device=None) -> list:
    """The (is_stuck, stuck_on) masks of each whole array of ``arrays``, a
    list of ``(salt, (rows, cols))``: what K3's batched mask fill writes in
    one launch."""
    return [stuck_cell_masks_ref(seed, salt, shape, rate, on_frac,
                                 device=device) for salt, shape in arrays]


#: Salt block of the hardware-aware write path (``repro/train/hw_aware.py``),
#: between the kernels' read-noise salts and the fault masks.
HW_SALT_BASE = 0x0A00_0000
#: Salt block of the fault masks (``core.faults`` re-exports it), disjoint
#: from the read-noise salts of the fused kernels, which count up from 0.
FAULT_SALT_BASE = 0x0F00_0000


@dataclasses.dataclass(frozen=True)
class WritePath:
    """The scalars of the hardware-aware write path, K3's third entry point
    (``repro_torch.train.hw_aware`` builds one from an ``HwAwareConfig``).
    ``num_layers`` is the L of the salt formula; ``stuck_rate`` 0 means no
    stuck cells; ``drift`` holds each draw's float32 drift factor (empty:
    no drift snapshot)."""
    noise_seed: int
    k_draws: int
    num_layers: int
    g_min: float
    g_max: float
    levels: int
    quantize: bool
    prog_noise: float
    read_sigma: float
    stuck_rate: float = 0.0
    on_frac: float = 0.5
    fault_seed: int = 0
    fault_ensemble: bool = False
    drift: tuple = ()

    @property
    def g_step(self) -> float:
        return (self.g_max - self.g_min) / (self.levels - 1)


def _step_u32(step):
    """A training step as uint32: a Python int, or a 0-dim integer tensor
    (the engines' int32 counter, -1 being 2^32 - 1) as int64 on its own
    device, so that nothing is read back to the host."""
    if isinstance(step, torch.Tensor):
        return step.to(torch.int64) & U32_MASK
    return int(step) & U32_MASK


def hw_salt(k_draws: int, num_layers: int, step, draw: int,
            layer: int, pair: int, channel: int):
    """``HW_SALT_BASE + ((step k + draw) L + layer) 4 + 2 pair + channel`` in
    uint32 that wraps, as the JAX package forms it; an int, or an int64
    tensor for a tensor ``step``."""
    s = (_step_u32(step) * k_draws + draw) * num_layers + layer
    return (HW_SALT_BASE + s * 4 + 2 * pair + channel) & U32_MASK


def hw_write_tensor_ref(folded: torch.Tensor, wp: WritePath, step,
                        draw: int, layer: int, *,
                        ste: bool = False) -> torch.Tensor:
    """One folded array (bias as the last row) through the write path, in
    ``repro/train/hw_aware.py:write_path_tensor``'s order: differential pair
    at the layer's scale, 6-bit quantise, programming noise clipped to
    [0, 1.5 g_max], stuck pinning, drift snapshot, read noise,
    ``(g+ - g-) / scale``.  ``ste`` returns ``folded + (w_hw - folded)``,
    the straight-through estimator's value.

    Every division is a true division on either device (the level's divisor
    is a 0-dim tensor on ``folded``'s device: a Python divisor becomes a
    multiplication by its reciprocal on CUDA), so the kernel can repeat
    each operation bit for bit."""
    f = folded.to(F32)
    dev = f.device
    shape = tuple(f.shape)
    g_min = torch.full((), wp.g_min, dtype=F32, device=dev)
    g_max = torch.full((), wp.g_max, dtype=F32, device=dev)
    scale = (wp.g_max - wp.g_min) / torch.clamp(torch.max(torch.abs(f)),
                                                min=1e-12)
    mag = torch.abs(f) * scale
    gp = torch.where(f >= 0, wp.g_min + mag, g_min)
    gm = torch.where(f >= 0, g_min, wp.g_min + mag)
    if wp.quantize:
        g_step = torch.full((), wp.g_step, dtype=F32, device=dev)

        def quantize(g):
            q = torch.clamp(torch.round((g - wp.g_min) / g_step), 0,
                            wp.levels - 1)
            return wp.g_min + q * wp.g_step
        gp, gm = quantize(gp), quantize(gm)

    def noisy(g, sigma, pair, channel):
        e = counter_normal_ref(wp.noise_seed, hw_salt(
            wp.k_draws, wp.num_layers, step, draw, layer, pair, channel),
            shape, dev)
        return g * (1.0 + sigma * e)

    if wp.prog_noise > 0:
        gp = torch.clamp(noisy(gp, wp.prog_noise, 0, 0), 0.0, wp.g_max * 1.5)
        gm = torch.clamp(noisy(gm, wp.prog_noise, 1, 0), 0.0, wp.g_max * 1.5)
    if wp.stuck_rate > 0:
        seed = wp.fault_seed & U32_MASK
        if wp.fault_ensemble:
            seed = splitmix32_ref(
                seed ^ ((_step_u32(step) * wp.k_draws + draw) & U32_MASK))
        pinned = []
        for pair, g in ((0, gp), (1, gm)):
            is_stuck, stuck_on = stuck_cell_masks_ref(
                seed, FAULT_SALT_BASE + 2 * layer + pair, shape,
                wp.stuck_rate, wp.on_frac, device=dev)
            pinned.append(torch.where(is_stuck,
                                      torch.where(stuck_on, g_max, g_min), g))
        gp, gm = pinned
    if wp.drift:
        gp = gp * wp.drift[draw]
        gm = gm * wp.drift[draw]
    if wp.read_sigma > 0:
        gp = noisy(gp, wp.read_sigma, 0, 1)
        gm = noisy(gm, wp.read_sigma, 1, 1)
    w_hw = (gp - gm) / scale
    return f + (w_hw - f) if ste else w_hw


def hw_write_path_ref(weights: Sequence[torch.Tensor],
                      biases: Sequence[torch.Tensor], wp: WritePath,
                      step, draws, *, layer0: int = 0,
                      ste: bool = False) -> list:
    """Every layer's folded weights through the write path, for each draw
    of ``draws``: a list (per draw) of lists (per layer) of ``(w_hw,
    b_hw)``, the rows and the last row of the ``(K + 1, N)`` result.
    Layer i takes salts as layer ``layer0 + i``."""
    folded = [torch.cat([w.to(F32), b.to(F32)[None, :]])
              for w, b in zip(weights, biases)]
    out = [[hw_write_tensor_ref(fo, wp, step, d, layer0 + li, ste=ste)
            for li, fo in enumerate(folded)] for d in draws]
    return [[(o[:-1], o[-1]) for o in per_layer] for per_layer in out]


# ---------------------------------------------------------------------------
# crossbar differential-pair VMM (K7)
# ---------------------------------------------------------------------------

def crossbar_effective_g(gp: torch.Tensor, gm: torch.Tensor, *,
                         g_step: Optional[float] = None, g_min: float = 0.0,
                         g_max: float = 0.0, read_noise: float = 0.0,
                         noise_seed: int = 0, stuck_rate: float = 0.0,
                         stuck_on_frac: float = 0.5, fault_seed: int = 0,
                         fault_salts=(0, 1), drift: float = 1.0
                         ) -> torch.Tensor:
    """The (K, N) differential conductance one K7 read multiplies by, in
    the reference kernel's order: uint8 level indices rebuilt to absolute
    conductances where noise or stuck cells need them, stuck cells pinned
    at their global ids, read noise drawn per 128 x 128 tile (salt
    ``k_tile * 2 * 65536 + n_tile * 2``, +1 for G-; element ids local to
    the tile), the pair subtracted (dequantised through ``g_step`` on the
    clean path), then the drift factor."""
    K, N = gp.shape
    gp, gm = gp.to(F32), gm.to(F32)
    stuck, noisy = stuck_rate > 0.0, read_noise > 0.0
    if g_step is not None and (noisy or stuck):
        gp = g_min + gp * g_step
        gm = g_min + gm * g_step
    if stuck:
        gp = pin_stuck_ref(gp, fault_seed, fault_salts[0], stuck_rate,
                           stuck_on_frac, g_max, g_min)
        gm = pin_stuck_ref(gm, fault_seed, fault_salts[1], stuck_rate,
                           stuck_on_frac, g_max, g_min)
    if noisy:
        tile = CROSSBAR_TILE
        k = torch.arange(K, dtype=torch.int64, device=gp.device)[:, None]
        n = torch.arange(N, dtype=torch.int64, device=gp.device)[None, :]
        salt = (k // tile) * (2 * 65536) + (n // tile) * 2
        local = (k % tile) * tile + (n % tile)
        gp = gp * (1.0 + read_noise * counter_normal_at_ref(
            noise_seed, salt, local))
        gm = gm * (1.0 + read_noise * counter_normal_at_ref(
            noise_seed, salt + 1, local))
    g = gp - gm
    if g_step is not None and not (noisy or stuck):
        g = g * g_step
    if drift != 1.0:
        g = g * drift
    return g


def crossbar_matmul_ref(x: torch.Tensor, gp: torch.Tensor, gm: torch.Tensor,
                        *, inv_scale: float, clamp: Optional[float] = None,
                        **read) -> torch.Tensor:
    """y = clip((x @ G) * inv_scale, -clamp, clamp) with G the read's
    differential conductance (:func:`crossbar_effective_g`, which takes
    ``read``): the plain version of K7 (``kernels/csrc/crossbar_vmm.cu``)."""
    y = (x.to(F32) @ crossbar_effective_g(gp, gm, **read)) * inv_scale
    if clamp is not None:
        y = torch.clamp(y, -clamp, clamp)
    return y


def crossbar_matmul_q_ref(x: torch.Tensor, gp_idx: torch.Tensor,
                          gm_idx: torch.Tensor, g_step: float,
                          inv_scale: float,
                          clamp: Optional[float]) -> torch.Tensor:
    """Quantised-storage variant: uint8 level indices dequantised on the
    fly, ``gp - gm = (idx_p - idx_m) * g_step`` (the G_min offsets cancel
    in the pair)."""
    g = (gp_idx.to(F32) - gm_idx.to(F32)) * g_step
    y = (x.to(F32) @ g) * inv_scale
    if clamp is not None:
        y = torch.clamp(y, -clamp, clamp)
    return y


# ---------------------------------------------------------------------------
# fused analogue RK4 rollout (K4)
# ---------------------------------------------------------------------------

def analogue_read_pairs_ref(gps: Sequence[torch.Tensor],
                            gms: Sequence[torch.Tensor], *, fault: dict,
                            g_step: Optional[float] = None,
                            g_min: float = 0.0, g_max: float = 0.0):
    """Each layer's pair as a noisy read sees it before the noise: absolute
    float32 conductances (uint8 level indices decoded as ``g_min + idx *
    g_step``) with the stuck cells of ``fault`` pinned at their global
    ids.  Returns (G+ per layer, G- per layer)."""
    def absolute(g):
        g = g.to(F32)
        return g_min + g * g_step if g_step is not None else g

    def pin(g, li, pair):
        return pin_stuck_ref(g, fault["fault_seed"],
                             fault["salt_base"] + 2 * li + pair,
                             fault["stuck_rate"], fault["stuck_on_frac"],
                             g_max, g_min)

    gps_a = [absolute(g) for g in gps]
    gms_a = [absolute(g) for g in gms]
    if fault["stuck_rate"] > 0.0:
        gps_a = [pin(g, li, 0) for li, g in enumerate(gps_a)]
        gms_a = [pin(g, li, 1) for li, g in enumerate(gms_a)]
    return gps_a, gms_a


def noisy_pair_ref(gp: torch.Tensor, gm: torch.Tensor, read_noise: float,
                   noise_seed: int, salt: int) -> torch.Tensor:
    """One noisy read of a pair of absolute arrays: ``G+ (1 + s e+) - G-
    (1 + s e-)``, e+ drawn at ``salt`` and e- at ``salt + 1`` over the
    row-major flat ids of the whole array."""
    shape = tuple(gp.shape)
    ep = counter_normal_ref(noise_seed, salt, shape, gp.device)
    em = counter_normal_ref(noise_seed, salt + 1, shape, gp.device)
    return gp * (1.0 + read_noise * ep) - gm * (1.0 + read_noise * em)


def fused_analogue_noisy_pairs_ref(gps: Sequence[torch.Tensor],
                                   gms: Sequence[torch.Tensor], T: int, *,
                                   fault: dict,
                                   g_step: Optional[float] = None,
                                   g_min: float = 0.0, g_max: float = 0.0,
                                   read_noise: float, noise_seed: int,
                                   step_offset: int = 0) -> list:
    """The plain version of K4's read-noise pre-pass
    (``k4_noise_kernel``): the noisy pair S that every evaluation of a
    T-step noisy rollout reads, per layer a (T, 4, in_l + 1, out_l)
    float32 tensor, S[t, stage] salted ``(step_offset + t) * 8L + stage *
    2L + 2 l`` as :func:`fused_analogue_rollout_ref` salts it."""
    gps_a, gms_a = analogue_read_pairs_ref(gps, gms, fault=fault,
                                           g_step=g_step, g_min=g_min,
                                           g_max=g_max)
    L = len(gps_a)
    return [torch.stack([noisy_pair_ref(
        gps_a[li], gms_a[li], read_noise, noise_seed,
        (step_offset + t) * 8 * L + s * 2 * L + 2 * li)
        for t in range(T) for s in range(4)]).reshape(
            T, 4, *gps_a[li].shape) for li in range(L)]


def fused_analogue_rollout_ref(gps: Sequence[torch.Tensor],
                               gms: Sequence[torch.Tensor],
                               scales: torch.Tensor, y0: torch.Tensor,
                               u_half: torch.Tensor, dt: float, *,
                               fault: dict, g_step: Optional[float] = None,
                               g_min: float = 0.0, g_max: float = 0.0,
                               v_clamp: Optional[float] = None,
                               read_noise: float = 0.0, noise_seed: int = 0,
                               step_offset: int = 0) -> torch.Tensor:
    """Analogue RK4 rollout through per-layer crossbar pairs: the plain
    version of K4 (``kernels/csrc/fused_analogue.cu``), in the order of
    the JAX kernel (``repro/kernels/fused_analogue.py:_make_kernel``).

    gps/gms: per layer (K_l + 1, N_l), float32 conductances or uint8 level
    indices, bias as the last row; scales (L,); y0 (B, D); u_half as for
    K1; ``fault`` the full ``FaultModel.kernel_args()`` dict.  Returns
    (T+1, B, D).

    Noise-free, each pair is combined once into ``W = (G+ - G-)[*g_step]
    * (1/scale)`` and a layer is ``x @ W[:-1] + W[-1]``; with read noise
    every evaluation re-draws ``G+ (1 + s e+) - G- (1 + s e-)`` over the
    whole absolute array (:func:`noisy_pair_ref`), salted ``(step_offset
    + t) * 8L + stage * 2L + 2 * layer (+1 for G-)``, and a layer is
    ``(x @ g[:-1] + g[-1]) / scale``.  Then the drift factor ``exp(-nu *
    log1p(n / tau))`` with ``n = drift_n0 + 4 * (step_offset + t)``, then
    the clamp, then ReLU between layers.
    """
    L = len(gps)
    device = y0.device
    inv = [1.0 / scales[li] for li in range(L)]
    stuck = fault["stuck_rate"] > 0.0
    noisy = read_noise > 0.0

    if noisy or stuck:
        gps_a, gms_a = analogue_read_pairs_ref(gps, gms, fault=fault,
                                               g_step=g_step, g_min=g_min,
                                               g_max=g_max)
    if not noisy:
        ws, bs = [], []
        for li in range(L):
            if stuck:
                g = gps_a[li] - gms_a[li]
            else:
                g = gps[li].to(F32) - gms[li].to(F32)
                if g_step is not None:
                    g = g * g_step
            g = g * inv[li]
            ws.append(g[:-1])
            bs.append(g[-1])

    def layer_out(x, li, salt, dfac):
        if noisy:
            g = noisy_pair_ref(gps_a[li], gms_a[li], read_noise, noise_seed,
                               salt)
            y = (x @ g[:-1] + g[-1]) * inv[li]
        else:
            y = x @ ws[li] + bs[li]
        if dfac is not None:
            y = y * dfac
        if v_clamp is not None:
            y = torch.clamp(y, -v_clamp, v_clamp)
        return y

    B = y0.shape[0]

    def f(u, y, salt, dfac):
        if u.shape[-1] > 0:
            if u.ndim == 1:
                u = u[None, :].expand(B, u.shape[0])
            x = torch.cat([u.to(F32), y], dim=-1)
        else:
            x = y
        for li in range(L):
            x = layer_out(x, li, salt + 2 * li, dfac)
            if li < L - 1:
                x = torch.relu(x)
        return x

    u_tm = _time_major(u_half)
    nu, tau = fault["drift_nu"], fault["drift_tau"]
    ys, y = [y0], y0
    for t in range(u_tm.shape[0] // 2):
        step = step_offset + t
        salt = step * 8 * L if noisy else 0
        dfac = None
        if nu > 0.0:
            n = torch.tensor(float(fault["drift_n0"] + 4 * step), dtype=F32,
                             device=device)
            dfac = torch.exp(torch.tensor(-nu, dtype=F32, device=device)
                             * torch.log1p(n / torch.tensor(
                                 tau, dtype=F32, device=device)))
        u0, um, u1 = u_tm[2 * t], u_tm[2 * t + 1], u_tm[2 * t + 2]
        k1 = f(u0, y, salt, dfac)
        k2 = f(um, y + dt / 2 * k1, salt + 2 * L, dfac)
        k3 = f(um, y + dt / 2 * k2, salt + 4 * L, dfac)
        k4 = f(u1, y + dt * k3, salt + 6 * L, dfac)
        y = y + dt / 6 * (k1 + 2 * k2 + 2 * k3 + k4)
        ys.append(y)
    return torch.stack(ys)


# ---------------------------------------------------------------------------
# soft-DTW wavefront (K5 forward, K6 E-matrix backward)
# ---------------------------------------------------------------------------

#: Padding-sentinel threshold of the kernels: a cost at or above it marks
#: a cell outside the (n, m) matrix (real costs are pairwise distances,
#: orders of magnitude below it).
BIG_CUT = BIG * 0.5


def diag_layout(D: torch.Tensor, fill: float = BIG) -> torch.Tensor:
    """(..., n, m) cost matrices -> (..., n+m-1, n) anti-diagonal layout:
    ``layout[k, i]`` holds cell (i, k-i), ``fill`` (BIG) where k-i is
    outside [0, m)."""
    n, m = D.shape[-2], D.shape[-1]
    rows = torch.arange(n, device=D.device)
    j = torch.arange(n + m - 1, device=D.device)[:, None] - rows[None, :]
    valid = (j >= 0) & (j < m)
    vals = D[..., rows[None, :], j.clamp(0, m - 1)]
    return torch.where(valid, vals, torch.full_like(vals, fill))


def undiag_layout(x: torch.Tensor, n: int, m: int) -> torch.Tensor:
    """Inverse of :func:`diag_layout`: (..., n+m-1, n) -> (..., n, m),
    cell (i, j) gathered from ``x[..., i+j, i]``."""
    rows = torch.arange(n, device=x.device)[:, None]
    cols = torch.arange(m, device=x.device)[None, :]
    return x[..., rows + cols, rows]


def softdtw_ref(D: torch.Tensor, gamma: float,
                hard: bool = False) -> torch.Tensor:
    """Accumulated (soft-)DTW cost of a (n, m) distance matrix."""
    return _dtw_scan(D, gamma, _hardmin if hard else _softmin)


def softdtw_batch_ref(D: torch.Tensor, gamma: float,
                      hard: bool = False) -> torch.Tensor:
    """:func:`softdtw_ref` of each (n, m) matrix of a (B, n, m) batch."""
    return _dtw_scan(D, gamma, _hardmin if hard else _softmin)


def _softmin3(a, b, c, gamma: float, inv_g: float):
    """Soft minimum with the minimum subtracted, term by term as K5:
    mn - gamma * log(e^((mn-a)/g) + e^((mn-b)/g) + e^((mn-c)/g))."""
    mn = torch.minimum(torch.minimum(a, b), c)
    s = (torch.exp((mn - a) * inv_g) + torch.exp((mn - b) * inv_g)
         + torch.exp((mn - c) * inv_g))
    return mn - gamma * torch.log(s)


def softdtw_wavefront_ref(dd: torch.Tensor, n: int, m: int, *,
                          gamma: float = 1.0, hard: bool = False,
                          return_r: bool = False):
    """Batched (soft-)DTW from the (B, n+m-1, n) float32 diagonal layout
    of the costs -> (B,), and with ``return_r`` also R in the same layout
    — the plain version of K5 (``kernels/csrc/softdtw.cu``) in the TPU
    kernel's layout; :func:`softdtw_rowmajor_ref` runs it on row-major
    costs.

    Walks the diagonals k = 0 .. n+m-2 as the kernel does: up, left and
    diag are R_{k-1}[i], R_{k-1}[i-1] and R_{k-2}[i-1] (BIG off the
    edge); a cell whose cost is at or above ``BIG_CUT`` is invalid and
    gets R = BIG, the cell (0, 0) takes its cost alone."""
    B, kd = dd.shape[0], dd.shape[1]
    inv_g = 1.0 / gamma
    big = torch.full((B, 1), BIG, dtype=dd.dtype, device=dd.device)
    r1 = big.expand(B, n)                    # R_{k-1}
    r2 = big.expand(B, n)                    # R_{k-2}
    rs = []
    for k in range(kd):
        d_k = dd[:, k]
        left = torch.cat([big, r1[:, :-1]], dim=1)
        diag = torch.cat([big, r2[:, :-1]], dim=1)
        if hard:
            best = torch.minimum(torch.minimum(r1, left), diag)
        else:
            best = _softmin3(r1, left, diag, gamma, inv_g)
        invalid = d_k >= BIG_CUT
        r_k = d_k if k == 0 else d_k + torch.where(
            invalid, torch.zeros_like(best), best)
        r_k = torch.where(invalid, big, r_k)
        rs.append(r_k)
        r1, r2 = r_k, r1
    ans = r1[:, n - 1].contiguous()
    if return_r:
        return ans, torch.stack(rs, dim=1)
    return ans


def softdtw_wavefront_bwd_ref(dd: torch.Tensor, rd: torch.Tensor, n: int,
                              m: int, *, gamma: float = 1.0) -> torch.Tensor:
    """The E-matrix dSDTW/dD in the diagonal layout, (B, n+m-1, n)
    float32 — the plain version of K6 (``kernels/csrc/softdtw.cu``) in
    the TPU kernel's layout (:func:`softdtw_rowmajor_bwd_ref` on row-major
    operands).

    The closed-form reverse DP of Cuturi & Blondel 2017 (Alg. 2), walking
    k = n+m-2 .. 0: the children of cell (i, k-i) sit at layout[k+1, i+1],
    layout[k+1, i] and layout[k+2, i+1], each weighted by
    exp((R_child - R - D_child) / gamma) where its cost is below
    ``BIG_CUT`` and zero otherwise; an invalid cell is zero; E = 1 seeds
    row n-1 of the last diagonal."""
    B, kd = dd.shape[0], dd.shape[1]
    inv_g = 1.0 / gamma
    zero = torch.zeros((B, 1), dtype=dd.dtype, device=dd.device)
    big = torch.full((B, 1), BIG, dtype=dd.dtype, device=dd.device)
    e1 = e2 = zero.expand(B, n)
    r1 = r2 = d1 = d2 = big.expand(B, n)

    def below(x, pad):
        """layout row i -> i+1 (the children one row down)."""
        return torch.cat([x[:, 1:], pad], dim=1)

    def term(ev, rv, dv, r_k):
        w = torch.exp((rv - r_k - dv) * inv_g)
        return torch.where(dv < BIG_CUT, ev * w, torch.zeros_like(w))

    es = [None] * kd
    for k in range(kd - 1, -1, -1):
        d_k, r_k = dd[:, k], rd[:, k]
        e_k = (term(below(e1, zero), below(r1, big), below(d1, big), r_k)
               + term(e1, r1, d1, r_k)
               + term(below(e2, zero), below(r2, big), below(d2, big), r_k))
        e_k = torch.where(d_k < BIG_CUT, e_k, torch.zeros_like(e_k))
        if k == n + m - 2:
            seed = torch.zeros_like(e_k)
            seed[:, n - 1] = 1.0
            e_k = e_k + seed
        es[k] = e_k
        e1, e2, r1, r2, d1, d2 = e_k, e1, r_k, r1, d_k, d1
    return torch.stack(es, dim=1)


def softdtw_rowmajor_ref(D: torch.Tensor, *, gamma: float = 1.0,
                         hard: bool = False, return_r: bool = False):
    """The plain version of K5 on row-major costs: (B, n, m) float32 ->
    (B,), and with ``return_r`` also R (B, n, m).  The diagonal-layout
    plain version on ``diag_layout(D)``, R gathered back: the same cells
    in the same order."""
    n, m = D.shape[1], D.shape[2]
    ans, rd = softdtw_wavefront_ref(diag_layout(D), n, m, gamma=gamma,
                                    hard=hard, return_r=True)
    return (ans, undiag_layout(rd, n, m)) if return_r else ans


def softdtw_rowmajor_bwd_ref(D: torch.Tensor, R: torch.Tensor, *,
                             gamma: float = 1.0) -> torch.Tensor:
    """The plain version of K6 on row-major operands: the E-matrix
    (B, n, m) from the costs D and K5's R, both (B, n, m) float32."""
    n, m = D.shape[1], D.shape[2]
    e_dd = softdtw_wavefront_bwd_ref(diag_layout(D), diag_layout(R), n, m,
                                     gamma=gamma)
    return undiag_layout(e_dd, n, m)


def softdtw_grad_ref(D, gamma: float) -> np.ndarray:
    """Closed-form E-matrix (dSDTW/dD) of one (n, m) cost matrix by the
    reverse DP of Cuturi & Blondel 2017, Alg. 2, in float64 numpy — the
    oracle for K6 and its plain version.

    Pads R and D with +inf borders so every child weight
    exp((R_child - R - D_child) / gamma) vanishes outside the matrix.
    """
    D = np.asarray(D, dtype=np.float64)
    n, m = D.shape
    R = np.full((n, m), np.inf)
    for i in range(n):
        for j in range(m):
            if i == 0 and j == 0:
                R[i, j] = D[i, j]
                continue
            preds = []
            if i > 0:
                preds.append(R[i - 1, j])
            if j > 0:
                preds.append(R[i, j - 1])
            if i > 0 and j > 0:
                preds.append(R[i - 1, j - 1])
            p = np.asarray(preds)
            soft = -gamma * (np.log(np.sum(np.exp(-(p - p.min()) / gamma)))
                             - p.min() / gamma)
            R[i, j] = D[i, j] + soft
    Rp = np.full((n + 1, m + 1), np.inf)
    Rp[:n, :m] = R
    Dp = np.full((n + 1, m + 1), np.inf)
    Dp[:n, :m] = D
    Ep = np.zeros((n + 1, m + 1))
    Ep[n - 1, m - 1] = 1.0
    for k in range(n + m - 3, -1, -1):          # reverse anti-diagonals
        for i in range(max(0, k - m + 1), min(n, k + 1)):
            j = k - i
            acc = 0.0
            for ci, cj in ((i + 1, j), (i, j + 1), (i + 1, j + 1)):
                if np.isfinite(Dp[ci, cj]):
                    acc += Ep[ci, cj] * np.exp(
                        (Rp[ci, cj] - R[i, j] - Dp[ci, cj]) / gamma)
            Ep[i, j] = acc
    return Ep[:n, :m]


# ---------------------------------------------------------------------------
# LM kernels: causal GQA flash attention (K8), selective-SSM scan (K9)
# ---------------------------------------------------------------------------

#: Score of a masked (q, kv) pair in K8 and its plain version (not -inf,
#: as the TPU kernel has it).
ATTN_NEG_INF = -1e30


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, scale: Optional[float] = None) -> torch.Tensor:
    """Plain K8 (port of ``flash_attention_pallas_ref``): dense causal
    softmax attention in float32.  q (B, H, S, d); k (B, Hkv, S, d) and v
    (B, Hkv, S, dv) with Hkv | H, kv head h // (H / Hkv); returns (B, H,
    S, dv) in q's dtype."""
    b, h, s, d = q.shape
    group = h // k.shape[1]
    scale = scale if scale is not None else d ** -0.5
    kk = k.repeat_interleave(group, dim=1).to(F32)
    vv = v.repeat_interleave(group, dim=1).to(F32)
    scores = torch.einsum("bhqd,bhkd->bhqk", q.to(F32), kk) * scale
    mask = torch.ones((s, s), dtype=torch.bool, device=q.device).tril()
    scores.masked_fill_(~mask, ATTN_NEG_INF)
    p = torch.softmax(scores, dim=-1)
    del scores
    return torch.einsum("bhqk,bhkd->bhqd", p, vv).to(q.dtype)


def ssm_scan_ref(dt: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
                 x: torch.Tensor, a: torch.Tensor):
    """Plain K9 (port of ``ssm_scan_ref``), the sequential scan:
    h_t = exp(dt_t A) h_{t-1} + (dt_t x_t) B_t, y_t = <h_t, C_t>.
    dt, x (B, S, DI); b, c (B, S, N); a (DI, N); float32.  Returns
    (y (B, S, DI), h_final (B, DI, N))."""
    bsz, s, di = dt.shape
    h = torch.zeros((bsz, di, a.shape[-1]), dtype=F32, device=dt.device)
    ys = torch.empty((bsz, s, di), dtype=F32, device=dt.device)
    for t in range(s):
        dt_t = dt[:, t]
        da = torch.exp(dt_t[:, :, None] * a)
        dbx = (dt_t * x[:, t])[:, :, None] * b[:, t, None, :]
        h = da * h + dbx
        ys[:, t] = torch.sum(h * c[:, t, None, :], dim=-1)
    return ys, h
