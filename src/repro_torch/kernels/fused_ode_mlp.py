"""Weights-stationary fused neural-ODE solve (port of ``repro/kernels/fused_ode_mlp.py``).

:func:`fused_node_rollout` runs the whole RK4 trajectory of
dy/dt = ReLU-MLP([u(t), y]) for a fleet of twins in ONE launch of the
hand-written Hopper kernel ``csrc/fused_ode_mlp.cu`` (K1): the MLP
weights sit in shared memory for all 4*T evaluations, and the only
device-memory traffic is y0 and the drive in, the trajectory out.  The
kernel's design, and what bounds it, are in the source's header; its
launch (twins per block, threads, shared memory) comes from
:func:`launch_geometry`, which K2 shares.  Widths whose weights do not fit
one block (the paper's 6->512->512->6 scorecard twin) run K1w
(``csrc/fused_wide.cu``) instead: a thread-block cluster of
``WIDE_CLUSTER`` CTAs that split every layer between them
(:func:`wide_geometry`).

Device rule: the plain version :func:`repro_torch.kernels.ref.fused_node_rollout_ref`
runs only for CPU tensors.  CUDA tensors launch the kernel or raise; no
path swaps in the plain version.

Precision policies (JAX's ``precision``): ``"f32"``, ``"bf16_f32acc"``
(weights, drive and trajectory stored as bfloat16, every layer input
rounded to bf16, products summed in float32, a float32 carry rounded
through bf16 once every ``time_chunk`` steps) and ``"bf16"`` (the dot's
sum, the bias add and every RK4 operation rounded too, so the carry is
bf16).  Under a bf16 policy the chunk is where the carry is rounded, so
it changes results: :func:`plan_time_chunk` picks it as the JAX
planner does (pure arithmetic over the widths and the policy's
itemsizes; on the card it stages nothing, :func:`launch_geometry` does
that).  Under f32 ``time_chunk`` changes no bit.  The wide kernel K1w
takes f32 only.
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import NamedTuple, Sequence

import torch

from repro_torch.kernels import ref, work

#: Precision policies of the JAX kernel (see the module docstring).
PRECISIONS = ("f32", "bf16", "bf16_f32acc")

#: The JAX planner's per-cell VMEM budget: it sizes the bf16 policies'
#: rounding chunk (``time_chunk=None``), not any buffer on the card.
DEFAULT_VMEM_BUDGET = 14 * 1024 * 1024

#: Shared memory a Hopper block may use (227 KB of the SM's 256 KB).
SMEM_LIMIT_BYTES = 232_448

#: Streaming multiprocessors of the H100 SXM.
NUM_SMS = 132

#: Twins per block once the fleet fills every SM at that many (the
#: kernels' RT = 4 instantiation); fewer twins get one block each.
FLEET_TWINS_PER_BLOCK = 4

#: Threads a K1 or K2 block may have (K1_MAX_THREADS / K2_MAX_THREADS in
#: the sources); a wider product loops over its lanes.
MAX_THREADS = 512

#: Gradient tiles (4 x 4 entries) one K2 thread holds in registers
#: (K2_MAX_TILES in ``csrc/fused_ode_mlp_bwd.cu``).
MAX_TILES_PER_THREAD = 4

#: Time steps of the drive (and, in K2, of the trajectory and its
#: cotangent) brought into shared memory per load; halved while a block
#: would not fit.
TIME_CHUNK = 16

#: Layers the kernels' argument structs hold (FM_MAX_LAYERS in
#: ``csrc/fused_mlp_eval.cuh``).
MAX_LAYERS = 8

#: Launches of the CUDA kernel in this process (one per kernel launch)
#: under the f32 policy; the bf16 policies count in ``LAUNCHES_BF16`` and
#: ``LAUNCHES_BF16_F32ACC``.
LAUNCHES = 0
LAUNCHES_BF16 = 0
LAUNCHES_BF16_F32ACC = 0

#: CTAs of one thread-block cluster of the wide kernels K1w and K4w
#: (``csrc/fused_wide.cu``): the portable maximum.
WIDE_CLUSTER = 8

#: Words of the wide kernels' per-rank product table (KW_OPS_WORDS).
WIDE_OPS_WORDS = 8 * MAX_LAYERS

#: Launches of K1w in this process (one per wide rollout).
WIDE_LAUNCHES = 0


@dataclasses.dataclass(frozen=True)
class Geometry:
    """How K1 or K2 is launched for one call: ``blocks`` blocks of
    ``threads`` threads, each owning ``twins_per_block`` twins, with
    ``smem_bytes`` of dynamic shared memory and ``time_chunk`` steps of
    rows staged per load.  ``cluster`` > 1 is a wide kernel's launch
    (K1w, K4w): clusters of that many CTAs, each cluster owning
    ``twins_per_block`` twins; ``blocks`` counts CTAs and ``smem_bytes``
    is one CTA's."""
    twins_per_block: int
    threads: int
    blocks: int
    smem_bytes: int
    time_chunk: int
    cluster: int = 1


def default_precision() -> str:
    """``"f32"`` on every device the port runs on.  The JAX package picks
    ``"bf16_f32acc"`` only when its default backend is a TPU; the port
    has no such device, and its card numbers are float32 unless a call
    asks for a bf16 policy."""
    return "f32"


def resolve_precision(precision: str | None) -> str:
    """A policy name, or ``None`` for :func:`default_precision`."""
    if precision is None:
        return default_precision()
    if precision not in PRECISIONS:
        raise ValueError(
            f"unknown precision {precision!r}; have {list(PRECISIONS)}")
    return precision


def precision_dtypes(precision: str):
    """``(store, compute, acc, carry)`` torch dtypes of a resolved policy:
    the stored slabs (weights, biases, drive, trajectory), the products'
    operands, their sums, and the RK4 carry."""
    if precision == "f32":
        return (torch.float32,) * 4
    if precision == "bf16":
        return (torch.bfloat16,) * 4
    if precision == "bf16_f32acc":
        return torch.bfloat16, torch.bfloat16, torch.float32, torch.float32
    raise ValueError(
        f"unknown precision {precision!r}; have {list(PRECISIONS)}")


def _require_float(name: str, x: torch.Tensor,
                   precision: str = "f32") -> None:
    """A non-floating input raises here, naming the input."""
    if not torch.is_floating_point(x):
        store = str(precision_dtypes(precision)[0]).replace("torch.", "")
        raise ValueError(
            f"fused_node_rollout: {name} has non-floating dtype {x.dtype}; "
            f"the precision={precision!r} policy stores {store} — cast "
            f"{name} to a floating dtype first")


class ChunkPlan(NamedTuple):
    """How the JAX kernel streams a T-step horizon through VMEM; its
    ``time_chunk`` is where a bf16 policy rounds the carry."""
    time_chunk: int          # C: RK4 steps per grid cell
    num_chunks: int          # ceil(T / C)
    vmem_bytes: int          # estimated per-cell VMEM footprint


def _itemsizes(precision: str):
    store, _, acc, carry = precision_dtypes(resolve_precision(precision))
    return store.itemsize, acc.itemsize, carry.itemsize


def _rk4_activation_bytes(bt: int, D: int, sizes: Sequence[int],
                          acc_itemsize: int) -> int:
    """VMEM slack of one RK4 step's live temporaries in the JAX kernel:
    ``acc_itemsize * bt * (6 D + max_l(in_l + out_l))``."""
    widest_pair = max(a + b for a, b in zip(sizes[:-1], sizes[1:]))
    return acc_itemsize * bt * (6 * D + widest_pair)


def _param_count(sizes: Sequence[int]) -> int:
    return sum(a * b + b for a, b in zip(sizes[:-1], sizes[1:]))


def _plan(T: int, per_step: int, fixed: int, u_row: int,
          vmem_budget_bytes: int, time_chunk, what: str) -> int:
    """The chunk C of the JAX planners: ``time_chunk`` clamped to [1, T],
    or the most steps of ``per_step`` bytes that fit the budget beside
    ``fixed`` and one drive row."""
    if time_chunk is not None:
        return max(1, min(int(time_chunk), T))
    C = int((vmem_budget_bytes - fixed - u_row) // per_step)
    if C < 1:
        raise ValueError(
            f"{what} need ~{(fixed + per_step + u_row) / 2 ** 20:.1f} MiB "
            f"VMEM (budget {vmem_budget_bytes / 2 ** 20:.1f}); shrink "
            f"batch_tile or the MLP")
    return min(C, T)


def plan_time_chunk(T: int, bt: int, D: int, du: int, per_tile_drive: bool,
                    sizes: Sequence[int],
                    vmem_budget_bytes: int = DEFAULT_VMEM_BUDGET,
                    time_chunk: int | None = None,
                    precision: str = "f32") -> ChunkPlan:
    """The JAX forward planner (``repro/kernels/fused_ode_mlp.py``) over
    the MLP widths ``sizes``: the largest chunk C whose per-cell bytes
    (weights and biases, the (C, bt, D) output slab, the (2C+1)-row drive
    slab at the storage itemsize; the carry; the RK4 activation slack at
    the accumulation itemsize) fit ``vmem_budget_bytes``, or an explicit
    ``time_chunk``, which raises a ``ValueError`` where it would not
    fit."""
    sb, ab, cb = _itemsizes(precision)
    u_width = max(du, 1) * (bt if per_tile_drive else 1)
    fixed = (sb * _param_count(sizes)
             + _rk4_activation_bytes(bt, D, sizes, ab) + cb * bt * D)
    per_step = sb * bt * D + 2 * sb * u_width
    C = _plan(T, per_step, fixed, sb * u_width, vmem_budget_bytes,
              time_chunk, "fused kernel weights + one RK4 step")
    need = fixed + sb * C * bt * D + sb * (2 * C + 1) * u_width
    if need > vmem_budget_bytes:
        raise ValueError(
            f"time_chunk={C} needs ~{need / 2 ** 20:.1f} MiB VMEM "
            f"(budget {vmem_budget_bytes / 2 ** 20:.1f}); shrink "
            f"time_chunk or batch_tile")
    return ChunkPlan(C, -(-T // C), need)


#: Words of the product-descriptor table at the start of a block's shared
#: memory (FM_OPS_WORDS in ``csrc/fused_mlp_eval.cuh``).
OPS_WORDS = 2 * MAX_LAYERS * 8


def _round4(n: int) -> int:
    return (n + 3) & ~3


def ksplit(n: int) -> int:
    """Lanes that split a sum of ``n`` products (``fm_ksplit``): the
    largest power of two <= 8 leaving each lane >= 8 terms.  It fixes
    the summation order of every output, so it depends on ``n`` alone."""
    s = 1
    while s < 8 and 16 * s <= n:
        s *= 2
    return s


def _matvec_lanes(n_red: int, n_out: int) -> int:
    """Threads one product of ``n_red`` terms into ``n_out`` outputs uses
    (``fm_matvec_lanes``): a team of ``ksplit(n_red)`` lanes per 4
    outputs, whole warps."""
    per_warp = 32 // ksplit(n_red)
    groups = -(-n_out // 4)
    return 32 * -(-groups // per_warp)


def weight_floats(sizes: Sequence[int], transposed: bool) -> int:
    """Floats of the shared weight block (``fm_layout``): the table of
    product descriptors (``FM_OPS_WORDS``), then per layer w_l with rows
    padded to 4 floats and b_l padded to 4; K2 adds every w_l^T."""
    pairs = list(zip(sizes[:-1], sizes[1:]))
    n = OPS_WORDS + sum(a * _round4(b) + _round4(b) for a, b in pairs)
    if transposed:
        n += sum(b * _round4(a) for a, b in pairs)
    return n


def _hidden(sizes: Sequence[int]) -> int:
    return max(sizes[1:-1], default=0)


def gradient_tiles(sizes: Sequence[int]) -> int:
    """4 x 4 tiles of K2's gradient: per layer ceil(in/4) + 1 (the bias)
    rows of ceil(out/4)."""
    return sum((-(-a // 4) + 1) * -(-b // 4)
               for a, b in zip(sizes[:-1], sizes[1:]))


def smem_bytes(sizes: Sequence[int], twins_per_block: int = 1,
               time_chunk: int = TIME_CHUNK) -> int:
    """Dynamic shared memory of one K1 block for MLP layer widths
    ``sizes`` (in_0, ..., out_{L-1}): the weight block, and per twin two
    stage inputs, two hidden buffers, the state and the RK4 sum (each
    padded to 4 floats), and ``2 time_chunk + 1`` half-steps of the
    drive."""
    D = sizes[-1]
    du = sizes[0] - D
    act = twins_per_block * (2 * _round4(sizes[0])
                             + 2 * _round4(_hidden(sizes)) + 2 * _round4(D))
    return 4 * (weight_floats(sizes, False) + act
                + _round4((2 * time_chunk + 1) * du * twins_per_block))


def smem_bytes_k2(sizes: Sequence[int], twins_per_block: int = 1,
                  time_chunk: int = TIME_CHUNK) -> int:
    """Dynamic shared memory of one K2 block: the weight block with every
    w_l^T, and per twin the state, adjoint and stage output, four stage
    cotangents, four stage inputs, the step's hidden activations and their
    cotangents for the four stages, ``time_chunk`` rows each of the
    trajectory and its cotangent, and ``2 time_chunk + 1`` half-steps of
    the drive."""
    D4 = _round4(sizes[-1])
    du = sizes[0] - sizes[-1]
    L = len(sizes) - 1
    act = twins_per_block * (7 * D4 + 4 * _round4(sizes[0])
                             + 8 * (L - 1) * _round4(_hidden(sizes))
                             + 2 * time_chunk * D4)
    return 4 * (weight_floats(sizes, True) + act
                + _round4((2 * time_chunk + 1) * du * twins_per_block))


def _threads(sizes: Sequence[int], backward: bool) -> int:
    """Threads of a block: every product's lanes (a wider one loops), and
    in K2 enough threads to own every gradient tile."""
    pairs = list(zip(sizes[:-1], sizes[1:]))
    lanes = max(_matvec_lanes(a, b) for a, b in pairs)
    if backward:
        lanes = max(lanes, *(_matvec_lanes(b, a) for a, b in pairs))
        tiles = gradient_tiles(sizes)
        if tiles > MAX_TILES_PER_THREAD * MAX_THREADS:
            raise ValueError(
                f"fused backward kernel: MLP {tuple(sizes)} has {tiles} "
                f"gradient tiles, over the {MAX_TILES_PER_THREAD} x "
                f"{MAX_THREADS} a block's threads hold")
        lanes = max(lanes, 32 * -(-tiles // (32 * MAX_TILES_PER_THREAD)))
    return min(MAX_THREADS, max(32, lanes))


def _over_limit(sizes, need: int, twins: int, backward: bool,
                what: str) -> ValueError:
    if backward:
        return ValueError(
            f"fused backward kernel: MLP {tuple(sizes)} needs {need:,} B of "
            f"shared memory per block ({twins} twin(s), one time step "
            f"staged), over the 227 KB ({SMEM_LIMIT_BYTES:,} B) per-block "
            f"limit of sm_90; the weights and their transposes must stay "
            f"resident, so this width needs a cluster or a split across "
            f"blocks")
    return ValueError(
        f"{what}: MLP {tuple(sizes)} needs {need:,} B of shared "
        f"memory per block ({twins} twin(s), one time step staged), over "
        f"the 227 KB ({SMEM_LIMIT_BYTES:,} B) per-block limit of sm_90 for "
        f"the resident design; launch_geometry runs this width on the wide "
        f"cluster kernels (wide_geometry)")


def _tiles(B: int, twins_per_block: int | None, blocks_per_twin: int):
    """The twins per block (or per cluster) to try, the wider first: four
    once ``B / 4`` of them cover the card's SMs, else one; a forced 1 or
    4 alone."""
    if twins_per_block is None:
        fleet = (-(-B // FLEET_TWINS_PER_BLOCK) * blocks_per_twin
                 >= NUM_SMS)
        return (FLEET_TWINS_PER_BLOCK, 1) if fleet else (1,)
    if twins_per_block in (1, FLEET_TWINS_PER_BLOCK):
        return (twins_per_block,)
    raise ValueError(
        f"launch_geometry: twins_per_block={twins_per_block}; the "
        f"kernels hold 1 or {FLEET_TWINS_PER_BLOCK}")


def _resident_geometry(B: int, sizes: Sequence[int], backward: bool,
                       twins_per_block: int | None, weight_blocks: int):
    """The resident kernels' launch (K1, K2, K4: all weights in one
    block), or ``(None, need, tile)`` with the bytes of the last choice
    tried when none fits the 227 KB a block may use."""
    if B < 1:
        raise ValueError(f"launch_geometry: B={B} twins")
    smem_of = smem_bytes_k2 if backward else smem_bytes
    tiles = _tiles(B, twins_per_block, 1)
    for rt in tiles:
        tc = TIME_CHUNK
        while True:
            need = smem_of(sizes, rt, tc) + 4 * (weight_blocks - 1) * \
                weight_floats(sizes, backward)
            if need <= SMEM_LIMIT_BYTES:
                return Geometry(rt, _threads(sizes, backward), -(-B // rt),
                                need, tc), need, rt
            if tc == 1:
                break
            tc //= 2
    return None, need, tiles[-1]


def launch_geometry(B: int, sizes: Sequence[int], *, backward: bool = False,
                    twins_per_block: int | None = None, weight_blocks: int = 1,
                    what: str = "fused kernel") -> Geometry:
    """The launch of K1 (or, with ``backward``, K2) for ``B`` twins of MLP
    widths ``sizes``.  One twin per block while ``B`` leaves SMs idle at
    four (every training shape gets B blocks); ``FLEET_TWINS_PER_BLOCK``
    twins per block once ``B / 4`` blocks cover the card's SMs, so each
    weight read from shared memory feeds four twins.  The time chunk is
    ``TIME_CHUNK`` steps, halved while the block would not fit.
    ``twins_per_block`` (1 or 4) forces the tile, as the checks that a
    trajectory does not depend on the geometry do.  ``weight_blocks`` = 2
    adds a second weight block (K4's double buffer under read noise);
    ``what`` names the kernel in the error.  Where no resident choice fits
    the 227 KB a block may use, the forward goes to the wide kernels'
    cluster launch (:func:`wide_geometry`, which raises above its own
    limit); K2 raises a ``ValueError``: its weights and their transposes
    stay resident."""
    geom, need, tile = _resident_geometry(B, sizes, backward,
                                          twins_per_block, weight_blocks)
    if geom is not None:
        return geom
    if backward:
        raise _over_limit(sizes, need, tile, True, what)
    return wide_geometry(B, sizes, twins_per_block=twins_per_block, what=what)


def check_smem_fit(sizes: Sequence[int]) -> int:
    """Raise a ``ValueError`` when one resident K1 block (one twin, one
    time step staged) exceeds the 227 KB a Hopper block may use; returns
    the bytes of one twin and ``TIME_CHUNK`` steps, or of fewer steps
    where that is what fits.  (Such widths run K1w: :func:`wide_geometry`
    has its own check.)"""
    geom, need, tile = _resident_geometry(1, sizes, False, None, 1)
    if geom is None:
        raise _over_limit(sizes, need, tile, False, "fused kernel")
    return geom.smem_bytes


# ---------------------------------------------------------------------------
# The wide kernels K1w / K4w (csrc/fused_wide.cu): thread-block clusters
# ---------------------------------------------------------------------------

def _wide_slice(n: int) -> int:
    """Columns (or rows) of a hidden width ``n`` one CTA of the cluster
    owns: ceil(n / WIDE_CLUSTER), padded to 4."""
    return _round4(-(-n // WIDE_CLUSTER))


def _wide_count(n: int, q: int, rank: int) -> int:
    return max(0, min(q, n - rank * q))


def wide_smem_bytes(sizes: Sequence[int], twins_per_block: int = 1,
                    time_chunk: int = TIME_CHUNK) -> int:
    """Dynamic shared memory of one CTA of K1w / K4w (``kw_smem_floats``):
    the per-rank product table; layer 0 whole (rows padded to 4 floats,
    then the bias); a hidden-to-hidden layer's in_l rows of its column
    slice and the slice's bias; the last layer's rows of the CTA's slice of
    the last hidden vector and the whole last bias; then per twin the stage
    input, a whole hidden vector, two hidden slices, the last layer's
    partials of two stages, the state and the RK4 sum; and ``2 time_chunk
    + 1`` half-steps of the drive."""
    L = len(sizes) - 1
    q = [0] + [_wide_slice(n) for n in sizes[1:-1]]
    n = WIDE_OPS_WORDS
    for li, (a, b) in enumerate(zip(sizes[:-1], sizes[1:])):
        if li == 0:
            n += (a + 1) * _round4(b)
        elif li == L - 1:
            n += (q[li] + 1) * _round4(b)
        else:
            n += (a + 1) * q[li + 1]
    hfull = _round4(max(sizes[1:max(2, L - 1)]))
    qmax = max(q[2:L], default=0)
    D4 = _round4(sizes[-1])
    du = sizes[0] - sizes[-1]
    act = twins_per_block * (_round4(sizes[0]) + hfull + 2 * qmax + 4 * D4)
    return 4 * (n + act + _round4((2 * time_chunk + 1) * du
                                  * twins_per_block))


def _wide_threads(sizes: Sequence[int], rt: int) -> int:
    """Threads of a wide CTA: every product's lanes for each of its ``rt``
    twins (so each product gives a twin its own lanes), whole warps, at
    most ``MAX_THREADS``."""
    L = len(sizes) - 1
    q = [0] + [_wide_slice(n) for n in sizes[1:-1]]
    lanes = _matvec_lanes(sizes[0], sizes[1])
    for rank in range(WIDE_CLUSTER):
        for li in range(1, L):
            if li < L - 1:
                n_red = sizes[li]
                n_out = _wide_count(sizes[li + 1], q[li + 1], rank)
            else:
                n_red = _wide_count(sizes[li], q[li], rank)
                n_out = sizes[-1]
            if n_out:
                lanes = max(lanes, _matvec_lanes(n_red, n_out))
    return min(MAX_THREADS, max(32, rt * lanes))


def wide_geometry(B: int, sizes: Sequence[int], *,
                  twins_per_block: int | None = None,
                  what: str = "fused kernel") -> Geometry:
    """The cluster launch of K1w / K4w for ``B`` twins of MLP widths
    ``sizes``: clusters of ``WIDE_CLUSTER`` CTAs, each cluster owning one
    twin, or four once ``B / 4`` clusters of CTAs cover the card's SMs; the
    time chunk halved while a CTA would not fit.  K4w takes the same launch
    clean and under read noise (the noisy pairs stream into the weights'
    own buffers).  Raises a ``ValueError`` when the MLP has no hidden
    layer or one CTA's slices exceed the 227 KB a block may use: the
    widest square twin it holds is 6->640->640->6 at one twin per cluster
    (6->512->512->6 needs 150,720 B per CTA at one twin, 158,880 B at
    four)."""
    if B < 1:
        raise ValueError(f"wide_geometry: B={B} twins")
    cluster = WIDE_CLUSTER
    if len(sizes) < 3:
        raise ValueError(
            f"{what}: MLP {tuple(sizes)} does not fit one block and has no "
            f"hidden layer for the {cluster}-CTA cluster variant to split")
    tiles = _tiles(B, twins_per_block, cluster)
    for rt in tiles:
        tc = TIME_CHUNK
        while True:
            need = wide_smem_bytes(sizes, rt, tc)
            if need <= SMEM_LIMIT_BYTES:
                return Geometry(rt, _wide_threads(sizes, rt),
                                -(-B // rt) * cluster, need, tc, cluster)
            if tc == 1:
                break
            tc //= 2
    raise ValueError(
        f"{what}: MLP {tuple(sizes)} needs {need:,} B of shared memory per "
        f"CTA of the {cluster}-CTA cluster variant ({tiles[-1]} twin(s) per "
        f"cluster, one time step staged), over the 227 KB "
        f"({SMEM_LIMIT_BYTES:,} B) per-block limit of sm_90: wider than the "
        f"cluster variant holds")


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


#: The policy argument of ``k1_fused_node_rollout`` per precision policy.
_POLICY_CODES = {"f32": 0, "bf16_f32acc": 1, "bf16": 2}


def _launch(y0, u_half, weights, biases, dt, per_twin, T, du, sizes,
            geom: Geometry, precision: str = "f32", C: int | None = None):
    """Launch K1 (K1w for a cluster ``geom``, f32 only) on the current
    stream at ``geom`` under ``precision``, the carry rounded every ``C``
    steps under a bf16 policy: y0 float32, the drive, weights and biases
    at the policy's storage dtype; returns the (T+1, B, D) trajectory at
    that dtype.  Counts the launch in the policy's counter."""
    global LAUNCHES, LAUNCHES_BF16, LAUNCHES_BF16_F32ACC
    if geom.cluster > 1:
        return _launch_wide(y0, u_half, weights, biases, dt, per_twin, T, du,
                            sizes, geom)
    from repro_torch.kernels import _build
    fn = _build.load("fused_ode_mlp").k1_fused_node_rollout
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 5
                   + [ctypes.c_longlong] + [ctypes.c_float] * 3
                   + [ctypes.c_int] * 5 + [ctypes.c_longlong, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    B, D = y0.shape
    L = len(weights)
    store = precision_dtypes(precision)[0]
    out = torch.empty((T + 1, B, D), dtype=store, device=y0.device)
    w_ptrs = (ctypes.c_void_p * L)(*[w.data_ptr() for w in weights])
    b_ptrs = (ctypes.c_void_p * L)(*[b.data_ptr() for b in biases])
    c_sizes = (ctypes.c_int * (L + 1))(*sizes)
    u_ptr = u_half.data_ptr() if du > 0 else None
    u_twin_stride = (2 * T + 1) * du if per_twin else 0
    c2, c1, c6 = ref.rk4_consts(float(dt), precision == "bf16")
    with torch.cuda.device(y0.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(y0.data_ptr(), u_ptr, out.data_ptr(),
                 ctypes.addressof(w_ptrs), ctypes.addressof(b_ptrs),
                 ctypes.addressof(c_sizes), L, B, T, D, du, u_twin_stride,
                 c1, c2, c6, _POLICY_CODES[precision], C or max(T, 1),
                 geom.twins_per_block, geom.threads, geom.time_chunk,
                 geom.smem_bytes, stream)
    if err != 0:
        raise RuntimeError(
            f"fused_node_rollout: CUDA kernel launch failed with "
            f"cudaError_t {err} (precision={precision!r}, B={B}, T={T}, "
            f"sizes={tuple(sizes)}, {geom})")
    if precision == "f32":
        LAUNCHES += 1
    elif precision == "bf16":
        LAUNCHES_BF16 += 1
    else:
        LAUNCHES_BF16_F32ACC += 1
    return out


def _launch_wide(y0, u_half, weights, biases, dt, per_twin, T, du, sizes,
                 geom: Geometry):
    """Launch K1w on the current stream at the cluster ``geom``."""
    global WIDE_LAUNCHES
    from repro_torch.kernels import _build
    fn = _build.load("fused_wide").k1w_fused_node_rollout_f32
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 5
                   + [ctypes.c_longlong] + [ctypes.c_float] * 3
                   + [ctypes.c_int] * 4 + [ctypes.c_longlong, ctypes.c_void_p])
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
                 dt64, dt64 / 2, dt64 / 6, geom.cluster, geom.twins_per_block,
                 geom.threads, geom.time_chunk, geom.smem_bytes, stream)
    if err != 0:
        raise RuntimeError(
            f"fused_node_rollout: the wide cluster kernel K1w failed to "
            f"launch with cudaError_t {err} (B={B}, T={T}, "
            f"sizes={tuple(sizes)}, {geom})")
    WIDE_LAUNCHES += 1
    return out


def rollout_work(sizes: Sequence[int], B: int, T: int, u_numel: int,
                 store_itemsize: int = 4):
    """(FLOP, bytes) of one rollout of ``B`` twins over ``T`` steps: the
    MLP's products for every twin and RK4 evaluation; y0 (float32), the
    drive and the weights read once, the trajectory written once, the last
    three at the policy's storage itemsize (2 under the bf16 policies)."""
    pairs = list(zip(sizes[:-1], sizes[1:]))
    macs = sum(a * b for a, b in pairs)
    params = sum(a * b + b for a, b in pairs)
    return (2.0 * macs * 4 * T * B,
            4.0 * B * sizes[-1] + float(store_itemsize)
            * (u_numel + params + (T + 1) * B * sizes[-1]))


def _rollout_args(y0, u_half, weights, biases, precision: str = "f32"):
    """Validate a rollout's inputs; returns ``(y0, u_half, per_twin, T,
    du, sizes)`` with a zero-width per-twin drive folded to a shared one."""
    _require_float("y0", y0, precision)
    _require_float("u_half", u_half, precision)
    for li, (w, b) in enumerate(zip(weights, biases)):
        _require_float(f"weights[{li}]", w, precision)
        _require_float(f"biases[{li}]", b, precision)
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
    sizes = [weights[0].shape[0]] + [w.shape[1] for w in weights]
    if sizes[0] != du + D or sizes[-1] != D:
        raise ValueError(
            f"fused_node_rollout: MLP {tuple(sizes)} does not map "
            f"[u (Du={du}), y (D={D})] to dy/dt (D={D})")
    return y0, u_half, per_twin, T, du, sizes


def fused_node_rollout(
    y0: torch.Tensor,                 # (B, D) float
    u_half: torch.Tensor,             # (2T+1, Du) shared or (B, 2T+1, Du)
    weights: Sequence[torch.Tensor],
    biases: Sequence[torch.Tensor],
    dt: float,
    *,
    batch_tile: int = 64,
    time_chunk: int | None = None,
    precision: str | None = None,
) -> torch.Tensor:
    """Full-trajectory RK4 solve; returns (T+1, B, D) at the policy's
    storage dtype (float32, or bfloat16 under a bf16 policy), row 0 = y0.

    ``u_half`` is the drive sampled at RK4 half-steps: (2T+1, Du) shared
    by the whole fleet, or (B, 2T+1, Du) with one stimulus per twin; Du
    may be 0 (autonomous).  B must divide by ``batch_tile``
    (:func:`pad_fleet_to_tile` pads a fleet up to it).  Floating inputs
    are cast to the policy's dtypes; a non-floating input raises a
    ``ValueError`` naming it.  ``precision`` (None = :func:`default_precision`)
    picks the policy; under a bf16 one the carry is rounded every
    ``time_chunk`` steps (None: :func:`plan_time_chunk`'s pick for
    ``batch_tile`` at ``DEFAULT_VMEM_BUDGET``, as the JAX kernel plans
    it by default).  CPU tensors take the plain version, CUDA tensors the kernel at
    :func:`launch_geometry` (K1w above one block, f32 only); any other
    placement raises.  The call reports its work to
    :mod:`repro_torch.kernels.work`.
    """
    precision = resolve_precision(precision)
    y0, u_half, per_twin, T, du, sizes = _rollout_args(y0, u_half, weights,
                                                       biases, precision)
    B = y0.shape[0]
    bt = min(batch_tile, B)
    if B % bt:
        raise ValueError(f"batch {B} not divisible by tile {bt}")
    geom = launch_geometry(B, sizes)
    if precision != "f32":
        C = plan_time_chunk(T, bt, sizes[-1], du, per_twin, sizes,
                            time_chunk=time_chunk,
                            precision=precision).time_chunk
        return _rollout_bf16(y0, u_half, weights, biases, dt, per_twin, T,
                             du, sizes, geom, precision, C)

    L = len(weights)
    device, (y0, u_half, *wb) = placed_f32(
        "fused_node_rollout", [y0, u_half, *weights, *biases], L)
    weights, biases = wb[:L], wb[L:]
    work.report("K1w" if geom.cluster > 1 else "K1",
                *rollout_work(sizes, B, T, u_half.numel()))
    if device.type == "cpu":
        with work.uncounted():
            return ref.fused_node_rollout_ref(y0, u_half, weights, biases,
                                              float(dt))
    return _launch(y0, u_half, weights, biases, dt, per_twin, T, du, sizes,
                   geom)


def _rollout_bf16(y0, u_half, weights, biases, dt, per_twin, T, du, sizes,
                  geom: Geometry, precision: str, C: int):
    """K1 under a bf16 policy with the carry rounded every ``C`` steps:
    the plain version for CPU tensors, the kernel for CUDA tensors."""
    if geom.cluster > 1:
        raise NotImplementedError(
            f"precision={precision!r} at MLP {tuple(sizes)}: the wide "
            f"cluster kernel K1w takes the f32 policy only (ROADMAP.md, "
            f"queue 2 A1); use precision='f32'")
    device, (y0, u_half, weights, biases) = placed_bf16(
        "fused_node_rollout", y0, u_half, weights, biases)
    work.report("K1", *rollout_work(sizes, y0.shape[0], T, u_half.numel(),
                                    store_itemsize=2))
    if device.type == "cpu":
        with work.uncounted():
            return ref.fused_node_rollout_bf16_ref(
                y0, u_half, weights, biases, float(dt), precision, C)
    return _launch(y0, u_half, weights, biases, dt, per_twin, T, du, sizes,
                   geom, precision, C)


def fused_node_rollout_at(geom: Geometry, y0: torch.Tensor,
                          u_half: torch.Tensor,
                          weights: Sequence[torch.Tensor],
                          biases: Sequence[torch.Tensor],
                          dt: float) -> torch.Tensor:
    """K1 on CUDA tensors at an explicit ``geom`` (from
    :func:`launch_geometry`, e.g. with ``twins_per_block=1``; K1w at a
    cluster geometry from :func:`wide_geometry`): for checks that a
    trajectory does not depend on the launch geometry."""
    y0, u_half, per_twin, T, du, sizes = _rollout_args(y0, u_half, weights,
                                                       biases)
    L = len(weights)
    device, (y0, u_half, *wb) = placed_f32(
        "fused_node_rollout_at", [y0, u_half, *weights, *biases], L)
    if device.type != "cuda":
        raise ValueError("fused_node_rollout_at: the kernel runs on CUDA")
    return _launch(y0, u_half, wb[:L], wb[L:], dt, per_twin, T, du, sizes,
                   geom)


def _one_device(caller: str, tensors: Sequence[torch.Tensor],
                num_layers: int) -> torch.device:
    """The one device all ``tensors`` lie on.  The CPU (plain versions) and
    CUDA (kernels) are accepted; inputs on several devices, on any other
    device, or an MLP deeper than the kernels' argument struct on CUDA
    raise."""
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
    return device


def placed_f32(caller: str, tensors: Sequence[torch.Tensor],
               num_layers: int):
    """The one device all ``tensors`` lie on (:func:`_one_device`), and the
    tensors as contiguous float32."""
    device = _one_device(caller, tensors, num_layers)
    return device, [x.to(torch.float32).contiguous() for x in tensors]


def placed_bf16(caller: str, y0, u_half, weights, biases):
    """The device of a bf16 rollout's inputs (:func:`_one_device`), y0 as
    contiguous float32 (the seed is rounded in the kernel) and the drive,
    weights and biases as contiguous bfloat16 (the policies' storage)."""
    device = _one_device(caller, [y0, u_half, *weights, *biases],
                         len(weights))
    bf = torch.bfloat16
    return device, (y0.to(torch.float32).contiguous(),
                    u_half.to(bf).contiguous(),
                    [w.to(bf).contiguous() for w in weights],
                    [b.to(bf).contiguous() for b in biases])
