"""Sharding rules: twin-fleet placement and the LM logical-axis rules
(port of ``repro/launch/sharding.py``).

**Twin fleets** (:mod:`repro_torch.launch.fleet_serving`) split one axis
only, the fleet dimension: ``fleet_batch_spec`` puts dim 0 of every
request tensor (initial conditions, per-twin drive parameters) on the
``"twins"`` mesh axis, and ``fleet_param_shardings`` replicates the
trained weights onto every device.  A neural-ODE rollout is
embarrassingly parallel across fleet members, so nothing else is split.

**Placement.**  :class:`PartitionSpec` (a tuple, printed as JAX prints
its own) names a mesh axis, a tuple of axes or ``None`` per tensor
dimension; :class:`NamedSharding` pairs it with a
:class:`~repro_torch.launch.mesh.Mesh`.  What is placed on a one-axis
mesh is a :class:`Placed`: the object as each mesh position holds it.
:func:`device_put` places a tensor tree by such shardings (a dimension
named by the axis cut into equal blocks; a replicated leaf copied once
per distinct device) and :func:`replicate` copies any object (a
programmed substrate) whole; ``Placed.gather()`` puts the whole object
back together.  The LM rules' meshes are shape only and are never
placed on.

**LM rules** (the roofline dry-run's, word for word): every parameter
leaf is matched by (leaf name, rank) to an ordered list of
tensor-parallel candidate dims; the first dim divisible by the mesh's
``"model"`` axis wins.  A second pass gives the ``"data"`` axis,
FSDP-style, to the largest remaining dim at or above the threshold.  The
``"pod"`` axis stays pure data parallelism.  The port's trees are nested
dicts, lists and NamedTuples; a leaf's path is the tuple of its dict keys,
field names and indices (:func:`repro_torch.tree.tree_map_with_path`),
and its name the last dict key or field name, as ``_leaf_name`` reads it.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any

import torch

from repro_torch.launch.mesh import TWIN_AXIS, Mesh, axis_size, batch_axes
from repro_torch.tree import tree_leaves, tree_map, tree_map_with_path

Pytree = Any


class PartitionSpec(tuple):
    """Per tensor dimension: a mesh axis name, a tuple of names (split
    jointly, the first one major) or ``None`` (not split).  As in JAX, a
    one-name tuple is that name and an empty one is ``None``."""

    def __new__(cls, *parts):
        def canon(p):
            if isinstance(p, (tuple, list)):
                return None if not p else p[0] if len(p) == 1 else tuple(p)
            return p
        return super().__new__(cls, tuple(canon(p) for p in parts))

    def __repr__(self) -> str:
        return f"PartitionSpec({', '.join(repr(p) for p in self)})"


P = PartitionSpec


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    mesh: Mesh
    spec: PartitionSpec

    def __post_init__(self):
        object.__setattr__(self, "spec", PartitionSpec(*self.spec))


class Placed(tuple):
    """An object placed on a one-axis mesh: one entry per mesh position,
    the object as that position's device holds it.  Positions that share
    a device share one copy of each block (four shards on one card hold
    one copy of a replicated weight).

    ``shardings`` is the tree of :class:`NamedSharding` that placed a
    tensor tree (:func:`device_put`), or None for an object copied whole
    to every device (:func:`replicate`)."""

    def __new__(cls, entries, mesh, shardings=None):
        self = super().__new__(cls, entries)
        self.mesh, self.shardings = mesh, shardings
        return self

    def gather(self, device=None):
        """The whole object on ``device`` (default: the first position's):
        each split leaf put back together from its blocks, anything
        replicated taken from the first copy (itself, when it is there
        already)."""
        dev = self.mesh.devices[0] if device is None else torch.device(device)
        if self.shardings is None:
            return to_device(self[0], dev)
        n = len(self)

        def leaf(sharding, *blocks):
            if all(e is None for e in sharding.spec):     # replicated
                return blocks[0].to(dev)
            shape = list(blocks[0].shape)
            for d, entry in enumerate(sharding.spec):
                if entry is not None:
                    shape[d] *= n
            out = torch.empty(shape, dtype=blocks[0].dtype, device=dev)
            for k, b in enumerate(blocks):
                out[_block(sharding, shape, k)] = b.to(dev)
            return out
        return tree_map(leaf, self.shardings, *self)


def _mesh_axis(mesh: Mesh) -> str:
    if not mesh.devices:
        raise ValueError(
            f"device_put: mesh {mesh.shape} has no devices (shape only)")
    if len(mesh.axis_names) != 1:
        raise ValueError(
            f"device_put: the port places on one-axis meshes, got "
            f"{mesh.shape}")
    return mesh.axis_names[0]


def _block(sharding: NamedSharding, shape, k: int) -> tuple:
    """The index of mesh position ``k``'s block of a ``shape`` tensor: a
    dimension whose spec names the mesh's axis is cut into equal blocks,
    every other one is whole."""
    mesh, spec = sharding.mesh, sharding.spec
    axis, n = _mesh_axis(mesh), mesh.axis_sizes[0]
    if len(spec) > len(shape):
        raise ValueError(
            f"{spec} has {len(spec)} entries for a rank-{len(shape)} tensor")
    if sum(e is not None for e in spec) > 1:
        raise ValueError(f"{spec}: the axis {axis!r} splits one dimension")
    index = []
    for d, size in enumerate(shape):
        entry = spec[d] if d < len(spec) else None
        if entry is None:
            index.append(slice(None))
            continue
        if entry != axis:
            raise ValueError(f"{spec}: mesh {mesh.shape} has no axis {entry!r}")
        if size % n:
            raise ValueError(
                f"{spec}: dim {d} of size {size} does not split {n} ways")
        step = size // n
        index.append(slice(k * step, (k + 1) * step))
    return tuple(index)


def device_put(tree: Pytree, shardings) -> Placed:
    """Place every leaf of ``tree`` by ``shardings`` (one
    :class:`NamedSharding` for all leaves, or a tree of them with
    ``tree``'s structure, all on one mesh): the :class:`Placed` tree of
    every mesh position, its blocks on its device."""
    if isinstance(shardings, NamedSharding):
        shardings = tree_map(lambda _: shardings, tree)
    meshes = {s.mesh for s in tree_leaves(shardings)}
    if len(meshes) != 1:
        raise ValueError(f"device_put: the shardings name {len(meshes)} "
                         f"meshes; place on one")
    mesh = meshes.pop()
    _mesh_axis(mesh)
    copies = {}

    def leaf(k, x, sharding):
        x = torch.as_tensor(x)
        index = _block(sharding, tuple(x.shape), k)
        key = (id(x), str(mesh.devices[k]),
               tuple((s.start, s.stop) for s in index))
        if key not in copies:
            copies[key] = x[index].to(mesh.devices[k]).clone()
        return copies[key]
    return Placed([tree_map(functools.partial(leaf, k), tree, shardings)
                   for k in range(len(mesh.devices))], mesh, shardings)


def to_device(obj, device):
    """``obj`` with every tensor it holds on ``device``: tensors, dicts,
    lists, tuples (NamedTuples such as a backend's ``ExecState``) and
    dataclass instances (a programmed vector field, a repair report) are
    walked; anything else (a drive callable, a float) is kept, since the
    vector field moves a drive's output to the state's device
    (:func:`repro_torch.core.node.field_input`).  A tensor already there
    is kept as it is, not copied."""
    if isinstance(obj, torch.Tensor):
        return obj.to(device)
    if isinstance(obj, dict):
        return {k: to_device(v, device) for k, v in obj.items()}
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return type(obj)(*[to_device(v, device) for v in obj])
    if isinstance(obj, (list, tuple)):
        return type(obj)(to_device(v, device) for v in obj)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        moved = {f.name: to_device(getattr(obj, f.name), device)
                 for f in dataclasses.fields(obj) if f.init}
        if all(moved[k] is getattr(obj, k) for k in moved):
            return obj
        return dataclasses.replace(obj, **moved)
    return obj


def tensor_leaves(obj) -> list:
    """Every tensor ``obj`` holds, walked as :func:`to_device` walks it."""
    if isinstance(obj, torch.Tensor):
        return [obj]
    if isinstance(obj, dict):
        obj = list(obj.values())
    elif dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        obj = [getattr(obj, f.name) for f in dataclasses.fields(obj)]
    if isinstance(obj, (list, tuple)):
        return [x for v in obj for x in tensor_leaves(v)]
    return []


def replicate(obj, mesh: Mesh) -> Placed:
    """``obj`` copied whole to every position of ``mesh``, once per
    distinct device (weights-stationary placement of a programmed
    substrate, made once)."""
    _mesh_axis(mesh)
    copies = {}
    for d in mesh.devices:
        if d not in copies:
            copies[d] = to_device(obj, d)
    return Placed([copies[d] for d in mesh.devices], mesh)


# ---------------------------------------------------------------------------
# Twin-fleet serving specs
# ---------------------------------------------------------------------------

def fleet_batch_spec(ndim: int) -> PartitionSpec:
    """PartitionSpec splitting dim 0 (the fleet axis) on ``"twins"``."""
    return P(TWIN_AXIS, *([None] * (ndim - 1)))


def fleet_input_shardings(mesh, tree: Pytree) -> Pytree:
    """NamedShardings placing request tensors (y0s, thetas, ...) with
    their leading fleet dimension split across the twin mesh."""
    return tree_map(
        lambda x: NamedSharding(mesh, fleet_batch_spec(len(x.shape))), tree)


def fleet_param_shardings(mesh, params: Pytree) -> Pytree:
    """NamedShardings replicating the trained twin weights on every
    device (weights-stationary serving: each device keeps a full copy)."""
    return replicated(mesh, params)


# ---------------------------------------------------------------------------
# LM logical-axis rules (roofline dry-run)
# ---------------------------------------------------------------------------

# (leaf name, rank) -> ordered TP candidate dims (stack axis not counted)
MODEL_DIM_PREFS = {
    ("embed", 2): [0], ("head", 2): [0],
    # canonical Megatron flow: shard q heads; kv heads replicate when they
    # don't divide (NO head_dim fallback — contracting a sharded head_dim
    # turns every flash score tile into a partial-sum all-reduce)
    ("wq", 3): [1], ("wk", 3): [1], ("wv", 3): [1],
    ("wo", 3): [0],
    ("bq", 2): [0], ("bk", 2): [0], ("bv", 2): [0],
    # MLA
    ("w_dkv", 2): [0], ("w_uk", 3): [1], ("w_uv", 3): [1],
    ("w_kr", 2): [], ("w_dq", 2): [0], ("w_uq", 3): [1],
    # dense MLP
    ("w_up", 2): [1], ("w_gate", 2): [1], ("w_down", 2): [0],
    # MoE (expert parallelism on the expert axis)
    ("router", 2): [1],
    ("w_up", 3): [0], ("w_gate", 3): [0], ("w_down", 3): [0],
    ("sh_up", 2): [1], ("sh_gate", 2): [1], ("sh_down", 2): [0],
    # Mamba
    ("in_proj", 2): [1], ("conv_w", 2): [1], ("conv_b", 1): [0],
    ("x_proj", 2): [0], ("dt_proj", 2): [1], ("dt_bias", 1): [0],
    ("A_log", 2): [0], ("D", 1): [0], ("out_proj", 2): [0],
    # xLSTM
    ("up", 2): [1], ("down", 2): [0], ("up_gate", 2): [1],
    ("wi", 2): [0], ("wf", 2): [0], ("gn", 1): [], ("r", 3): [1, 2],
    ("wx", 2): [1], ("b", 1): [],
    # norms / misc (replicated)
    ("scale", 1): [], ("bias", 1): [], ("q_norm", 1): [], ("k_norm", 1): [],
    ("dt_norm", 1): [], ("b_norm", 1): [], ("c_norm", 1): [],
}

# KV / state cache leaves: TP candidates per name
CACHE_MODEL_PREFS = {
    "k": [2, 3], "v": [2, 3],        # (B, S, kv_heads, hd)
    "k_scale": [2], "v_scale": [2],  # int8-cache scales (B, S, kv, 1)
    "ckv": [2], "k_rope": [2],       # (B, S, lora/rope)
    "ssm": [1], "conv": [2],         # (B, di, N) / (B, k-1, di)
}


def _leaf_name(path) -> str:
    for entry in reversed(path):
        if isinstance(entry, str):
            return entry
    return ""


def _is_stacked(path) -> bool:
    return any(isinstance(e, str) and e == "stack" for e in path)


_ATTN_LEAVES = {"wq", "wk", "wv", "wo", "bq", "bk", "bv", "w_dkv", "w_uk",
                "w_uv", "w_kr", "w_dq", "w_uq", "q_norm", "k_norm"}


def param_spec(path, shape, mesh, *, fsdp_threshold: int = 2048,
               no_attn_tp: bool = False) -> PartitionSpec:
    """PartitionSpec for one parameter leaf."""
    name = _leaf_name(path)
    stacked = _is_stacked(path)
    off = 1 if stacked else 0
    rank = len(shape) - off
    model = axis_size(mesh, "model")
    data = axis_size(mesh, "data")

    spec = [None] * len(shape)
    prefs = MODEL_DIM_PREFS.get((name, rank))
    if prefs is None:
        prefs = []                       # unknown leaf -> replicate TP
    if no_attn_tp and name in _ATTN_LEAVES:
        prefs = []                       # replicate attn over the TP axis
    model_dim = None
    for d in prefs:
        dd = d + off
        if shape[dd] % model == 0 and shape[dd] >= model:
            spec[dd] = "model"
            model_dim = dd
            break

    # FSDP: largest remaining dim divisible by `data` and big enough
    if data > 1:
        cands = [d for d in range(off, len(shape))
                 if d != model_dim and shape[d] % data == 0
                 and shape[d] >= fsdp_threshold]
        if cands:
            best = max(cands, key=lambda d: shape[d])
            spec[best] = "data"
    return P(*spec)


def param_shardings(mesh, params_tree: Pytree,
                    fsdp_threshold: int = 2048,
                    no_attn_tp: bool = False) -> Pytree:
    """NamedSharding tree matching a (shape-only or concrete) params tree."""
    def leaf(path, x):
        return NamedSharding(mesh, param_spec(
            path, x.shape, mesh, fsdp_threshold=fsdp_threshold,
            no_attn_tp=no_attn_tp))
    return tree_map_with_path(leaf, params_tree)


def opt_state_shardings(mesh, opt_shapes,
                        no_attn_tp: bool = False) -> Pytree:
    """Optimizer state: mu/nu leaves mirror the param specs (their leaf
    names are the param names), scalars (step) replicate."""
    def leaf(path, x):
        if len(x.shape) == 0:
            return NamedSharding(mesh, P())
        return NamedSharding(mesh, param_spec(path, x.shape, mesh,
                                              no_attn_tp=no_attn_tp))
    return tree_map_with_path(leaf, opt_shapes)


def cache_spec(path, shape, mesh, *, global_batch: int) -> PartitionSpec:
    name = _leaf_name(path)
    stacked = _is_stacked(path)
    off = 1 if stacked else 0
    model = axis_size(mesh, "model")
    dp = 1
    for a in batch_axes(mesh):
        dp *= axis_size(mesh, a)

    spec = [None] * len(shape)
    # batch dim
    if shape[off] % dp == 0 and shape[off] >= dp:
        spec[off] = batch_axes(mesh)
        batch_sharded = True
    else:
        batch_sharded = False

    prefs = CACHE_MODEL_PREFS.get(name)
    if prefs is None:
        # tuple states (mLSTM c/n/m, sLSTM): try dims after batch
        prefs = list(range(1, len(shape) - off))
    for d in prefs:
        dd = d + off
        if dd < len(shape) and shape[dd] % model == 0 and shape[dd] >= model:
            spec[dd] = "model"
            break

    # unshardable batch (e.g. long_500k batch=1): shard the seq dim on data
    if not batch_sharded and name in ("k", "v", "ckv", "k_rope"):
        seq_dim = off + 1
        data = axis_size(mesh, "data")
        if spec[seq_dim] is None and shape[seq_dim] % data == 0:
            spec[seq_dim] = "data"
    return P(*spec)


def cache_shardings(mesh, cache_tree: Pytree, global_batch: int) -> Pytree:
    def leaf(path, x):
        return NamedSharding(mesh, cache_spec(path, x.shape, mesh,
                                              global_batch=global_batch))
    return tree_map_with_path(leaf, cache_tree)


def batch_shardings(mesh, batch_tree: Pytree) -> Pytree:
    """Token batches: shard dim0 on (pod, data) when divisible."""
    dp = 1
    for a in batch_axes(mesh):
        dp *= axis_size(mesh, a)

    def leaf(x):
        if x.shape and x.shape[0] % dp == 0 and x.shape[0] >= dp:
            return NamedSharding(mesh, P(batch_axes(mesh),
                                         *([None] * (len(x.shape) - 1))))
        return NamedSharding(mesh, P(*([None] * len(x.shape))))
    return tree_map(leaf, batch_tree)


def replicated(mesh, tree: Pytree) -> Pytree:
    return tree_map(
        lambda x: NamedSharding(mesh, P(*([None] * len(x.shape)))), tree)
