"""Meshes for twin-fleet serving and the LM sharding rules (port of
``repro/launch/mesh.py``).

Twin serving (:mod:`repro_torch.launch.fleet_serving`) uses a 1-D mesh
over the ``"twins"`` axis: the trained weights are copied onto every
device of the mesh and the fleet (initial conditions and per-twin
stimulus parameters) is split along it, so each device rolls out its
slice of the assets with no traffic between devices during the solve.

The JAX package's ``shard_map`` is single-controller: one process places
the shards on its local devices.  The port does the same with plain
PyTorch, so it needs no ``torch.distributed`` and no process group: a
:class:`Mesh` is a small frozen record of axis names, axis sizes and the
``torch.device`` of every position, and
:func:`~repro_torch.launch.fleet_serving.shard_rollout_batch` walks its
devices.  A mesh may name one device several times (``Mesh(("twins",),
(4,), ("cuda:0",) * 4)`` splits a fleet four ways on a one-card machine)
and its devices may all be
the CPU (``make_twin_mesh(n, device="cpu")``, the counterpart of XLA's
``--xla_force_host_platform_device_count``), which is what the CPU tests
use.

The LM meshes of the roofline study keep the JAX package's shapes:
single pod (16, 16) ``("data", "model")``, multi-pod (2, 16, 16)
``("pod", "data", "model")``.  No machine the port runs on has 256 cards,
so :func:`make_production_mesh` and :func:`make_host_mesh` return
shape-only meshes with no devices: the sharding rules read nothing but
``axis_names`` and ``shape``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from repro_torch.device import resolve_device

TWIN_AXIS = "twins"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Axis names, axis sizes and the device of every mesh position in
    row-major order (empty for a shape-only mesh).  ``shape`` maps each
    axis name to its size, as ``jax.sharding.Mesh.shape`` does."""
    axis_names: tuple
    axis_sizes: tuple
    devices: tuple = ()

    def __post_init__(self):
        names, sizes = tuple(self.axis_names), tuple(
            int(s) for s in self.axis_sizes)
        if len(names) != len(sizes) or len(set(names)) != len(names):
            raise ValueError(
                f"Mesh: axis names {names} and sizes {sizes} do not pair up")
        if any(s < 1 for s in sizes):
            raise ValueError(f"Mesh: axis sizes must be >= 1, got {sizes}")
        devs = tuple(torch.device(d) for d in self.devices)
        if devs and len(devs) != math.prod(sizes):
            raise ValueError(
                f"Mesh: {len(devs)} device(s) for a {sizes} mesh; give one "
                f"per position (repeat a device to place several there)")
        object.__setattr__(self, "axis_names", names)
        object.__setattr__(self, "axis_sizes", sizes)
        object.__setattr__(self, "devices", devs)

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.axis_sizes))


def make_twin_mesh(n_devices: Optional[int] = None, *,
                   device=None) -> Mesh:
    """1-D mesh over the ``"twins"`` axis for fleet serving.

    ``device`` (default ``cuda``, through
    :func:`repro_torch.device.resolve_device`, which raises without a
    card) picks the device type.  On CUDA ``n_devices=None`` uses every
    visible card from ``device``'s index on; asking for more raises.
    ``device="cpu"`` builds ``n_devices`` (default 1) shards that all sit
    on the CPU.  There is no fallback from CUDA to the CPU."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        first = dev.index or 0
        have = max(torch.cuda.device_count() - first, 0)
        n = have if n_devices is None else int(n_devices)
        if not 1 <= n <= have:
            raise ValueError(
                f"make_twin_mesh: asked for {n} devices, have {have}")
        return Mesh((TWIN_AXIS,), (n,),
                    tuple(torch.device("cuda", first + i) for i in range(n)))
    n = 1 if n_devices is None else int(n_devices)
    if n < 1:
        raise ValueError(f"make_twin_mesh: asked for {n} devices")
    return Mesh((TWIN_AXIS,), (n,), (dev,) * n)


def twin_shard_count(mesh) -> int:
    """How many ways the twin axis is split on ``mesh`` (1 if absent)."""
    return int(mesh.shape.get(TWIN_AXIS, 1))


def twin_devices(mesh: Mesh) -> tuple:
    """The device of each shard of a twin mesh (the one axis
    ``"twins"``)."""
    if not mesh.devices:
        raise ValueError(
            f"mesh {mesh.shape} has no devices (a shape-only mesh); "
            f"build one with make_twin_mesh")
    if mesh.axis_names != (TWIN_AXIS,):
        raise ValueError(
            f"a twin mesh has the one axis {TWIN_AXIS!r}, got {mesh.shape}")
    return mesh.devices


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The roofline study's pod meshes, shape only (no devices)."""
    if multi_pod:
        return Mesh(("pod", "data", "model"), (2, 16, 16))
    return Mesh(("data", "model"), (16, 16))


def make_host_mesh(n_data: int = 1, n_model: int = 1) -> Mesh:
    """A small ``("data", "model")`` mesh for tests, shape only."""
    return Mesh(("data", "model"), (n_data, n_model))


def batch_axes(mesh) -> tuple:
    """The mesh axes that jointly shard the batch dimension."""
    names = mesh.axis_names
    return tuple(a for a in ("pod", "data") if a in names)


def axis_size(mesh, name: str) -> int:
    if name not in mesh.axis_names:
        return 1
    return mesh.shape[name]
