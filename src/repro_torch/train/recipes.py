"""Experiment recipes (port of the Lorenz96 fleet part of ``repro/train/recipes.py``).

The HP and Lorenz96 training recipes come with the training slice
(ROADMAP.md, queue 1).
"""
from __future__ import annotations

import torch

from repro_torch.configs.lorenz96_twin import FLEET
from repro_torch.core.backends import FusedCudaBackend
from repro_torch.core.twin import TwinFleet, make_autonomous_twin
from repro_torch.device import resolve_device


def make_l96_fleet(cfg=None, backend=None) -> TwinFleet:
    """The Lorenz96 fleet-serving scenario: one autonomous twin at the
    paper's Fig. 4 sizes, wrapped in a :class:`TwinFleet` so N assets
    roll out as one program.

    ``cfg``: a ``Lorenz96FleetConfig`` (default: ``FLEET``).  ``backend``:
    Backend instance or registry name; ``None`` uses the config's choice
    (``fused_cuda`` with its ``batch_tile``)."""
    cfg = cfg or FLEET
    twin = make_autonomous_twin(cfg.state_dim, hidden=cfg.hidden,
                                n_hidden_layers=cfg.n_hidden_layers)
    if backend is None:
        backend = (FusedCudaBackend(batch_tile=cfg.batch_tile)
                   if cfg.backend == "fused_cuda" else cfg.backend)
    if backend != "digital":
        twin = twin.with_backend(backend)
    return TwinFleet(twin)


def l96_fleet_ts(cfg=None, horizon=None) -> torch.Tensor:
    """The serving time grid: ``horizon`` RK4 steps at the training dt,
    uniform and concrete (a float32 host tensor), as the fused kernel
    requires."""
    cfg = cfg or FLEET
    h = cfg.horizon if horizon is None else int(horizon)
    return torch.linspace(0.0, h * cfg.dt, h + 1, dtype=torch.float32)


def l96_fleet_requests(cfg=None, fleet_size=None, num_batches=1, seed=0,
                       device=None):
    """Stream request batches of per-asset initial conditions: each a
    (fleet_size, state_dim) tensor on ``device`` (default ``cuda``) of
    sensed states drawn around the normalised attractor, from a
    ``torch.Generator`` seeded with ``seed``."""
    cfg = cfg or FLEET
    device = resolve_device(device)
    n = cfg.fleet_size if fleet_size is None else int(fleet_size)
    gen = torch.Generator().manual_seed(seed)
    for _ in range(num_batches):
        y = torch.randn((n, cfg.state_dim), generator=gen)
        yield (cfg.y0_spread * y).to(device)
