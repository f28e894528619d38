"""Lorenz96 dynamics (paper Eq. 4) — ground truth for the autonomous twin
(port of ``repro/data/lorenz96.py``).

    dx_i/dt = (x_{i+1} - x_{i-2}) x_{i-1} - x_i + F,  periodic in i.

Paper setup (Methods): n = 6 variables, initial condition
[-1.2061, 0.0617, 1.1632, -1.5008, -1.5944, -0.0187], 2400 points,
first 1800 interpolation (training) / remainder extrapolation (test).
"""
from __future__ import annotations

import functools

import torch

from repro_torch.core.twin import reference_trajectory
from repro_torch.device import resolve_device

PAPER_Y0 = (-1.2061, 0.0617, 1.1632, -1.5008, -1.5944, -0.0187)


def lorenz96_field(forcing: float = 8.0):
    def f(t, x, _params=None):
        del t
        xp1 = torch.roll(x, -1, dims=-1)
        xm1 = torch.roll(x, 1, dims=-1)
        xm2 = torch.roll(x, 2, dims=-1)
        return (xp1 - xm2) * xm1 - x + forcing
    return f


def generate(num_points: int = 2400, dt: float = 0.02, y0=PAPER_Y0,
             forcing: float = 8.0, train_points: int | None = None,
             device=None):
    """Returns (ts, ys, split) with ys of shape (num_points, n), float32
    on ``device`` (default ``cuda``); the solve runs on the CPU, so every
    device gets the same data, and is cached per argument set (the
    tensors returned are fresh copies).

    ``train_points`` defaults to the paper's 3/4 split (1800 of 2400).
    """
    if train_points is None:
        train_points = int(num_points * 0.75)
    device = resolve_device(device)
    ts, ys = _simulate(int(num_points), float(dt),
                       tuple(float(v) for v in y0), float(forcing))
    return ts.to(device, copy=True), ys.to(device, copy=True), train_points


@functools.lru_cache(maxsize=8)
def _simulate(num_points, dt, y0, forcing):
    """The CPU solve behind :func:`generate`, cached per argument set."""
    ts = torch.arange(num_points, dtype=torch.float32) * dt
    y0 = torch.tensor(y0, dtype=torch.float32)
    ys = reference_trajectory(lorenz96_field(forcing), y0, ts,
                              steps_per_interval=8)
    return ts, ys


def normalize(ys: torch.Tensor):
    """Per-dim standardisation; returns (normed, mean, std).  The std is
    the population std (``correction=0``), as ``jnp.std`` computes it."""
    mean = ys.mean(dim=0)
    std = ys.std(dim=0, correction=0) + 1e-8
    return (ys - mean) / std, mean, std
