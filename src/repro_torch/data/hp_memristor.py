"""HP memristor physics (Strukov et al. 2008) — ground truth for the twin
(port of ``repro/data/hp_memristor.py``).

State x = w/D in [0, 1] (normalised doped-region boundary):

    R(x)   = R_ON * x + R_OFF * (1 - x)            (paper Eq. 2)
    i(t)   = v(t) / R(x)
    dx/dt  = (mu_v * R_ON / D^2) * i * window(x)   (paper Eq. 3 + Joglekar
                                                    window to keep x in [0,1])

The waveform generators mirror the paper's four stimulation cases (sine,
triangular, rectangular, modulated sine) as *continuous* callables u(t)
of a float32 time tensor of any shape.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Callable

import torch

from repro_torch.core.twin import reference_trajectory
from repro_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class HPParams:
    r_on: float = 100.0       # ohm
    r_off: float = 16e3       # ohm
    d: float = 1e-8           # m (10 nm)
    mu_v: float = 1e-14       # m^2 / (V s)
    window_p: int = 1         # Joglekar window exponent

    @property
    def k(self) -> float:
        """mu_v * R_ON / D^2 — the Eq. 3 rate constant (1/(V s) units
        after absorbing i = v/R)."""
        return self.mu_v * self.r_on / self.d ** 2


def resistance(x: torch.Tensor, p: HPParams) -> torch.Tensor:
    return p.r_on * x + p.r_off * (1.0 - x)


def hp_field(drive: Callable, p: HPParams = HPParams()):
    """Ground-truth vector field dx/dt = f(t, x)."""

    def f(t, x, _params=None):
        v = drive(t)
        i = v / resistance(x, p)
        window = 1.0 - (2.0 * x - 1.0) ** (2 * p.window_p)
        return p.k * i * window

    return f


# ---------------------------------------------------------------------------
# Continuous drive waveforms (the paper's four stimulation cases)
# ---------------------------------------------------------------------------

def sine(amp: float = 1.0, freq: float = 2.0) -> Callable:
    return lambda t: amp * torch.sin(2 * math.pi * freq * t)


def triangular(amp: float = 1.0, freq: float = 2.0) -> Callable:
    def u(t):
        phase = torch.remainder(t * freq, 1.0)
        return amp * (4.0 * torch.abs(phase - 0.5) - 1.0)
    return u


def rectangular(amp: float = 1.0, freq: float = 2.0,
                sharpness: float = 80.0) -> Callable:
    """Smoothed square wave (tanh edges keep the ODE Lipschitz, mirroring
    the finite slew rate of the analogue waveform generator)."""
    def u(t):
        return amp * torch.tanh(sharpness * torch.sin(2 * math.pi * freq * t))
    return u


def modulated_sine(amp: float = 1.0, freq: float = 4.0,
                   mod_freq: float = 1.0) -> Callable:
    def u(t):
        return amp * torch.sin(2 * math.pi * freq * t) * torch.sin(
            2 * math.pi * mod_freq * t)
    return u


WAVEFORMS = {
    "sine": sine,
    "triangular": triangular,
    "rectangular": rectangular,
    "modulated_sine": modulated_sine,
}


# ---------------------------------------------------------------------------
# Dataset generation (paper Methods: 500 points, dt = 1e-3 s)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=16)
def _simulate(waveform, num_points, dt, x0, p, amp, freq):
    drive = WAVEFORMS[waveform](amp=amp, freq=freq)
    ts = torch.arange(num_points, dtype=torch.float32) * dt
    f = hp_field(drive, p)
    x0a = torch.tensor([x0], dtype=torch.float32)
    xs = reference_trajectory(f, x0a, ts, steps_per_interval=16)[:, 0]
    vs = drive(ts)
    return ts, xs, vs, vs / resistance(xs, p)


def generate(waveform: str = "sine", num_points: int = 500,
             dt: float = 1e-3, x0: float = 0.1,
             p: HPParams = HPParams(), amp: float = 1.0,
             freq: float = 2.0, device=None):
    """Simulate the HP memristor; returns (ts, xs, vs, currents), float32
    on ``device`` (default ``cuda``).  The solve runs on the CPU, so every
    device gets the same data, and is cached per argument set (the
    tensors returned are fresh copies)."""
    device = resolve_device(device)
    return tuple(x.to(device, copy=True) for x in _simulate(
        waveform, int(num_points), float(dt), float(x0), p, float(amp),
        float(freq)))
