"""Seeded traffic generators for streaming twin serving (port of
``repro/launch/traffic.py``; numpy only, so a seed gives the JAX
package's trace field for field).

Streaming correctness depends on scheduling (batch composition,
eviction order, state hand-off), so the serving loop is driven with
reproducible arrival traces: every generator is a pure function of its
seed, and a trace replayed through
:class:`repro_torch.launch.fleet_serving.StreamingFleetServer` makes the
whole schedule (batches, evictions, carried states) deterministic.

Shapes of traffic:

  ``poisson_trace``      memoryless sensor uplinks, the steady state;
  ``bursty_trace``       synchronised fleet wake-ups (a burst of
                         requests, a quiet gap): stresses batch assembly;
  ``all_cold_trace``     every request hits a twin never seen before:
                         the most paging, no hot reuse;
  ``hot_loop_trace``     every request hits one twin: batching degrades
                         to serial windows;
  ``ragged_trace``       log-uniform horizons: the most padding per batch
                         and requests split across windows;
  ``deadline_trace``     Poisson arrivals with deadlines, a fraction of
                         them expiring on arrival: admission control.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class Arrival:
    """One streaming request: advance ``twin_id`` by ``horizon`` RK4
    steps, arriving at virtual time ``time`` (seconds).  ``deadline``
    (same clock) is the latest the request may still be *started*;
    ``None`` means no deadline — the admission-control path ignores
    it."""
    time: float
    twin_id: int
    horizon: int
    deadline: Optional[float] = None


def _emit(times, twins, horizons, deadlines=None) -> List[Arrival]:
    order = np.argsort(times, kind="stable")
    return [Arrival(float(times[i]), int(twins[i]), int(horizons[i]),
                    None if deadlines is None else float(deadlines[i]))
            for i in order]


def poisson_trace(seed: int, n_requests: int, *, rate_hz: float = 200.0,
                  population: int = 64, min_horizon: int = 4,
                  max_horizon: int = 32) -> List[Arrival]:
    """Memoryless arrivals: exponential inter-arrival gaps at
    ``rate_hz``, twin ids uniform over ``population``, horizons uniform
    in ``[min_horizon, max_horizon]``."""
    rng = np.random.default_rng(seed)
    gaps = rng.exponential(1.0 / rate_hz, size=n_requests)
    times = np.cumsum(gaps)
    twins = rng.integers(0, population, size=n_requests)
    horizons = rng.integers(min_horizon, max_horizon + 1, size=n_requests)
    return _emit(times, twins, horizons)


def bursty_trace(seed: int, n_requests: int, *, burst_size: int = 16,
                 burst_gap_s: float = 0.05, population: int = 64,
                 min_horizon: int = 4, max_horizon: int = 32
                 ) -> List[Arrival]:
    """Synchronized wake-ups: ``burst_size`` near-simultaneous requests,
    then a quiet gap — the batcher sees deep queues and empty ones."""
    rng = np.random.default_rng(seed)
    burst_idx = np.arange(n_requests) // burst_size
    jitter = rng.uniform(0.0, 1e-4, size=n_requests)
    times = burst_idx * burst_gap_s + jitter
    twins = rng.integers(0, population, size=n_requests)
    horizons = rng.integers(min_horizon, max_horizon + 1, size=n_requests)
    return _emit(times, twins, horizons)


def all_cold_trace(seed: int, n_requests: int, *, rate_hz: float = 200.0,
                   min_horizon: int = 4, max_horizon: int = 32
                   ) -> List[Arrival]:
    """Adversarial paging: request i targets twin i — no twin is ever
    re-requested, so every fetch is a page-in and (once the hot slab
    fills) every promotion an eviction."""
    rng = np.random.default_rng(seed)
    times = np.cumsum(rng.exponential(1.0 / rate_hz, size=n_requests))
    twins = np.arange(n_requests)
    horizons = rng.integers(min_horizon, max_horizon + 1, size=n_requests)
    return _emit(times, twins, horizons)


def hot_loop_trace(seed: int, n_requests: int, *, rate_hz: float = 200.0,
                   twin_id: int = 0, min_horizon: int = 4,
                   max_horizon: int = 32) -> List[Arrival]:
    """Adversarial serialisation: every request targets one twin, so no
    two can share a batch (each window consumes the previous one's end
    state) — continuous batching must degrade to in-order windows, never
    reorder or coalesce them."""
    rng = np.random.default_rng(seed)
    times = np.cumsum(rng.exponential(1.0 / rate_hz, size=n_requests))
    twins = np.full(n_requests, twin_id)
    horizons = rng.integers(min_horizon, max_horizon + 1, size=n_requests)
    return _emit(times, twins, horizons)


def ragged_trace(seed: int, n_requests: int, *, rate_hz: float = 200.0,
                 population: int = 64, max_horizon: int = 128
                 ) -> List[Arrival]:
    """Adversarial padding: horizons log-uniform in [1, max_horizon] —
    most batches mix tiny and huge windows, maximising the padded tail
    the chunk-carry kernel streams past."""
    rng = np.random.default_rng(seed)
    times = np.cumsum(rng.exponential(1.0 / rate_hz, size=n_requests))
    twins = rng.integers(0, population, size=n_requests)
    horizons = np.exp(rng.uniform(0.0, np.log(max_horizon),
                                  size=n_requests)).astype(int) + 1
    return _emit(times, twins, horizons)


def deadline_trace(seed: int, n_requests: int, *, rate_hz: float = 200.0,
                   population: int = 64, min_horizon: int = 4,
                   max_horizon: int = 32, slack_s: float = 0.5,
                   tight_fraction: float = 0.25) -> List[Arrival]:
    """Poisson arrivals where every request carries a deadline: most get
    ``slack_s`` of headroom (comfortably served), but a
    ``tight_fraction`` get essentially zero slack — they expire the
    moment any later arrival's pump looks at them.  The admission-
    control trace: a correct server sheds exactly the stale ones and
    accounts for every seq once."""
    rng = np.random.default_rng(seed)
    times = np.cumsum(rng.exponential(1.0 / rate_hz, size=n_requests))
    twins = rng.integers(0, population, size=n_requests)
    horizons = rng.integers(min_horizon, max_horizon + 1, size=n_requests)
    tight = rng.random(n_requests) < tight_fraction
    deadlines = times + np.where(tight, 1e-9, slack_s)
    return _emit(times, twins, horizons, deadlines)


#: name -> generator, for CLI/benchmark selection.
TRACES = {
    "poisson": poisson_trace,
    "bursty": bursty_trace,
    "all_cold": all_cold_trace,
    "hot_loop": hot_loop_trace,
    "ragged": ragged_trace,
    "deadline": deadline_trace,
}


def population_of(trace) -> int:
    """Number of distinct twins a trace touches (registration size)."""
    return len({a.twin_id for a in trace})
