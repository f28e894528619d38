"""Crash and fault injection for the serving stack (port of the injection
registry of ``repro/launch/chaos.py``).

The serving loop declares named **kill points**, places where a real
process death would do the most damage, and **fault points**, places
where a transient infrastructure fault (a device hiccup, a preempted
kernel) may strike.  Both are no-ops until a test arms them:

  ``crash_at(name, hit)``   the ``hit``-th execution of kill point
                            ``name`` raises :class:`SimulatedCrash`;
  ``flaky(name, times)``    fault point ``name`` raises
                            :class:`TransientFault` ``times`` times,
                            then heals.

The serving loop's retry and fallback paths catch :class:`TransientFault`
and nothing else: a kernel that fails to build or launch raises out of
``pump``.  :class:`SimulatedCrash` subclasses ``BaseException``, so it
gets past every handler as a real death would.  Both registries are
process-global and the context managers always disarm on exit.

The journal's and snapshots' kill points and the crash-matrix CLI come
with crash recovery (ROADMAP.md, queue 1 item 9b).
"""
from __future__ import annotations

import contextlib
from typing import Dict, Iterator

#: Every kill point the serving stack declares: a solved batch not yet
#: committed to the store, a committed one, and the middle of an LRU
#: page-out.  ``crash_at`` validates against this list, so a misspelt name
#: fails instead of never firing.
KILL_POINTS = (
    "pump:pre_commit",
    "pump:post_commit",
    "store:evict",
)

_armed: Dict[str, int] = {}            # kill point -> hits until crash
_faults: Dict[str, int] = {}           # fault point -> faults still to raise


class TransientFault(RuntimeError):
    """A fault that may heal on retry (a device hiccup, a preempted
    solve): the one exception the serving loop retries and falls through
    the tiers on."""


class SimulatedCrash(BaseException):
    """An injected process death; deliberately not an ``Exception``, so no
    ``except Exception`` handler can intercept it."""


def kill_point(name: str) -> None:
    """Declare a crash site: a no-op unless armed by :func:`crash_at`."""
    hits = _armed.get(name)
    if hits is None:
        return
    if hits > 1:
        _armed[name] = hits - 1
        return
    del _armed[name]
    raise SimulatedCrash(f"simulated crash at kill point {name!r}")


@contextlib.contextmanager
def crash_at(name: str, hit: int = 1) -> Iterator[None]:
    """Arm ``name`` to crash on its ``hit``-th execution (1 = the first);
    disarmed on exit, whether or not it fired."""
    if name not in KILL_POINTS:
        raise ValueError(
            f"unknown kill point {name!r}; chaos knows {KILL_POINTS}")
    if hit < 1:
        raise ValueError(f"crash_at: hit must be >= 1, got {hit}")
    _armed[name] = hit
    try:
        yield
    finally:
        _armed.pop(name, None)


def fault_point(name: str) -> None:
    """Declare a transient-fault site: a no-op unless armed by
    :func:`flaky`; armed, it raises :class:`TransientFault` on each of
    its next ``times`` executions, then heals."""
    count = _faults.get(name)
    if count is None:
        return
    if count <= 1:
        del _faults[name]
    else:
        _faults[name] = count - 1
    raise TransientFault(f"injected transient fault at {name!r}")


@contextlib.contextmanager
def flaky(name: str, times: int = 1) -> Iterator[None]:
    """Arm fault point ``name`` to fail ``times`` times, then heal."""
    if times < 1:
        raise ValueError(f"flaky: times must be >= 1, got {times}")
    _faults[name] = times
    try:
        yield
    finally:
        _faults.pop(name, None)


def reset() -> None:
    """Disarm everything."""
    _armed.clear()
    _faults.clear()
