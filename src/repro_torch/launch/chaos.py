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

The durable serving loop (:mod:`repro_torch.launch.journal`,
``StreamingFleetServer(durability_dir=)``) declares the journal's and the
snapshots' kill points too; :func:`main` is the crash-matrix CLI, one
crash and recovery at a named kill point checked against a crash-free
run:

  PYTHONPATH=src python -m repro_torch.launch.chaos --device cpu \\
      --kill pump:post_commit
"""
from __future__ import annotations

import argparse
import contextlib
from typing import Callable, Dict, Iterator, Optional

#: Every kill point the serving stack declares: a solved batch not yet
#: committed to the store, a committed one whose journal records are not
#: yet durable, the middle of an LRU page-out, a snapshot written but not
#: yet renamed into place (the checkpointer's publish, so it arms
#: ``train.checkpoint.save`` too), and a journal append that dies
#: mid-write, leaving a torn half frame.  ``crash_at`` validates against
#: this list, so a misspelt name fails instead of never firing.
KILL_POINTS = (
    "pump:pre_commit",
    "pump:post_commit",
    "store:evict",
    "snapshot:pre_rename",
    "journal:torn_append",
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


def kill_point(name: str, partial: Optional[Callable[[], None]] = None
               ) -> None:
    """Declare a crash site: a no-op unless armed by :func:`crash_at`.
    ``partial`` runs just before the crash: the damage a real death there
    leaves behind (a journal append writes half its frame)."""
    hits = _armed.get(name)
    if hits is None:
        return
    if hits > 1:
        _armed[name] = hits - 1
        return
    del _armed[name]
    if partial is not None:
        partial()
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


# ---------------------------------------------------------------------------
# CLI: one crash and recovery at a chosen kill point
# ---------------------------------------------------------------------------

def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        description="Crash a streaming serve mid-flight at a named kill "
                    "point, recover from the journal, and check parity "
                    "with an uninterrupted run")
    ap.add_argument("--kill", default="pump:post_commit",
                    choices=list(KILL_POINTS))
    ap.add_argument("--hit", type=int, default=2,
                    help="crash on the N-th execution of the kill point")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--requests", type=int, default=24)
    ap.add_argument("--device", default="cuda",
                    help="torch device (cpu runs K1's plain version)")
    args = ap.parse_args(argv)

    import tempfile

    import numpy as np
    import torch

    from repro_torch.core.twin import TwinFleet, make_autonomous_twin
    from repro_torch.device import resolve_device
    from repro_torch.launch import traffic
    from repro_torch.launch.fleet_serving import StreamingFleetServer

    device = resolve_device(args.device)
    twin = make_autonomous_twin(state_dim=3, hidden=8, n_hidden_layers=1,
                                backend="fused_cuda")
    params = twin.init(torch.Generator().manual_seed(0), device=device)
    fleet = TwinFleet(twin)
    trace = traffic.poisson_trace(args.seed, args.requests, population=8,
                                  max_horizon=12)
    rng = np.random.default_rng(1)
    y0s = {tid: np.float32(rng.normal(size=3) * 0.1) for tid in range(8)}
    y0_of = y0s.__getitem__
    kw = dict(dt=0.01, hot_capacity=4, max_batch=4, max_window=8,
              horizon_quantum=4, device=device)

    ref = StreamingFleetServer(fleet, params, **kw)
    ref_done = ref.serve_trace(trace, y0_of=y0_of)

    with tempfile.TemporaryDirectory() as d:
        live = StreamingFleetServer(fleet, params, durability_dir=d,
                                    snapshot_every=3, **kw)
        delivered = []          # completions received before the crash
        try:
            with crash_at(args.kill, hit=args.hit):
                live.serve_trace(trace, y0_of=y0_of, sink=delivered)
            raise SystemExit(f"kill point {args.kill!r} never fired "
                             f"(hit={args.hit} too deep for this trace?)")
        except SimulatedCrash as e:
            print(f"crashed: {e}")
        live.close()
        rec, redelivered = StreamingFleetServer.recover(d, fleet, params,
                                                        device=device)
        resumed = rec.serve_trace(trace, y0_of=y0_of,
                                  start=rec.stream_stats.enqueued)
        rec.close()
    rec_done = ({c.seq for c in delivered} | {c.seq for c in redelivered}
                | {c.seq for c in resumed})
    for tid in y0s:
        if tid in ref.store:
            y_ref, s_ref = ref.store.peek(tid)
            y_rec, s_rec = rec.store.peek(tid)
            if s_ref != s_rec or not np.array_equal(y_ref, y_rec):
                raise SystemExit(f"twin {tid} diverged after recovery")
    ref_seqs = {c.seq for c in ref_done}
    if rec_done != ref_seqs:
        raise SystemExit(f"completion sets differ: lost "
                         f"{sorted(ref_seqs - rec_done)}, phantom "
                         f"{sorted(rec_done - ref_seqs)}")
    print(f"recovered: {len(rec_done)} completions, {len(ref.store)} twins "
          f"bitwise equal to the uninterrupted run")


if __name__ == "__main__":
    # ``python -m`` runs this file as ``__main__``, a second module whose
    # registry the serving stack (which imports repro_torch.launch.chaos)
    # never reads: arm kill points in the canonical module instead.
    from repro_torch.launch import chaos as _canonical
    _canonical.main()
