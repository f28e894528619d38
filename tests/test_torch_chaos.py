"""Crash-safe streaming serving in the port, on the CPU: the invariants of
``tests/test_chaos.py`` re-run on ``repro_torch``, and the journal and
snapshot formats held against the JAX package's in both directions.

Kill the serving process at any kill point, on any tier, and
``StreamingFleetServer.recover`` plus feeding the rest of the trace gives
carried states, steps, trajectories and a completion set **bitwise** the
port's own crash-free run.  The crash-free run is held against the JAX
package's within 1e-5 of the peak (different float32 arithmetic orders;
on the analogue tier with programming noise off on both sides, since the
packages' programming generators differ).  The journal the port writes
for a trace is **byte-identical** to the JAX package's; each package
recovers a digital-tier directory the other wrote mid-crash.
"""
import functools
import os
import struct
import tempfile
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import traffic  # noqa: E402
from repro.core.analogue import AnalogueSpec as JSpec  # noqa: E402
from repro.core.backends import (DigitalBackend as JDigital,  # noqa: E402
                                 FusedAnalogueBackend, FusedPallasBackend)
from repro.core.twin import TwinFleet as JFleet  # noqa: E402
from repro.core.twin import make_autonomous_twin as jmake  # noqa: E402
from repro.launch import chaos as jchaos  # noqa: E402
from repro.launch.fleet_serving import (  # noqa: E402
    StreamingFleetServer as JServer)
from repro.train import checkpoint as jckpt  # noqa: E402
from repro_torch.core import faults as tfaults  # noqa: E402
from repro_torch.core.analogue import AnalogueSpec  # noqa: E402
from repro_torch.core.backends import (DigitalBackend,  # noqa: E402
                                       FusedAnalogueCudaBackend,
                                       FusedCudaBackend)
from repro_torch.core.twin import TwinFleet  # noqa: E402
from repro_torch.core.twin import make_autonomous_twin  # noqa: E402
from repro_torch.interop import params_from_numpy  # noqa: E402
from repro_torch.launch import chaos  # noqa: E402
from repro_torch.launch import journal as journal_lib  # noqa: E402
from repro_torch.launch import traffic as ttraffic  # noqa: E402
from repro_torch.launch.fleet_serving import (  # noqa: E402
    ServingSLO, StreamingFleetServer, _program_tiers)
from repro_torch.train import checkpoint as ckpt  # noqa: E402

try:
    from hypothesis import given, settings, strategies as st
    HAVE_HYPOTHESIS = True
except ImportError:
    HAVE_HYPOTHESIS = False

DT = 0.01
DIM = 3
TOL = 1e-5

#: The matrix's tiers: port backend, and the JAX package's counterpart.
TIERS = {
    "digital": (lambda: DigitalBackend(), lambda: JDigital()),
    "fused_cuda": (lambda: FusedCudaBackend(),
                   lambda: FusedPallasBackend(precision="f32")),
    "analogue_fused_cuda": (
        lambda: FusedAnalogueCudaBackend(
            spec=AnalogueSpec(read_noise=0.02), prog_seed=7),
        lambda: FusedAnalogueBackend(spec=JSpec(read_noise=0.02),
                                     prog_key=jax.random.PRNGKey(7))),
    # the analogue tier with programming noise off on both sides: the
    # cross-package value check of the noisy read path
    "analogue_quiet_programming": (
        lambda: FusedAnalogueCudaBackend(
            spec=AnalogueSpec(read_noise=0.02, prog_noise=0.0), prog_seed=7),
        lambda: FusedAnalogueBackend(
            spec=JSpec(read_noise=0.02, prog_noise=0.0),
            prog_key=jax.random.PRNGKey(7))),
}
MATRIX_TIERS = ("digital", "fused_cuda", "analogue_fused_cuda")
KILLS = [("pump:pre_commit", 2), ("pump:post_commit", 2), ("store:evict", 1),
         ("snapshot:pre_rename", 1), ("journal:torn_append", 5)]

_KW = dict(dt=DT, hot_capacity=4, max_batch=4, max_window=8,
           horizon_quantum=4)


@functools.lru_cache(maxsize=None)
def _jax_params():
    p = jmake(DIM, hidden=8, n_hidden_layers=1).init(jax.random.PRNGKey(0))
    return [{k: np.asarray(v) for k, v in layer.items()} for layer in p]


@functools.lru_cache(maxsize=None)
def _fleet(tier: str):
    twin = make_autonomous_twin(DIM, hidden=8, n_hidden_layers=1,
                                backend=TIERS[tier][0]())
    return TwinFleet(twin), params_from_numpy(_jax_params(), "cpu")


@functools.lru_cache(maxsize=None)
def _jfleet(tier: str):
    twin = jmake(DIM, hidden=8, n_hidden_layers=1, backend=TIERS[tier][1]())
    params = [{k: jax.numpy.asarray(v) for k, v in layer.items()}
              for layer in _jax_params()]
    return JFleet(twin=twin), params


def _y0_of(tid):
    return (np.random.default_rng(100 + tid).normal(size=DIM)
            .astype(np.float32) * 0.1)


def _trace(seed=0, n=16):
    return ttraffic.poisson_trace(seed, n, population=6, max_horizon=10)


def _server(tier, **kw):
    fleet, params = _fleet(tier)
    return StreamingFleetServer(fleet, params, device="cpu", **_KW, **kw)


def _states(server) -> dict:
    ids, _, _, _ = server.store.export_state()
    return {tid: server.store.peek(tid) for tid in ids}


@functools.lru_cache(maxsize=None)
def _reference(tier: str, seed: int = 0, n: int = 16):
    """The port's crash-free run: per-twin (state, step), completions."""
    server = _server(tier)
    done = server.serve_trace(_trace(seed, n), y0_of=_y0_of)
    return done, _states(server)


@functools.lru_cache(maxsize=None)
def _jax_durable(tier: str):
    """The JAX package's crash-free run with durability on, as the matrix
    arms it: journal bytes, states, completions and the newest
    snapshot's array names and ``extra``."""
    fleet, params = _jfleet(tier)
    with tempfile.TemporaryDirectory() as d:
        server = JServer(fleet, params, durability_dir=d, snapshot_every=3,
                         **_KW)
        done = server.serve_trace(_trace(), y0_of=_y0_of)
        server._journal.close()
        with open(journal_lib.journal_path(d), "rb") as f:
            wal = f.read()
        _, arrays, extra = journal_lib.load_latest_snapshot(d)
    ids, _, _, _ = server.store.export_state()
    states = {tid: server.store.peek(tid) for tid in ids}
    return wal, states, done, sorted(arrays), extra


def _crash_recover_cycle(tier, kill, hit, d, seed=0, n=16,
                         snapshot_every=3):
    """Serve the trace with ``kill`` armed; on the crash, recover and feed
    the rest of the trace.  Returns (recovered server, every completion
    delivered), or (None, None) if the kill point never fired."""
    fleet, params = _fleet(tier)
    trace = _trace(seed, n)
    d = str(d)
    live = StreamingFleetServer(fleet, params, durability_dir=d,
                                snapshot_every=snapshot_every, device="cpu",
                                **_KW)
    delivered = []          # what the client received before the crash
    try:
        with chaos.crash_at(kill, hit=hit):
            live.serve_trace(trace, y0_of=_y0_of, sink=delivered)
        return None, None
    except chaos.SimulatedCrash:
        pass
    finally:
        live.close()
    rec, redelivered = StreamingFleetServer.recover(d, fleet, params,
                                                    device="cpu")
    resumed = rec.serve_trace(trace, y0_of=_y0_of,
                              start=rec.stream_stats.enqueued)
    rec.close()
    # at-least-once delivery: redelivered may repeat what the client saw
    return rec, delivered + list(redelivered) + list(resumed)


def _assert_parity(tier, rec, got, seed=0, n=16):
    ref_done, ref_states = _reference(tier, seed, n)
    assert {c.seq for c in got} == {c.seq for c in ref_done}, \
        "completion sets differ after recovery"
    for tid, (y_ref, s_ref) in ref_states.items():
        y_rec, s_rec = rec.store.peek(tid)
        assert s_rec == s_ref, f"twin {tid}: step {s_rec} != {s_ref}"
        np.testing.assert_array_equal(
            y_rec, y_ref, err_msg=f"twin {tid}: state not bitwise after "
                                  f"recovery")
    ref_traj = {c.seq: c.trajectory for c in ref_done}
    for c in got:
        np.testing.assert_array_equal(
            c.trajectory, ref_traj[c.seq],
            err_msg=f"seq {c.seq}: redelivered trajectory differs")
    traffic.check_conservation(rec)


def _peak_err(states, want) -> float:
    peak = max(float(np.max(np.abs(y))) for y, _ in want.values())
    assert set(states) == set(want)
    for tid, (y, s) in want.items():
        assert states[tid][1] == s, f"twin {tid}: step differs"
    return max(float(np.max(np.abs(states[t][0] - want[t][0])))
               for t in want) / peak


# ---------------------------------------------------------------------------
# The kill-point x tier matrix
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kill,hit", KILLS)
@pytest.mark.parametrize("tier", MATRIX_TIERS)
def test_chaos_matrix_recovery_parity(tier, kill, hit, tmp_path):
    """A crash at every kill point on every tier: recovery plus resume is
    bitwise the crash-free run (states, steps, trajectories, the exact
    completion set)."""
    rec, got = _crash_recover_cycle(tier, kill, hit, tmp_path)
    assert rec is not None, \
        f"kill point {kill!r} (hit={hit}) never fired on this schedule"
    _assert_parity(tier, rec, got)


@pytest.mark.parametrize("tier", ["digital", "fused_cuda",
                                  "analogue_quiet_programming"])
def test_crash_free_run_matches_jax(tier):
    """The port's crash-free run against the JAX package's: the same
    completions in the same order, states and trajectories within 1e-5 of
    the peak."""
    done, states = _reference(tier)
    if tier in MATRIX_TIERS:
        _, want, jdone, _, _ = _jax_durable(tier)
    else:
        fleet, params = _jfleet(tier)
        server = JServer(fleet, params, **_KW)
        jdone = server.serve_trace(_trace(), y0_of=_y0_of)
        ids, _, _, _ = server.store.export_state()
        want = {tid: server.store.peek(tid) for tid in ids}
    assert [c.seq for c in done] == [c.seq for c in jdone]
    assert _peak_err(states, want) <= TOL
    peak = max(float(np.max(np.abs(c.trajectory))) for c in jdone)
    err = max(float(np.max(np.abs(c.trajectory - j.trajectory)))
              for c, j in zip(done, jdone))
    assert err / peak <= TOL


@pytest.mark.parametrize("tier", MATRIX_TIERS)
def test_journal_is_byte_identical_to_jax(tier, tmp_path):
    """The records are decisions and inputs (seqs, tier index, H, served
    counts, ``now``, y0 floats) and the schedulers agree, so the two
    packages write the same bytes; the newest snapshot names the same
    arrays and carries the same ``extra`` keys."""
    server = _server(tier, durability_dir=str(tmp_path), snapshot_every=3)
    server.serve_trace(_trace(), y0_of=_y0_of)
    server.close()
    wal, _, _, jarrays, jextra = _jax_durable(tier)
    with open(journal_lib.journal_path(str(tmp_path)), "rb") as f:
        assert f.read() == wal
    _, arrays, extra = journal_lib.load_latest_snapshot(str(tmp_path))
    assert sorted(arrays) == jarrays and sorted(extra) == sorted(jextra)
    if tier == "digital":
        assert extra == jextra


def test_chaos_matrix_seeded_random_points(tmp_path):
    """Seeded (kill, hit, trace seed) draws on ``fused_cuda``."""
    rng = np.random.default_rng(42)
    kills = ["pump:pre_commit", "pump:post_commit", "journal:torn_append"]
    fired = 0
    for i in range(4):
        kill = kills[int(rng.integers(len(kills)))]
        hit = int(rng.integers(1, 6))
        seed = int(rng.integers(100))
        rec, got = _crash_recover_cycle("fused_cuda", kill, hit,
                                        tmp_path / f"case{i}", seed=seed)
        if rec is None:
            continue                # hit too deep for this schedule
        fired += 1
        _assert_parity("fused_cuda", rec, got, seed=seed)
    assert fired


@pytest.mark.parametrize("kill", ["pump:pre_commit", "pump:post_commit"])
def test_a_crash_in_the_final_drain_keeps_earlier_completions(kill,
                                                              tmp_path):
    """Seed 27's trace ends in a drain of several pumps; the crash falls in
    its last pump, after a snapshot covered the pump before.  The port's
    ``serve_trace`` hands each pump's completions to the sink as the pump
    returns them, so none is lost; the JAX package's hands the drain's
    completions over when the drain ends, and the crash loses the earlier
    pump's (a snapshot covers them, so recovery does not redeliver
    them)."""
    rec, got = _crash_recover_cycle("fused_cuda", kill, 7, tmp_path / "port",
                                    seed=27)
    assert rec is not None and rec.recovery.commits == 0
    _assert_parity("fused_cuda", rec, got, seed=27)
    jfleet, jparams = _jfleet("fused_cuda")
    d = str(tmp_path / "jax")
    live = JServer(jfleet, jparams, durability_dir=d, snapshot_every=3,
                   **_KW)
    delivered = []
    with pytest.raises(jchaos.SimulatedCrash):
        with jchaos.crash_at(kill, hit=7):
            live.serve_trace(_trace(27), y0_of=_y0_of, sink=delivered)
    live._journal.close()
    jrec, redelivered = JServer.recover(d, jfleet, jparams)
    resumed = jrec.serve_trace(_trace(27), y0_of=_y0_of,
                               start=jrec.stream_stats.enqueued)
    jrec._journal.close()
    jgot = {c.seq for c in delivered + list(redelivered) + list(resumed)}
    assert {c.seq for c in got} - jgot == {14, 15}


if HAVE_HYPOTHESIS:
    @given(data=st.data())
    @settings(max_examples=8, deadline=None)
    def test_chaos_property_any_crash_recovers(data, tmp_path_factory):
        kill = data.draw(st.sampled_from(list(chaos.KILL_POINTS)))
        hit = data.draw(st.integers(1, 8))
        seed = data.draw(st.integers(0, 50))
        d = tmp_path_factory.mktemp("chaos")
        rec, got = _crash_recover_cycle("fused_cuda", kill, hit, d,
                                        seed=seed)
        if rec is None:
            return                  # the kill never fired: vacuously safe
        _assert_parity("fused_cuda", rec, got, seed=seed)


# ---------------------------------------------------------------------------
# Across packages: each recovers what the other wrote
# ---------------------------------------------------------------------------

def test_port_recovers_a_directory_the_jax_package_wrote(tmp_path):
    jfleet, jparams = _jfleet("digital")
    d = str(tmp_path)
    trace = _trace()
    live = JServer(jfleet, jparams, durability_dir=d, snapshot_every=3,
                   **_KW)
    delivered = []
    with pytest.raises(jchaos.SimulatedCrash):
        with jchaos.crash_at("pump:post_commit", hit=4):
            live.serve_trace(trace, y0_of=_y0_of, sink=delivered)
    live._journal.close()
    assert journal_lib.load_latest_snapshot(d) is not None
    fleet, params = _fleet("digital")
    rec, redelivered = StreamingFleetServer.recover(d, fleet, params,
                                                    device="cpu")
    resumed = rec.serve_trace(trace, y0_of=_y0_of,
                              start=rec.stream_stats.enqueued)
    rec.close()
    _, want, jdone, _, _ = _jax_durable("digital")
    got = {c.seq for c in delivered + redelivered + resumed}
    assert got == {c.seq for c in jdone}
    assert _peak_err(_states(rec), want) <= TOL
    traffic.check_conservation(rec)


def test_jax_package_recovers_a_directory_the_port_wrote(tmp_path):
    d = str(tmp_path)
    trace = _trace()
    fleet, params = _fleet("digital")
    live = StreamingFleetServer(fleet, params, durability_dir=d,
                                snapshot_every=3, device="cpu", **_KW)
    delivered = []
    with pytest.raises(chaos.SimulatedCrash):
        with chaos.crash_at("pump:post_commit", hit=4):
            live.serve_trace(trace, y0_of=_y0_of, sink=delivered)
    live.close()
    jfleet, jparams = _jfleet("digital")
    rec, redelivered = JServer.recover(d, jfleet, jparams)
    resumed = rec.serve_trace(trace, y0_of=_y0_of,
                              start=rec.stream_stats.enqueued)
    rec._journal.close()
    _, want, jdone, _, _ = _jax_durable("digital")
    got = {c.seq for c in delivered + list(redelivered) + list(resumed)}
    assert got == {c.seq for c in jdone}
    ids, _, _, _ = rec.store.export_state()
    assert _peak_err({t: rec.store.peek(t) for t in ids}, want) <= TOL


def test_port_snapshot_loads_through_jax_load_arrays(tmp_path):
    server = _server("fused_cuda", durability_dir=str(tmp_path),
                     snapshot_every=0)
    server.serve_trace(_trace()[:9], y0_of=_y0_of)
    path = server.snapshot()
    server.close()
    arrays, manifest = jckpt.load_arrays(path)
    mine, my_manifest = ckpt.load_arrays(path)
    assert sorted(arrays) == sorted(mine) and manifest == my_manifest
    for k in arrays:
        np.testing.assert_array_equal(arrays[k], mine[k])
    ids, ys, steps, _ = server.store.export_state()
    assert manifest["extra"]["ids"] == ids
    np.testing.assert_array_equal(arrays["store_ys"], ys)
    np.testing.assert_array_equal(arrays["store_steps"], steps)


# ---------------------------------------------------------------------------
# Rules that keep the bits equal
# ---------------------------------------------------------------------------

def _leaves(x, out):
    if isinstance(x, torch.Tensor):
        out.append(x)
    elif isinstance(x, dict):
        for k in sorted(x):
            _leaves(x[k], out)
    elif isinstance(x, (list, tuple)):
        for v in x:
            _leaves(v, out)
    return out


def test_programming_twice_gives_bitwise_equal_exec_states():
    """``recover`` programs the tiers again from their seeds; programming
    is a pure function of the seed, so the tiers come out the same."""
    fleet, params = _fleet("analogue_fused_cuda")
    fleet = fleet.with_backend(FusedAnalogueCudaBackend(
        spec=AnalogueSpec(read_noise=0.02), prog_seed=7,
        faults=tfaults.make_fault_model(("stuck", dict(rate=0.05)), seed=3)))
    tiers = [("analogue_fused_cuda", fleet)]
    (_, a), = _program_tiers(tiers, params)
    (_, b), = _program_tiers(tiers, params)
    la, lb = _leaves(a.extra, []), _leaves(b.extra, [])
    assert len(la) == len(lb) > 0
    assert all(torch.equal(x, y) for x, y in zip(la, lb))
    assert all(torch.equal(x["gp"], y["gp"]) for x, y in
               zip(a.field.progs, b.field.progs))


def test_recovery_under_an_slo_keeps_the_snapshots_active_tier(tmp_path):
    """With an SLO armed, the active tier comes from the snapshot alone and
    probes are not replayed (as in the JAX package): a server snapshotted
    before its first probe recovers on its primary tier with no probe
    counted, though the live server demoted to digital, while every
    replayed window runs on the tier it was served by and the states are
    bitwise the live run's."""
    fleet, params = _fleet("digital")
    fleet = fleet.with_backend(FusedAnalogueCudaBackend(
        spec=AnalogueSpec(prog_noise=0.0, read_noise=0.05),
        faults=tfaults.make_fault_model(("stuck", dict(rate=0.3)), seed=5)))
    slo = ServingSLO(max_rel_error=0.05)
    d = str(tmp_path)
    live = StreamingFleetServer(fleet, params, slo=slo, durability_dir=d,
                                snapshot_every=0, device="cpu", **_KW)
    for tid in range(6):
        live.register_twin(tid, _y0_of(tid))
    live.snapshot()
    live.serve_trace(_trace(), y0_of=_y0_of)
    live.close()
    assert live.active_tier == "digital"
    assert live.serving_stats.probes >= 1
    rec, redelivered = StreamingFleetServer.recover(d, fleet, params,
                                                    slo=slo, device="cpu")
    rec.close()
    assert rec.active_tier == "analogue_fused_cuda"
    assert rec.serving_stats.probes == 0
    assert rec.serving_stats.served_by == live.serving_stats.served_by
    assert rec.recovery.commits == live.stream_stats.batches
    for tid, (y, s) in _states(live).items():
        y_rec, s_rec = rec.store.peek(tid)
        assert s_rec == s
        np.testing.assert_array_equal(y_rec, y)
    assert len(redelivered) == live.stream_stats.served


def test_export_state_is_the_whole_population_on_the_host():
    server = _server("fused_cuda")
    server.serve_trace(_trace(), y0_of=_y0_of)
    ids, ys, steps, thetas = server.store.export_state()
    assert thetas is None and ys.dtype == np.float32
    assert steps.dtype == np.int64 and len(ids) == len(server.store)
    for i, tid in enumerate(ids):
        y, s = server.store.peek(tid)
        np.testing.assert_array_equal(ys[i], y)
        assert steps[i] == s
    assert len(server.store.hot_ids) > 0


# ---------------------------------------------------------------------------
# Journal mechanics
# ---------------------------------------------------------------------------

def test_journal_round_trip(tmp_path):
    p = str(tmp_path / "journal.wal")
    j = journal_lib.Journal(p)
    recs = [{"t": "submit", "seq": i, "id": i % 3, "h": 4,
             "ta": 0.1 * i, "dl": None} for i in range(7)]
    for r in recs:
        j.append(r)
    assert j.nbytes == os.path.getsize(p)
    j.close()
    back, valid, torn = journal_lib.read_journal(p)
    assert back == recs and torn == 0
    assert valid == os.path.getsize(p)


def test_journal_torn_tail_truncated_on_reopen(tmp_path):
    """A partial last frame (a death mid-write) is invisible to the reader
    and cut off on reopen; appends then continue."""
    p = str(tmp_path / "journal.wal")
    j = journal_lib.Journal(p)
    j.append({"t": "submit", "seq": 0})
    j.append({"t": "commit", "seqs": [0]})
    j.close()
    whole = os.path.getsize(p)
    with open(p, "ab") as f:
        f.write(struct.pack("<II", 999, 12345) + b'{"t":"sub')
    back, valid, torn = journal_lib.read_journal(p)
    assert len(back) == 2 and valid == whole and torn > 0
    j2 = journal_lib.Journal(p)
    assert j2.torn_bytes_dropped == torn
    assert os.path.getsize(p) == whole
    j2.append({"t": "submit", "seq": 1})
    j2.close()
    back2, _, torn2 = journal_lib.read_journal(p)
    assert [r["t"] for r in back2] == ["submit", "commit", "submit"]
    assert torn2 == 0


def test_journal_torn_append_leaves_half_a_frame(tmp_path):
    p = str(tmp_path / "journal.wal")
    j = journal_lib.Journal(p)
    j.append({"t": "submit", "seq": 0})
    whole = os.path.getsize(p)
    with pytest.raises(chaos.SimulatedCrash):
        with chaos.crash_at("journal:torn_append"):
            j.append({"t": "submit", "seq": 1, "id": 5})
    assert os.path.getsize(p) > whole
    back, valid, torn = journal_lib.read_journal(p)
    assert back == [{"t": "submit", "seq": 0}] and valid == whole
    assert torn == os.path.getsize(p) - whole


def test_journal_crc_stops_at_corruption(tmp_path):
    """A flipped byte fails its frame's CRC: the records before it are
    served, everything after is dropped."""
    p = tmp_path / "journal.wal"
    j = journal_lib.Journal(str(p))
    for i in range(5):
        j.append({"t": "submit", "seq": i})
    j.close()
    raw = bytearray(p.read_bytes())
    off = 0
    for _ in range(2):
        ln = struct.unpack_from("<I", raw, off)[0]
        off += 8 + ln
    raw[off + 8] ^= 0xFF
    p.write_bytes(bytes(raw))
    back, valid, torn = journal_lib.read_journal(str(p))
    assert [r["seq"] for r in back] == [0, 1]
    assert valid == off and torn == len(raw) - off


def test_journal_config_header_written_once(tmp_path):
    d = str(tmp_path)
    server = _server("fused_cuda", durability_dir=d)
    server.register_twin(0, np.zeros(DIM, np.float32))
    server.close()
    recs, _, _ = journal_lib.read_journal(journal_lib.journal_path(d))
    assert recs[0]["t"] == "config" and recs[0]["schema"] == 1
    assert recs[0]["cfg"]["max_batch"] == _KW["max_batch"]
    assert "device" not in recs[0]["cfg"]
    assert [r["t"] for r in recs[1:]] == ["register"]


def test_recover_refuses_fresh_server_on_history(tmp_path):
    """A fresh server on a directory with journal history would fork that
    history: it refuses and points at recover()."""
    d = str(tmp_path)
    server = _server("fused_cuda", durability_dir=d)
    server.register_twin(0, np.zeros(DIM, np.float32))
    server.submit(0, 4)
    server.drain()
    server.close()
    with pytest.raises(ValueError, match="recover"):
        _server("fused_cuda", durability_dir=d)
    with pytest.raises(ValueError, match="no usable journal"):
        StreamingFleetServer.recover(str(tmp_path / "empty"),
                                     *_fleet("fused_cuda"), device="cpu")
    with pytest.raises(RuntimeError, match="durability"):
        _server("fused_cuda").snapshot()
    with pytest.raises(ValueError, match="snapshot_every"):
        _server("fused_cuda", snapshot_every=-1)


# ---------------------------------------------------------------------------
# Snapshot atomicity
# ---------------------------------------------------------------------------

def test_snapshot_crash_before_rename_publishes_nothing(tmp_path):
    """A death after the snapshot's temporary directory is written but
    before the rename publishes nothing: recovery replays the journal
    alone and still reaches parity."""
    d = str(tmp_path)
    trace = _trace()
    fleet, params = _fleet("fused_cuda")
    live = StreamingFleetServer(fleet, params, durability_dir=d,
                                snapshot_every=3, device="cpu", **_KW)
    with pytest.raises(chaos.SimulatedCrash):
        with chaos.crash_at("snapshot:pre_rename"):
            live.serve_trace(trace, y0_of=_y0_of)
    live.close()
    assert journal_lib.load_latest_snapshot(d) is None
    rec, redelivered = StreamingFleetServer.recover(d, fleet, params,
                                                    device="cpu")
    assert rec.recovery.snapshot_lsn is None and rec.recovery.commits > 0
    resumed = rec.serve_trace(trace, y0_of=_y0_of,
                              start=rec.stream_stats.enqueued)
    rec.close()
    _assert_parity("fused_cuda", rec, list(redelivered) + list(resumed))


def test_snapshot_damaged_newest_falls_back_to_older(tmp_path):
    """A corrupted newest snapshot is skipped: recovery loads the older
    one, replays the longer suffix and still reaches bitwise parity."""
    d = str(tmp_path)
    fleet, params = _fleet("fused_cuda")
    live = StreamingFleetServer(fleet, params, durability_dir=d,
                                snapshot_every=2, device="cpu", **_KW)
    done = live.serve_trace(_trace(), y0_of=_y0_of)
    live.close()
    snap_root = os.path.join(d, journal_lib.SNAPSHOT_DIR)
    steps = ckpt.all_steps(snap_root)
    assert len(steps) >= 2, "the schedule made fewer than 2 snapshots"
    newest = os.path.join(snap_root, f"step_{steps[-1]:010d}")
    arrs = sorted(f for f in os.listdir(newest) if f.endswith(".npy"))
    with open(os.path.join(newest, arrs[0]), "r+b") as f:
        f.write(b"\x00" * 64)
    lsn, _, _ = journal_lib.load_latest_snapshot(d)
    assert lsn == steps[-2], "the damaged newest snapshot was not skipped"
    rec, redelivered = StreamingFleetServer.recover(d, fleet, params,
                                                    device="cpu")
    rec.close()
    assert rec.recovery.snapshot_lsn == steps[-2]
    _assert_parity("fused_cuda", rec, done + list(redelivered))


def test_recover_after_clean_run_is_parity(tmp_path):
    """Recovering a cleanly finished directory gives the final state
    exactly, and a further drain serves nothing."""
    d = str(tmp_path)
    fleet, params = _fleet("fused_cuda")
    live = StreamingFleetServer(fleet, params, durability_dir=d,
                                snapshot_every=4, device="cpu", **_KW)
    done = live.serve_trace(_trace(), y0_of=_y0_of)
    live.close()
    rec, redelivered = StreamingFleetServer.recover(d, fleet, params,
                                                    device="cpu")
    _assert_parity("fused_cuda", rec, done + list(redelivered))
    assert rec.drain() == [] and rec.pending == 0
    rec.close()


# ---------------------------------------------------------------------------
# The checkpointer's asynchronous writer
# ---------------------------------------------------------------------------

def _wait_in_thread(timeout=30.0) -> bool:
    """``wait_for_async`` on a helper thread, joined with a timeout: a
    dead writer would make it wait for ever.  True when it returned."""
    t = threading.Thread(target=ckpt.wait_for_async, daemon=True)
    t.start()
    t.join(timeout)
    return not t.is_alive()


def test_async_save_round_trips_through_jax_load_arrays(tmp_path):
    tree = {"w": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "steps": torch.tensor([3, 4], dtype=torch.int64)}
    extra = {"queue": [[0, 1, 4, 4, 0.5, None]], "seq": 7}
    path = ckpt.save(str(tmp_path), 5, tree, blocking=False, extra=extra)
    assert _wait_in_thread()
    arrays, manifest = jckpt.load_arrays(path)
    assert sorted(arrays) == ["steps", "w"] and manifest["extra"] == extra
    np.testing.assert_array_equal(arrays["w"], tree["w"].numpy())
    np.testing.assert_array_equal(arrays["steps"], tree["steps"].numpy())
    assert ckpt.all_steps(str(tmp_path)) == [5]


def test_async_save_killed_before_rename_publishes_nothing(tmp_path):
    """A non-blocking save that dies at ``snapshot:pre_rename`` on the
    writer thread publishes nothing, and ``wait_for_async`` returns then
    and later: the writer survives the death of one job."""
    tree = {"w": torch.ones(4)}
    with chaos.crash_at("snapshot:pre_rename"):
        ckpt.save(str(tmp_path), 1, tree, blocking=False)
        assert _wait_in_thread()
    assert ckpt.all_steps(str(tmp_path)) == []
    assert _wait_in_thread()
    ckpt.save(str(tmp_path), 2, tree, blocking=False)
    assert _wait_in_thread()
    assert ckpt.all_steps(str(tmp_path)) == [2]


def test_blocking_save_killed_before_rename_raises(tmp_path):
    with pytest.raises(chaos.SimulatedCrash):
        with chaos.crash_at("snapshot:pre_rename"):
            ckpt.save_twin(str(tmp_path), [{"w": torch.ones(2, 2),
                                            "b": torch.zeros(2)}])
    assert ckpt.latest_step(str(tmp_path)) is None


# ---------------------------------------------------------------------------
# Chaos harness hygiene and the CLI
# ---------------------------------------------------------------------------

def test_chaos_unknown_kill_point_rejected():
    with pytest.raises(ValueError, match="unknown kill point"):
        with chaos.crash_at("pump:typo"):
            pass
    with pytest.raises(ValueError, match="hit"):
        with chaos.crash_at("pump:pre_commit", hit=0):
            pass
    with pytest.raises(ValueError, match="times"):
        with chaos.flaky("x", times=0):
            pass
    assert chaos.KILL_POINTS == jchaos.KILL_POINTS


def test_chaos_disarms_after_fire_and_on_exit():
    fired, damage = [], []
    try:
        with chaos.crash_at("store:evict"):
            chaos.kill_point("store:evict", lambda: damage.append(1))
    except chaos.SimulatedCrash:
        fired.append(True)
    assert fired and damage == [1]
    chaos.kill_point("store:evict")          # disarmed: must not raise
    with chaos.crash_at("store:evict", hit=3):
        chaos.kill_point("store:evict")
        chaos.kill_point("store:evict")      # hits 1, 2: survive
    chaos.kill_point("store:evict")          # exited: disarmed
    assert chaos.SimulatedCrash.__bases__ == (BaseException,)


def test_chaos_cli_recovers_and_verifies(capsys):
    chaos.main(["--kill", "pump:post_commit", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "crashed: simulated crash at kill point 'pump:post_commit'" in out
    assert "bitwise equal to the uninterrupted run" in out
