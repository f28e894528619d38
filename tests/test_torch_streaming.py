"""The port's streaming serving slice against the JAX package, on the CPU.

Resumed rollouts (``rollout_batch_resumed`` on the digital, fused and
fused-analogue backends and on ``TwinFleet``), the host-paged
``TwinStateStore``, the traffic generators and ``StreamingFleetServer``.
Inputs come from numpy seeds; JAX-made params pass over as numpy; the JAX
package's fused kernels run in interpret mode, as its own tests run them.

Tolerances: the port within 1e-5 of the JAX package's peak (different
float32 arithmetic orders); within the port, split-and-resume through the
store is bitwise the uninterrupted rollout (the determinism contract of
``docs/serving.md``), and so is a streamed twin's stitched trajectory.
Traces, store statistics, server statistics and completion order are
equal to the JAX package's.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import traffic  # noqa: E402
from repro.core.analogue import AnalogueSpec as JSpec  # noqa: E402
from repro.core.backends import (DigitalBackend as JDigital,  # noqa: E402
                                 FusedAnalogueBackend, FusedPallasBackend)
from repro.core.twin import TwinFleet as JFleet  # noqa: E402
from repro.core.twin import make_autonomous_twin as jmake  # noqa: E402
from repro.core.twin import make_driven_twin as jdriven  # noqa: E402
from repro.launch import fleet_serving as jserve  # noqa: E402
from repro.launch import state_store as jstore  # noqa: E402
from repro.launch import traffic as jtraffic  # noqa: E402
from repro_torch.core.analogue import AnalogueSpec  # noqa: E402
from repro_torch.core.backends import (DigitalBackend,  # noqa: E402
                                       FusedAnalogueCudaBackend,
                                       FusedCudaBackend)
from repro_torch.core.twin import TwinFleet  # noqa: E402
from repro_torch.core.twin import make_autonomous_twin  # noqa: E402
from repro_torch.core.twin import make_driven_twin  # noqa: E402
from repro_torch.interop import params_from_numpy  # noqa: E402
from repro_torch.kernels.ops import window_times  # noqa: E402
from repro_torch.launch import chaos  # noqa: E402
from repro_torch.launch import traffic as ttraffic  # noqa: E402
from repro_torch.launch.fleet_serving import (  # noqa: E402
    StreamingFleetServer)
from repro_torch.launch.state_store import TwinStateStore  # noqa: E402

DT = 0.01
DIM = 3
TOL = 1e-5
SPLITS = [(1, 12), (5, 12), (11, 12), (8, 24)]
#: The JAX package's tier names beside the port's.
TIER_NAMES = {"digital": "digital", "fused_pallas": "fused_cuda",
              "analogue_fused": "analogue_fused_cuda",
              "analogue_fused_clean": "analogue_fused_cuda_clean"}

#: backend -> (JAX backend, port backend); the analogue pair is noise-free
#: in programming (the packages' programming generators differ) and in
#: reads, so the two packages hold the same conductances.
PAIRS = {
    "digital": (lambda: JDigital(), lambda: DigitalBackend()),
    "fused": (lambda: FusedPallasBackend(precision="f32"),
              lambda: FusedCudaBackend()),
    "analogue_fused": (
        lambda: FusedAnalogueBackend(spec=JSpec(prog_noise=0.0)),
        lambda: FusedAnalogueCudaBackend(spec=AnalogueSpec(prog_noise=0.0))),
}
#: port-only backends of the bitwise split-and-resume checks
PORT = {
    "digital": lambda: DigitalBackend(),
    "fused": lambda: FusedCudaBackend(),
    "analogue_noisy": lambda: FusedAnalogueCudaBackend(
        spec=AnalogueSpec(read_noise=0.02), prog_seed=7, read_seed=3),
}


def rel(a, b) -> float:
    a, b = np.asarray(a), np.asarray(b)
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


def t(x):
    return torch.from_numpy(np.array(x, dtype=np.float32, copy=True))


def carried(n=3, seed=3):
    return (np.random.default_rng(seed).normal(size=(n, DIM))
            * 0.1).astype(np.float32)


@functools.lru_cache(maxsize=None)
def jax_params(seed=0):
    p = jmake(DIM, hidden=8, n_hidden_layers=1).init(jax.random.PRNGKey(seed))
    return [{k: np.asarray(v) for k, v in layer.items()} for layer in p]


@functools.lru_cache(maxsize=None)
def programmed(key: str):
    jbe, tbe = PAIRS[key][0](), PAIRS[key][1]()
    jt = jmake(DIM, hidden=8, n_hidden_layers=1, backend=jbe)
    tt = make_autonomous_twin(DIM, hidden=8, n_hidden_layers=1, backend=tbe)
    jp = [{k: jnp.asarray(v) for k, v in layer.items()}
          for layer in jax_params()]
    return (jbe, jbe.program(jt.node.field, jp), tbe,
            tbe.program(tt.node.field, params_from_numpy(jax_params(),
                                                         "cpu")))


@functools.lru_cache(maxsize=None)
def port_programmed(key: str):
    be = PORT[key]()
    twin = make_autonomous_twin(DIM, hidden=8, n_hidden_layers=1, backend=be)
    return be, be.program(twin.node.field,
                          params_from_numpy(jax_params(), "cpu"))


# ---------------------------------------------------------------------------
# Resumed rollouts
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("key", list(PAIRS))
@pytest.mark.parametrize("k,T", SPLITS)
def test_resumed_rollout_matches_jax(key, k, T):
    """The whole window from step 0 and the tail resumed at step k, from
    the same carried states, in both packages."""
    jbe, jst, tbe, tst = programmed(key)
    ys = carried()
    for start, n in ((0, T), (k, T - k)):
        want = np.asarray(jbe.rollout_batch_resumed(
            jst, jnp.asarray(ys), dt=DT, num_steps=n, start_steps=start))
        got = tbe.rollout_batch_resumed(tst, t(ys), dt=DT, num_steps=n,
                                        start_steps=start)
        assert tuple(got.shape) == want.shape == (3, n + 1, DIM)
        assert rel(got.detach().numpy(), want) <= TOL


def split_and_resume(key: str, k: int, T: int):
    """Roll [0, k], then resume [k, T] from the state store; return
    (head, tail, full)."""
    be, state = port_programmed(key)
    ys = t(carried())
    n = ys.shape[0]
    full = be.rollout_batch_resumed(state, ys, dt=DT, num_steps=T)
    head = be.rollout_batch_resumed(state, ys, dt=DT, num_steps=k)
    store = TwinStateStore(DIM, n, device="cpu")
    ids = list(range(n))
    for i in ids:
        store.register(i, ys[i].numpy())
    store.fetch(ids)
    store.commit(ids, head[:, k], np.full(n, k))
    mid, steps, _ = store.fetch(ids)
    assert list(steps) == [k] * n
    tail = be.rollout_batch_resumed(state, mid, dt=DT, num_steps=T - k,
                                    start_steps=steps)
    return head, tail, full


@pytest.mark.parametrize("key", list(PORT))
@pytest.mark.parametrize("k,T", SPLITS)
def test_split_and_resume_through_the_store_is_bitwise(key, k, T):
    head, tail, full = split_and_resume(key, k, T)
    assert torch.equal(head, full[:, : k + 1])
    assert torch.equal(tail, full[:, k:])


def test_noisy_analogue_resume_is_keyed_by_the_offset():
    """The noisy tail replays the uninterrupted stream only because the
    shared offset keys the noise: the same tail at offset 0 differs."""
    be, state = port_programmed("analogue_noisy")
    _, tail, _ = split_and_resume("analogue_noisy", 5, 12)
    at0 = be.rollout_batch_resumed(state, tail[:, 0], dt=DT, num_steps=7)
    assert not torch.equal(at0, tail)


@pytest.mark.parametrize("key", list(PORT))
def test_resumed_rollout_is_solve_window_at_the_shared_offset(key):
    """``rollout_batch_resumed`` of a homogeneous batch is ``solve_window``
    at the batch's step; the server's window (offset 0) differs from it
    only on the noisy substrate, whose draws the offset keys."""
    be, state = port_programmed(key)
    ys = t(carried())
    starts = np.full(ys.shape[0], 5)
    resumed = be.rollout_batch_resumed(state, ys, dt=DT, num_steps=7,
                                       start_steps=starts)
    at5 = be.solve_window(state, ys, dt=DT, num_steps=7, starts=starts,
                          step_offset=5)
    at0 = be.solve_window(state, ys, dt=DT, num_steps=7, starts=starts)
    assert torch.equal(resumed, at5)
    assert torch.equal(at0, at5) == (key != "analogue_noisy")


def test_resumed_equals_plain_rollout_on_the_window_grid_digital():
    be, state = port_programmed("digital")
    ys = t(carried())
    ts = window_times(0.0, DT, 16)
    plain = torch.stack([be.rollout(state, y, ts) for y in ys])
    resumed = be.rollout_batch_resumed(state, ys, dt=DT, num_steps=16)
    assert torch.equal(plain, resumed)


@pytest.mark.parametrize("key", ["fused", "digital"])
def test_mixed_phases_batch_each_row_as_its_own_resume(key):
    """Twins at different global steps in one batch: each row equals that
    twin's own resume, bitwise (fused: per-twin drive slabs, offset 0)."""
    be, state = port_programmed(key)
    ys = t(carried())
    starts = np.array([0, 5, 11])
    mixed = be.rollout_batch_resumed(state, ys, dt=DT, num_steps=6,
                                     start_steps=starts)
    for i, s in enumerate(starts):
        solo = be.rollout_batch_resumed(state, ys[i: i + 1], dt=DT,
                                        num_steps=6, start_steps=[s])
        assert torch.equal(mixed[i], solo[0])


def test_mixed_phase_noisy_analogue_is_deterministic_per_batch():
    """Mixed phases on the noisy analogue substrate pass offset 0: the
    batch repeats bitwise, and equals the batch with every twin at step 0
    (the noise is keyed by the batch's step, not replayed per twin)."""
    be, state = port_programmed("analogue_noisy")
    ys = t(carried())
    starts = np.array([0, 5, 11])
    a = be.rollout_batch_resumed(state, ys, dt=DT, num_steps=6,
                                 start_steps=starts)
    b = be.rollout_batch_resumed(state, ys, dt=DT, num_steps=6,
                                 start_steps=starts)
    at0 = be.rollout_batch_resumed(state, ys, dt=DT, num_steps=6)
    assert torch.equal(a, b) and torch.equal(a, at0)


def test_resumed_rollout_argument_errors():
    be, state = port_programmed("digital")
    ys = t(carried())
    with pytest.raises(ValueError, match="non-negative"):
        be.rollout_batch_resumed(state, ys, dt=DT, num_steps=2,
                                 start_steps=np.array([0, -1, 0]))
    with pytest.raises(ValueError, match="3 non-negative"):
        be.rollout_batch_resumed(state, ys, dt=DT, num_steps=2,
                                 start_steps=[0, 1])
    fb, fstate = port_programmed("fused")
    for kw in (dict(method="euler"), dict(steps_per_interval=2)):
        with pytest.raises(ValueError, match="canonical step grid"):
            fb.rollout_batch_resumed(fstate, ys, dt=DT, num_steps=2, **kw)
    # a tensor of starts is read back once and means the same
    a = be.rollout_batch_resumed(state, ys, dt=DT, num_steps=3,
                                 start_steps=torch.tensor([2, 2, 4]))
    b = be.rollout_batch_resumed(state, ys, dt=DT, num_steps=3,
                                 start_steps=[2, 2, 4])
    assert torch.equal(a, b)


def drive_family_np(t_, th):
    return th[0] * jnp.sin(th[1] * t_)


def drive_family_torch(t_, th):
    return th[0] * torch.sin(th[1] * t_)


@pytest.mark.parametrize("key", ["digital", "fused"])
def test_driven_fleet_resume_matches_jax_and_splits_bitwise(key):
    """``TwinFleet.rollout_batch_resumed`` of a driven fleet (one drive
    per twin from its theta) at mixed phases: within 1e-5 of the JAX
    package, and split at step 4 it is bitwise the unsplit window."""
    jbe, tbe = PAIRS[key][0](), PAIRS[key][1]()
    jt = jdriven(2, drive=lambda s: jnp.sin(s), hidden=8, n_hidden_layers=1,
                 gradient="fused_vjp", backend=jbe)
    tt = make_driven_twin(2, drive=lambda s: torch.sin(s), hidden=8,
                          n_hidden_layers=1, gradient="fused_vjp",
                          backend=tbe)
    jp = jt.init(jax.random.PRNGKey(2))
    tp = params_from_numpy([{k: np.asarray(v) for k, v in layer.items()}
                            for layer in jp], "cpu")
    ys = (np.random.default_rng(5).normal(size=(3, 2)) * 0.1).astype(
        np.float32)
    th = np.float32([[0.5, 2.0], [0.4, 2.5], [0.7, 1.5]])
    starts = np.array([0, 3, 9])
    want = np.asarray(JFleet(jt, drive_family=drive_family_np)
                      .rollout_batch_resumed(jp, jnp.asarray(ys), dt=DT,
                                             num_steps=10,
                                             start_steps=starts,
                                             drive_params=jnp.asarray(th)))
    fleet = TwinFleet(tt, drive_family=drive_family_torch)
    with torch.no_grad():
        got = fleet.rollout_batch_resumed(tp, t(ys), dt=DT, num_steps=10,
                                          start_steps=starts,
                                          drive_params=t(th))
        assert rel(got.numpy(), want) <= TOL
        head = fleet.rollout_batch_resumed(tp, t(ys), dt=DT, num_steps=4,
                                           start_steps=starts,
                                           drive_params=t(th))
        tail = fleet.rollout_batch_resumed(tp, head[:, 4], dt=DT,
                                           num_steps=6,
                                           start_steps=starts + 4,
                                           drive_params=t(th))
    assert torch.equal(head, got[:, :5]) and torch.equal(tail, got[:, 4:])
    with pytest.raises(ValueError, match="together"):
        fleet.rollout_batch_resumed(tp, t(ys), dt=DT, num_steps=2)


# ---------------------------------------------------------------------------
# TwinStateStore
# ---------------------------------------------------------------------------

def test_store_lru_eviction_pages_not_drops():
    store = TwinStateStore(2, hot_capacity=2, device="cpu")
    for i in range(4):
        store.register(i, np.float32([i, i]))
    store.fetch([0, 1])
    store.fetch([2])                      # evicts 0 (LRU)
    assert 0 not in store.hot_ids and 2 in store.hot_ids
    assert store.stats.evictions == 1
    y, _ = store.peek(0)                  # paged, not lost
    np.testing.assert_array_equal(y, np.float32([0, 0]))
    store.fetch([0])                      # pages 0 back in
    store.check_invariants()
    assert store.stats.page_ins == 4


def test_store_fetch_touches_lru_order():
    store = TwinStateStore(2, hot_capacity=2, device="cpu")
    for i in range(3):
        store.register(i, np.float32([i, i]))
    store.fetch([0, 1])
    store.fetch([0])                      # 0 becomes MRU -> 1 is LRU
    store.fetch([2])                      # must evict 1, not 0
    assert set(store.hot_ids) == {0, 2}
    store.check_invariants()


def test_store_commit_round_trips_state_and_evicts_in_one_fetch():
    store = TwinStateStore(3, hot_capacity=2, device="cpu")
    store.register("a", np.zeros(3, np.float32))
    store.fetch(["a"])
    store.commit(["a"], torch.tensor([[1.0, 2.0, 3.0]]), np.array([5]))
    y, step = store.peek("a")
    np.testing.assert_array_equal(y, np.float32([1, 2, 3]))
    assert step == 5
    store.register("b", np.zeros(3, np.float32))
    store.register("c", np.float32([7, 8, 9]))
    store.fetch(["b", "c"])               # evicts "a" on its way in
    y2, step2 = store.peek("a")
    np.testing.assert_array_equal(y2, y)
    assert step2 == 5
    # two evictions in one fetch: both rows leave before their slots refill
    store.register("d", np.float32([4, 5, 6]))
    ys, steps, _ = store.fetch(["a", "d"])
    np.testing.assert_array_equal(ys.numpy(), np.float32([[1, 2, 3],
                                                          [4, 5, 6]]))
    assert list(steps) == [5, 0]
    for tid, want in (("b", [0, 0, 0]), ("c", [7, 8, 9])):
        np.testing.assert_array_equal(store.peek(tid)[0], np.float32(want))
    store.check_invariants()


def test_store_rejects_bad_usage():
    store = TwinStateStore(2, hot_capacity=2, device="cpu")
    store.register(0, np.zeros(2, np.float32))
    with pytest.raises(ValueError, match="already registered"):
        store.register(0, np.zeros(2, np.float32))
    with pytest.raises(ValueError, match="shape"):
        store.register(1, np.zeros(3, np.float32))
    with pytest.raises(ValueError, match="non-finite"):
        store.register(2, np.float32([np.nan, 0.0]))
    with pytest.raises(KeyError, match="unregistered"):
        store.fetch([99])
    store.register(3, np.zeros(2, np.float32))
    with pytest.raises(ValueError, match="duplicate"):
        store.fetch([0, 0])
    store.register(4, np.zeros(2, np.float32))
    with pytest.raises(ValueError, match="exceeds hot_capacity"):
        store.fetch([0, 3, 4])
    with pytest.raises(KeyError, match="not hot"):
        store.commit([4], np.zeros((1, 2), np.float32), np.array([1]))
    store.register("t", np.zeros(2, np.float32), theta=np.float32([1.0]))
    with pytest.raises(ValueError, match="mixed drive"):
        store.fetch([0, "t"])
    with pytest.raises(ValueError, match="hot_capacity"):
        TwinStateStore(2, hot_capacity=0)
    with pytest.raises(chaos.SimulatedCrash):
        with chaos.crash_at("store:evict"):
            store.fetch([4, 3])


def test_store_defaults_to_the_card_and_raises_without_it(monkeypatch):
    """No ``device`` means cuda, as every entry point of the port: without
    a card the store raises instead of placing the slab on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TwinStateStore(2, hot_capacity=2)
    assert TwinStateStore(2, hot_capacity=2, device="cpu").device.type == \
        "cpu"


def test_store_theta_survives_paging():
    store = TwinStateStore(2, hot_capacity=1, device="cpu")
    store.register("a", np.zeros(2, np.float32), theta=np.float32([1, 2]),
                   step=3)
    store.register("b", np.zeros(2, np.float32), theta=np.float32([3, 4]))
    _, steps, thetas = store.fetch(["a"])
    assert list(steps) == [3]
    np.testing.assert_array_equal(thetas.numpy(), np.float32([[1, 2]]))
    store.fetch(["b"])                        # evicts "a"
    np.testing.assert_array_equal(store.theta("a"), np.float32([1, 2]))
    _, _, thetas = store.fetch(["a"])
    np.testing.assert_array_equal(thetas.numpy(), np.float32([[1, 2]]))


def test_store_matches_jax_store_operation_for_operation():
    """One seeded sequence of register / fetch / commit on both packages'
    stores: equal hot ids (in LRU order), statistics and states."""
    rng = np.random.default_rng(0)
    js = jstore.TwinStateStore(DIM, 5)
    ts = TwinStateStore(DIM, 5, device="cpu")
    for i in range(12):
        y = rng.normal(size=DIM).astype(np.float32)
        js.register(i, y)
        ts.register(i, y)
    for op in range(40):
        ids = [int(x) for x in rng.choice(12, size=rng.integers(1, 6),
                                          replace=False)]
        jy, jsteps, _ = js.fetch(ids)
        ty, tsteps, _ = ts.fetch(ids)
        np.testing.assert_array_equal(np.asarray(jy), ty.numpy())
        np.testing.assert_array_equal(jsteps, tsteps)
        if op % 2:
            new = rng.normal(size=(len(ids), DIM)).astype(np.float32)
            js.commit(ids, new, jsteps + op)
            ts.commit(ids, new, tsteps + op)
        assert js.hot_ids == ts.hot_ids
        assert js.stats.as_dict() == ts.stats.as_dict()
    for i in range(12):
        jy, jstep = js.peek(i)
        ty, tstep = ts.peek(i)
        np.testing.assert_array_equal(jy, ty)
        assert jstep == tstep
    ts.check_invariants()


# ---------------------------------------------------------------------------
# Traffic
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(jtraffic.TRACES))
def test_traces_equal_jax_field_for_field(name):
    kw = dict(max_horizon=40) if name != "hot_loop" else {}
    want = jtraffic.TRACES[name](7, 50, **kw)
    got = ttraffic.TRACES[name](7, 50, **kw)
    assert [tuple(vars(a).values()) for a in got] == \
        [tuple(vars(a).values()) for a in want]
    assert ttraffic.population_of(got) == jtraffic.population_of(want)


# ---------------------------------------------------------------------------
# StreamingFleetServer
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def fleets(key: str = "fused"):
    """(JAX fleet, JAX params, port fleet, port params): one small
    autonomous twin on each package's counterpart substrate."""
    jbe, tbe = PAIRS[key][0](), PAIRS[key][1]()
    jt = jmake(DIM, hidden=8, n_hidden_layers=1, gradient="fused_vjp",
               backend=jbe)
    tt = make_autonomous_twin(DIM, hidden=8, n_hidden_layers=1,
                              gradient="fused_vjp", backend=tbe)
    jp = [{k: jnp.asarray(v) for k, v in layer.items()}
          for layer in jax_params(1)]
    return (JFleet(jt), jp, TwinFleet(tt),
            params_from_numpy(jax_params(1), "cpu"))


def y0_maker(seed=11):
    rng = np.random.default_rng(seed)
    y0s = {}

    def y0_of(tid):
        if tid not in y0s:
            y0s[tid] = rng.normal(size=DIM).astype(np.float32) * 0.1
        return y0s[tid]
    return y0_of


SERVER_KW = dict(dt=DT, hot_capacity=8, max_batch=4, max_window=8,
                 horizon_quantum=4)


def serve(trace, key="fused", jax_too=False, **kw):
    cfg = {**SERVER_KW, **kw}
    jfleet, jp, tfleet, tp = fleets(key)
    server = StreamingFleetServer(tfleet, tp, device="cpu", **cfg)
    done = server.serve_trace(trace, y0_of=y0_maker())
    if not jax_too:
        return server, done
    jserver = jserve.StreamingFleetServer(jfleet, jp, **cfg)
    return server, done, jserver, jserver.serve_trace(trace,
                                                      y0_of=y0_maker())


def renamed(stats: dict) -> dict:
    sv = stats["serving"]
    return {**stats, "serving": {
        **sv, "served_by": {TIER_NAMES[k]: v
                            for k, v in sv["served_by"].items()},
        "probe_errors": {TIER_NAMES[k]: v
                         for k, v in sv["probe_errors"].items()}}}


def assert_servers_agree(server, done, jserver, jdone):
    """Equal statistics and completion order (seq, twin, start step,
    tier); trajectories within 1e-5 of the peak."""
    assert server.stats().as_dict() == renamed(jserver.stats().as_dict())
    assert [(c.seq, c.twin_id, c.start_step, c.tier) for c in done] == \
        [(c.seq, c.twin_id, c.start_step, TIER_NAMES[c.tier])
         for c in jdone]
    for c, jc in zip(done, jdone):
        assert c.trajectory.shape == jc.trajectory.shape
        assert rel(c.trajectory, jc.trajectory) <= TOL


@pytest.mark.parametrize("trace_name", sorted(jtraffic.TRACES))
def test_server_invariants_and_parity_with_jax(trace_name):
    """Every traffic shape through both servers: the port drops nothing,
    keeps per-twin order and conserves requests and state (the deadline
    trace expires by design: conservation only), with the JAX server's
    statistics and completion order."""
    trace = ttraffic.TRACES[trace_name](seed=5, n_requests=24,
                                        max_horizon=12)
    server, done, jserver, jdone = serve(trace, jax_too=True)
    if trace_name == "deadline":
        traffic.check_conservation(server, done)
        traffic.check_arrival_order(done)
        traffic.check_state_safety(server, trace, done)
    else:
        traffic.check_all(server, trace, done)
    assert_servers_agree(server, done, jserver, jdone)


def test_server_parity_digital_and_analogue_tiers():
    trace = ttraffic.poisson_trace(seed=9, n_requests=20, population=12,
                                   min_horizon=2, max_horizon=10)
    for key in ("digital", "analogue_fused"):
        server, done, jserver, jdone = serve(trace, key, jax_too=True,
                                             hot_capacity=4)
        traffic.check_all(server, trace, done)
        assert server.store.stats.evictions > 0
        assert_servers_agree(server, done, jserver, jdone)


@pytest.mark.parametrize("key", ["fused", "digital", "analogue_fused"])
def test_streamed_twin_is_bitwise_one_uninterrupted_rollout(key):
    """Continuous batching is invisible in the numbers: each twin's
    stitched completions equal one uninterrupted resumed rollout of the
    same total horizon from its y0, bitwise."""
    trace = ttraffic.poisson_trace(seed=2, n_requests=20, population=6,
                                   min_horizon=2, max_horizon=12)
    server, done = serve(trace, key)
    traffic.check_all(server, trace, done)
    be, state = server._programs[0]
    by_twin = {}
    for c in sorted(done, key=lambda c: c.seq):
        by_twin.setdefault(c.twin_id, []).append(c.trajectory)
    for parts in by_twin.values():
        stitched = np.concatenate([parts[0]] + [p[1:] for p in parts[1:]])
        full = be.rollout_batch_resumed(state, t(stitched[None, 0]), dt=DT,
                                        num_steps=stitched.shape[0] - 1)
        np.testing.assert_array_equal(stitched, full[0].detach().numpy())


def test_streaming_deadline_trace_expires_exactly_once():
    trace = ttraffic.deadline_trace(seed=5, n_requests=30, population=8,
                                    max_horizon=10, tight_fraction=0.4)
    server, done = serve(trace)
    s = server.stats().stream
    assert s.expired > 0
    traffic.check_conservation(server, done)
    traffic.check_state_safety(server, trace, done)
    assert server.drain(now=trace[-1].time + 1.0) == []
    assert server.stats().stream.expired == s.expired
    traffic.check_conservation(server, done)


def test_streaming_pages_a_population_4x_the_hot_slab():
    trace = ttraffic.poisson_trace(seed=9, n_requests=40, population=32,
                                   min_horizon=2, max_horizon=10)
    server, done = serve(trace, hot_capacity=4, max_batch=4)
    assert ttraffic.population_of(trace) >= 4 * server.store.hot_capacity
    traffic.check_all(server, trace, done)
    assert server.store.stats.evictions > 0


def test_streaming_deterministic_replay_and_long_request_splits():
    trace = ttraffic.bursty_trace(seed=4, n_requests=16, population=8,
                                  max_horizon=10)
    _, a = serve(trace)
    _, b = serve(trace)
    assert [(c.seq, c.twin_id, c.tier) for c in a] == \
        [(c.seq, c.twin_id, c.tier) for c in b]
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x.trajectory, y.trajectory)
    trace = [ttraffic.Arrival(0.0, 0, 21)]
    server, done = serve(trace, max_window=8)
    traffic.check_all(server, trace, done)
    assert len(done) == 1 and done[0].trajectory.shape == (22, DIM)
    assert server.stream_stats.splits >= 2


def small_server(**kw):
    _, _, tfleet, tp = fleets()
    cfg = dict(dt=DT, hot_capacity=4, max_batch=2, max_window=8,
               horizon_quantum=4, device="cpu")
    cfg.update(kw)
    return StreamingFleetServer(tfleet, tp, **cfg)


def test_streaming_front_door_and_submit_validation_name_the_argument():
    server = small_server()
    with pytest.raises(KeyError, match="not registered"):
        server.submit("ghost", 4)
    server.register_twin(0, np.zeros(DIM, np.float32))
    with pytest.raises(ValueError, match="theta"):
        server.register_twin(1, np.zeros(DIM, np.float32),
                             theta=np.float32([1.0]))
    for bad, match in ((dict(horizon=0), "horizon"),
                       (dict(horizon=True), "horizon"),
                       (dict(horizon=2.5), "horizon"),
                       (dict(horizon=4, t_arrival=float("nan")),
                        "t_arrival"),
                       (dict(horizon=4, t_arrival=1.0, deadline=0.5),
                        "deadline"),
                       (dict(horizon=4, deadline=float("inf")), "deadline")):
        with pytest.raises(ValueError, match=match):
            server.submit(0, **bad)
    assert server.stats().stream.enqueued == 0 and server.pending == 0
    for kw, match in ((dict(hot_capacity=2, max_batch=4), "max_batch"),
                      (dict(dt=0.0), "dt"), (dict(max_window=0),
                                             "max_window"),
                      (dict(max_queue=0), "max_queue"),
                      (dict(shed_policy="lifo"), "shed_policy"),
                      (dict(transient_retries=-1), "transient_retries")):
        with pytest.raises(ValueError, match=match):
            small_server(**kw)


def test_streaming_backpressure_reject_new():
    server = small_server(max_queue=2, shed_policy="reject_new")
    rng = np.random.default_rng(3)
    for tid in range(4):
        server.register_twin(tid, rng.normal(size=DIM).astype(np.float32)
                             * 0.1)
    accepted = [server.submit(tid, 4) for tid in range(2)]
    assert all(s is not None for s in accepted)
    assert server.submit(2, 4) is None and server.submit(3, 4) is None
    s = server.stats().stream
    assert s.enqueued == 4 and s.shed == 2 and server.pending == 2
    done = server.drain()
    assert sorted(c.seq for c in done) == accepted
    traffic.check_conservation(server, done)


def test_streaming_backpressure_drop_oldest_same_twin():
    server = small_server(max_queue=2, shed_policy="drop_oldest")
    rng = np.random.default_rng(4)
    for tid in ("a", "b"):
        server.register_twin(tid, rng.normal(size=DIM).astype(np.float32)
                             * 0.1)
    server.submit("a", 4)
    s1 = server.submit("b", 4)
    s2 = server.submit("a", 8)          # sheds s0 (same twin, oldest)
    assert [r.seq for r in server._queue] == [s1, s2]
    s3 = server.submit("b", 4)          # sheds s1
    server.register_twin("c", np.zeros(DIM, np.float32))
    assert server.submit("c", 4) is None
    done = server.drain()
    assert sorted(c.seq for c in done) == sorted([s2, s3])
    st = server.stats().stream
    assert st.enqueued == 5 and st.shed == 3 and st.served == 2
    traffic.check_conservation(server, done)


def test_streaming_poison_request_quarantined_with_diagnostic():
    """NaN weights: the only tier is non-finite, so the request is parked
    with a diagnostic naming the tier and the twin's state is untouched."""
    _, _, tfleet, tp = fleets()
    bad = [{k: v * float("nan") for k, v in layer.items()} for layer in tp]
    server = StreamingFleetServer(tfleet, bad, dt=DT, hot_capacity=4,
                                  max_batch=2, max_window=8,
                                  horizon_quantum=4, device="cpu")
    y0 = np.float32([0.1, 0.2, 0.3])
    server.register_twin("t", y0)
    seq = server.submit("t", 4)
    assert server.drain() == [] and server.stream_stats.quarantined == 1
    q = server.quarantine[seq]
    assert q.twin_id == "t" and q.horizon == 4
    assert "non-finite" in q.reason and "fused_cuda" in q.reason
    traffic.check_conservation(server, [])
    y, step = server.store.peek("t")
    np.testing.assert_array_equal(y, y0)
    assert step == 0
    assert server.drain() == [] and server.stream_stats.quarantined == 1


def test_streaming_drain_with_a_quarantined_pending_mix():
    server = small_server()
    rng = np.random.default_rng(21)
    for tid in range(4):
        server.register_twin(tid, rng.normal(size=DIM).astype(np.float32)
                             * 0.1)
    server.register_twin("hot", np.float32([3e38, 3e38, 3e38]))
    seqs = [server.submit(tid, 4) for tid in range(4)]
    bad = server.submit("hot", 8)
    done = server.drain()
    assert sorted(c.seq for c in done) == seqs
    assert server.stream_stats.quarantined == 1 and bad in server.quarantine
    assert server.pending == 0
    traffic.check_conservation(server, done)


def test_streaming_transient_fault_retried_on_the_same_tier():
    server = small_server(transient_retries=2, backoff_base_s=0.0)
    server.register_twin(0, np.float32([0.1, 0.2, 0.3]))
    server.submit(0, 4)
    with chaos.flaky("pump:run_tier", times=2):
        done = server.drain()
    assert len(done) == 1 and done[0].tier == "fused_cuda"
    assert server.serving_stats.transient_retries == 2
    assert server.stream_stats.quarantined == 0


def test_streaming_transient_exhaustion_without_a_chain_raises():
    server = small_server(transient_retries=1, backoff_base_s=0.0)
    server.register_twin(0, np.float32([0.1, 0.2, 0.3]))
    server.submit(0, 4)
    with chaos.flaky("pump:run_tier", times=2):
        with pytest.raises(RuntimeError, match="injected transient"):
            server.drain()


def test_streaming_stats_snapshot_is_a_deep_copy():
    trace = ttraffic.poisson_trace(seed=3, n_requests=8, population=4,
                                   max_horizon=8)
    server, done = serve(trace)
    snap = server.stats()
    assert snap.stream.served == len(done)
    assert snap.store.page_ins == server.store.stats.page_ins
    d = snap.as_dict()
    assert set(d) == {"stream", "serving", "store"}
    before = snap.stream.enqueued
    server.submit(done[0].twin_id, 4)
    assert snap.stream.enqueued == before
    server.drain()


def test_streaming_store_audit_env_flag(monkeypatch):
    monkeypatch.setenv("REPRO_STORE_AUDIT", "1")
    trace = ttraffic.poisson_trace(seed=6, n_requests=10, population=4,
                                   max_horizon=8)
    audits = []
    real = TwinStateStore.check_invariants
    monkeypatch.setattr(TwinStateStore, "check_invariants",
                        lambda self: audits.append(1) or real(self))
    server, done = serve(trace)
    assert server._audit is True
    assert len(audits) == server.stream_stats.batches > 0
    traffic.check_all(server, trace, done)


def test_chaos_registry_arms_validates_and_disarms():
    """Kill points crash on their hit-th execution and get past the retry
    path (a crash is not a transient fault); names and counts are
    validated; ``reset`` disarms everything."""
    with pytest.raises(ValueError, match="unknown kill point"):
        with chaos.crash_at("pump:commit"):
            pass
    with pytest.raises(ValueError, match="hit"):
        with chaos.crash_at("pump:pre_commit", hit=0):
            pass
    with pytest.raises(ValueError, match="times"):
        with chaos.flaky("pump:run_tier", times=0):
            pass
    server = small_server(transient_retries=2, backoff_base_s=0.0)
    for tid in range(3):
        server.register_twin(tid, np.float32([0.1, 0.2, 0.3]) * (tid + 1))
        server.submit(tid, 4)
    with chaos.crash_at("pump:post_commit", hit=2):
        with pytest.raises(chaos.SimulatedCrash, match="post_commit"):
            server.drain()
    s = server.stats()
    assert s.stream.batches == 2 and s.store.commits == 2
    assert s.serving.transient_retries == 0       # not retried
    with chaos.crash_at("pump:pre_commit"), chaos.flaky("pump:run_tier"):
        chaos.reset()
        chaos.kill_point("pump:pre_commit")
        chaos.fault_point("pump:run_tier")
    server.drain()
    assert server.pending == 0
