"""The port's streaming server on the bf16 substrate, against the JAX
package on the CPU.

``StreamingFleetServer`` on ``FusedCudaBackend(precision="bf16_f32acc" |
"bf16")`` serves every request and hands its completions over in float32,
as the JAX package's server does on ``FusedPallasBackend`` with the same
policy: the window is widened on the host (numpy has no bfloat16).  The
same trace through both packages gives the same statistics, completion
order and trajectories within 1e-6 of the peak (the port's plain bf16
rollout is bitwise the JAX package's interpret-mode kernel, so the
trajectories come out bitwise; the test reports it).  A crash at a kill
point and ``recover`` under ``bf16_f32acc`` then end bitwise the
crash-free run: the journal replay goes through the same widening.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import traffic  # noqa: E402
from repro.core.backends import FusedPallasBackend  # noqa: E402
from repro.core.twin import TwinFleet as JFleet  # noqa: E402
from repro.core.twin import make_autonomous_twin as jmake  # noqa: E402
from repro.launch import fleet_serving as jserve  # noqa: E402
from repro_torch.core.backends import FusedCudaBackend  # noqa: E402
from repro_torch.core.twin import TwinFleet  # noqa: E402
from repro_torch.core.twin import make_autonomous_twin  # noqa: E402
from repro_torch.interop import params_from_numpy  # noqa: E402
from repro_torch.launch import chaos  # noqa: E402
from repro_torch.launch import traffic as ttraffic  # noqa: E402
from repro_torch.launch.fleet_serving import (  # noqa: E402
    StreamingFleetServer)

DIM = 3
TOL = 1e-6
POLICIES = ("bf16_f32acc", "bf16")
KW = dict(dt=0.01, hot_capacity=4, max_batch=4, max_window=8,
          horizon_quantum=4)
TIER_NAMES = {"fused_pallas": "fused_cuda", "digital": "digital"}


def rel(a, b) -> float:
    a, b = np.asarray(a), np.asarray(b)
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


@functools.lru_cache(maxsize=None)
def jax_params():
    p = jmake(DIM, hidden=8, n_hidden_layers=1).init(jax.random.PRNGKey(4))
    rng = np.random.default_rng(4)
    return [{"w": np.asarray(layer["w"]),
             "b": (0.1 * rng.standard_normal(layer["b"].shape)
                   ).astype(np.float32)} for layer in p]


def fleets(prec: str):
    """(JAX fleet, JAX params, port fleet, port params) on the bf16
    substrate of ``prec``."""
    jt = jmake(DIM, hidden=8, n_hidden_layers=1, gradient="fused_vjp",
               backend=FusedPallasBackend(precision=prec))
    tt = make_autonomous_twin(DIM, hidden=8, n_hidden_layers=1,
                              gradient="fused_vjp",
                              backend=FusedCudaBackend(precision=prec))
    jp = [{k: jnp.asarray(v) for k, v in layer.items()}
          for layer in jax_params()]
    return JFleet(jt), jp, TwinFleet(tt), params_from_numpy(jax_params(),
                                                            "cpu")


def y0_of(tid):
    return (np.random.default_rng(50 + tid).normal(size=DIM)
            .astype(np.float32) * 0.3)


def trace(seed=3, n=14):
    return ttraffic.poisson_trace(seed, n, population=6, max_horizon=20)


@functools.lru_cache(maxsize=None)
def port_run(prec: str):
    _, _, fleet, params = fleets(prec)
    server = StreamingFleetServer(fleet, params, device="cpu", **KW)
    done = server.serve_trace(trace(), y0_of=y0_of)
    ids, _, _, _ = server.store.export_state()
    return server, done, {tid: server.store.peek(tid) for tid in ids}


@pytest.mark.parametrize("prec", POLICIES)
def test_bf16_stream_completions_are_float32_and_match_jax(prec):
    server, done, _ = port_run(prec)
    jfleet, jp, _, _ = fleets(prec)
    jserver = jserve.StreamingFleetServer(jfleet, jp, **KW)
    jdone = jserver.serve_trace(trace(), y0_of=y0_of)
    traffic.check_all(server, trace(), done)
    assert len(done) == len(jdone) == server.stream_stats.served > 0
    assert server.stream_stats.splits > 0          # windows were stitched
    assert [(c.seq, c.twin_id, c.start_step, c.tier) for c in done] == \
        [(c.seq, c.twin_id, c.start_step, TIER_NAMES[c.tier])
         for c in jdone]
    stats, jstats = server.stats().as_dict(), jserver.stats().as_dict()
    assert stats["stream"] == jstats["stream"]
    assert stats["store"] == jstats["store"]
    bitwise = True
    for c, jc in zip(done, jdone):
        assert c.trajectory.dtype == jc.trajectory.dtype == np.float32
        assert c.trajectory.shape == jc.trajectory.shape
        assert np.isfinite(c.trajectory).all()
        assert rel(c.trajectory, jc.trajectory) <= TOL
        bitwise &= np.array_equal(c.trajectory, jc.trajectory)
    # every served value is a bf16 value widened to float32
    for c in done:
        widened = torch.from_numpy(c.trajectory).to(torch.bfloat16).float()
        assert np.array_equal(widened.numpy(), c.trajectory)
    print(f"{prec}: completions bitwise the JAX package's: {bitwise}")


@pytest.mark.parametrize("kill,hit", [("pump:pre_commit", 2),
                                      ("pump:post_commit", 3),
                                      ("snapshot:pre_rename", 1)])
def test_bf16_crash_and_recover_end_bitwise_the_crash_free_run(
        tmp_path, kill, hit):
    prec = "bf16_f32acc"
    _, ref_done, ref_states = port_run(prec)
    _, _, fleet, params = fleets(prec)
    d = str(tmp_path)
    live = StreamingFleetServer(fleet, params, durability_dir=d,
                                snapshot_every=2, device="cpu", **KW)
    delivered = []
    with pytest.raises(chaos.SimulatedCrash):
        with chaos.crash_at(kill, hit=hit):
            live.serve_trace(trace(), y0_of=y0_of, sink=delivered)
    live.close()
    rec, redelivered = StreamingFleetServer.recover(d, fleet, params,
                                                    device="cpu")
    resumed = rec.serve_trace(trace(), y0_of=y0_of,
                              start=rec.stream_stats.enqueued)
    rec.close()
    got = delivered + list(redelivered) + list(resumed)
    assert {c.seq for c in got} == {c.seq for c in ref_done}
    want = {c.seq: c.trajectory for c in ref_done}
    for c in got:
        assert c.trajectory.dtype == np.float32
        np.testing.assert_array_equal(c.trajectory, want[c.seq])
    for tid, (y_ref, s_ref) in ref_states.items():
        y_rec, s_rec = rec.store.peek(tid)
        assert s_rec == s_ref
        np.testing.assert_array_equal(y_rec, y_ref)
