"""The port's serving SLO, fallback chain and the two repairs that came
with streaming serving, against the JAX package on the CPU.

``ServingSLO``, ``fallback_chain`` and ``FleetServer(slo=)``'s health
probes (demotion, re-promotion, retries), the streaming server's SLO
chain on a driven analogue fleet, the trainable analogue write path keyed
by a resumed rollout's step offset, and ``RepairReport`` fields kept on
the device.  The JAX package's ``FleetServer`` runs on a one-device mesh
with Auto axes (its default mesh has Explicit axes on this JAX, which its
serving path rejects).  Inputs come from numpy seeds; JAX-made params
pass over as numpy.

Tolerances: served trajectories within 1e-5 of the JAX package's peak;
probe errors within 1e-4 (they are ratios of rollout differences);
gradients within 1e-4 of each gradient's peak (the fused VJP against
JAX's autodiff through the unrolled RK4); repair-report errors 1e-5 rel.
Both packages program the analogue arrays without programming noise
where their numbers are compared (their programming generators differ).
"""
import functools
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import traffic  # noqa: E402
from repro.core import analogue as jan  # noqa: E402
from repro.core import faults as jfaults  # noqa: E402
from repro.core.backends import DigitalBackend as JDigital  # noqa: E402
from repro.core.backends import FusedAnalogueBackend  # noqa: E402
from repro.core.twin import TwinFleet as JFleet  # noqa: E402
from repro.core.twin import make_autonomous_twin as jmake  # noqa: E402
from repro.core.twin import make_driven_twin as jdriven  # noqa: E402
from repro.launch import fleet_serving as jserve  # noqa: E402
from repro.train import hw_aware as jhw  # noqa: E402
from repro_torch.core import analogue as tan  # noqa: E402
from repro_torch.core import faults as tfaults  # noqa: E402
from repro_torch.core.backends import (AnalogueBackend,  # noqa: E402
                                       DigitalBackend,
                                       FusedAnalogueCudaBackend,
                                       FusedCudaBackend)
from repro_torch.core.twin import TwinFleet  # noqa: E402
from repro_torch.core.twin import make_autonomous_twin  # noqa: E402
from repro_torch.core.twin import make_driven_twin  # noqa: E402
from repro_torch.interop import params_from_numpy  # noqa: E402
from repro_torch.launch import chaos  # noqa: E402
from repro_torch.launch import traffic as ttraffic  # noqa: E402
from repro_torch.launch.fleet_serving import (FleetServer,  # noqa: E402
                                              ServingSLO,
                                              StreamingFleetServer,
                                              fallback_chain)

TOL = 1e-5
PROBE_TOL = 1e-4
GRAD_TOL = 1e-4
CAL = "calibration/paper_device.json"
TIER_NAMES = {"digital": "digital", "analogue_fused": "analogue_fused_cuda",
              "analogue_fused_clean": "analogue_fused_cuda_clean"}


def rel(a, b) -> float:
    a, b = np.asarray(a), np.asarray(b)
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


def t(x):
    return torch.from_numpy(np.array(x, dtype=np.float32, copy=True))


def to_numpy(params):
    return [{k: np.asarray(v) for k, v in layer.items()} for layer in params]


def jax_mesh():
    return jax.sharding.Mesh(np.array(jax.devices()[:1]), ("twins",))


# ---------------------------------------------------------------------------
# ServingSLO and the fallback chain
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw,match", [
    (dict(max_rel_error=0.0), "max_rel_error"),
    (dict(probe_every=0), "probe_every"),
    (dict(probe_horizon=0), "probe_horizon"),
    (dict(probe_fleet=0), "probe_fleet"),
    (dict(max_retries=-1), "max_retries"),
    (dict(timeout_s=0.0), "timeout_s"),
])
def test_serving_slo_validation(kw, match):
    with pytest.raises(ValueError, match=match):
        ServingSLO(**kw)


def test_fallback_chain_tiers():
    fleet = TwinFleet(make_driven_twin(1, drive=None, hidden=14))
    spec = tan.AnalogueSpec(prog_noise=0.0, read_noise=0.01)
    fm = tfaults.make_fault_model(("stuck", dict(rate=0.01)), seed=2)
    noisy = FusedAnalogueCudaBackend(spec=spec, prog_seed=4, read_seed=5,
                                     faults=fm, batch_tile=8)
    chain = fallback_chain(fleet.with_backend(noisy))
    assert [n for n, _ in chain] == ["analogue_fused_cuda",
                                     "analogue_fused_cuda_clean", "digital"]
    clean = chain[1][1].backend
    assert clean.spec.read_noise == 0.0 and clean.faults is fm
    assert (clean.prog_seed, clean.read_seed, clean.batch_tile) == (4, 5, 8)
    sim = AnalogueBackend(spec=spec, prog_seed=6, storage="float",
                          faults=fm, n_reads=3)
    chain = fallback_chain(fleet.with_backend(sim))
    assert [n for n, _ in chain] == ["analogue", "analogue_fused_cuda_clean",
                                     "digital"]
    quiet = chain[1][1].backend
    assert isinstance(quiet, FusedAnalogueCudaBackend)
    assert (quiet.spec.read_noise, quiet.prog_seed, quiet.faults,
            quiet.n_reads) == (0.0, 6, fm, 3)
    # a noise-free fused analogue primary has no quiet tier to add
    assert [n for n, _ in fallback_chain(fleet.with_backend(
        FusedAnalogueCudaBackend(spec=tan.AnalogueSpec())))] == \
        ["analogue_fused_cuda", "digital"]
    assert [n for n, _ in fallback_chain(fleet.with_backend(
        FusedCudaBackend()))] == ["fused_cuda", "digital"]
    assert [n for n, _ in fallback_chain(fleet)] == ["digital"]


# ---------------------------------------------------------------------------
# FleetServer(slo=) against the JAX package's
# ---------------------------------------------------------------------------

def fam_jax(s, th):
    return th[0] * jnp.sin(2.0 * jnp.pi * th[1] * s)


def fam_torch(s, th):
    return th[0] * torch.sin(2.0 * math.pi * th[1] * s)


@functools.lru_cache(maxsize=None)
def hp_serving():
    """The HP twin's fleet with one drive per twin, in both packages."""
    jtwin = jdriven(1, drive=None, hidden=14)
    jp = jtwin.init(jax.random.PRNGKey(0))
    ttwin = make_driven_twin(1, drive=None, hidden=14)
    rng = np.random.default_rng(1)
    y0s = (0.3 * rng.normal(size=(6, 1))).astype(np.float32)
    thetas = (1.0 + rng.uniform(size=(6, 2))).astype(np.float32)
    ts = np.linspace(0.0, 0.1, 101).astype(np.float32)
    return (JFleet(jtwin, drive_family=fam_jax), jp,
            TwinFleet(ttwin, drive_family=fam_torch),
            params_from_numpy(to_numpy(jp), "cpu"), y0s, thetas, ts)


def both_servers(jbackend, tbackend, slo_kw):
    jfleet, jp, tfleet, tp, y0s, thetas, ts = hp_serving()
    jsrv = jserve.FleetServer(jfleet.with_backend(jbackend), jp,
                              jnp.asarray(ts), mesh=jax_mesh(),
                              slo=jserve.ServingSLO(**slo_kw))
    tsrv = FleetServer(tfleet.with_backend(tbackend), tp, t(ts),
                       device="cpu", slo=ServingSLO(**slo_kw))
    return jsrv, tsrv, y0s, thetas


def assert_same_decisions(jsrv, tsrv):
    js, ts_ = jsrv.stats.as_dict(), tsrv.stats.as_dict()
    for k in ("requests", "probes", "probe_demotions", "probe_recoveries",
              "nan_rescues", "retries", "transient_retries", "timeouts"):
        assert ts_[k] == js[k], k
    assert ts_["served_by"] == {TIER_NAMES[k]: v
                                for k, v in js["served_by"].items()}
    assert set(ts_["probe_errors"]) == {TIER_NAMES[k]
                                        for k in js["probe_errors"]}
    assert tsrv.active_tier == TIER_NAMES[jsrv.active_tier]


def test_healthy_array_serves_primary_like_jax():
    spec_kw = dict(prog_noise=0.0)
    jsrv, tsrv, y0s, thetas = both_servers(
        FusedAnalogueBackend(spec=jan.AnalogueSpec(**spec_kw)),
        FusedAnalogueCudaBackend(spec=tan.AnalogueSpec(**spec_kw)),
        dict(max_rel_error=0.2, probe_every=2, probe_horizon=101,
             probe_fleet=2))
    for _ in range(2):
        want = np.asarray(jsrv.serve(jnp.asarray(y0s), jnp.asarray(thetas)))
        got = tsrv.serve(t(y0s), t(thetas))
        assert bool(torch.isfinite(got).all())
        assert rel(got.numpy(), want) <= TOL
    assert tsrv.active_tier == "analogue_fused_cuda"
    assert tsrv.stats.served_by == {"analogue_fused_cuda": 2}
    assert tsrv.stats.probes == 1 and tsrv.stats.probe_demotions == 0
    assert_same_decisions(jsrv, tsrv)
    err, jerr = (tsrv.stats.probe_errors["analogue_fused_cuda"],
                 jsrv.stats.probe_errors["analogue_fused"])
    assert abs(err - jerr) <= PROBE_TOL and err < 0.2


def test_unrepairable_array_falls_back_to_digital_like_jax():
    """30% stuck cells: every request is served by the digital tier, no
    non-finite output, the demotion counted, the served trajectories the
    digital fleet's."""
    fm = dict(rate=0.3)
    jsrv, tsrv, y0s, thetas = both_servers(
        FusedAnalogueBackend(spec=jan.AnalogueSpec(prog_noise=0.0),
                             faults=jfaults.make_fault_model(("stuck", fm),
                                                             seed=5)),
        FusedAnalogueCudaBackend(spec=tan.AnalogueSpec(prog_noise=0.0),
                                 faults=tfaults.make_fault_model(
                                     ("stuck", fm), seed=5)),
        dict(max_rel_error=0.05, probe_every=1, probe_horizon=101,
             probe_fleet=2))
    for _ in range(3):
        jout = np.asarray(jsrv.serve(jnp.asarray(y0s), jnp.asarray(thetas)))
        out = tsrv.serve(t(y0s), t(thetas))
        assert bool(torch.isfinite(out).all())
        assert rel(out.numpy(), jout) <= TOL
    assert tsrv.active_tier == "digital"
    assert tsrv.stats.probe_demotions >= 1
    assert tsrv.stats.served_by == {"digital": 3}
    assert_same_decisions(jsrv, tsrv)
    _, _, tfleet, tp, _, _, ts = hp_serving()
    ref = tfleet.with_backend(DigitalBackend()).rollout_batch(
        tp, t(y0s), t(ts), t(thetas))
    assert torch.equal(out, ref.detach())


def test_probe_recovers_after_demotion_like_jax():
    spec_kw = dict(prog_noise=0.0)
    jsrv, tsrv, y0s, thetas = both_servers(
        FusedAnalogueBackend(spec=jan.AnalogueSpec(**spec_kw)),
        FusedAnalogueCudaBackend(spec=tan.AnalogueSpec(**spec_kw)),
        dict(max_rel_error=0.2, probe_every=1, probe_horizon=101,
             probe_fleet=2))
    for srv in (jsrv, tsrv):
        srv._active = len(srv._tiers) - 1       # a past demotion
    jsrv.serve(jnp.asarray(y0s), jnp.asarray(thetas))
    tsrv.serve(t(y0s), t(thetas))
    assert tsrv.active_tier == "analogue_fused_cuda"
    assert tsrv.stats.probe_recoveries == 1
    assert_same_decisions(jsrv, tsrv)


def test_poison_request_raises_after_every_tier():
    _, _, tfleet, tp, y0s, thetas, ts = hp_serving()
    bad = [{k: v * float("nan") for k, v in layer.items()} for layer in tp]
    srv = FleetServer(tfleet.with_backend(FusedCudaBackend()), bad, t(ts),
                      device="cpu", slo=ServingSLO(probe_every=100))
    assert [n for n, _ in srv._tiers] == ["fused_cuda", "digital"]
    with pytest.raises(RuntimeError, match="every fallback tier"):
        srv.serve(t(y0s), t(thetas))
    s = srv.stats        # the first request's probe demoted to digital
    assert (s.probes, s.probe_demotions, s.retries) == (1, 1, 0)
    assert s.served_by == {} and s.requests == 1
    assert not np.isfinite(s.probe_errors["fused_cuda"])
    srv._active = 0      # both tiers in turn: the retry counted too
    with pytest.raises(RuntimeError, match="every fallback tier"):
        srv.serve(t(y0s), t(thetas))
    assert s.retries == 1 and s.served_by == {}


def test_serve_without_slo_keeps_the_legacy_path():
    _, _, tfleet, tp, y0s, thetas, ts = hp_serving()
    srv = FleetServer(tfleet, tp, t(ts), device="cpu")
    out = srv.serve(t(y0s), t(thetas))
    ref = tfleet.rollout_batch(tp, t(y0s), t(ts), t(thetas))
    assert torch.equal(out, ref)
    assert srv.stats.requests == 1 and srv.stats.probes == 0
    assert srv.stats.served_by == {"primary": 1}


# ---------------------------------------------------------------------------
# The streaming server's SLO chain
# ---------------------------------------------------------------------------

def stream_fam_jax(s, th):
    return th[0] * jnp.sin(th[1] * s)


def stream_fam_torch(s, th):
    return th[0] * torch.sin(th[1] * s)


@functools.lru_cache(maxsize=None)
def driven_analogue_fleets():
    jtwin = jdriven(2, drive=lambda s: jnp.sin(s), hidden=8,
                    n_hidden_layers=1, gradient="fused_vjp")
    jp = jtwin.init(jax.random.PRNGKey(2))
    ttwin = make_driven_twin(2, drive=lambda s: torch.sin(s), hidden=8,
                             n_hidden_layers=1, gradient="fused_vjp")
    jbe = FusedAnalogueBackend(spec=jan.AnalogueSpec(prog_noise=0.0,
                                                     read_noise=0.05))
    tbe = FusedAnalogueCudaBackend(spec=tan.AnalogueSpec(prog_noise=0.0,
                                                         read_noise=0.05))
    return (JFleet(jtwin.with_backend(jbe), drive_family=stream_fam_jax), jp,
            TwinFleet(ttwin.with_backend(tbe), drive_family=stream_fam_torch),
            params_from_numpy(to_numpy(jp), "cpu"))


STREAM_KW = dict(dt=0.01, hot_capacity=8, max_batch=4, max_window=8,
                 horizon_quantum=4)


def theta_of(i):
    return np.float32([0.5, 2.0 + 0.1 * i])


def test_streaming_slo_chain_on_a_driven_analogue_fleet_like_jax():
    """The chain is built, probes run every ``probe_every`` batches, every
    request is served by some tier with the invariants intact, and the
    statistics, completion order and trajectories are the JAX server's."""
    jfleet, jp, tfleet, tp = driven_analogue_fleets()
    trace = ttraffic.bursty_trace(seed=6, n_requests=12, population=6,
                                  max_horizon=8)
    slo = dict(max_rel_error=0.5, probe_every=2)
    out = []
    for Server, fleet, params, kw in (
            (jserve.StreamingFleetServer, jfleet, jp, {}),
            (StreamingFleetServer, tfleet, tp, {"device": "cpu"})):
        S = jserve.ServingSLO if Server is not StreamingFleetServer \
            else ServingSLO
        srv = Server(fleet, params, slo=S(**slo), **STREAM_KW, **kw)
        rng = np.random.default_rng(13)
        done = srv.serve_trace(
            trace, y0_of=lambda i: rng.normal(size=2).astype(np.float32)
            * 0.1, theta_of=theta_of)
        out.append((srv, done))
    (jsrv, jdone), (srv, done) = out
    assert [n for n, _ in srv._tiers] == \
        ["analogue_fused_cuda", "analogue_fused_cuda_clean", "digital"]
    traffic.check_all(srv, trace, done)
    st = srv.stats()
    assert st.serving.probes == -(-st.stream.batches // 2) > 0
    assert sum(st.serving.served_by.values()) == st.stream.batches
    jst = jsrv.stats().as_dict()
    d = st.as_dict()
    assert d["stream"] == jst["stream"] and d["store"] == jst["store"]
    for k, v in jst["serving"].items():
        if k == "served_by":
            assert d["serving"][k] == {TIER_NAMES[n]: c
                                       for n, c in v.items()}
        elif k == "probe_errors":
            for n, e in v.items():
                assert abs(d["serving"][k][TIER_NAMES[n]] - e) <= PROBE_TOL
        else:
            assert d["serving"][k] == v, k
    assert [(c.seq, c.twin_id, c.start_step, c.tier) for c in done] == \
        [(c.seq, c.twin_id, c.start_step, TIER_NAMES[c.tier])
         for c in jdone]
    for c, jc in zip(done, jdone):
        assert rel(c.trajectory, jc.trajectory) <= TOL


def test_streaming_transient_exhaustion_falls_to_the_next_tier():
    """More faults than the retry budget exhaust the first tier; the next
    tier serves the batch, and nothing is quarantined."""
    _, _, tfleet, tp = driven_analogue_fleets()
    srv = StreamingFleetServer(tfleet, tp, slo=ServingSLO(max_rel_error=0.5),
                               transient_retries=1, backoff_base_s=0.0,
                               device="cpu", **{**STREAM_KW,
                                                "hot_capacity": 4,
                                                "max_batch": 2})
    srv.register_twin(0, np.float32([0.1, 0.2]), theta=theta_of(0))
    srv.submit(0, 4)
    with chaos.flaky("pump:run_tier", times=2):
        done = srv.drain()
    assert len(done) == 1 and done[0].tier == "analogue_fused_cuda_clean"
    assert srv.serving_stats.transient_retries == 1
    assert srv.serving_stats.retries == 1
    assert srv.stream_stats.quarantined == 0
    traffic.check_conservation(srv, done)


def test_streaming_kernel_error_raises_out_of_pump_under_an_slo(monkeypatch):
    """Only a ``TransientFault`` is retried or falls down the chain: a
    kernel that fails to build or launch raises out of ``pump``, and the
    digital tier never serves in its place."""
    from repro_torch.kernels import ops
    with chaos.flaky("pump:run_tier"):
        with pytest.raises(chaos.TransientFault):
            chaos.fault_point("pump:run_tier")
    assert issubclass(chaos.TransientFault, RuntimeError)
    _, _, tfleet, tp = driven_analogue_fleets()
    srv = StreamingFleetServer(
        tfleet, tp, slo=ServingSLO(max_rel_error=0.5, probe_every=100),
        transient_retries=2, backoff_base_s=0.0, device="cpu",
        **STREAM_KW)
    for tid in range(2):
        srv.register_twin(tid, np.float32([0.1, 0.2]), theta=theta_of(tid))
        srv.submit(tid, 4)
    srv.pump()                               # probes, then serves
    assert srv.serving_stats.served_by == {"analogue_fused_cuda": 1}

    def broken(*a, **k):
        raise RuntimeError("K4 failed to launch")
    monkeypatch.setattr(ops, "fused_analogue_rollout", broken)
    srv.submit(0, 4)
    with pytest.raises(RuntimeError, match="K4 failed to launch"):
        srv.pump()
    s = srv.serving_stats
    assert s.transient_retries == 0 and s.retries == 0
    assert s.served_by == {"analogue_fused_cuda": 1}
    assert srv.stream_stats.quarantined == 0


def test_streaming_unrepairable_array_demotes_to_digital():
    """An array with unrepairable stuck cells demotes at the first probe;
    every request is served (by digital), none quarantined."""
    jfleet, _, tfleet, tp = driven_analogue_fleets()
    be = FusedAnalogueCudaBackend(
        spec=tan.AnalogueSpec(prog_noise=0.0, read_noise=0.05),
        faults=tfaults.make_fault_model(("stuck", dict(rate=0.3)), seed=5))
    srv = StreamingFleetServer(tfleet.with_backend(be), tp,
                               slo=ServingSLO(max_rel_error=0.05),
                               device="cpu", **STREAM_KW)
    trace = ttraffic.poisson_trace(seed=1, n_requests=12, population=5,
                                   max_horizon=8)
    rng = np.random.default_rng(2)
    done = srv.serve_trace(trace, y0_of=lambda i: rng.normal(size=2).astype(
        np.float32) * 0.1, theta_of=theta_of)
    traffic.check_all(srv, trace, done)
    s = srv.stats().serving
    assert srv.active_tier == "digital" and s.probe_demotions == 1
    assert s.served_by == {"digital": srv.stream_stats.batches}
    assert all(c.tier == "digital" for c in done)


# ---------------------------------------------------------------------------
# Repair 1: the trainable write path keyed by the resumed step
# ---------------------------------------------------------------------------

def test_trainable_resumed_rollout_keys_the_write_path_by_its_offset():
    """``FusedAnalogueCudaBackend(trainable=True)``: a rollout resumed at
    step 37 differentiates through the write path of step 37, as the JAX
    package's ``hw_aware_params(masters, cfg, 37)``; its gradient is not
    the step-0 one."""
    dim, steps, offset, dt = 3, 10, 37, 0.01
    jt = jmake(dim, hidden=8, n_hidden_layers=1)
    jp = jt.init(jax.random.PRNGKey(4))
    rng = np.random.default_rng(8)
    ys = (0.3 * rng.normal(size=(4, dim))).astype(np.float32)
    w = rng.normal(size=(4, steps + 1, dim)).astype(np.float32)
    jcfg = jhw.HwAwareConfig.from_backend(
        FusedAnalogueBackend(spec=jan.spec_from_calibration(CAL),
                             read_seed=5), k_draws=1)
    jbe = JDigital()

    def jloss(p):
        eff = jhw.hw_aware_params(p, jcfg, offset)
        out = jbe.rollout_batch_resumed(
            jbe.program(jt.node.field, eff), jnp.asarray(ys), dt=dt,
            num_steps=steps, start_steps=offset, gradient="direct")
        return jnp.sum(out * w)

    jgrads = jax.grad(jloss)(jp)

    tt = make_autonomous_twin(dim, hidden=8, n_hidden_layers=1)
    be = FusedAnalogueCudaBackend(spec=tan.spec_from_calibration(CAL),
                                  read_seed=5, trainable=True)

    def grads(start):
        leaves = params_from_numpy(to_numpy(jp), "cpu")
        for layer in leaves:
            for v in layer.values():
                v.requires_grad_()
        out = be.rollout_batch_resumed(be.program(tt.node.field, leaves),
                                       t(ys), dt=dt, num_steps=steps,
                                       start_steps=start)
        return torch.autograd.grad((out * t(w)).sum(),
                                   [layer[k] for layer in leaves
                                    for k in ("w", "b")])

    got = grads(offset)
    want = [np.asarray(layer[k]) for layer in jgrads for k in ("w", "b")]
    for g, wg in zip(got, want):
        assert rel(g.numpy(), wg) <= GRAD_TOL
    at0 = grads(0)
    assert max(rel(g.numpy(), wg) for g, wg in zip(at0, want)) > 100 * \
        GRAD_TOL


# ---------------------------------------------------------------------------
# Repair 2: RepairReport fields stay on the device
# ---------------------------------------------------------------------------

def test_repair_report_fields_are_tensors_and_summary_is_jaxs():
    w = np.random.default_rng(3).normal(size=(32, 32)).astype(np.float32)
    jspec = jan.AnalogueSpec(prog_noise=0.0)
    tspec = tan.AnalogueSpec(prog_noise=0.0)
    fm = dict(rate=0.05, on_frac=0.5)
    _, jr = jan.program_with_verify(
        jax.random.PRNGKey(0), jnp.asarray(w), jspec,
        faults=jfaults.make_fault_model(("stuck", fm), seed=5),
        verify=jan.VerifyConfig(), layer=1)
    _, tr = tan.program_with_verify(
        None, t(w), tspec, faults=tfaults.make_fault_model(("stuck", fm),
                                                           seed=5),
        verify=tan.VerifyConfig(), layer=1)
    for f in ("n_unrepairable", "max_error", "mean_error",
              "projected_rollout_error"):
        v = getattr(tr, f)
        assert isinstance(v, torch.Tensor) and v.ndim == 0, f
    got, want = tr.summary(), jr.summary()
    assert set(got) == set(want)
    for k in ("name", "attempts", "n_cells", "n_unrepairable"):
        assert got[k] == want[k] and type(got[k]) is type(want[k]), k
    for k in ("max_error", "mean_error", "projected_rollout_error"):
        assert isinstance(got[k], float)
        assert got[k] == pytest.approx(want[k], rel=1e-5), k
    reps = FusedAnalogueCudaBackend(
        spec=tspec, faults=tfaults.make_fault_model(("stuck", fm), seed=5),
        verify=tan.VerifyConfig()).program(
        None, params_from_numpy([{"w": w[:, :8], "b": w[0, :8]}],
                                "cpu")).extra["repair_reports"]
    assert isinstance(reps[0].n_unrepairable, torch.Tensor)
