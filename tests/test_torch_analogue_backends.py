"""The port's analogue backends on the CPU: counterparts of the JAX
package's ``tests/test_backends.py`` (fused analogue section),
``tests/test_faults.py`` (baking vs in-kernel injection, the 2x margin)
and the analogue gates of ``tests/test_twins.py``.

``FusedAnalogueCudaBackend`` runs K4's plain version here.  Noise-free
programming is deterministic in both packages, so the port's backends
are also held against the JAX package's ``AnalogueBackend`` /
``FusedAnalogueBackend`` from the same numpy-made weights (1e-5 of the
peak).  Noisy programming draws from ``torch.Generator``s (``jax.random``
in JAX): those tests hold the port to the reference's gates, not to its
numbers.  The HP gates train the port's own twin on the fused substrate
(~30 s, as ``tests/test_torch_training.py`` does).
"""
import dataclasses
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import analogue as jan  # noqa: E402
from repro.core import backends as jbe  # noqa: E402
from repro.core import faults as jfaults  # noqa: E402
from repro.core import twin as jtwin  # noqa: E402
from repro_torch.core import faults as tfaults  # noqa: E402
from repro_torch.core.analogue import AnalogueSpec, VerifyConfig  # noqa: E402
from repro_torch.core.backends import (BACKENDS, AnalogueBackend,  # noqa: E402
                                       FusedAnalogueCudaBackend,
                                       resolve_backend)
from repro_torch.core.losses import mre  # noqa: E402
from repro_torch.core.twin import (TwinFleet, make_autonomous_twin,  # noqa: E402
                                   make_driven_twin)
from repro_torch.interop import params_from_numpy  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.train import recipes as trecipes  # noqa: E402

QUANT_CLEAN = AnalogueSpec(prog_noise=0.0)


def t(x):
    return torch.from_numpy(np.array(x, copy=True))


def rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


def np_params(seed, sizes):
    rng = np.random.default_rng(seed)
    return [{"w": (rng.standard_normal((a, b)) * np.sqrt(2.0 / a))
             .astype(np.float32),
             "b": (0.1 * rng.standard_normal(b)).astype(np.float32)}
            for a, b in zip(sizes[:-1], sizes[1:])]


def hp_drive(tt):
    return torch.sin(4.0 * torch.as_tensor(tt))


@pytest.fixture(scope="module")
def hp_setup():
    twin = make_driven_twin(1, hp_drive)
    params = params_from_numpy(np_params(0, (2, 14, 14, 1)), "cpu")
    ts = torch.linspace(0.0, 0.3, 31)
    return twin, params, torch.tensor([0.2]), ts


@pytest.fixture(scope="module")
def l96_setup():
    twin = make_autonomous_twin(6, hidden=16)
    params = params_from_numpy(np_params(1, (6, 16, 16, 6)), "cpu")
    ts = torch.linspace(0.0, 0.05, 21)
    y0 = torch.from_numpy((0.5 * np.random.default_rng(2).standard_normal(6))
                          .astype(np.float32))
    return twin, params, y0, ts


def pair(twin, params, spec, **fused_kw):
    """(simulator backend + state, fused backend + state), one program."""
    sim = AnalogueBackend(spec=spec, prog_seed=3)
    fused = FusedAnalogueCudaBackend(spec=spec, prog_seed=3, **fused_kw)
    return (sim, sim.program(twin.node.field, params),
            fused, fused.program(twin.node.field, params))


def test_registry_names():
    assert isinstance(resolve_backend("analogue_fused_cuda"),
                      FusedAnalogueCudaBackend)
    assert isinstance(resolve_backend("analogue"), AnalogueBackend)
    assert {"analogue", "analogue_fused_cuda"} <= set(BACKENDS)


@pytest.mark.parametrize("setup", ["hp_setup", "l96_setup"])
def test_fused_matches_simulator(request, setup):
    """Noise-free K4 (plain) == the crossbar simulator (<= 1e-5 rel)."""
    twin, params, y0, ts = request.getfixturevalue(setup)
    sim, st_s, fused, st_f = pair(twin, params, QUANT_CLEAN)
    want = sim.rollout(st_s, y0, ts)
    got = fused.rollout(st_f, y0, ts)
    assert got.shape == want.shape
    assert rel(got, want) <= 1e-5


@pytest.mark.parametrize("faulty", [False, True])
def test_fused_backend_matches_jax_from_the_same_weights(faulty):
    """prog_noise=0 programming is deterministic (stuck cells too): the
    port's K4 backend and the JAX package's fused analogue backend from
    the same weights agree (L96-shaped twin, fleet of 5)."""
    p = np_params(4, (6, 16, 16, 6))
    fm = dict(seed=7)
    mech = [("stuck", dict(rate=0.05)), ("drift", dict(nu=0.02, tau=50.0))]
    jfm = jfaults.make_fault_model(*mech, **fm) if faulty else None
    tfm = tfaults.make_fault_model(*mech, **fm) if faulty else None
    ts = np.linspace(0.0, 0.05, 21).astype(np.float32)
    y0s = (0.5 * np.random.default_rng(5).standard_normal((5, 6))
           ).astype(np.float32)
    jb = jbe.FusedAnalogueBackend(spec=jan.AnalogueSpec(prog_noise=0.0),
                                  faults=jfm, batch_tile=4)
    jfleet = jtwin.TwinFleet(jtwin.make_autonomous_twin(6, hidden=16)
                             .with_backend(jb))
    want = jfleet.rollout_batch([{k: jnp.asarray(v) for k, v in q.items()}
                                 for q in p], jnp.asarray(y0s),
                                jnp.asarray(ts))
    tb = FusedAnalogueCudaBackend(spec=QUANT_CLEAN, faults=tfm, batch_tile=4)
    tfleet = TwinFleet(make_autonomous_twin(6, hidden=16).with_backend(tb))
    got = tfleet.rollout_batch(params_from_numpy(p, "cpu"), t(y0s), t(ts))
    assert rel(got, want) <= 1e-5


def test_uint8_matches_float(hp_setup):
    twin, params, y0, ts = hp_setup
    _, _, f_float, st_float = pair(twin, params, QUANT_CLEAN)
    _, _, f_u8, st_u8 = pair(twin, params, QUANT_CLEAN, storage="uint8")
    assert st_u8.extra["gps"][0].dtype == torch.uint8
    a = f_float.rollout(st_float, y0, ts)
    b = f_u8.rollout(st_u8, y0, ts)
    assert rel(b, a) <= 1e-6
    sim_u8 = AnalogueBackend(spec=QUANT_CLEAN, prog_seed=3, storage="uint8")
    c = sim_u8.rollout(sim_u8.program(twin.node.field, params), y0, ts)
    assert rel(c, a) <= 1e-5


def test_fleet_per_twin_drives(hp_setup):
    twin, params, _, ts = hp_setup

    def family(tt, theta):
        return theta[0] * torch.sin(theta[1] * tt)

    y0s = torch.tensor([[0.1], [-0.2], [0.3], [0.05]])
    thetas = torch.tensor([[1.0, 4.0], [0.5, 8.0], [2.0, 2.0], [1.5, 6.0]])
    fleet = TwinFleet(twin, drive_family=family)
    sim = fleet.with_backend(AnalogueBackend(
        spec=QUANT_CLEAN, prog_seed=3)).simulate(params, y0s, ts, thetas)
    fused = fleet.with_backend(FusedAnalogueCudaBackend(
        spec=QUANT_CLEAN, prog_seed=3, batch_tile=3)).simulate(
            params, y0s, ts, thetas)
    assert fused.shape == (4, 31, 1)
    np.testing.assert_allclose(fused.numpy(), sim.numpy(), atol=1e-5,
                               rtol=1e-5)


def test_read_noise_is_deterministic(hp_setup):
    twin, params, y0, ts = hp_setup
    spec = AnalogueSpec(prog_noise=0.0, read_noise=0.01)
    be = FusedAnalogueCudaBackend(spec=spec, prog_seed=3, read_seed=42)
    st = be.program(twin.node.field, params)
    o1, o2 = be.rollout(st, y0, ts), be.rollout(st, y0, ts)
    assert torch.equal(o1, o2)
    be2 = dataclasses.replace(be, read_seed=43)
    assert not torch.equal(o1, be2.rollout(be2.program(twin.node.field,
                                                        params), y0, ts))
    clean = FusedAnalogueCudaBackend(spec=QUANT_CLEAN, prog_seed=3)
    o_clean = clean.rollout(clean.program(twin.node.field, params), y0, ts)
    assert float((o1 - o_clean).abs().max()) > 0.0
    # the simulator's per-read generator noise: seeded, time-keyed
    sim = AnalogueBackend(spec=spec, prog_seed=3, read_seed=42)
    s1 = sim.rollout(sim.program(twin.node.field, params), y0, ts)
    s2 = sim.rollout(sim.program(twin.node.field, params), y0, ts)
    assert torch.equal(s1, s2) and not torch.equal(s1, o1)
    assert float((s1 - o_clean).abs().max()) < 0.05 * float(
        o_clean.abs().max())


def test_fused_is_detached_and_trainable_raises(hp_setup):
    twin, params, y0, ts = hp_setup
    be = FusedAnalogueCudaBackend(spec=QUANT_CLEAN)
    st = be.program(twin.node.field, params)
    y = y0.clone().requires_grad_()
    out = be.rollout(st, y, ts)
    assert out.grad_fn is None
    # trainable=True is ported: the rollout differentiates to the masters
    leaves = [{k: v.clone().requires_grad_() for k, v in p.items()}
              for p in params]
    trainable = FusedAnalogueCudaBackend(spec=QUANT_CLEAN, trainable=True)
    out = trainable.rollout(trainable.program(twin.node.field, leaves), y0,
                            ts)
    assert out.grad_fn is not None
    grads = torch.autograd.grad(out.sum(), leaves[0]["w"])
    assert bool(torch.isfinite(grads[0]).all())
    assert float(grads[0].abs().sum()) > 0
    with pytest.raises(ValueError, match="storage"):
        FusedAnalogueCudaBackend(storage="int4").program(twin.node.field,
                                                         params)


def test_baked_faults_match_in_kernel_injection():
    """AnalogueBackend bakes the stuck cells into the conductances;
    FusedAnalogueCudaBackend re-derives the same masks inside K4: the
    trajectories agree to float32 rounding, and the faults moved them."""
    twin = make_driven_twin(1, hp_drive)
    params = params_from_numpy(np_params(6, (2, 14, 14, 1)), "cpu")
    ts = torch.linspace(0.0, 0.1, 21)
    y0 = torch.tensor([0.2])
    fm = tfaults.make_fault_model(("stuck", dict(rate=0.1)), seed=13)
    outs = {}
    for name, be in [("sim", AnalogueBackend(spec=QUANT_CLEAN, faults=fm)),
                     ("fused", FusedAnalogueCudaBackend(spec=QUANT_CLEAN,
                                                        faults=fm)),
                     ("fused_u8", FusedAnalogueCudaBackend(
                         spec=QUANT_CLEAN, faults=fm, storage="uint8"))]:
        outs[name] = be.rollout(be.program(twin.node.field, params), y0, ts)
    np.testing.assert_allclose(outs["sim"].numpy(), outs["fused"].numpy(),
                               rtol=0, atol=2e-6)
    np.testing.assert_allclose(outs["sim"].numpy(), outs["fused_u8"].numpy(),
                               rtol=0, atol=2e-6)
    clean = AnalogueBackend(spec=QUANT_CLEAN)
    c = clean.rollout(clean.program(twin.node.field, params), y0, ts)
    assert float((c - outs["sim"]).abs().max()) > 1e-4


def test_drift_snapshot_scales_the_conductances():
    twin = make_driven_twin(1, hp_drive)
    params = params_from_numpy(np_params(7, (2, 14, 14, 1)), "cpu")
    spec = AnalogueSpec(prog_noise=0.0, quantize=False)
    fm = tfaults.make_fault_model(("drift", dict(nu=0.05, tau=100.0)))
    st0 = AnalogueBackend(spec=spec).program(twin.node.field, params)
    st1 = AnalogueBackend(spec=spec, faults=fm, n_reads=400).program(
        twin.node.field, params)
    fac = float(tfaults.drift_factor(fm, 400))
    x = torch.tensor([0.3])
    assert float((st1.field(0.1, x) - st0.field(0.1, x)).abs().max()) > 0
    for p0, p1 in zip(st0.field.progs, st1.field.progs):
        np.testing.assert_allclose(p1["gp"].numpy(), p0["gp"].numpy() * fac,
                                   rtol=1e-6)


def test_within_2x_margin_at_1pct_stuck_with_verify():
    """The reference's acceptance gate: at 1% stuck cells, write-verify
    keeps the HP fleet rollout error within 2x the fault-free analogue
    margin (both with the paper's 4.36% programming noise)."""
    def fam(tt, th):
        return th[0] * torch.sin(2.0 * torch.pi * th[1] * tt)

    twin = make_driven_twin(1, drive=None, hidden=14)
    params = twin.init(torch.Generator().manual_seed(0), device="cpu")
    fleet = TwinFleet(twin, drive_family=fam)
    ts = torch.linspace(0.0, 0.1, 101)
    gen = torch.Generator().manual_seed(7)
    y0s = 0.3 * torch.randn((8, 1), generator=gen)
    thetas = 1.0 + torch.rand((8, 2), generator=gen)
    ref = fleet.rollout_batch(params, y0s, ts, thetas)
    spec = AnalogueSpec(prog_noise=0.0436)

    def err(be):
        out = fleet.with_backend(be).rollout_batch(params, y0s, ts, thetas)
        return float(torch.linalg.norm(out - ref) / torch.linalg.norm(ref))

    margin = err(FusedAnalogueCudaBackend(spec=spec, prog_seed=17))
    fm = tfaults.make_fault_model(("stuck", dict(rate=0.01)), seed=3)
    e_verify = err(FusedAnalogueCudaBackend(spec=spec, prog_seed=17,
                                            faults=fm, verify=VerifyConfig()))
    assert e_verify <= 2.0 * margin, (e_verify, margin)


def test_repair_reports_surface_through_both_backends(hp_setup):
    twin, params, _, _ = hp_setup
    fm = tfaults.make_fault_model(("stuck", dict(rate=0.02)), seed=1)
    for be in [AnalogueBackend(faults=fm, verify=VerifyConfig()),
               FusedAnalogueCudaBackend(faults=fm, verify=VerifyConfig())]:
        reps = be.program(twin.node.field, params).extra["repair_reports"]
        assert len(reps) == len(params)
        assert all(r.attempts >= 1 for r in reps)


def test_l96_fleet_serves_on_k4_and_noise_grid_runs():
    """``make_l96_fleet("analogue_fused_cuda")`` through ``serve_fleet``
    (the serving CLI's path) and the Fig. 4j noise grid, at toy sizes."""
    from repro_torch.launch import fleet_serving
    outs = fleet_serving.main(["--device", "cpu", "--fleet", "6",
                               "--horizon", "5", "--batches", "1",
                               "--backend", "analogue_fused_cuda"])
    assert len(outs) == 1 and tuple(outs[0].shape) == (6, 6, 6)
    fleet = trecipes.make_l96_fleet(backend="analogue_fused_cuda")
    assert fleet.backend.batch_tile == trecipes.FLEET.batch_tile
    data = trecipes.l96_data(num_points=240, device="cpu")
    twin = make_autonomous_twin(6, hidden=16)
    params = twin.init(torch.Generator().manual_seed(0), device="cpu")
    rows = trecipes.noise_robustness_grid(
        twin, params, read_noises=[0.0, 0.02], prog_noises=[0.0],
        data=data, repeats=1)
    assert len(rows) == 2
    assert all(np.isfinite(r["extrap_l1"]) for r in rows)


# ---------------------------------------------------------------------------
# The analogue gates of tests/test_twins.py, on a twin the port trains
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def hp_twin():
    t0 = time.perf_counter()
    out = trecipes.train_hp_twin(pretrain_steps=200, train_steps=250,
                                 backend="fused_cuda", device="cpu")
    print(f"train_hp_twin(200, 250, fused_cuda, cpu): "
          f"{time.perf_counter() - t0:.1f} s")
    return out


@pytest.mark.parametrize("substrate", ["analogue", "analogue_fused_cuda"])
def test_analogue_deployment_close_to_digital(hp_twin, substrate):
    """6-bit quantisation alone costs only a few % accuracy."""
    twin, params, _ = hp_twin
    m = trecipes.eval_hp_twin(twin, params, "sine", device="cpu")
    spec = AnalogueSpec(prog_noise=0.0)
    if substrate == "analogue":
        with pytest.deprecated_call():
            at = twin.deploy_analogue(0, params, spec)
        with torch.no_grad():
            pred = at.simulate(None, m["true"][:1], m["ts"])[:, 0]
    else:
        be = FusedAnalogueCudaBackend(spec=spec, batch_tile=1)
        pred = twin.with_backend(be).simulate(params, m["true"][:1],
                                              m["ts"])[:, 0]
    assert float(mre(pred, m["pred"])) < 0.08


@pytest.mark.parametrize("substrate", ["analogue", "analogue_fused_cuda"])
def test_analogue_noise_degrades_gracefully(hp_twin, substrate):
    """The paper's device statistics (Fig. 2k/3e) do not break the twin."""
    twin, params, _ = hp_twin
    m = trecipes.eval_hp_twin(twin, params, "sine", device="cpu")
    spec = AnalogueSpec(prog_noise=0.0436, read_noise=0.02)
    if substrate == "analogue":
        be = AnalogueBackend(spec=spec, prog_seed=0, read_seed=1)
    else:
        be = FusedAnalogueCudaBackend(spec=spec, prog_seed=0, read_seed=1,
                                      batch_tile=1)
    with torch.no_grad():
        pred = twin.with_backend(be).simulate(params, m["true"][:1],
                                              m["ts"])[:, 0]
    assert float(mre(pred, m["true"])) < 0.3


def test_fused_analogue_ops_rejects_integer_inputs(hp_setup):
    twin, params, _, _ = hp_setup
    st = FusedAnalogueCudaBackend(spec=QUANT_CLEAN).program(twin.node.field,
                                                            params)
    with pytest.raises(ValueError, match="non-floating"):
        tops.fused_analogue_rollout(st.extra, torch.zeros((1, 1),
                                                          dtype=torch.int64),
                                    torch.zeros((3, 1)), 0.01)
