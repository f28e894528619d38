"""The port's hardware-aware training (``repro_torch.train.hw_aware``) and
calibration loaders against the JAX package, on the CPU.

The write path runs K3's plain version here (``ref.hw_write_path_ref``);
``chip_smoke.py`` holds the kernel against it on the card.  Inputs are
numpy-made (or JAX-made and passed as numpy).  Tolerances: write-path
values within 1e-6 of each layer's peak (Box-Muller's log/cos rounding;
the uniforms, masks and levels are bitwise, so the differential levels
of a noise-free write path are equal integers); step-0 losses within
1e-5 relative; loss histories within 1e-3 relative per step (the
reference's own fused-vs-digital gate), state noise off because the two
packages' state-noise generators differ.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import analogue as jan  # noqa: E402
from repro.core import faults as jfaults  # noqa: E402
from repro.core import twin as jtwin  # noqa: E402
from repro.core.backends import (FusedAnalogueBackend,  # noqa: E402
                                 FusedPallasBackend)
from repro.data import hp_memristor as jhp  # noqa: E402
from repro.train import hw_aware as jhw  # noqa: E402
from repro.train import optimizer as jopt  # noqa: E402
from repro.train import trainer as jtrainer  # noqa: E402
from repro_torch.core import analogue as tan  # noqa: E402
from repro_torch.core import faults as tfaults  # noqa: E402
from repro_torch.core import twin as ttwin  # noqa: E402
from repro_torch.core.backends import FusedAnalogueCudaBackend  # noqa: E402
from repro_torch.data import hp_memristor as thp  # noqa: E402
from repro_torch.interop import params_from_numpy  # noqa: E402
from repro_torch.kernels import noise as tnoise  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.train import hw_aware as thw  # noqa: E402
from repro_torch.train import optimizer as topt  # noqa: E402
from repro_torch.train import recipes as trecipes  # noqa: E402
from repro_torch.train import trainer as ttrainer  # noqa: E402

CAL = "calibration/paper_device.json"
WRITE_TOL = 1e-6
LOSS_TOL = 1e-5
HIST_TOL = 1e-3
WIDTHS = {"hp": (2, 14, 14, 1), "l96": (6, 64, 64, 6)}
#: The step whose salts wrap past 2^32 at both widths: (step k + draw) L 4.
WRAP_STEP = 200_000_000
STEPS = [0, 11, WRAP_STEP]


def t(x):
    return torch.from_numpy(np.array(x, copy=True))


def np_params(seed, sizes):
    rng = np.random.default_rng(seed)
    return [{"w": (rng.standard_normal((a, b)) * np.sqrt(2.0 / a))
             .astype(np.float32),
             "b": (0.1 * rng.standard_normal(b)).astype(np.float32)}
            for a, b in zip(sizes[:-1], sizes[1:])]


def jparams(p):
    return [{k: jnp.asarray(v) for k, v in layer.items()} for layer in p]


def folded(layer):
    return np.concatenate([np.asarray(layer["w"]),
                           np.asarray(layer["b"])[None, :]])


def configs(faults: bool, noisy: bool = True, k: int = 2, drift_reads=100):
    """The same policy in both packages: the calibrated spec (noise-free if
    asked), with faults 5% stuck cells resampled per (step, draw) and the
    calibrated drift over ``drift_reads`` reads."""
    kw = {} if noisy else dict(prog_noise=0.0, read_noise=0.0)
    jspec = jan.spec_from_calibration(CAL, **kw)
    tspec = tan.spec_from_calibration(CAL, **kw)
    jc = dict(spec=jspec, k_draws=k, noise_seed=3)
    tc = dict(spec=tspec, k_draws=k, noise_seed=3)
    if faults:
        jc.update(faults=jfaults.make_fault_model(
            ("stuck", dict(rate=0.05)), ("drift", dict(nu=0.03, tau=1000.0)),
            seed=5), fault_ensemble=True, drift_reads=drift_reads)
        tc.update(faults=tfaults.make_fault_model(
            ("stuck", dict(rate=0.05)), ("drift", dict(nu=0.03, tau=1000.0)),
            seed=5), fault_ensemble=True, drift_reads=drift_reads)
    return jhw.HwAwareConfig(**jc), thw.HwAwareConfig(**tc)


# ---------------------------------------------------------------------------
# The write path against JAX's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("width", sorted(WIDTHS))
@pytest.mark.parametrize("faults", [False, True])
@pytest.mark.parametrize("step", STEPS)
def test_hw_aware_params_within_1e6_of_jax(width, faults, step):
    p = np_params(1, WIDTHS[width])
    jc, tc = configs(faults)
    for draw in range(tc.k_draws):
        want = jhw.hw_aware_params(jparams(p), jc, step, draw)
        got = thw.hw_aware_params(params_from_numpy(p, "cpu"), tc, step, draw)
        for jl, tl in zip(want, got):
            a, b = folded(jl), folded({k: v.detach() for k, v in tl.items()})
            assert np.max(np.abs(a - b)) <= WRITE_TOL * np.max(np.abs(a))


@pytest.mark.parametrize("width", sorted(WIDTHS))
@pytest.mark.parametrize("step", STEPS)
def test_noise_free_levels_and_stuck_cells_equal_jax(width, step):
    """Without programming and read noise (and drift) the write path is the
    differential level of each cell times one step over the scale: the
    levels, stuck cells included, are equal integers in both packages."""
    p = np_params(2, WIDTHS[width])
    jc, tc = configs(True, noisy=False, drift_reads=0)
    g_step = tc.spec.g_step
    n_stuck = 0
    for li, layer in enumerate(p):
        f = folded(layer)
        scale = (tc.spec.g_max - tc.spec.g_min) / np.max(np.abs(f))
        for draw in range(tc.k_draws):
            a = np.asarray(jhw.write_path_tensor(jnp.asarray(f), jc, step,
                                                 draw, li, len(p)))
            b = thw.write_path_tensor(t(f), tc, step, draw, li,
                                      len(p)).numpy()
            la = np.round(a.astype(np.float64) * scale / g_step)
            lb = np.round(b.astype(np.float64) * scale / g_step)
            np.testing.assert_array_equal(la, lb)
            n_stuck += int(np.sum(np.abs(la - np.round(f * scale / g_step))
                                  > 0.5))
    assert n_stuck > 0


def test_write_path_salts_wrap_like_jax():
    _, tc = configs(False)
    for step in STEPS:
        for args in [(0, 0, 0, 0), (1, 2, 1, 1), (1, 1, 0, 1)]:
            want = int(jhw._hw_salt(jhw.HwAwareConfig(k_draws=2), step,
                                    *args, 3))
            assert thw._hw_salt(tc, step, *args, 3) == want
    # the step past the wrap does wrap: its salts left uint32's range
    assert thw.HW_SALT_BASE + (WRAP_STEP * 2 * 3 + 2) * 4 > 2 ** 32


def test_transform_is_deterministic_per_seed_step_draw():
    p = params_from_numpy(np_params(3, WIDTHS["hp"]), "cpu")
    _, tc = configs(True, k=3)

    def flat(params):
        return torch.cat([torch.cat([x["w"].reshape(-1), x["b"]])
                          for x in params]).detach()

    a = flat(thw.hw_aware_params(p, tc, 11, 1))
    assert torch.equal(a, flat(thw.hw_aware_params(p, tc, 11, 1)))
    for other in (thw.hw_aware_params(p, tc, 12, 1),
                  thw.hw_aware_params(p, tc, 11, 2),
                  thw.hw_aware_params(p, dataclasses.replace(
                      tc, noise_seed=8), 11, 1)):
        assert not torch.equal(a, flat(other))
    # the one-launch helper gives every draw of a step
    every = thw._step_draws(p, tc, 11)
    assert len(every) == tc.k_draws
    assert torch.equal(a, flat(every[1]))


def test_ste_gradient_is_identity():
    p = params_from_numpy(np_params(4, WIDTHS["hp"]), "cpu")
    _, tc = configs(True)
    leaves = [v.requires_grad_() for layer in p for v in layer.values()]
    cot = [torch.randn(x.shape, generator=torch.Generator().manual_seed(i))
           for i, x in enumerate(leaves)]
    # one draw: the cotangent passes through unchanged
    eff = thw.hw_aware_params(p, tc, 5, 1)
    out = [v for layer in eff for v in layer.values()]
    grads = torch.autograd.grad(out, leaves, cot)
    for g, c in zip(grads, cot):
        assert torch.equal(g, c)
    # all draws of a step at once: the cotangents summed over the draws
    every = thw._step_draws(p, tc, 5)
    out = [v for params in every for layer in params for v in layer.values()]
    grads = torch.autograd.grad(out, leaves, cot * tc.k_draws)
    for g, c in zip(grads, cot):
        torch.testing.assert_close(g, tc.k_draws * c, rtol=0, atol=1e-6)


def test_expectation_over_draws_averages():
    _, tc = configs(False, k=4)
    got = thw.expectation_over_draws(lambda d: torch.tensor(float(d)), tc)
    assert float(got) == 1.5


@pytest.mark.parametrize("kw,field", [
    (dict(k_draws=0), "k_draws"), (dict(read_sigma=-0.1), "read_sigma"),
    (dict(drift_reads=-1), "drift_reads"),
    (dict(fault_ensemble=True), "fault_ensemble")])
def test_config_validation_names_field(kw, field):
    with pytest.raises(ValueError, match=field):
        thw.HwAwareConfig(**kw)
    with pytest.raises(ValueError, match=field):
        jhw.HwAwareConfig(**kw)


def test_config_defaults_and_from_backend_match_jax():
    j, tcfg = jhw.HwAwareConfig(), thw.HwAwareConfig()
    for f in ("k_draws", "noise_seed", "read_sigma", "fault_ensemble",
              "drift_reads"):
        assert getattr(j, f) == getattr(tcfg, f)
    assert tcfg.effective_read_sigma == tcfg.spec.read_noise
    assert thw.HwAwareConfig(read_sigma=0.05).effective_read_sigma == 0.05
    fm = tfaults.make_fault_model(("stuck", dict(rate=0.01)), seed=2)
    be = FusedAnalogueCudaBackend(spec=tan.AnalogueSpec(read_noise=0.02),
                                  read_seed=9, faults=fm)
    cfg = thw.HwAwareConfig.from_backend(be, k_draws=1)
    assert (cfg.spec, cfg.noise_seed, cfg.faults, cfg.k_draws) == (
        be.spec, 9, fm, 1)


def test_write_path_refuses_integer_weights():
    _, tc = configs(False)
    with pytest.raises(ValueError, match=r"params\[1\].*non-floating"):
        thw.write_path_tensor(torch.ones((3, 4), dtype=torch.int32), tc, 0,
                              0, 1, 3)


# ---------------------------------------------------------------------------
# Losses and histories against JAX's
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def hp():
    ts, xs, _, _ = jhp.generate("sine", num_points=500, dt=1e-3, amp=2.0,
                                freq=2.0)
    p = [{k: np.asarray(v) for k, v in layer.items()} for layer in
         jtwin.make_driven_twin(1, lambda s: s, hidden=14).init(
             jax.random.PRNGKey(42))]
    ts, ys = np.asarray(ts), np.asarray(xs)[:, None]
    jt = jtwin.make_driven_twin(1, jhp.WAVEFORMS["sine"](amp=2.0, freq=2.0),
                                hidden=14)
    tt = ttwin.make_driven_twin(1, thp.WAVEFORMS["sine"](amp=2.0, freq=2.0),
                                hidden=14)
    jseg = jtrainer.make_segments(jnp.asarray(ts), jnp.asarray(ys), 50)
    tseg = ttrainer.make_segments(t(ts), t(ys), 50)
    return dict(ts=ts, ys=ys, p=p, jt=jt, tt=tt, jseg=jseg, tseg=tseg)


@pytest.mark.parametrize("backend", ["digital", "fused"])
def test_step0_loss_matches_jax(hp, backend):
    jc, tc = configs(True)
    jb = FusedPallasBackend(precision="f32") if backend == "fused" else None
    tb = "fused_cuda" if backend == "fused" else None
    want = float(jtrainer.segment_loss_fn(
        hp["jt"], *hp["jseg"], backend=jb, hw_aware=jc)(
            jparams(hp["p"]), None, 0))
    loss = ttrainer.segment_loss_fn(hp["tt"], *hp["tseg"], backend=tb,
                                    hw_aware=tc)
    assert loss.wants_step
    got = float(loss(params_from_numpy(hp["p"], "cpu"), None, 0))
    assert abs(got - want) <= LOSS_TOL * abs(want)


def test_training_on_fused_analogue_is_hardware_aware(hp):
    """Training on the fused analogue substrate derives the policy from the
    backend and is step-keyed: its step-0 loss is JAX's on
    ``FusedAnalogueBackend``, not the clean ``fused_cuda`` loss."""
    spec = dict(read_noise=0.02)
    want = float(jtrainer.segment_loss_fn(
        hp["jt"], *hp["jseg"], backend=FusedAnalogueBackend(
            spec=jan.AnalogueSpec(**spec), batch_tile=8))(
                jparams(hp["p"]), None, 0))
    loss = ttrainer.segment_loss_fn(
        hp["tt"], *hp["tseg"],
        backend=FusedAnalogueCudaBackend(spec=tan.AnalogueSpec(**spec)))
    assert loss.wants_step
    params = params_from_numpy(hp["p"], "cpu")
    got = float(loss(params, None, 0))
    assert abs(got - want) <= LOSS_TOL * abs(want)
    clean = float(ttrainer.segment_loss_fn(
        hp["tt"], *hp["tseg"], backend="fused_cuda")(params, None))
    assert abs(got - clean) > 10 * LOSS_TOL * abs(clean)


def test_digital_history_matches_jax_fit(hp):
    jc, tc = configs(False)
    jloss = jtrainer.segment_loss_fn(hp["jt"], *hp["jseg"], hw_aware=jc)
    _, want = jtrainer.fit(jloss, jparams(hp["p"]), jopt.adam(1e-3), 40)
    tloss = ttrainer.segment_loss_fn(hp["tt"], *hp["tseg"], hw_aware=tc)
    _, got = ttrainer.fit(tloss, params_from_numpy(hp["p"], "cpu"),
                          topt.adam(1e-3), 40)
    want = np.asarray(want)
    assert got.shape == want.shape == (40,)
    assert float(np.max(np.abs(got.numpy() - want) / np.abs(want))) \
        <= HIST_TOL


def test_fit_is_bitwise_reproducible_and_matches_per_step(hp):
    _, tc = configs(True)
    loss = ttrainer.segment_loss_fn(hp["tt"], *hp["tseg"], noise_std=0.002,
                                    backend="fused_cuda", hw_aware=tc)
    runs = [engine(loss, params_from_numpy(hp["p"], "cpu"), topt.adam(1e-3),
                   5, torch.Generator().manual_seed(3))
            for engine in (ttrainer.fit, ttrainer.fit, ttrainer.fit_per_step)]
    for _, hist in runs[1:]:
        np.testing.assert_array_equal(hist.numpy(), runs[0][1].numpy())
    other = ttrainer.segment_loss_fn(
        hp["tt"], *hp["tseg"], noise_std=0.002, backend="fused_cuda",
        hw_aware=dataclasses.replace(tc, noise_seed=4))
    hist = ttrainer.fit(other, params_from_numpy(hp["p"], "cpu"),
                        topt.adam(1e-3), 5,
                        torch.Generator().manual_seed(3))[1]
    assert not np.array_equal(hist.numpy(), runs[0][1].numpy())


def test_recipe_trains_hardware_aware_on_the_cpu():
    _, tc = configs(False)
    twin, params, loss = trecipes.train_hp_twin(
        pretrain_steps=20, train_steps=10, backend="fused_cuda",
        hw_aware=tc, device="cpu")
    assert np.isfinite(loss)
    assert len(params) == 3


# ---------------------------------------------------------------------------
# The calibration loaders against JAX's
# ---------------------------------------------------------------------------

def test_calibration_loaders_match_jax():
    assert tan.load_calibration(CAL) == jan.load_calibration(CAL)
    js, ts_ = jan.spec_from_calibration(CAL), tan.spec_from_calibration(CAL)
    assert dataclasses.asdict(js) == dataclasses.asdict(ts_)
    over = tan.spec_from_calibration(CAL, read_noise=0.0)
    assert over.read_noise == 0.0 and over.g_max == ts_.g_max
    jd, td = jan.drift_from_calibration(CAL), tan.drift_from_calibration(CAL)
    assert (td.nu, td.tau) == (jd.nu, jd.tau)
    assert isinstance(td, tfaults.ConductanceDrift)
    cal = tan.load_calibration(CAL)
    del cal["drift"]
    assert tan.drift_from_calibration(cal) is None


def _cal(**device):
    return {"schema": 1, "device": dict({
        "g_off_S": 20e-6, "g_on_S": 100e-6, "levels": 64,
        "prog_noise_sigma": 0.0436, "read_noise_sigma": 0.02}, **device)}


@pytest.mark.parametrize("cal,match", [
    (_cal(g_on_S=-1.0), r"device\.g_on_S must be > 0"),
    (_cal(levels=1), r"device\.levels must be >= 2"),
    (_cal(levels=6.5), r"device\.levels must be an integer"),
    (_cal(read_noise_sigma=-0.1), r"device\.read_noise_sigma must be >= 0"),
    (_cal(g_on_S=10e-6), r"device\.g_on_S .* must exceed"),
    (_cal(typo=1.0), r"unknown field device\.typo"),
    (dict(_cal(), schema=2), "schema must be 1"),
    (dict(_cal(), extra={}), "unknown section 'extra'"),
    ({"schema": 1}, "missing required section 'device'"),
    (dict(_cal(), drift={"nu": 0.1}), r"missing field drift\.tau"),
])
def test_calibration_errors_name_the_field_as_jax(cal, match):
    for load in (jan.load_calibration, tan.load_calibration):
        with pytest.raises(ValueError, match=match):
            load(cal)
    with pytest.raises(TypeError, match="path or a dict"):
        tan.load_calibration(3)


# ---------------------------------------------------------------------------
# The trainable fused analogue backend
# ---------------------------------------------------------------------------

def test_trainable_fused_analogue_rollout_has_gradients(hp):
    spec = tan.spec_from_calibration(CAL)
    tt = hp["tt"]
    leaves = params_from_numpy(hp["p"], "cpu")
    for layer in leaves:
        for v in layer.values():
            v.requires_grad_()
    ts, y0 = t(hp["ts"][:51]), t(hp["ys"][:1, 0])
    be = FusedAnalogueCudaBackend(spec=spec, trainable=True)
    out = be.rollout(be.program(tt.node.field, leaves), y0, ts)
    grads = torch.autograd.grad(out.sum(), [v for layer in leaves
                                            for v in layer.values()])
    for g in grads:
        assert bool(torch.isfinite(g).all()) and float(g.abs().sum()) > 0
    frozen = FusedAnalogueCudaBackend(spec=spec)
    assert frozen.rollout(frozen.program(tt.node.field, leaves), y0,
                          ts).grad_fn is None
    # the trainable rollout sees the write path of draw 0 at step 0
    eff = thw.hw_aware_params(leaves, thw.HwAwareConfig.from_backend(
        be, k_draws=1), 0)
    want = tt.with_backend("fused_cuda").simulate(eff, y0, ts)
    assert torch.equal(out.detach(), want.detach())


def test_write_path_launch_count_only_moves_on_cuda():
    p = params_from_numpy(np_params(5, WIDTHS["hp"]), "cpu")
    _, tc = configs(True)
    before = tnoise.WRITE_LAUNCHES
    thw._step_draws(p, tc, 3)
    assert tnoise.WRITE_LAUNCHES == before
    wp = thw._write_path(tc, 3, tc.k_draws)
    got = tnoise.hw_write_path([x["w"] for x in p], [x["b"] for x in p], wp,
                               3, range(tc.k_draws))
    want = tref.hw_write_path_ref([x["w"] for x in p], [x["b"] for x in p],
                                  wp, 3, range(tc.k_draws))
    for ga, wa in zip(got, want):
        for (aw, ab), (bw, bb) in zip(ga, wa):
            assert torch.equal(aw, bw) and torch.equal(ab, bb)
            assert aw.shape == (aw.shape[0], ab.shape[0])
