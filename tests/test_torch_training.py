"""The port's training slice against JAX, on the CPU.

The continuous adjoint, the optimizers and schedules, the ground-truth
generators, the losses and the multiple-shooting trainer are held
against the JAX package on the same numpy-made inputs and params; the
HP recipe on the fused substrate (K1/K2's plain versions here) is held
to the HP gates of ``tests/test_twins.py``; the soft-DTW objectives
(K5/K6's plain versions on the fused path) follow JAX's histories.  Parity tolerances: adjoint
gradients 1e-5 relative to the peak; optimizer steps 1e-6; generated
data 1e-5 of the peak (HP) and 1e-4 (Lorenz96 over 1200 points, where
chaos amplifies float32 rounding roughly as e^(1.7 t)); loss histories
1e-3 relative per step (the reference's own fused-vs-digital gate).
"""
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import adjoint as jadj  # noqa: E402
from repro.core import losses as jlosses  # noqa: E402
from repro.core import node as jnode  # noqa: E402
from repro.core import twin as jtwin  # noqa: E402
from repro.core.backends import FusedPallasBackend  # noqa: E402
from repro.data import hp_memristor as jhp  # noqa: E402
from repro.data import lorenz96 as jl96  # noqa: E402
from repro.train import optimizer as jopt  # noqa: E402
from repro.train import recipes as jrecipes  # noqa: E402
from repro.train import trainer as jtrainer  # noqa: E402
from repro_torch.core import adjoint as tadj  # noqa: E402
from repro_torch.core import losses as tlosses  # noqa: E402
from repro_torch.core import node as tnode  # noqa: E402
from repro_torch.core import twin as ttwin  # noqa: E402
from repro_torch.data import hp_memristor as thp  # noqa: E402
from repro_torch.data import lorenz96 as tl96  # noqa: E402
from repro_torch.interop import params_from_numpy, params_to_numpy  # noqa: E402
from repro_torch.train import optimizer as topt  # noqa: E402
from repro_torch.train import recipes as trecipes  # noqa: E402
from repro_torch.train import trainer as ttrainer  # noqa: E402


def t(x):
    return torch.from_numpy(np.array(x, copy=True))


def rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.max(np.abs(a - b)) / (np.max(np.abs(b)) + 1e-30))


def np_params(seed, sizes):
    rng = np.random.default_rng(seed)
    return [{"w": (rng.standard_normal((a, b)) * np.sqrt(2.0 / a))
             .astype(np.float32),
             "b": (0.1 * rng.standard_normal(b)).astype(np.float32)}
            for a, b in zip(sizes[:-1], sizes[1:])]


def jparams(p):
    return [{k: jnp.asarray(v) for k, v in layer.items()} for layer in p]


def flat(tree):
    """[w0, b0, w1, b1, ...] as numpy, from either package's params."""
    return [np.asarray(layer[k]) for layer in tree for k in ("w", "b")]


def torch_grads(loss, p, y0=None):
    tp = params_from_numpy(p, "cpu")
    leaves = [v.requires_grad_() for layer in tp for v in layer.values()]
    ty = None if y0 is None else t(y0).requires_grad_()
    loss(tp, ty).backward()
    out = [x.grad.numpy() for x in leaves]
    return out + ([] if ty is None else [ty.grad.numpy()])


# ---------------------------------------------------------------------------
# Gradients: the continuous adjoint, the fused VJP, finite differences
# ---------------------------------------------------------------------------

SIZES = (2, 14, 14, 1)
TS = np.linspace(0.0, 0.23, 24).astype(np.float32)
Y0 = np.array([0.2], np.float32)


@pytest.mark.parametrize("method,sub", [("rk4", 1), ("rk4", 3),
                                        ("heun", 1), ("euler", 2)])
def test_odeint_adjoint_matches_jax(method, sub):
    p = np_params(0, SIZES)
    jf = jnode.MLPVectorField(sizes=SIZES, drive=lambda s: jnp.sin(4.0 * s))
    tf = tnode.MLPVectorField(sizes=SIZES, drive=lambda s: torch.sin(4.0 * s))
    g = jax.grad(lambda q, y: jnp.mean(jadj.odeint_adjoint(
        jf, y, jnp.asarray(TS), q, method, sub) ** 2), argnums=(0, 1))(
            jparams(p), jnp.asarray(Y0))
    want = flat(g[0]) + [np.asarray(g[1])]
    got = torch_grads(lambda q, y: torch.mean(tadj.odeint_adjoint(
        tf, y, t(TS), q, method, sub) ** 2), p, Y0)
    for a, b in zip(got, want):
        assert a.shape == b.shape
        assert rel(a, b) <= 1e-5


def _hp_twin():
    return ttwin.make_driven_twin(1, lambda s: torch.sin(4.0 * s))


def test_fused_vjp_matches_digital_adjoint():
    """Same loss, same weights: continuous-adjoint grads (digital) and
    discretise-then-optimise grads (fused, K2) agree to <= 1e-3 rel."""
    p = np_params(1, SIZES)
    twin = _hp_twin()
    fused = twin.with_backend("fused_cuda")
    g_dig = torch_grads(lambda q, _: torch.mean(
        twin.simulate(q, t(Y0), t(TS)) ** 2), p)
    g_fus = torch_grads(lambda q, _: torch.mean(
        fused.simulate(q, t(Y0), t(TS)) ** 2), p)
    scale = max(np.abs(x).max() for x in g_dig)
    assert max(np.abs(a - b).max() for a, b in zip(g_fus, g_dig)) \
        <= 1e-3 * scale


def test_fused_vjp_matches_finite_differences():
    """Directional derivative along the gradient, and the y0 derivative,
    vs central differences, <= 1e-3 rel (tests/test_gradients.py:140)."""
    p = params_from_numpy(np_params(2, SIZES), "cpu")
    fused = _hp_twin().with_backend("fused_cuda")

    def loss(q, y):
        return torch.mean(fused.node.trajectory(q, y, t(TS)) ** 2)

    leaves = [v.requires_grad_() for layer in p for v in layer.values()]
    y0 = t(Y0).requires_grad_()
    grads = torch.autograd.grad(loss(p, y0), leaves + [y0])
    gp, gy = grads[:-1], grads[-1]
    norm = torch.sqrt(sum(torch.sum(x ** 2) for x in gp))
    eps = 3e-3

    def shifted(s):
        it = iter([x.detach() + s * g / norm for x, g in zip(leaves, gp)])
        return [{k: next(it) for k in layer} for layer in p]

    with torch.no_grad():
        fd = (loss(shifted(eps), y0) - loss(shifted(-eps), y0)) / (2 * eps)
        assert abs(float(fd) - float(norm)) / abs(float(fd)) < 1e-3
        fd_y = (loss(p, y0 + eps) - loss(p, y0 - eps)) / (2 * eps)
        assert abs(float(fd_y - gy[0])) / abs(float(fd_y)) < 1e-3


# ---------------------------------------------------------------------------
# Optimizers and schedules, step for step
# ---------------------------------------------------------------------------

OPTIMIZERS = {
    "adam": (lambda m: m.adam(1e-2)),
    "adamw": (lambda m: m.adamw(1e-2, weight_decay=0.1)),
    "adam_warmup_cosine_wd": (lambda m: m.adam(
        m.warmup_cosine_schedule(3e-3, 5, 30), weight_decay=1e-4)),
    "adam_clip": (lambda m: m.adam(1e-2, grad_clip=0.5)),
    "sgd_momentum_clip": (lambda m: m.sgd(1e-2, momentum=0.9,
                                          grad_clip=1.0)),
}


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_optimizer_steps_match_jax(name):
    p = np_params(3, (6, 16, 6))
    rng = np.random.default_rng(4)
    grads = [[{k: (rng.standard_normal(v.shape) * 0.5).astype(np.float32)
               for k, v in layer.items()} for layer in p] for _ in range(30)]
    jo, to = OPTIMIZERS[name](jopt), OPTIMIZERS[name](topt)
    jp, tp = jparams(p), params_from_numpy(p, "cpu")
    js, ts_ = jo.init(jp), to.init(tp)
    for g in grads:
        ju, js = jo.update(jparams(g), js, jp)
        jp = jopt.apply_updates(jp, ju)
        tu, ts_ = to.update(params_from_numpy(g, "cpu"), ts_, tp)
        tp = topt.apply_updates(tp, tu)
        for a, b in zip(flat(params_to_numpy(tp)), flat(jp)):
            assert rel(a, b) <= 1e-6


def test_warmup_cosine_schedule_matches_jax():
    js = jopt.warmup_cosine_schedule(3e-3, 50, 250)
    tsch = topt.warmup_cosine_schedule(3e-3, 50, 250)
    steps = np.arange(0, 300, dtype=np.int32)
    want = np.asarray([js(jnp.int32(s)) for s in steps])
    got = np.asarray([float(tsch(torch.tensor(int(s), dtype=torch.int32)))
                      for s in steps])
    assert rel(got, want) <= 1e-6
    assert got.dtype == np.float64 and want.dtype == np.float32


# ---------------------------------------------------------------------------
# Ground truth and losses
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("waveform", sorted(thp.WAVEFORMS))
def test_hp_generate_matches_jax(waveform):
    kw = trecipes.hp_waveform_config(waveform)
    want = jhp.generate(waveform, num_points=500, dt=1e-3, **kw)
    got = thp.generate(waveform, num_points=500, dt=1e-3, device="cpu", **kw)
    for a, b in zip(got, want):
        assert a.dtype == torch.float32 and tuple(a.shape) == b.shape
        assert rel(a.numpy(), b) <= 1e-5


def test_l96_generate_and_normalize_match_jax():
    _, jys, jsplit = jl96.generate(num_points=2400, dt=trecipes.L96_DT)
    _, tys, tsplit = tl96.generate(num_points=2400, dt=trecipes.L96_DT,
                                   device="cpu")
    assert tsplit == jsplit == 1800
    assert rel(tys[:1200].numpy(), np.asarray(jys)[:1200]) <= 1e-4
    want = jl96.normalize(jys)
    got = tl96.normalize(t(np.asarray(jys)))
    for a, b in zip(got, want):
        assert rel(a.numpy(), b) <= 1e-6
    # the CI window of the Lorenz96 gates, whole
    jts, jy, _ = jrecipes.l96_data(num_points=1200)
    tts, ty, _ = trecipes.l96_data(num_points=1200, device="cpu")
    np.testing.assert_array_equal(tts.numpy(), np.asarray(jts))
    assert rel(ty.numpy(), jy) <= 1e-4


def test_losses_match_jax():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((40, 3)).astype(np.float32)
    y = rng.standard_normal((33, 3)).astype(np.float32)
    for fn in ("dtw", "normalized_dtw"):
        want = float(getattr(jlosses, fn)(jnp.asarray(x), jnp.asarray(y)))
        got = float(getattr(tlosses, fn)(t(x), t(y)))
        assert abs(got - want) <= 1e-5 * abs(want)
    a, b = x[:, 0], x[:, 1]
    assert abs(float(tlosses.dtw(t(a), t(a)))) == 0.0
    for fn in ("l1", "mre"):
        want = float(getattr(jlosses, fn)(jnp.asarray(a), jnp.asarray(b)))
        assert abs(float(getattr(tlosses, fn)(t(a), t(b))) - want) \
            <= 1e-6 * abs(want)


# ---------------------------------------------------------------------------
# The trainer
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def hp_data():
    ts, xs, _, _ = jhp.generate("sine", num_points=500, dt=1e-3,
                                amp=2.0, freq=2.0)
    p = [{k: np.asarray(v) for k, v in layer.items()} for layer in
         jtwin.make_driven_twin(1, lambda s: s, hidden=14).init(
             jax.random.PRNGKey(42))]
    return np.asarray(ts), np.asarray(xs)[:, None], p


@pytest.mark.parametrize("backend", ["fused", "digital"])
def test_train_twin_loss_history_matches_jax(hp_data, backend):
    """40 steps of multiple-shooting L1 training on the HP data from the
    same (JAX-made) params: the port's loss history follows JAX's on the
    same substrate kind to <= 1e-3 rel per step.  State noise is off:
    the two packages' random streams differ."""
    ts, ys, p = hp_data
    jt = jtwin.make_driven_twin(1, jhp.WAVEFORMS["sine"](amp=2.0, freq=2.0),
                                hidden=14)
    tt = ttwin.make_driven_twin(1, thp.WAVEFORMS["sine"](amp=2.0, freq=2.0),
                                hidden=14)
    jb = FusedPallasBackend(precision="f32") if backend == "fused" else None
    tb = "fused_cuda" if backend == "fused" else None
    _, want = jtrainer.train_twin(
        jt, jparams(p), jnp.asarray(ts), jnp.asarray(ys),
        optimizer=jopt.adam(1e-3), num_steps=40, segment_len=50, loss="l1",
        noise_std=0.0, backend=jb)
    _, got = ttrainer.train_twin(
        tt, params_from_numpy(p, "cpu"), t(ts), t(ys),
        optimizer=topt.adam(1e-3), num_steps=40, segment_len=50, loss="l1",
        noise_std=0.0, backend=tb)
    want = np.asarray(want)
    assert got.shape == want.shape == (40,)
    assert float(np.max(np.abs(got.numpy() - want) / np.abs(want))) <= 1e-3
    assert got[-1] < got[0]


def test_pretrain_derivatives_matches_jax(hp_data):
    ts, ys, p = hp_data
    jt = jtwin.make_driven_twin(1, jhp.WAVEFORMS["sine"](amp=2.0, freq=2.0),
                                hidden=14)
    tt = ttwin.make_driven_twin(1, thp.WAVEFORMS["sine"](amp=2.0, freq=2.0),
                                hidden=14)
    jp, jh = jtrainer.pretrain_derivatives(
        jt.field, jparams(p), jnp.asarray(ts), jnp.asarray(ys),
        optimizer=jopt.adam(1e-2), num_steps=20)
    tp, th = ttrainer.pretrain_derivatives(
        tt.field, params_from_numpy(p, "cpu"), t(ts), t(ys),
        optimizer=topt.adam(1e-2), num_steps=20)
    assert rel(th.numpy(), jh) <= 1e-4
    for a, b in zip(flat(params_to_numpy(tp)), flat(jp)):
        assert rel(a, b) <= 1e-4


def test_fit_matches_per_step_oracle_and_noise_is_seeded(hp_data):
    ts, ys, p = hp_data
    tt = ttwin.make_driven_twin(1, thp.WAVEFORMS["sine"](amp=2.0, freq=2.0),
                                hidden=14)
    ts_seg, ys_seg = ttrainer.make_segments(t(ts), t(ys), 50)
    assert tuple(ts_seg.shape) == (9, 51) and tuple(ys_seg.shape) == (9, 51, 1)
    loss = ttrainer.segment_loss_fn(tt, ts_seg, ys_seg, noise_std=0.002,
                                    backend="fused_cuda")
    runs = [engine(loss, params_from_numpy(p, "cpu"), topt.adam(1e-3), 5,
                   torch.Generator().manual_seed(3))
            for engine in (ttrainer.fit, ttrainer.fit_per_step,
                           ttrainer.fit)]
    for params, hist in runs[1:]:
        np.testing.assert_array_equal(hist.numpy(), runs[0][1].numpy())
        for a, b in zip(flat(params_to_numpy(params)),
                        flat(params_to_numpy(runs[0][0]))):
            np.testing.assert_array_equal(a, b)
    other = ttrainer.fit(loss, params_from_numpy(p, "cpu"), topt.adam(1e-3),
                         5, torch.Generator().manual_seed(4))[1]
    assert not np.array_equal(other.numpy(), runs[0][1].numpy())
    params, hist = ttrainer.fit(loss, params_from_numpy(p, "cpu"),
                                topt.adam(1e-3), 0)
    assert hist.shape == (0,)


def test_unported_objectives_raise(hp_data):
    ts, ys, _ = hp_data
    tt = ttwin.make_driven_twin(1, thp.WAVEFORMS["sine"](), hidden=14)
    ts_seg, ys_seg = ttrainer.make_segments(t(ts), t(ys), 50)
    # hardware-aware training is ported: its loss is keyed by the step
    from repro_torch.train.hw_aware import HwAwareConfig
    loss = ttrainer.segment_loss_fn(tt, ts_seg, ys_seg,
                                    hw_aware=HwAwareConfig(k_draws=1))
    assert loss.wants_step
    assert not getattr(ttrainer.segment_loss_fn(tt, ts_seg, ys_seg),
                       "wants_step", False)
    with pytest.raises(ValueError, match="uniform time grid"):
        ttrainer.segment_loss_fn(tt, ts_seg ** 2, ys_seg)
    euler = ttwin.make_driven_twin(1, thp.WAVEFORMS["sine"](), hidden=14,
                                   method="euler")
    with pytest.raises(ValueError, match="RK4 only"):
        ttrainer.segment_loss_fn(euler, ts_seg, ys_seg, backend="fused_cuda")


# ---------------------------------------------------------------------------
# The soft-DTW objectives (fused: K5/K6 plain versions; digital: the
# reference DP under autograd)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def sdtw_case():
    """The HP case of tests/test_gradients.py's soft-DTW fit: 200 points,
    segments of 40, JAX-made params, and JAX's 6-step histories on both
    substrates for both soft-DTW objectives (gamma 0.1, no state noise)."""
    ts, xs, _, _ = jhp.generate("sine", num_points=200, dt=1e-3, amp=2.0,
                                freq=2.0)
    jt = jtwin.make_driven_twin(1, jhp.WAVEFORMS["sine"](amp=2.0, freq=2.0),
                                hidden=14)
    params = jt.init(jax.random.PRNGKey(42))
    hists = {}
    for loss in ("l1+softdtw", "softdtw"):
        for name, be in (("fused", FusedPallasBackend(precision="f32")),
                         ("digital", None)):
            hists[loss, name] = np.asarray(jtrainer.train_twin(
                jt, params, ts, xs[:, None], optimizer=jopt.adam(1e-3),
                num_steps=6, segment_len=40, loss=loss, gamma=0.1,
                backend=be)[1])
    p = [{k: np.asarray(v) for k, v in layer.items()} for layer in params]
    return np.asarray(ts), np.asarray(xs)[:, None], p, hists


@pytest.mark.parametrize("loss", ["l1+softdtw", "softdtw"])
@pytest.mark.parametrize("backend", ["fused", "digital"])
def test_softdtw_loss_history_matches_jax(sdtw_case, backend, loss):
    """6 steps of soft-DTW training from the same JAX-made weights: the
    port's fused (K1/K2/K5/K6 plain versions) or digital (adjoint +
    autograd of the reference DP) history is within 1e-3 rel per step of
    JAX's fused AND digital histories, the reference's own
    fused-vs-digital gate (tests/test_gradients.py)."""
    ts, ys, p, hists = sdtw_case
    tt = ttwin.make_driven_twin(1, thp.WAVEFORMS["sine"](amp=2.0, freq=2.0),
                                hidden=14)
    _, got = ttrainer.train_twin(
        tt, params_from_numpy(p, "cpu"), t(ts), t(ys),
        optimizer=topt.adam(1e-3), num_steps=6, segment_len=40, loss=loss,
        gamma=0.1, backend="fused_cuda" if backend == "fused" else None)
    assert got.shape == (6,) and bool(torch.isfinite(got).all())
    for ref_backend in ("fused", "digital"):
        want = hists[loss, ref_backend]
        assert float(np.max(np.abs(got.numpy() - want)
                            / np.abs(want))) <= 1e-3, ref_backend


@pytest.mark.parametrize("backend", ["fused", "digital"])
def test_segment_loss_fn_positional_gamma_matches_jax(sdtw_case, backend):
    """``segment_loss_fn(twin, ts_seg, ys_seg, loss, gamma, noise_std)``
    means the same in both packages: the fifth positional argument is
    soft-DTW's gamma (0.5 here, not the default 0.1), the sixth the state
    noise."""
    ts, ys, p, _ = sdtw_case
    jt = jtwin.make_driven_twin(1, jhp.WAVEFORMS["sine"](amp=2.0, freq=2.0),
                                hidden=14)
    tt = ttwin.make_driven_twin(1, thp.WAVEFORMS["sine"](amp=2.0, freq=2.0),
                                hidden=14)
    j_seg = jtrainer.make_segments(jnp.asarray(ts), jnp.asarray(ys), 40)
    t_seg = ttrainer.make_segments(t(ts), t(ys), 40)
    jb = FusedPallasBackend(precision="f32") if backend == "fused" else None
    tb = "fused_cuda" if backend == "fused" else None
    want = float(jtrainer.segment_loss_fn(jt, *j_seg, "l1+softdtw", 0.5,
                                          0.0, jb)(jparams(p), None))
    got = float(ttrainer.segment_loss_fn(tt, *t_seg, "l1+softdtw", 0.5, 0.0,
                                         tb)(params_from_numpy(p, "cpu"),
                                             None))
    default = float(ttrainer.segment_loss_fn(tt, *t_seg, "l1+softdtw",
                                             backend=tb)(
        params_from_numpy(p, "cpu"), None))
    assert got == pytest.approx(want, rel=1e-5)
    assert abs(default - got) > 1e-3 * abs(got)


def test_l96_recipe_runs_on_the_cpu():
    """The Lorenz96 recipe end to end at a tiny budget (the gates need
    the full one: ``chip_smoke.py`` meets them on the card)."""
    data = trecipes.l96_data(num_points=300, device="cpu")
    twin, params = trecipes.train_l96_twin(
        pretrain_steps=3, train_steps=((60, 2, 1e-3),), hidden=16,
        data=data, backend="fused_cuda", device="cpu")
    m = trecipes.eval_l96_twin(twin, params, data=data)
    assert np.isfinite(m["interp_l1"]) and np.isfinite(m["extrap_l1"])
    assert tuple(m["pred_extrap"].shape) == (300 - 225, 6)


# ---------------------------------------------------------------------------
# The HP gates of tests/test_twins.py on the fused substrate
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def hp_twin():
    t0 = time.perf_counter()
    out = trecipes.train_hp_twin(pretrain_steps=200, train_steps=250,
                                 backend="fused_cuda", device="cpu")
    print(f"train_hp_twin(200, 250, fused_cuda, cpu): "
          f"{time.perf_counter() - t0:.1f} s")
    return out


def test_hp_twin_fits_training_drive(hp_twin):
    twin, params, loss = hp_twin
    assert loss < 0.01
    m = trecipes.eval_hp_twin(twin, params, "sine", device="cpu")
    assert m["mre"] < 0.1


def test_hp_twin_extrapolates_waveforms(hp_twin):
    twin, params, _ = hp_twin
    for wf in ["triangular", "rectangular", "modulated_sine"]:
        m = trecipes.eval_hp_twin(twin, params, wf, device="cpu")
        assert m["mre"] < 0.25, (wf, m["mre"])


@pytest.fixture(scope="module")
def hp_resnet():
    t0 = time.perf_counter()
    out = trecipes.train_hp_resnet(train_steps=250, device="cpu")
    print(f"train_hp_resnet(250, cpu): {time.perf_counter() - t0:.1f} s")
    return out


def test_node_beats_recurrent_resnet(hp_twin, hp_resnet):
    """Paper Fig. 3j (``tests/test_twins.py:40``): the neural ODE's mean
    MRE over the four drives is under half the recurrent ResNet's, both at
    the JAX test's budget."""
    twin, params, _ = hp_twin
    resnet, rparams, loss = hp_resnet
    assert np.isfinite(loss)
    node_mre, res_mre = [], []
    for wf in ["sine", "triangular", "rectangular", "modulated_sine"]:
        node_mre.append(trecipes.eval_hp_twin(twin, params, wf,
                                              device="cpu")["mre"])
        res_mre.append(trecipes.eval_hp_resnet(resnet, rparams, wf,
                                               device="cpu")["mre"])
    assert sum(node_mre) / 4 < 0.5 * sum(res_mre) / 4, (node_mre, res_mre)
