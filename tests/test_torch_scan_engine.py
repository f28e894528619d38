"""The port's training engines (``make_step_fn``, ``make_scan_engine``,
``fit``, ``fit_per_step``) on the CPU, where each engine runs its step
uncaptured: the plain version of the CUDA graphs it replays on the card.

The cases of ``tests/test_trainer.py`` run on the port, on the HP fixture
built from JAX-made data and params passed in as numpy: the chunked
``fit`` equals ``fit_per_step`` and the eager loop ``fit_eager`` bit for
bit (the JAX package needs 1e-4 there: its scan and per-step programs
compile apart), the state noise is the generator's whatever the chunking,
and the caller's params are never written.  Against the JAX package: the
keyless derivative-matching fit chunked at 7 within 1e-4 relative (the
tolerance of ``test_torch_training.py::test_pretrain_derivatives_matches_jax``)
and a step-keyed hardware-aware fit chunked at 7 within 1e-3 relative per
step (``test_torch_hw_aware.py``'s history tolerance; state noise off,
the two packages' generators differ).  K3's write path (its plain version
here) is bitwise the same with the step as an int and as the engines'
int32 counter.
"""
import inspect

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import analogue as jan  # noqa: E402
from repro.core import twin as jtwin  # noqa: E402
from repro.data import hp_memristor as jhp  # noqa: E402
from repro.train import hw_aware as jhw  # noqa: E402
from repro.train import optimizer as jopt  # noqa: E402
from repro.train import trainer as jtrainer  # noqa: E402
from repro_torch.core import analogue as tan  # noqa: E402
from repro_torch.core import twin as ttwin  # noqa: E402
from repro_torch.data import hp_memristor as thp  # noqa: E402
from repro_torch.interop import params_from_numpy, params_to_numpy  # noqa: E402
from repro_torch.kernels import noise as tnoise  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.train import hw_aware as thw  # noqa: E402
from repro_torch.train import trainer as ttrainer  # noqa: E402
from repro_torch.train.optimizer import (adam, sgd,  # noqa: E402
                                         warmup_cosine_schedule)

CAL = "calibration/paper_device.json"
PRETRAIN_TOL = 1e-4
HIST_TOL = 1e-3


def t(x):
    return torch.from_numpy(np.array(x, copy=True))


def flat(tree):
    """[w0, b0, w1, b1, ...] as numpy, from either package's params."""
    return [np.asarray(layer[k]) for layer in tree for k in ("w", "b")]


def rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.max(np.abs(a - b)) / (np.max(np.abs(b)) + 1e-30))


def gen(seed):
    return torch.Generator().manual_seed(seed)


def assert_same(run_a, run_b):
    """Bitwise equal loss histories and final params."""
    (pa, ha), (pb, hb) = run_a, run_b
    assert ha.dtype == hb.dtype == torch.float32
    np.testing.assert_array_equal(ha.numpy(), hb.numpy())
    for a, b in zip(flat(params_to_numpy(pa)), flat(params_to_numpy(pb))):
        np.testing.assert_array_equal(a, b)


@pytest.fixture(scope="module")
def hp():
    """The HP recipe's two loss phases (derivative matching, and the
    multiple-shooting trajectory with state noise 0.002) on JAX's data and
    JAX-initialised params, in both packages."""
    ts, xs, _, _ = jhp.generate("sine", num_points=500, dt=1e-3, amp=2.0,
                                freq=2.0)
    ts, ys = np.asarray(ts), np.asarray(xs)[:, None]
    jt = jtwin.make_driven_twin(1, jhp.WAVEFORMS["sine"](amp=2.0, freq=2.0),
                                hidden=14)
    tt = ttwin.make_driven_twin(1, thp.WAVEFORMS["sine"](amp=2.0, freq=2.0),
                                hidden=14)
    p = [{k: np.asarray(v) for k, v in layer.items()}
         for layer in jt.init(jax.random.PRNGKey(42))]
    tsm, ysm, dys = ttrainer.finite_difference_derivatives(t(ts), t(ys))
    pre = ttrainer.derivative_matching_loss(tt.field, tsm, ysm, dys)
    tseg = ttrainer.make_segments(t(ts), t(ys), 50)
    traj = ttrainer.segment_loss_fn(tt, *tseg, "l1", noise_std=0.002)
    return dict(ts=ts, ys=ys, p=p, jt=jt, tt=tt, pre=pre, traj=traj,
                tseg=tseg)


def params(hp):
    return params_from_numpy(hp["p"], "cpu")


# ---------------------------------------------------------------------------
# tests/test_trainer.py's cases on the port
# ---------------------------------------------------------------------------

PRE_STEPS = 120


@pytest.fixture(scope="module")
def pre_reference(hp):
    """The derivative-matching fit's per-step engine and eager loop."""
    want = ttrainer.fit_per_step(hp["pre"], params(hp), adam(1e-2),
                                 PRE_STEPS, gen(1))
    assert_same(want, ttrainer.fit_eager(hp["pre"], params(hp), adam(1e-2),
                                         PRE_STEPS, gen(1)))
    return want


@pytest.mark.parametrize("scan_chunk", [None, 1, 37, 200])
def test_fit_equals_per_step_reference(hp, pre_reference, scan_chunk):
    """Any chunking, a partial last chunk included (120 steps, chunk 37:
    three chunks of blocks of 8 and 5, then one of 9: 8 and 1), is bitwise
    the per-step engine and the eager loop."""
    got = ttrainer.fit(hp["pre"], params(hp), adam(1e-2), PRE_STEPS, gen(1),
                       scan_chunk=scan_chunk)
    assert got[1].shape == pre_reference[1].shape == (PRE_STEPS,)
    assert_same(got, pre_reference)


def test_fit_equals_per_step_on_trajectory_loss(hp):
    """The noise-regularised multiple-shooting phase: the generator's draws
    land in the same steps inside a chunk as in the per-step loop (12
    steps in chunks of 7 and 5)."""
    steps = 12
    got = ttrainer.fit(hp["traj"], params(hp), adam(1e-3), steps, gen(2),
                       scan_chunk=7)
    assert_same(got, ttrainer.fit_per_step(hp["traj"], params(hp),
                                           adam(1e-3), steps, gen(2)))


@pytest.fixture(scope="module")
def noisy_reference(hp):
    return ttrainer.fit_eager(hp["traj"], params(hp), adam(1e-3), 15, gen(3))


@pytest.mark.parametrize("scan_chunk", [None, 1, 7])
def test_fit_input_noise_reproducible_across_chunkings(hp, noisy_reference,
                                                       scan_chunk):
    """The noise is a function of (seed, step) only: every chunking is
    bitwise the eager loop (JAX's engines agree to float32 rounding)."""
    got = ttrainer.fit(hp["traj"], params(hp), adam(1e-3), 15, gen(3),
                       scan_chunk=scan_chunk)
    assert_same(got, noisy_reference)


def test_fit_input_noise_same_seed_bitwise_repeatable(hp):
    runs = [ttrainer.fit(hp["traj"], params(hp), adam(1e-3), 7, gen(4),
                         scan_chunk=4) for _ in range(2)]
    assert_same(*runs)
    _, other = ttrainer.fit(hp["traj"], params(hp), adam(1e-3), 7, gen(5),
                            scan_chunk=4)
    assert not np.array_equal(runs[0][1].numpy(), other.numpy())


def test_fit_keyless_and_schedule(hp):
    """No generator, and a schedule computed from the optimizer's device
    step counter."""
    def opt():
        return adam(warmup_cosine_schedule(1e-2, 10, 60))
    got = ttrainer.fit(hp["pre"], params(hp), opt(), 60, None, scan_chunk=25)
    assert_same(got, ttrainer.fit_per_step(hp["pre"], params(hp), opt(), 60,
                                           None))


def test_fit_sgd_momentum_state_carried(hp):
    """sgd's (step, velocity) tuple state survives the engine's buffers,
    and its velocity-free form (a None leaf) too."""
    for opt in (lambda: sgd(1e-3, momentum=0.9), lambda: sgd(1e-3)):
        got = ttrainer.fit(hp["pre"], params(hp), opt(), 30, None,
                           scan_chunk=8)
        assert_same(got, ttrainer.fit_per_step(hp["pre"], params(hp), opt(),
                                               30, None))


def test_fit_zero_steps(hp):
    p = params(hp)
    got, hist = ttrainer.fit(hp["pre"], p, adam(1e-2), 0)
    assert hist.shape == (0,)
    assert got is p
    _, hist = ttrainer.fit_per_step(hp["pre"], p, adam(1e-2), 0)
    assert hist.shape == (0,)
    opt = adam(1e-2)
    run = ttrainer.make_scan_engine(hp["pre"], opt, False)
    q, _, _, hist = run(p, opt.init(p), None, 0)
    assert hist.shape == (0,) and run.engine.blocks == {}
    for a, b in zip(flat(params_to_numpy(q)), flat(params_to_numpy(p))):
        np.testing.assert_array_equal(a, b)


def test_fit_logging_syncs_only_at_chunk_boundaries(hp, capsys):
    _, hist = ttrainer.fit(hp["pre"], params(hp), adam(1e-2), 45, None,
                           log_every=20, scan_chunk=30)
    out = capsys.readouterr().out
    lines = [ln for ln in out.splitlines() if "step" in ln]
    assert [int(ln.split()[1]) for ln in lines] == [0, 20, 40, 44]
    for ln in lines:
        i = int(ln.split()[1])
        assert ln.split()[-1] == f"{float(hist[i]):.6f}"
    ttrainer.fit_per_step(hp["pre"], params(hp), adam(1e-2), 45, None,
                          log_every=20)
    assert capsys.readouterr().out == out


def test_fit_does_not_write_caller_params(hp):
    p = params(hp)
    before = [x.copy() for x in flat(params_to_numpy(p))]
    ttrainer.fit(hp["pre"], p, adam(1e-2), 5)
    ttrainer.fit_per_step(hp["traj"], p, adam(1e-3), 3, gen(0))
    for a, b in zip(flat(params_to_numpy(p)), before):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# The engines' own surface
# ---------------------------------------------------------------------------

def test_engines_have_jax_parameter_names():
    """JAX's names, with ``generator`` where JAX takes ``key``."""
    def names(fn):
        return ["key" if n == "generator" else n
                for n in inspect.signature(fn).parameters]
    for name in ("make_step_fn", "make_scan_engine", "fit", "fit_per_step",
                 "train_twin", "pretrain_derivatives"):
        want = list(inspect.signature(getattr(jtrainer, name)).parameters)
        got = names(getattr(ttrainer, name))
        assert sorted(got) == sorted(want), name
        assert got[:4] == want[:4], name
    for name in ("make_step_fn", "make_scan_engine", "fit", "fit_per_step"):
        j = inspect.signature(getattr(jtrainer, name)).parameters
        p = inspect.signature(getattr(ttrainer, name)).parameters
        for k, v in j.items():
            if v.default is not inspect.Parameter.empty:
                got = p["generator" if k == "key" else k].default
                assert got == v.default, (name, k)


def test_scan_engine_carries_step_and_buffers(hp):
    """make_scan_engine by hand on a step-keyed loss: chunks of 5 and 3
    (unroll 4: blocks of 4, 1, then 3) equal the eager loop; the returned
    step counter is int32 and advanced; carries passed
    back are not copied; the caller's params are untouched."""
    _, tc = hw_configs(False)
    loss = ttrainer.segment_loss_fn(hp["tt"], *hp["tseg"], noise_std=0.002,
                                    hw_aware=tc)
    assert loss.wants_step
    p = params(hp)
    opt = adam(1e-3)
    run = ttrainer.make_scan_engine(loss, opt, True, unroll=4)
    g = gen(6)
    q, s, g, step, h1 = run(p, opt.init(p), g, 0, 5)
    assert step.dtype == torch.int32 and int(step) == 5
    q2, s2, g, step, h2 = run(q, s, g, step, 3)
    assert int(step) == 8 and all(a is b for a, b in zip(
        ttrainer.tree_leaves(q2), ttrainer.tree_leaves(q)))
    assert sorted(run.engine.blocks) == [1, 3, 4]
    want = ttrainer.fit_eager(loss, params(hp), adam(1e-3), 8, gen(6))
    assert_same((q2, torch.cat([h1, h2])), want)
    for a, b in zip(flat(params_to_numpy(p)), flat(hp["p"])):
        np.testing.assert_array_equal(a, b)


def test_scan_engine_donate_updates_callers_tensors(hp):
    """``donate=True``: the first call's param and state tensors become the
    engine's buffers, updated in place; the numbers are the copying
    engine's."""
    opt = adam(1e-2)
    p = params(hp)
    s = opt.init(p)
    run = ttrainer.make_scan_engine(hp["pre"], opt, False, donate=True)
    q, _, _, h = run(p, s, None, 10)
    for a, b in zip(ttrainer.tree_leaves(q), ttrainer.tree_leaves(p)):
        assert a.data_ptr() == b.data_ptr()
    assert int(s.step) == 10
    want = ttrainer.make_scan_engine(hp["pre"], opt, False)(
        params(hp), opt.init(params(hp)), None, 10)
    assert_same((p, h), (want[0], want[3]))


def test_step_fn_is_one_step(hp):
    p = params(hp)
    opt = adam(1e-3)
    step_fn = ttrainer.make_step_fn(hp["traj"], opt, True)
    state, g, hist = opt.init(p), gen(7), []
    q = p
    for _ in range(3):
        q, state, g, loss = step_fn(q, state, g)
        assert loss.shape == ()
        hist.append(loss)
    assert sorted(step_fn.engine.blocks) == [1]
    assert_same((q, torch.stack(hist)), ttrainer.fit_eager(
        hp["traj"], params(hp), adam(1e-3), 3, gen(7)))


def test_loss_drawing_from_the_generator_itself_raises(hp):
    """Inside an engine the loss's generator argument is a StepNoise: a
    loss that draws from it with torch directly fails, naming the cause."""
    ysm = torch.zeros((4, 1))

    def loss(p, generator):
        noise = torch.randn(ysm.shape, generator=generator)
        return torch.mean(hp["pre"](p, None) + noise.sum() * 0)

    with pytest.raises(TypeError, match="normal_like"):
        ttrainer.fit(loss, params(hp), adam(1e-2), 2, gen(0))
    ok = ttrainer.fit_eager(loss, params(hp), adam(1e-2), 2, gen(0))[1]
    assert ok.shape == (2,)


# ---------------------------------------------------------------------------
# Against the JAX package
# ---------------------------------------------------------------------------

def test_chunked_pretrain_matches_jax(hp):
    jtsm, jysm, jdys = jtrainer.finite_difference_derivatives(
        jnp.asarray(hp["ts"]), jnp.asarray(hp["ys"]))
    jloss = jtrainer.derivative_matching_loss(hp["jt"].field, jtsm, jysm,
                                              jdys)
    jp = [{k: jnp.asarray(v) for k, v in layer.items()} for layer in hp["p"]]
    want_p, want_h = jtrainer.fit(jloss, jp, jopt.adam(1e-2), 20,
                                  scan_chunk=7)
    got_p, got_h = ttrainer.fit(hp["pre"], params(hp), adam(1e-2), 20,
                                scan_chunk=7)
    assert rel(got_h.numpy(), want_h) <= PRETRAIN_TOL
    for a, b in zip(flat(params_to_numpy(got_p)), flat(want_p)):
        assert rel(a, b) <= PRETRAIN_TOL


def hw_configs(faults: bool):
    """The calibrated spec, 2 draws, noise seed 3, in both packages."""
    jc = jhw.HwAwareConfig(spec=jan.spec_from_calibration(CAL), k_draws=2,
                           noise_seed=3)
    tc = thw.HwAwareConfig(spec=tan.spec_from_calibration(CAL), k_draws=2,
                           noise_seed=3)
    return jc, tc


def test_chunked_step_keyed_fit_matches_jax(hp):
    """Hardware-aware (step-keyed) digital training, 9 steps chunked at
    7, against JAX's per-step loop (its scan is pinned to that loop by
    ``tests/test_trainer.py``): the int32 step counter crosses the chunk
    boundary as JAX's step does, so every step's device draws agree."""
    jc, tc = hw_configs(False)
    jseg = jtrainer.make_segments(jnp.asarray(hp["ts"]),
                                  jnp.asarray(hp["ys"]), 50)
    jloss = jtrainer.segment_loss_fn(hp["jt"], *jseg, hw_aware=jc)
    jp = [{k: jnp.asarray(v) for k, v in layer.items()} for layer in hp["p"]]
    _, want = jtrainer.fit_per_step(jloss, jp, jopt.adam(1e-3), 9)
    tloss = ttrainer.segment_loss_fn(hp["tt"], *hp["tseg"], hw_aware=tc)
    _, got = ttrainer.fit(tloss, params(hp), adam(1e-3), 9, scan_chunk=7)
    want = np.asarray(want)
    assert got.shape == want.shape == (9,)
    assert float(np.max(np.abs(got.numpy() - want) / np.abs(want))) \
        <= HIST_TOL


# ---------------------------------------------------------------------------
# K3's write path: the step as an int and as the engines' int32 counter
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("step", [0, 37, 2 ** 32 - 1])
@pytest.mark.parametrize("ensemble", [False, True])
def test_write_path_tensor_step_bitwise_int_step(step, ensemble):
    from repro_torch.core import faults as tfaults
    rng = np.random.default_rng(8)
    sizes = (2, 14, 14, 1)
    ws = [t(rng.standard_normal((a, b)).astype(np.float32))
          for a, b in zip(sizes[:-1], sizes[1:])]
    bs = [t(rng.standard_normal(b).astype(np.float32)) for b in sizes[1:]]
    kw = {}
    if ensemble:
        kw = dict(faults=tfaults.make_fault_model(
            ("stuck", dict(rate=0.05)), seed=5), fault_ensemble=True)
    cfg = thw.HwAwareConfig(spec=tan.spec_from_calibration(CAL), k_draws=2,
                            noise_seed=3, **kw)
    wp = thw._write_path(cfg, len(ws), cfg.k_draws)
    counter = torch.tensor(step - (2 ** 32 if step >= 2 ** 31 else 0),
                           dtype=torch.int32)
    by_int = tnoise.hw_write_path(ws, bs, wp, step, range(2), ste=True)
    by_tensor = tnoise.hw_write_path(ws, bs, wp, counter, range(2), ste=True)
    plain = tref.hw_write_path_ref(ws, bs, wp, counter, range(2), ste=True)
    for per_int, per_t, per_p in zip(by_int, by_tensor, plain):
        for (wi, bi), (wt, bt), (wr, br) in zip(per_int, per_t, per_p):
            assert torch.equal(wi, wt) and torch.equal(bi, bt)
            assert torch.equal(wi, wr) and torch.equal(bi, br)
    other = tnoise.hw_write_path(ws, bs, wp, (step + 1) % 2 ** 32, range(2),
                                 ste=True)
    assert not torch.equal(other[0][0][0], by_int[0][0][0])
    with pytest.raises(ValueError, match="int32"):
        tnoise.hw_write_path(ws, bs, wp, counter.to(torch.int64), range(2))
