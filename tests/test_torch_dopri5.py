"""The port's adaptive Dormand-Prince 5(4) solver against the JAX
package's ``odeint_dopri5``, on the CPU.

Same numpy-made params, initial states and grids through both packages.
Tolerances: 1e-5 of the peak against JAX (step-size decisions made in
float32 can flip where an error norm sits on the accept boundary; on
these fields none does); 1e-4 of the peak against a float64
``scipy.integrate.solve_ivp(method="DOP853", rtol=1e-10)``; 1e-6 where
the port is held to itself (a fleet against its single-row solves).
At the default ``rtol=1e-5`` the driven HP field (ReLU kinks, a drive
of 2 V at 2 Hz) ends 0.7-1.4e-4 of its peak from the float64 solution in
both packages alike, so that comparison runs the HP field at
``rtol=1e-7, atol=1e-9``; the Lorenz96-style field keeps the defaults
(at 1e-7 its steps would fall below float32's resolution of t).
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from scipy.integrate import solve_ivp  # noqa: E402

from repro.core import backends as jbackends  # noqa: E402
from repro.core import node as jnode  # noqa: E402
from repro.core import ode as jode  # noqa: E402
from repro.core import twin as jtwin  # noqa: E402
from repro.core.analogue import AnalogueSpec as JSpec  # noqa: E402
from repro_torch.core import analogue as tanalogue  # noqa: E402
from repro_torch.core import node as tnode  # noqa: E402
from repro_torch.core import ode as tode  # noqa: E402
from repro_torch.core import twin as ttwin  # noqa: E402
from repro_torch.core.analogue import AnalogueSpec  # noqa: E402
from repro_torch.core.backends import (BACKENDS, AnalogueBackend,  # noqa: E402
                                       Backend, BaseBackend, DigitalBackend,
                                       FusedCudaBackend)
from repro_torch.interop import params_from_numpy  # noqa: E402
from repro_torch.train import trainer as ttrainer  # noqa: E402
from repro_torch.train.optimizer import adam  # noqa: E402

TOL = 1e-5          # port vs JAX, of the peak
REF_TOL = 1e-4      # either package vs the float64 DOP853 solution
SELF_TOL = 1e-6     # a fleet vs its single-row solves


def t(x):
    return torch.from_numpy(np.array(x, copy=True))


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


def np_params(seed, sizes):
    rng = np.random.default_rng(seed)
    return [{"w": (rng.standard_normal((a, b)) * np.sqrt(2.0 / a))
             .astype(np.float32),
             "b": (0.1 * rng.standard_normal(b)).astype(np.float32)}
            for a, b in zip(sizes[:-1], sizes[1:])]


def jparams(p):
    return [{k: jnp.asarray(v) for k, v in layer.items()} for layer in p]


AMP, FREQ = 2.0, 2.0
FIELDS = {
    # name: (sizes, driven, grid, y0, float64 comparison's solver kwargs)
    "hp": ((2, 14, 14, 1), True, np.linspace(0.0, 0.5, 51),
           np.array([0.3]), dict(rtol=1e-7, atol=1e-9)),
    "l96": ((6, 16, 16, 6), False, np.linspace(0.0, 1.0, 41),
            np.linspace(-0.5, 0.5, 6), {}),
}


def fields(sizes, driven):
    jd = (lambda s: AMP * jnp.sin(2 * math.pi * FREQ * s)) if driven else None
    td = (lambda s: AMP * torch.sin(2 * math.pi * FREQ * s)) if driven \
        else None
    return (jnode.MLPVectorField(sizes=sizes, drive=jd),
            tnode.MLPVectorField(sizes=sizes, drive=td))


def float64_solution(p, driven, ts, y0):
    def f(s, y):
        x = np.concatenate([[AMP * np.sin(2 * np.pi * FREQ * s)], y]) \
            if driven else y
        for i, layer in enumerate(p):
            x = x @ layer["w"].astype(np.float64) + layer["b"]
            if i < len(p) - 1:
                x = np.maximum(x, 0.0)
        return x
    sol = solve_ivp(f, (ts[0], ts[-1]), y0.astype(np.float64),
                    method="DOP853", rtol=1e-10, atol=1e-12, t_eval=ts)
    return sol.y.T


@pytest.mark.parametrize("name", sorted(FIELDS))
def test_dopri5_matches_jax_and_a_float64_solution(name):
    sizes, driven, ts, y0, ref_kw = FIELDS[name]
    p = np_params(0, sizes)
    jf, tf = fields(sizes, driven)
    ts32, y032 = ts.astype(np.float32), y0.astype(np.float32)
    stats = {}
    want = np.asarray(jode.odeint_dopri5(jf, jnp.asarray(y032),
                                         jnp.asarray(ts32), jparams(p)))
    got = tode.odeint_dopri5(tf, t(y032), t(ts32), params_from_numpy(p, "cpu"),
                             stats=stats)
    assert tuple(got.shape) == want.shape == (len(ts), sizes[-1])
    assert rel(got.numpy(), want) <= TOL
    assert stats["iterations"] == int(stats["accepted"] + stats["rejected"])
    # both packages against a float64 solution, at the kwargs named above
    exact = float64_solution(p, driven, ts32.astype(np.float64), y0)
    jref = np.asarray(jode.odeint_dopri5(jf, jnp.asarray(y032),
                                         jnp.asarray(ts32), jparams(p),
                                         **ref_kw))
    tref = tode.odeint_dopri5(tf, t(y032), t(ts32),
                              params_from_numpy(p, "cpu"), **ref_kw).numpy()
    assert rel(jref, exact) <= REF_TOL
    assert rel(tref, exact) <= REF_TOL


def test_make_odeint_and_core_exports():
    import repro_torch.core as core
    assert core.odeint_dopri5 is tode.odeint_dopri5
    assert core.make_odeint is tode.make_odeint
    sizes, driven, ts, y0, _ = FIELDS["l96"]
    _, tf = fields(sizes, driven)
    tp = params_from_numpy(np_params(1, sizes), "cpu")
    args = (tf, t(y0.astype(np.float32)), t(ts.astype(np.float32)), tp)
    assert torch.equal(tode.make_odeint("dopri5", rtol=1e-6)(*args),
                       tode.odeint_dopri5(*args, rtol=1e-6))
    assert torch.equal(tode.make_odeint("rk38", steps_per_interval=2)(*args),
                       tode.odeint(*args, method="rk38",
                                   steps_per_interval=2))
    x = torch.randn(3, 4)
    w, b = torch.randn(4, 2), torch.randn(2)
    assert torch.equal(tnode.dense_linear(w, b, x), x @ w + b)


# a relaxation toward a drive, one rate and frequency per row: the stiff
# rows need ~10x the steps of the slow one.  Elementwise, so a row's
# evaluation in the fleet is its evaluation alone (an MLP's batched
# product rounds otherwise, and on a fast-driven ReLU field that can flip
# a step decision: JAX's own vmapped fleet then differs from its single
# solves by 1e-4-1e-3 of the peak).
RATES = np.array([[1.0], [30.0], [300.0]], np.float32)
OMEGAS = np.array([[2.0], [20.0], [60.0]], np.float32)


def relaxation(sin):
    return lambda s, y, k, w: -k * (y - sin(w * s[..., None]))


def test_fleet_rows_keep_their_own_step_control():
    """A fleet whose rows need very different steps: each row's controller
    is its own (the JAX package vmaps one while_loop per twin), so the
    fleet equals its single-row solves and JAX's vmapped fleet, in one
    loop whose iterations follow the busiest row."""
    ts = np.linspace(0.0, 1.0, 11).astype(np.float32)
    y0s = np.array([[0.5], [-0.2], [0.1]], np.float32)
    f = relaxation(torch.sin)
    stats = {}
    got = tode.odeint_dopri5(f, t(y0s), t(ts), t(RATES), t(OMEGAS),
                             stats=stats)
    acc = stats["accepted"].numpy()
    attempts = acc + stats["rejected"].numpy()
    assert acc.max() >= 5 * acc.min(), acc
    assert attempts.max() <= stats["iterations"] < attempts.sum()
    for i in range(len(y0s)):
        single = tode.odeint_dopri5(f, t(y0s[i]), t(ts), t(RATES[i]),
                                    t(OMEGAS[i]))
        assert rel(got[:, i].numpy(), single.numpy()) <= SELF_TOL
    jf = relaxation(jnp.sin)
    want = np.asarray(jax.vmap(
        lambda y0, k, w: jode.odeint_dopri5(jf, y0, jnp.asarray(ts), k, w),
        out_axes=1)(jnp.asarray(y0s), jnp.asarray(RATES),
                    jnp.asarray(OMEGAS)))
    assert rel(got.numpy(), want) <= TOL


def test_driven_fleet_matches_stacked_solves():
    """A driven twin fleet under dopri5 through ``TwinFleet`` (per-twin
    drives, the fleet one (N, D) solve) equals its stacked single-twin
    solves (1e-6).  JAX's vmapped fleet is held at 1e-3: at the 8 Hz row
    its batched products flip a step decision, and it sits 3.6e-4 of the
    peak from JAX's own single-twin solve."""
    sizes = (2, 14, 14, 1)
    p = np_params(2, sizes)
    ts = np.linspace(0.0, 0.5, 26).astype(np.float32)
    y0s = np.array([[0.1], [0.2], [0.3]], np.float32)
    freqs = np.array([[0.5], [2.0], [8.0]], np.float32)
    tp = params_from_numpy(p, "cpu")
    fam = lambda s, th: AMP * torch.sin(2 * math.pi * th[0] * s)  # noqa: E731
    fleet = ttwin.TwinFleet(ttwin.make_driven_twin(1, None, method="dopri5"),
                            drive_family=fam)
    got = fleet.rollout_batch(tp, t(y0s), t(ts), t(freqs))
    for i in range(len(y0s)):
        one = ttwin.make_driven_twin(
            1, lambda s, th=t(freqs[i]): fam(s, th), method="dopri5")
        single = one.simulate(tp, t(y0s[i]), t(ts))
        assert rel(got[i].numpy(), single.numpy()) <= SELF_TOL
    jfam = lambda s, th: AMP * jnp.sin(2 * math.pi * th[0] * s)  # noqa: E731
    jfleet = jtwin.TwinFleet(jtwin.make_driven_twin(1, None, method="dopri5"),
                             drive_family=jfam)
    want = np.asarray(jfleet.rollout_batch(jparams(p), jnp.asarray(y0s),
                                           jnp.asarray(ts),
                                           jnp.asarray(freqs)))
    assert rel(got.numpy(), want) <= 1e-3


def test_resumed_rows_on_their_own_grids_match_jax():
    """``rollout_batch_resumed`` under dopri5: each twin from its own
    global step, so each row integrates on its own grid (solve_window)."""
    sizes = (6, 16, 16, 6)
    p = np_params(3, sizes)
    ys = np.random.default_rng(3).standard_normal((4, 6)).astype(np.float32)
    starts = np.array([0, 7, 7, 300])
    jtw = jtwin.make_autonomous_twin(6, hidden=16, method="dopri5")
    want = np.asarray(jtwin.TwinFleet(jtw).rollout_batch_resumed(
        jparams(p), jnp.asarray(ys), dt=0.01, num_steps=12,
        start_steps=starts))
    ttw = ttwin.make_autonomous_twin(6, hidden=16, method="dopri5")
    got = ttwin.TwinFleet(ttw).rollout_batch_resumed(
        params_from_numpy(p, "cpu"), t(ys), dt=0.01, num_steps=12,
        start_steps=starts)
    assert tuple(got.shape) == want.shape == (4, 13, 6)
    assert rel(got.numpy(), want) <= TOL


def test_max_steps_truncation_matches_jax():
    """An interval that reaches ``max_steps`` attempts ends short of its
    end, with no error, and the next interval starts from there.  One
    attempt an interval: with more, the truncated states hang on which
    attempts a rounding accepts (JAX's own jitted and eager runs of this
    field differ by up to 5e-2 of the peak at 2 and 3 attempts)."""
    sizes, driven, ts, y0, _ = FIELDS["hp"]
    p = np_params(4, sizes)
    jf, tf = fields(sizes, driven)
    ts32 = np.linspace(0.0, 0.5, 6).astype(np.float32)
    y032 = y0.astype(np.float32)
    kw = dict(max_steps=1)
    want = np.asarray(jode.odeint_dopri5(jf, jnp.asarray(y032),
                                         jnp.asarray(ts32), jparams(p), **kw))
    stats = {}
    got = tode.odeint_dopri5(tf, t(y032), t(ts32), params_from_numpy(p, "cpu"),
                             stats=stats, **kw)
    assert rel(got.numpy(), want) <= TOL
    assert stats["iterations"] == len(ts32) - 1
    assert int(stats["rejected"]) > 0
    full = tode.odeint_dopri5(tf, t(y032), t(ts32),
                              params_from_numpy(p, "cpu"))
    assert rel(got.numpy(), full.numpy()) > 0.1      # truncated, not solved


def test_backward_raises_and_the_forward_works():
    sizes = (4, 8, 4)
    tp = params_from_numpy(np_params(5, sizes), "cpu")
    for layer in tp:
        layer["w"].requires_grad_()
    twin = ttwin.make_autonomous_twin(4, hidden=8, n_hidden_layers=1,
                                      method="dopri5")
    y0 = torch.full((3, 4), 0.1, requires_grad=True)
    ts = torch.linspace(0.0, 0.1, 6)
    for gradient in ("adjoint", "direct"):
        out = DigitalBackend().rollout(DigitalBackend().program(twin.field,
                                                                tp),
                                       y0, ts, method="dopri5",
                                       gradient=gradient)
        assert out.requires_grad and bool(torch.isfinite(out).all())
        with pytest.raises(NotImplementedError, match="rk4"):
            out.sum().backward()
    with torch.no_grad():
        quiet = twin.simulate_batch(tp, y0, ts)
    assert not quiet.requires_grad
    assert torch.equal(quiet.transpose(0, 1), out.detach())


def test_analogue_backend_supports_dopri5():
    """JAX's gate ``tests/test_backends.py:242``: a dopri5 twin deploys
    to the crossbar simulator, noise-free, within atol 5e-4 / rtol 1e-4 of
    digital; and both match JAX's."""
    jt = jtwin.make_driven_twin(1, lambda s: jnp.sin(4.0 * s),
                                method="dopri5")
    jp = jt.init(jax.random.PRNGKey(0))
    p = [{k: np.asarray(v) for k, v in layer.items()} for layer in jp]
    ts = np.linspace(0.0, 0.25, 51).astype(np.float32)
    y0 = np.array([0.2], np.float32)
    tt = ttwin.make_driven_twin(1, lambda s: torch.sin(4.0 * s),
                                method="dopri5")
    tp = params_from_numpy(p, "cpu")
    dig = tt.simulate(tp, t(y0), t(ts)).numpy()
    ana = tt.with_backend(AnalogueBackend(
        spec=AnalogueSpec(prog_noise=0.0, read_noise=0.0, quantize=False),
        prog_seed=0)).simulate(tp, t(y0), t(ts)).numpy()
    np.testing.assert_allclose(ana, dig, atol=5e-4, rtol=1e-4)
    jana = jt.with_backend(jbackends.AnalogueBackend(
        spec=JSpec(prog_noise=0.0, read_noise=0.0, quantize=False),
        prog_key=jax.random.PRNGKey(0))).simulate(jp, jnp.asarray(y0),
                                                  jnp.asarray(ts))
    assert rel(dig, jt.simulate(jp, jnp.asarray(y0), jnp.asarray(ts))) <= TOL
    assert rel(ana, np.asarray(jana)) <= TOL


NOISY = AnalogueSpec(prog_noise=0.0, read_noise=0.02)


def test_noisy_reads_group_rows_by_tick():
    """Rows evaluated at equal ticks read the same noise; each row reads
    what it would read alone at its own time."""
    gen = torch.Generator().manual_seed(0)
    sizes = (2, 14, 14, 1)
    progs = tuple(tanalogue.program_mlp(
        gen, params_from_numpy(np_params(6, sizes), "cpu"), NOISY))
    field = tanalogue.AnalogueMLPVectorField(
        progs=progs, spec=NOISY, drive=lambda s: torch.sin(4.0 * s),
        read_seed=7)
    y = torch.full((5, 1), 0.25)
    ts = torch.tensor([0.1, 0.2, 0.1, 0.3, 0.2])
    out = field(ts, y)
    assert torch.equal(out[0], out[2]) and torch.equal(out[1], out[4])
    assert not torch.equal(out[0], out[1])
    for i in range(5):
        alone = field(ts[i], y[i])
        assert float((out[i] - alone).abs().max()) <= SELF_TOL * float(
            alone.abs().max())


def test_noisy_dopri5_fleet_equals_its_single_twins():
    """A noisy simulator fleet under dopri5 (rows at different times in
    one evaluation) is, row by row, the single-twin noisy rollout."""
    sizes = (2, 14, 14, 1)
    tp = params_from_numpy(np_params(7, sizes), "cpu")
    twin = ttwin.make_driven_twin(1, lambda s: torch.sin(20.0 * s),
                                  method="dopri5").with_backend(
        AnalogueBackend(spec=NOISY, prog_seed=1, read_seed=3))
    y0s = torch.tensor([[0.05], [0.2], [0.4], [0.8]])
    ts = torch.linspace(0.0, 0.3, 7)
    fleet = twin.simulate_batch(tp, y0s, ts)
    assert bool(torch.isfinite(fleet).all())
    for i in range(len(y0s)):
        one = twin.simulate(tp, y0s[i], ts)
        assert rel(fleet[i].numpy(), one.numpy()) <= SELF_TOL


def test_every_backend_is_a_backend_and_fused_refuses_dopri5():
    for be in (BaseBackend(), *(cls() for cls in BACKENDS.values())):
        assert isinstance(be, Backend), type(be).__name__
    assert not isinstance(object(), Backend)
    twin = ttwin.make_autonomous_twin(4, hidden=8, n_hidden_layers=1,
                                      method="dopri5")
    tp = params_from_numpy(np_params(8, (4, 8, 4)), "cpu")
    ts = torch.linspace(0.0, 0.1, 6)
    with pytest.raises(ValueError, match="RK4 only"):
        twin.with_backend(FusedCudaBackend(batch_tile=1)).simulate(
            tp, torch.zeros(4), ts)
    with pytest.raises(ValueError, match="RK4 only"):
        ttrainer.train_twin(twin, tp, torch.linspace(0.0, 1.0, 31),
                            torch.zeros(31, 4), optimizer=adam(1e-3),
                            num_steps=1, segment_len=10,
                            backend="fused_cuda")
