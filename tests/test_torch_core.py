"""The port's numerics core (``repro_torch.core``) against the JAX package.

Same numpy-made inputs through both packages; float32 results agree to
1e-5 of the trajectory's peak (the two frameworks sum matrix products in
different orders).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import node as jnode  # noqa: E402
from repro.core import ode as jode  # noqa: E402
from repro.core import twin as jtwin  # noqa: E402
from repro.core.backends import FusedPallasBackend  # noqa: E402
from repro_torch.core import node as tnode  # noqa: E402
from repro_torch.core import ode as tode  # noqa: E402
from repro_torch.core import twin as ttwin  # noqa: E402
from repro_torch.core.backends import (BACKENDS, DigitalBackend,  # noqa: E402
                                       FusedCudaBackend, resolve_backend)
from repro_torch.interop import params_from_numpy, params_to_numpy  # noqa: E402

TOL = 1e-5


def rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


def np_params(seed, sizes):
    rng = np.random.default_rng(seed)
    return [{"w": (rng.standard_normal((a, b)) * np.sqrt(2.0 / a))
             .astype(np.float32),
             "b": (0.1 * rng.standard_normal(b)).astype(np.float32)}
            for a, b in zip(sizes[:-1], sizes[1:])]


def jparams(p):
    return [{k: jnp.asarray(v) for k, v in layer.items()} for layer in p]


@pytest.mark.parametrize("method", sorted(tode.STEP_FNS))
@pytest.mark.parametrize("sub", [1, 3])
def test_odeint_steppers_match_jax(method, sub):
    sizes = (2, 16, 16, 1)
    p = np_params(0, sizes)
    jf = jnode.MLPVectorField(sizes=sizes, drive=lambda s: jnp.sin(3.0 * s))
    tf = tnode.MLPVectorField(sizes=sizes, drive=lambda s: torch.sin(3.0 * s))
    ts = np.linspace(0.0, 1.0, 26).astype(np.float32)
    y0 = np.array([0.3], np.float32)
    want = np.asarray(jode.odeint(jf, jnp.asarray(y0), jnp.asarray(ts),
                                  jparams(p), method=method,
                                  steps_per_interval=sub))
    got = tode.odeint(tf, torch.from_numpy(y0), torch.from_numpy(ts),
                      params_from_numpy(p, "cpu"), method=method,
                      steps_per_interval=sub)
    assert tuple(got.shape) == want.shape == (26, 1)
    assert rel(got.numpy(), want) <= TOL


def test_odeint_unknown_method_raises():
    with pytest.raises(ValueError, match="unknown method"):
        tode.odeint(lambda t, y: y, torch.zeros(2), torch.arange(3.0),
                    method="dopri5")


def test_mlp_apply_matches_jax_and_init_is_he():
    sizes = (6, 64, 64, 6)
    p = np_params(1, sizes)
    x = np.random.default_rng(2).standard_normal((5, 6)).astype(np.float32)
    want = np.asarray(jnode.mlp_apply(jparams(p), jnp.asarray(x)))
    got = tnode.mlp_apply(params_from_numpy(p, "cpu"), torch.from_numpy(x))
    assert rel(got.numpy(), want) <= TOL
    init = tnode.mlp_init(torch.Generator().manual_seed(0), (512, 256, 4),
                          device="cpu")
    assert [tuple(q["w"].shape) for q in init] == [(512, 256), (256, 4)]
    assert all(float(q["b"].abs().max()) == 0.0 for q in init)
    assert abs(float(init[0]["w"].std()) - np.sqrt(2 / 512)) < 0.005
    again = tnode.mlp_init(torch.Generator().manual_seed(0), (512, 256, 4),
                           device="cpu")
    assert torch.equal(init[0]["w"], again[0]["w"])


def test_params_numpy_round_trip():
    p = np_params(3, (2, 14, 14, 1))
    tp = params_from_numpy(jparams(p), "cpu")      # JAX arrays go in too
    back = params_to_numpy(tp)
    for a, b in zip(p, back):
        for k in ("w", "b"):
            assert b[k].dtype == a[k].dtype
            np.testing.assert_array_equal(b[k], a[k])
    tp[0]["w"][0, 0] = 99.0                        # a copy, not a view
    assert p[0]["w"][0, 0] != 99.0


def test_backend_registry():
    assert set(BACKENDS) == {"digital", "fused_cuda", "analogue",
                             "analogue_fused_cuda"}
    assert resolve_backend(None).name == "digital"
    assert resolve_backend("fused_cuda").name == "fused_cuda"
    be = FusedCudaBackend(batch_tile=8)
    assert resolve_backend(be) is be
    with pytest.raises(ValueError, match="unknown backend"):
        resolve_backend("fused_pallas")


def test_driven_twin_fused_and_digital_match_jax():
    sizes = (2, 14, 14, 1)
    p = np_params(4, sizes)
    jt = jtwin.make_driven_twin(1, drive=lambda s: jnp.sin(5.0 * s))
    tt = ttwin.make_driven_twin(1, drive=lambda s: torch.sin(5.0 * s))
    ts = np.linspace(0.0, 0.5, 51).astype(np.float32)
    y0 = np.array([0.2], np.float32)
    tp = params_from_numpy(p, "cpu")
    want_d = np.asarray(jt.simulate(jparams(p), jnp.asarray(y0),
                                    jnp.asarray(ts)))
    want_f = np.asarray(jt.with_backend(FusedPallasBackend(precision="f32"))
                        .simulate(jparams(p), jnp.asarray(y0),
                                  jnp.asarray(ts)))
    got_d = tt.simulate(tp, torch.from_numpy(y0), torch.from_numpy(ts))
    got_f = tt.with_backend("fused_cuda").simulate(
        tp, torch.from_numpy(y0), torch.from_numpy(ts))
    assert tuple(got_f.shape) == want_f.shape == (51, 1)
    assert rel(got_d.numpy(), want_d) <= TOL
    assert rel(got_f.numpy(), want_f) <= TOL
    assert rel(got_f.numpy(), got_d.numpy()) <= TOL


def test_fleet_per_twin_drives_match_jax():
    sizes = (2, 14, 14, 1)
    p = np_params(5, sizes)
    rng = np.random.default_rng(6)
    y0s = (0.3 * rng.standard_normal((7, 1))).astype(np.float32)
    thetas = rng.uniform(0.5, 3.0, (7, 2)).astype(np.float32)
    ts = np.linspace(0.0, 0.4, 41).astype(np.float32)
    jfleet = jtwin.TwinFleet(jtwin.make_driven_twin(1, drive=None),
                             drive_family=lambda s, th: th[0] * jnp.sin(th[1] * s))
    tfleet = ttwin.TwinFleet(ttwin.make_driven_twin(1, drive=None),
                             drive_family=lambda s, th: th[0] * torch.sin(th[1] * s))
    tp = params_from_numpy(p, "cpu")
    args = (torch.from_numpy(y0s), torch.from_numpy(ts),
            torch.from_numpy(thetas))
    jargs = (jnp.asarray(y0s), jnp.asarray(ts), jnp.asarray(thetas))
    want_d = np.asarray(jfleet.simulate(jparams(p), *jargs))
    want_f = np.asarray(jfleet.with_backend(
        FusedPallasBackend(batch_tile=4, precision="f32")).simulate(
            jparams(p), *jargs))
    got_d = tfleet.simulate(tp, *args)
    got_f = tfleet.with_backend(FusedCudaBackend(batch_tile=4)).simulate(
        tp, *args)
    assert tuple(got_f.shape) == want_f.shape == (7, 41, 1)
    assert rel(got_d.numpy(), want_d) <= TOL
    assert rel(got_f.numpy(), want_f) <= TOL
    # batched == stacked single-twin solves
    for i in (0, 6):
        single = ttwin.TwinFleet(tfleet.twin, tfleet.drive_family).simulate(
            tp, args[0][i:i + 1], args[1], args[2][i:i + 1])
        assert rel(single[0].numpy(), got_d[i].numpy()) <= TOL
    with pytest.raises(ValueError, match="given together"):
        tfleet.simulate(tp, args[0], args[1])


def test_fused_backend_steps_per_interval_and_grid_checks():
    sizes = (4, 16, 16, 4)
    tp = params_from_numpy(np_params(7, sizes), "cpu")
    twin = ttwin.make_autonomous_twin(4, hidden=16)
    y0s = torch.from_numpy(
        (0.4 * np.random.default_rng(8).standard_normal((5, 4)))
        .astype(np.float32))
    ts = torch.linspace(0.0, 0.2, 11)
    fine = twin.with_backend("fused_cuda").simulate_batch(
        tp, y0s, torch.linspace(0.0, 0.2, 41))
    node = twin.node.__class__(field=twin.field, steps_per_interval=4,
                               backend=FusedCudaBackend())
    coarse = node.trajectory_batch(tp, y0s, ts)
    assert tuple(coarse.shape) == (5, 11, 4)
    assert rel(coarse.numpy(), fine[:, ::4].numpy()) <= TOL
    be = FusedCudaBackend()
    state = be.program(twin.field, tp)
    with pytest.raises(ValueError, match="uniform time grid"):
        be.rollout_batch(state, y0s, torch.tensor([0.0, 0.1, 0.3]))
    with pytest.raises(ValueError, match="RK4 only"):
        be.rollout_batch(state, y0s, ts, method="euler")


@pytest.mark.parametrize("ts, want", [
    (np.arange(500, dtype=np.float32) * np.float32(1e-3), 1e-3),
    (np.linspace(3.0, 4.0, 11, dtype=np.float32), 0.1),
    # shooting segments: one step, each row from its own start
    (np.arange(51) * 0.0025 + np.arange(9)[:, None] * 0.125, 0.0025),
    (np.array([0.0, 0.1, 0.3]), None),
    (np.stack([np.linspace(0, 1, 5), np.linspace(0, 2, 5)]), None),
    (np.array([0.5]), None),
    (np.zeros(4), None),
])
def test_uniform_dt_accepts_only_uniform_grids(ts, want):
    from repro_torch.core.backends import uniform_dt
    if want is None:
        with pytest.raises(ValueError, match="who needs a uniform time grid"):
            uniform_dt(torch.as_tensor(ts), "who")
    else:
        assert uniform_dt(torch.as_tensor(ts), "who") == pytest.approx(
            want, rel=1e-6)


def test_gradients_raise_until_ported_and_direct_backprops():
    sizes = (4, 8, 4)
    twin = ttwin.make_autonomous_twin(4, hidden=8, n_hidden_layers=1)
    tp = params_from_numpy(np_params(9, sizes), "cpu")
    for layer in tp:
        layer["w"].requires_grad_()
    y0s = torch.full((3, 4), 0.1)
    ts = torch.linspace(0.0, 0.1, 6)
    direct = ttwin.make_autonomous_twin(4, hidden=8, n_hidden_layers=1,
                                        gradient="direct")
    direct.simulate_batch(tp, y0s, ts).sum().backward()
    want = tp[0]["w"].grad.clone()
    assert want.abs().sum() > 0
    # the fused VJP (K2's plain version here) and the digital continuous
    # adjoint (the twin's default gradient) now give the gradient too
    for t in (twin.with_backend("fused_cuda"), twin):
        tp[0]["w"].grad = None
        t.simulate_batch(tp, y0s, ts).sum().backward()
        assert rel(tp[0]["w"].grad.numpy(), want.numpy()) <= 1e-4
    with torch.no_grad():
        twin.with_backend("fused_cuda").simulate_batch(tp, y0s, ts)
        twin.simulate_batch(tp, y0s, ts)
    # dopri5 on the digital backend: JAX's solve, and a backward that
    # raises (JAX's while_loop has no reverse mode either)
    out = DigitalBackend().rollout(DigitalBackend().program(twin.field, tp),
                                   y0s, ts, method="dopri5")
    jt = jtwin.make_autonomous_twin(4, hidden=8, n_hidden_layers=1,
                                    method="dopri5")
    want = np.asarray(jt.simulate_batch(jparams(np_params(9, sizes)),
                                        jnp.asarray(y0s.numpy()),
                                        jnp.asarray(ts.numpy())))
    assert rel(out.detach().transpose(0, 1).numpy(), want) <= TOL
    with pytest.raises(NotImplementedError, match="dopri5"):
        out.sum().backward()
