"""The port's crossbar simulator and fault model against JAX, on the CPU.

``repro_torch.core.analogue`` and ``repro_torch.core.faults`` are held
against ``repro.core.analogue`` / ``repro.core.faults`` on the same
numpy-made weights: the deterministic parts of programming (pair
mapping, quantisation, noise-free programming, uint8 staging,
write-verify against stuck cells without noise or write failures) to
the bit or within 1 ulp where XLA reassociates; fault application
including uint8 and the drift snapshot; and the crossbar forward pass
and ``AnalogueBackend`` rollouts with the noise off, within 1e-5 of the
peak.  Programming and read noise come from ``torch.Generator``s in the
port (``jax.random`` in JAX): equal in distribution, checked here by
their statistics only.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import analogue as jan  # noqa: E402
from repro.core import faults as jfaults  # noqa: E402
from repro.core.backends import AnalogueBackend as JAnalogueBackend  # noqa: E402
from repro.core.twin import TwinFleet as JTwinFleet  # noqa: E402
from repro.core.twin import make_autonomous_twin as jmake_autonomous  # noqa: E402
from repro_torch.core import analogue as tan  # noqa: E402
from repro_torch.core import faults as tfaults  # noqa: E402
from repro_torch.core.backends import AnalogueBackend  # noqa: E402
from repro_torch.core.twin import TwinFleet, make_autonomous_twin  # noqa: E402
from repro_torch.interop import (params_from_numpy, progs_from_numpy,  # noqa: E402
                                 progs_to_numpy)

KEY = jax.random.PRNGKey(0)
TOL = 1e-5


def t(x):
    return torch.from_numpy(np.array(x, copy=True))


def ulps(a, b):
    """Largest distance in float32 ulps (of |b|) between a and b."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    ulp = np.spacing(np.abs(b).astype(np.float32)).astype(np.float64)
    return float(np.max(np.abs(a - b) / ulp))


def rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


def np_weights(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def np_params(seed, sizes):
    rng = np.random.default_rng(seed)
    return [{"w": (rng.standard_normal((a, b)) * np.sqrt(2.0 / a))
             .astype(np.float32),
             "b": (0.1 * rng.standard_normal(b)).astype(np.float32)}
            for a, b in zip(sizes[:-1], sizes[1:])]


SPECS = {
    "paper": dict(),
    "worn": dict(g_min=40e-6, g_max=41e-6, levels=16),
    "unquantised": dict(quantize=False),
}


@pytest.mark.parametrize("spec_kw", sorted(SPECS))
def test_pair_quantise_program_and_stage_match_jax(spec_kw):
    w = np_weights(0, (15, 14))
    w[3, 4] = 0.0
    jspec = jan.AnalogueSpec(prog_noise=0.0, **SPECS[spec_kw])
    tspec = tan.AnalogueSpec(prog_noise=0.0, **SPECS[spec_kw])
    jgp, jgm, js = jan.conductance_pair(jnp.asarray(w), jspec)
    tgp, tgm, ts = tan.conductance_pair(t(w), tspec)
    assert ulps(ts, js) <= 1
    assert ulps(tgp, jgp) <= 1 and ulps(tgm, jgm) <= 1
    assert ulps(tan.quantize_conductance(tgp, tspec),
                jan.quantize_conductance(jgp, jspec)) <= 1
    jprog = jan.program_tensor(KEY, jnp.asarray(w), jspec)
    tprog = tan.program_tensor(None, t(w), tspec)
    for k in ("gp", "gm", "scale"):
        assert ulps(tprog[k], jprog[k]) <= 1, k
    np.testing.assert_allclose(tan.programming_error(tprog, t(w), tspec),
                               jan.programming_error(jprog, jnp.asarray(w),
                                                     jspec), atol=1e-6)
    if tspec.quantize:
        jst = jan.stage_uint8(jprog, jspec)
        tst = tan.stage_uint8(tprog, tspec)
        for k in ("gp_idx", "gm_idx"):
            assert tst[k].dtype == torch.uint8
            np.testing.assert_array_equal(tst[k].numpy(), np.asarray(jst[k]))


def test_programming_noise_is_seeded_and_has_the_papers_sigma():
    w = np_weights(1, (64, 64))
    spec = tan.AnalogueSpec()
    a = tan.program_tensor(torch.Generator().manual_seed(3), t(w), spec)
    b = tan.program_tensor(torch.Generator().manual_seed(3), t(w), spec)
    c = tan.program_tensor(torch.Generator().manual_seed(4), t(w), spec)
    assert torch.equal(a["gp"], b["gp"]) and not torch.equal(a["gp"], c["gp"])
    clean = tan.program_tensor(None, t(w), dataclasses.replace(
        spec, prog_noise=0.0))
    rel_dev = (a["gp"] / clean["gp"] - 1.0).std()
    assert abs(float(rel_dev) - 0.0436) < 0.004


@pytest.mark.parametrize("bad,match", [
    (np.array([[1, 2], [3, 4]]), "non-floating"),
    (np.array([[np.nan, 1.0], [0.0, 2.0]], np.float32), "NaN"),
])
def test_programming_validation_names_the_input(bad, match):
    with pytest.raises(ValueError, match=match) as e:
        tan.program_tensor(None, t(bad), tan.AnalogueSpec(), name="w_bad")
    assert "w_bad" in str(e.value)


@pytest.mark.parametrize("kw", [dict(g_max=1e-5), dict(levels=1),
                                dict(read_noise=-0.1)])
def test_spec_validation(kw):
    with pytest.raises(ValueError):
        tan.AnalogueSpec(**kw)


@pytest.mark.parametrize("rate,on_frac", [(0.05, 0.5), (0.5, 1.0)])
def test_program_with_verify_matches_jax_without_noise(rate, on_frac):
    """prog_noise=0 and stuck cells only: write-verify is deterministic in
    both packages, so the conductances and the repair reports match."""
    w = np_weights(3, (32, 32))
    jspec, tspec = jan.AnalogueSpec(prog_noise=0.0), \
        tan.AnalogueSpec(prog_noise=0.0)
    jfm = jfaults.make_fault_model(("stuck", dict(rate=rate,
                                                  on_frac=on_frac)), seed=5)
    tfm = tfaults.make_fault_model(("stuck", dict(rate=rate,
                                                  on_frac=on_frac)), seed=5)
    for vc in (dict(max_retries=0), {}):
        jp, jr = jan.program_with_verify(KEY, jnp.asarray(w), jspec,
                                         faults=jfm,
                                         verify=jan.VerifyConfig(**vc),
                                         layer=2)
        tp, tr = tan.program_with_verify(None, t(w), tspec, faults=tfm,
                                         verify=tan.VerifyConfig(**vc),
                                         layer=2)
        for k in ("gp", "gm"):
            assert ulps(tp[k], jp[k]) <= 1, k
        assert tr.attempts == jr.attempts
        assert tr.n_unrepairable == int(jr.n_unrepairable)
        np.testing.assert_array_equal(tr.unrepairable.numpy(),
                                      np.asarray(jr.unrepairable))
        np.testing.assert_allclose(
            [tr.max_error, tr.mean_error, tr.projected_rollout_error],
            [float(jr.max_error), float(jr.mean_error),
             float(jr.projected_rollout_error)], rtol=1e-5)
    assert tr.summary()["n_cells"] == 32 * 32


def test_verify_repairs_stuck_cells_and_beats_write_failures():
    w = np_weights(4, (14, 14))
    spec = tan.AnalogueSpec(prog_noise=0.0)
    fm = tfaults.make_fault_model(("stuck", dict(rate=0.05)), seed=5)
    _, naive = tan.program_with_verify(
        None, t(w), spec, faults=fm, verify=tan.VerifyConfig(max_retries=0))
    _, ver = tan.program_with_verify(None, t(w), spec, faults=fm)
    assert ver.mean_error < naive.mean_error
    assert ver.n_unrepairable < naive.n_unrepairable
    noisy = tan.AnalogueSpec()
    fm = tfaults.make_fault_model(("write_fail", dict(rate=0.4)), seed=11)
    _, naive = tan.program_with_verify(
        torch.Generator().manual_seed(0), t(w), noisy, faults=fm,
        verify=tan.VerifyConfig(max_retries=0))
    _, ver = tan.program_with_verify(torch.Generator().manual_seed(0), t(w),
                                     noisy, faults=fm)
    assert ver.max_error < naive.max_error
    assert ver.projected_rollout_error < naive.projected_rollout_error


@pytest.mark.parametrize("staged", [False, True])
def test_apply_faults_to_prog_matches_jax(staged):
    w = np_weights(6, (16, 16))
    jspec, tspec = jan.AnalogueSpec(prog_noise=0.0), \
        tan.AnalogueSpec(prog_noise=0.0)
    jprog = jan.program_tensor(KEY, jnp.asarray(w), jspec)
    if staged:
        jprog = jan.stage_uint8(jprog, jspec)
    tprog = progs_from_numpy([jprog], "cpu")[0]
    mech = [("stuck", dict(rate=0.2))] + ([] if staged else [
        ("drift", dict(nu=0.05, tau=100.0))])
    jfm = jfaults.make_fault_model(*mech, seed=4)
    tfm = tfaults.make_fault_model(*mech, seed=4)
    assert tfm.kernel_args(40) == jfm.kernel_args(40)
    jout = jfaults.apply_faults_to_prog(jprog, jfm, jspec, layer=1,
                                        n_reads=400)
    tout = tfaults.apply_faults_to_prog(tprog, tfm, tspec, layer=1,
                                        n_reads=400)
    assert sorted(tout) == sorted(jout)
    for k in jout:
        if k.endswith("_idx"):
            np.testing.assert_array_equal(tout[k].numpy(), np.asarray(jout[k]))
        else:
            assert ulps(tout[k], jout[k]) <= 1, k
    if staged:
        recon = tspec.g_min + tout["gp_idx"].float() * tspec.g_step
        np.testing.assert_allclose(recon.numpy(), tout["gp"].numpy(),
                                   rtol=0, atol=1e-9)
        with pytest.raises(ValueError, match="drift"):
            tfaults.apply_faults_to_prog(
                tprog, tfaults.make_fault_model("drift"), tspec)
    else:
        np.testing.assert_allclose(
            float(tfaults.drift_factor(tfm, 400)),
            float(jfaults.drift_factor(jfm, 400)), rtol=1e-6)


def test_apply_faults_to_mlp_matches_jax_and_per_layer():
    """The MLP's masks drawn at once are each layer's own: the result is the
    JAX package's and each layer's ``apply_faults_to_prog``, the uint8
    level indices pinned from the same masks."""
    sizes = (6, 32, 32, 6)
    jspec, tspec = jan.AnalogueSpec(prog_noise=0.0), \
        tan.AnalogueSpec(prog_noise=0.0)
    jprogs = [jan.stage_uint8(p, jspec) for p in jan.program_mlp(
        KEY, [{k: jnp.asarray(v) for k, v in layer.items()}
              for layer in np_params(8, sizes)], jspec)]
    tprogs = progs_from_numpy(jprogs, "cpu")
    jfm = jfaults.make_fault_model(("stuck", dict(rate=0.2)), seed=3)
    tfm = tfaults.make_fault_model(("stuck", dict(rate=0.2)), seed=3)
    jout = jfaults.apply_faults_to_mlp(jprogs, jfm, jspec)
    tout = tfaults.apply_faults_to_mlp(tprogs, tfm, tspec)
    for i, (jp, tp) in enumerate(zip(jout, tout)):
        one = tfaults.apply_faults_to_prog(tprogs[i], tfm, tspec, layer=i)
        for k in jp:
            if k.endswith("_idx"):
                np.testing.assert_array_equal(tp[k].numpy(),
                                              np.asarray(jp[k]))
            else:
                assert ulps(tp[k], jp[k]) <= 1, k
            assert torch.equal(tp[k], one[k])


def test_program_mlp_with_verify_is_per_layer_programming():
    """Drawing every layer's stuck masks at once leaves write-verify as it
    was layer by layer."""
    p = params_from_numpy(np_params(9, (2, 14, 14, 1)), "cpu")
    spec = tan.AnalogueSpec(prog_noise=0.0)
    fm = tfaults.make_fault_model(("stuck", dict(rate=0.1)), seed=6)
    progs, reports = tan.program_mlp_with_verify(None, p, spec, faults=fm)
    for i, layer in enumerate(p):
        w = torch.cat([layer["w"], layer["b"][None, :]])
        prog, rep = tan.program_with_verify(None, w, spec, faults=fm,
                                            layer=i)
        for k in ("gp", "gm", "scale"):
            assert torch.equal(progs[i][k], prog[k])
        assert reports[i].summary() == dict(rep.summary(), name=reports[i].name)


def test_fault_model_registry_and_validation():
    m = tfaults.make_fault_model(("stuck", dict(rate=0.02)), "drift",
                                 ("write_fail", dict(rate=0.3)), seed=7)
    assert m.stuck_rate == 0.02 and m.write_fail_rate == 0.3 and m.seed == 7
    assert float(tfaults.drift_factor(None, 10)) == 1.0
    with pytest.raises(ValueError, match="unknown fault mechanism"):
        tfaults.make_fault_model("cosmic_rays")
    with pytest.raises(ValueError, match="given twice"):
        tfaults.make_fault_model("stuck", ("stuck", dict(rate=0.1)))
    for cls, kw in [(tfaults.StuckCells, dict(rate=1.5)),
                    (tfaults.ConductanceDrift, dict(tau=0.0)),
                    (tfaults.WriteFailures, dict(rate=-1.0))]:
        with pytest.raises(ValueError):
            cls(**kw)
    with pytest.raises(ValueError):
        tan.VerifyConfig(backoff=0.0)


def jax_progs(params, spec_kw, staged=False):
    jspec = jan.AnalogueSpec(**spec_kw)
    jp = [{k: jnp.asarray(v) for k, v in layer.items()} for layer in params]
    progs = jan.program_mlp(KEY, jp, jspec)
    if staged:
        progs = [jan.stage_uint8(p, jspec) for p in progs]
    return progs, jspec, tan.AnalogueSpec(**spec_kw)


@pytest.mark.parametrize("spec_kw", [dict(), dict(v_clamp=0.5)])
def test_analogue_mlp_apply_matches_jax(spec_kw):
    """A JAX-programmed noisy array, carried over by ``progs_from_numpy``,
    read with the noise off: 1-D, 2-D and 3-D inputs."""
    params = np_params(7, (2, 14, 14, 1))
    jprogs, jspec, tspec = jax_progs(params, spec_kw)
    tprogs = progs_from_numpy(jprogs, "cpu")
    back = progs_to_numpy(tprogs)
    np.testing.assert_array_equal(back[1]["gp"], np.asarray(jprogs[1]["gp"]))
    x = np.random.default_rng(8).standard_normal((3, 5, 2)).astype(np.float32)
    for xi in (x[0, 0], x[0], x):
        want = jan.analogue_mlp_apply(jprogs, jnp.asarray(xi), jspec)
        got = tan.analogue_mlp_apply(tprogs, t(xi), tspec)
        assert got.shape == want.shape
        assert rel(got.numpy(), want) <= TOL


@pytest.mark.parametrize("storage", ["float", "uint8"])
def test_analogue_backend_rollout_matches_jax(storage):
    """L96-shaped fleet (6->16->16->6, T=20) on both packages'
    ``AnalogueBackend`` from one JAX-made program, noise-free reads."""
    params = np_params(9, (6, 16, 16, 6))
    spec_kw = dict(prog_noise=0.0)
    jprogs, jspec, tspec = jax_progs(params, spec_kw)
    tprogs = tuple(progs_from_numpy(jprogs, "cpu"))
    ts = np.linspace(0.0, 0.05, 21).astype(np.float32)
    y0s = (0.5 * np.random.default_rng(10).standard_normal((5, 6))
           ).astype(np.float32)
    jfleet = JTwinFleet(jmake_autonomous(6, hidden=16).with_backend(
        JAnalogueBackend(spec=jspec, progs=tuple(jprogs), storage=storage)))
    tfleet = TwinFleet(make_autonomous_twin(6, hidden=16).with_backend(
        AnalogueBackend(spec=tspec, progs=tprogs, storage=storage)))
    want = jfleet.rollout_batch(None, jnp.asarray(y0s), jnp.asarray(ts))
    got = tfleet.rollout_batch(None, t(y0s), t(ts))
    assert got.shape == (5, 21, 6)
    assert rel(got.numpy(), want) <= TOL
    single = tfleet.twin.simulate(None, t(y0s[2]), t(ts))
    assert rel(single.numpy(), np.asarray(want)[2]) <= TOL


def test_analogue_backend_programs_like_program_mlp_and_reports():
    params = params_from_numpy(np_params(11, (2, 14, 14, 1)), "cpu")
    twin_field = None
    be = AnalogueBackend(prog_seed=3)
    st = be.program(twin_field, params)
    want = tan.program_mlp(torch.Generator().manual_seed(3), params,
                           tan.AnalogueSpec())
    assert all(torch.equal(a["gp"], b["gp"])
               for a, b in zip(st.field.progs, want))
    assert st.params is None and st.extra is None
    fm = tfaults.make_fault_model(("stuck", dict(rate=0.02)), seed=1)
    st = AnalogueBackend(faults=fm, verify=tan.VerifyConfig()).program(
        None, params)
    reps = st.extra["repair_reports"]
    assert len(reps) == 3 and all(r.attempts >= 1 for r in reps)
    with pytest.raises(ValueError, match="storage"):
        AnalogueBackend(storage="int4").program(None, params)
    with pytest.raises(ValueError, match="drift"):
        AnalogueBackend(spec=tan.AnalogueSpec(prog_noise=0.0),
                        storage="uint8",
                        faults=tfaults.make_fault_model("drift")).program(
            None, params)
    with pytest.raises(ValueError, match="params"):
        AnalogueBackend().program(None, None)
