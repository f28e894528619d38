"""The port's energy model and scorecard (``repro_torch.core.energy``,
``repro_torch.core.scorecard``) against the JAX package, and K1's and K4's
plain versions at the scorecard's 6->512->512->6 width.

The energy model is the same pure Python in both packages, so its
projections, gains tables and calibrated constants are held bitwise
(``==``).  The scorecard's anchor rows and its projections without
measurement are JAX's row for row (backend names mapped); with
measurement the port counts what a rollout executes (FlopCounterMode for
the plain operations, the kernels' reported work for K1 / K4) instead of
parsing HLO, so the small-plumbing checks are those of
``tests/test_energy_scorecard.py``.  At the scorecard width the wrappers
launch the wide cluster kernels K1w / K4w on the card; on the CPU they run
the plain versions, held here against JAX's kernels in interpret mode
within 1e-5 of the trajectory's peak, on the weights of JAX's scorecard
twin (``PRNGKey(0)``) carried over by ``repro_torch.interop``.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import test_calibration  # noqa: E402
from repro.core import energy as jenergy  # noqa: E402
from repro.core import scorecard as jsc  # noqa: E402
from repro.core.faults import FAULT_SALT_BASE  # noqa: E402
from repro.kernels import fused_analogue as jk4  # noqa: E402
from repro.kernels import fused_ode_mlp as jk1  # noqa: E402
from repro_torch.core import energy as tenergy  # noqa: E402
from repro_torch.core import scorecard as tsc  # noqa: E402
from repro_torch.core.analogue import (AnalogueSpec, program_mlp,  # noqa: E402
                                       stage_uint8)
from repro_torch.interop import params_from_numpy  # noqa: E402
from repro_torch.kernels import fused_analogue as tk4  # noqa: E402
from repro_torch.kernels import fused_ode_mlp as tk1  # noqa: E402
from repro_torch.kernels import work  # noqa: E402

TOL = 1e-5      # of the trajectory's peak |y|
L96_WIDE = (6, 512, 512, 6)
#: The port's backend names and JAX's.
JAX_NAME = {"digital": "digital", "fused_cuda": "fused_pallas",
            "analogue": "analogue", "analogue_fused_cuda": "analogue_fused"}


def rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


# ---------------------------------------------------------------------------
# energy: bitwise JAX's
# ---------------------------------------------------------------------------

#: (in_dim, out_dim, n_layers, n_steps) of the HP and Lorenz96 twins.
TWINS = [(2, 1, 3, 500), (6, 6, 3, 1800)]


@pytest.mark.parametrize("hidden", [64, 512])
@pytest.mark.parametrize("system", jenergy.SYSTEMS)
def test_project_and_project_from_macs_are_jaxs(system, hidden):
    for in_dim, out_dim, n_layers, n_steps in TWINS:
        kw = dict(in_dim=in_dim, out_dim=out_dim, n_layers=n_layers,
                  n_steps=n_steps)
        assert (tenergy.project(system, hidden, **kw)
                == jenergy.project(system, hidden, **kw))
        macs = 4.0 * n_steps * (in_dim * hidden + hidden * hidden
                                + hidden * out_dim)
        if system == "analogue_node":
            for mod in (tenergy, jenergy):
                with pytest.raises(ValueError, match="digital"):
                    mod.project_from_macs(system, macs, hidden, n_steps)
        else:
            assert (tenergy.project_from_macs(system, macs, hidden, n_steps)
                    == jenergy.project_from_macs(system, macs, hidden,
                                                 n_steps))
    with pytest.raises(ValueError, match="unknown system"):
        tenergy.project("tpu", hidden)


def test_tables_constants_and_anchors_are_jaxs():
    assert tenergy.gains_table([8, 64, 512]) == jenergy.gains_table(
        [8, 64, 512])
    assert tenergy.hp_projection() == jenergy.hp_projection()
    assert tenergy.lorenz96_projection() == jenergy.lorenz96_projection()
    assert tenergy.PAPER_ANCHORS == jenergy.PAPER_ANCHORS
    assert tenergy.SYSTEMS == jenergy.SYSTEMS
    assert (dataclasses.asdict(tenergy.DEFAULT_CONSTANTS)
            == dataclasses.asdict(jenergy.DEFAULT_CONSTANTS))
    for name in ("T_MAC_US", "T_EVAL_US", "T_SOLVER_US", "E_MAC_A_PJ",
                 "E_MAC_B_PJ", "E_MAC_FLOOR_PJ", "T_SETTLE_US", "P_BASE_W",
                 "P_INT_W", "V_READ", "G_MEAN_S"):
        assert getattr(tenergy, name) == getattr(jenergy, name), name
    with pytest.raises(ValueError, match="v_read"):
        tenergy.EnergyConstants(v_read=0.0)


@pytest.mark.parametrize("which", ["measured", "paper_device"])
def test_constants_from_calibration_are_jaxs(tmp_path, which):
    if which == "measured":
        path = tmp_path / "device.json"
        path.write_text(__import__("json").dumps(test_calibration.GOOD))
    else:
        path = "calibration/paper_device.json"
    got = tenergy.constants_from_calibration(str(path))
    want = jenergy.constants_from_calibration(str(path))
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    for system in ("analogue_node", "node_gpu"):
        assert (tenergy.project(system, 64, constants=got)
                == jenergy.project(system, 64, constants=want))


# ---------------------------------------------------------------------------
# scorecard
# ---------------------------------------------------------------------------

def test_anchor_rows_are_jaxs_row_for_row():
    rows = tsc.assert_anchors()
    assert rows == jsc.anchor_rows()
    assert {(r["workload"], r["name"]) for r in rows} == {
        ("hp", "speedup_vs_node_gpu"), ("hp", "energy_gain_vs_node_gpu"),
        ("lorenz96", "speed_gain_vs_node_gpu"),
        ("lorenz96", "energy_gain_vs_node_gpu")}
    assert all(r["within_tol"] and r["rel_err"] <= tsc.ANCHOR_TOL
               for r in rows)
    assert tsc.ANCHOR_TOL == jsc.ANCHOR_TOL


def test_assert_anchors_raises_on_drift():
    rows = tsc.anchor_rows()
    rows[0] = dict(rows[0], within_tol=False, rel_err=0.5)
    with pytest.raises(AssertionError, match="out of tolerance"):
        tsc.assert_anchors(rows)


def test_workload_definitions_match_paper():
    assert tsc.HP.mlp_sizes() == (2, 64, 64, 1)
    assert tsc.HP.n_steps == 500
    assert tsc.LORENZ96.mlp_sizes() == (6, 512, 512, 6)
    assert tsc.LORENZ96.n_steps == 1800
    for tw, jw in zip(tsc.WORKLOADS, jsc.WORKLOADS):
        assert dataclasses.asdict(tw) == dataclasses.asdict(jw)
        assert tw.macs_per_trajectory() == jw.macs_per_trajectory()
    assert {JAX_NAME[k]: v for k, v in tsc.BACKEND_SUBSTRATE.items()} == \
        jsc.BACKEND_SUBSTRATE


def test_scorecard_without_measurement_is_jaxs():
    got = tsc.scorecard(measure=False)
    want = jsc.scorecard(measure=False)
    assert got["anchors"] == want["anchors"]
    assert len(got["backends"]) == 2 * len(tsc.BACKEND_SUBSTRATE)
    for g, w in zip(got["backends"], want["backends"]):
        assert "counted" not in g and "hlo" not in w
        assert dict(g, backend=JAX_NAME[g["backend"]]) == w


def test_backend_rows_small_plumbing():
    """Count every substrate's rollout at plumbing size on the CPU: the
    digital row's counted MACs equal the analytic count exactly, the
    simulator's show the differential pair's ~2x, the fused row counts
    exactly 4 T MACs per evaluation (K1's reported work; its plain version
    runs uncounted), and the two analogue substrates project identically
    from array physics."""
    rows = tsc.backend_rows(workloads=[tsc.HP], hidden=16, n_steps=10,
                            device="cpu")
    by_name = {r["backend"]: r for r in rows}
    assert set(by_name) == set(tsc.BACKEND_SUBSTRATE)
    w = dataclasses.replace(tsc.HP, hidden=16, n_steps=10)
    dig = by_name["digital"]
    assert dig["counted"]["macs"] == dig["model_macs"] == \
        w.macs_per_trajectory()
    assert dig["counted"]["traffic_bytes"] is None
    ana = by_name["analogue"]
    assert ana["counted"]["macs"] > 1.5 * ana["model_macs"]
    fused = by_name["fused_cuda"]["counted"]
    assert fused["macs"] == 4 * w.n_steps * w.macs_per_eval()
    assert fused["kernels"] == {"K1": 1}
    assert fused["traffic_bytes"] > 0
    assert by_name["analogue_fused_cuda"]["counted"]["kernels"] == {"K4": 1}
    for r in rows:
        assert r["projected"]["time_us"] > 0
        assert r["projected"]["energy_uj"] > 0
        assert r["substrate"] == tsc.BACKEND_SUBSTRATE[r["backend"]]
    assert (by_name["analogue"]["projected"]
            == by_name["analogue_fused_cuda"]["projected"])
    assert (by_name["digital"]["projected"]
            == by_name["fused_cuda"]["projected"])


def test_measurement_runs_on_the_card_unless_asked():
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tsc.measure_backend("digital", tsc.HP, hidden=4, n_steps=2)


def test_kernel_work_is_reported_and_plain_versions_uncounted():
    """Under a WorkCounter a CPU rollout counts the kernel's report once
    and none of its plain version's products; outside one nothing is
    counted."""
    sizes = (6, 16, 16, 6)
    ws = [torch.randn(a, b) for a, b in zip(sizes[:-1], sizes[1:])]
    bs = [torch.zeros(b) for b in sizes[1:]]
    y0, u = torch.zeros(3, 6), torch.zeros(9, 0)
    with work.WorkCounter() as wc:
        tk1.fused_node_rollout(y0, u, ws, bs, 0.01)
    macs = 6 * 16 + 16 * 16 + 16 * 6
    assert wc.aten_flops == 0.0
    assert wc.flops == 2 * macs * 4 * 4 * 3
    assert wc.kernels["K1"].calls == 1
    work.report("K1", 1.0, 1.0)          # no counter active: a no-op


# ---------------------------------------------------------------------------
# K1 and K4's plain versions at the scorecard width
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def l96_wide():
    """JAX's scorecard Lorenz96 twin (PRNGKey(0)), its params as the port's
    CPU tensors, and a seeded y0 of two twins."""
    _, jparams, _, _ = jsc._build_twin(jsc.LORENZ96)
    tparams = params_from_numpy(jparams, "cpu")
    y0 = (0.5 * np.random.default_rng(0).standard_normal((2, 6))).astype(
        np.float32)
    return jparams, tparams, y0


def test_plain_k1_at_the_scorecard_width_matches_jax(l96_wide):
    jparams, tparams, y0 = l96_wide
    T, dt = 3, 1.0 / 1800
    u = np.zeros((2 * T + 1, 0), np.float32)
    assert tk1.launch_geometry(2, L96_WIDE).cluster == tk1.WIDE_CLUSTER
    want = jk1.fused_node_rollout(
        jnp.asarray(y0), jnp.asarray(u), [p["w"] for p in jparams],
        [p["b"] for p in jparams], dt, batch_tile=2, interpret=True)
    got = tk1.fused_node_rollout(
        torch.from_numpy(y0), torch.from_numpy(u),
        [p["w"] for p in tparams], [p["b"] for p in tparams], dt,
        batch_tile=2)
    assert got.shape == (T + 1, 2, 6)
    assert rel(got.numpy(), want) <= TOL


G_MIN, G_MAX = 20e-6, 100e-6
WIDE_FAULT = {"stuck_rate": 0.01, "stuck_on_frac": 0.5, "fault_seed": 3,
              "salt_base": FAULT_SALT_BASE, "drift_nu": 0.02,
              "drift_tau": 100.0, "drift_n0": 40}
WIDE_K4_CASES = {
    # name: (storage, kernel kwargs)
    "float_clean": ("float", {}),
    "uint8_noisy_faulty": ("uint8", dict(read_noise=0.02, noise_seed=7,
                                         fault=WIDE_FAULT)),
    "uint8_clean": ("uint8", {}),
}


@pytest.mark.parametrize("case", sorted(WIDE_K4_CASES))
def test_plain_k4_at_the_scorecard_width_matches_jax(l96_wide, case):
    """The scorecard twin programmed by the port (seeded generator; uint8
    with programming noise off), the same arrays handed to JAX's kernel
    in interpret mode and to the port's wrapper (K4w's launch; on the CPU
    its plain version): read noise 0.02 with 1% stuck cells and drift,
    whose counter stream is bitwise, within 1e-5 as the clean reads."""
    _, tparams, y0 = l96_wide
    storage, kw = WIDE_K4_CASES[case]
    spec = AnalogueSpec(prog_noise=0.0 if storage == "uint8" else 0.0436)
    progs = program_mlp(torch.Generator().manual_seed(0), tparams, spec)
    if storage == "uint8":
        progs = [stage_uint8(p, spec) for p in progs]
    ka, kb = ("gp_idx", "gm_idx") if storage == "uint8" else ("gp", "gm")
    gps = [p[ka] for p in progs]
    gms = [p[kb] for p in progs]
    scales = torch.stack([p["scale"] for p in progs])
    g_step = spec.g_step if storage == "uint8" else None
    T, dt = 2, 1.0 / 1800
    u = np.zeros((2 * T + 1, 0), np.float32)
    common = dict(g_step=g_step, g_min=G_MIN, g_max=G_MAX, **kw)
    noisy = kw.get("read_noise", 0.0) > 0.0
    assert tk4.launch_geometry(2, L96_WIDE, noisy).cluster == \
        tk1.WIDE_CLUSTER
    want = jk4.fused_analogue_rollout(
        [jnp.asarray(g.numpy()) for g in gps],
        [jnp.asarray(g.numpy()) for g in gms], jnp.asarray(scales.numpy()),
        jnp.asarray(y0), jnp.asarray(u), dt, batch_tile=2, interpret=True,
        **common)
    got = tk4.fused_analogue_rollout(gps, gms, scales, torch.from_numpy(y0),
                                     torch.from_numpy(u), dt, batch_tile=2,
                                     **common)
    assert got.shape == (T + 1, 2, 6)
    assert rel(got.numpy(), want) <= TOL
