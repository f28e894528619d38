"""The port's twin mesh against the JAX package, on the CPU.

``launch/mesh.py`` (construction and its refusals: no CPU fallback),
``shard_rollout_batch`` on 1-4 shards that all sit on the CPU (the port's
counterpart of XLA's forced host device count), with even and uneven
fleets, autonomous and driven, on ``digital``, ``fused_cuda`` (K1's plain
version), ``analogue_fused_cuda`` (K4's plain version, read noise, stuck
cells and drift, programmed once) and at ``precision="bf16_f32acc"``;
``FleetServer(mesh=)`` / ``serve_fleet(mesh=)`` with and without an SLO;
the CLI; the elastic reshard of ``checkpoint.restore(shardings=)``; the LM
sharding rules leaf for leaf; ``set_batch_axes`` and ``input_specs``.

The JAX package runs on a one-device mesh with Auto axes (its default
``make_twin_mesh`` builds Explicit axes on this JAX, which its serving
path rejects): its contract is that sharding changes only placement, so
the port's sharded results are held against JAX's unsharded ones, within
1e-5 of the peak (bitwise under bf16_f32acc, where the port's plain
rollout is bitwise the JAX package's interpret-mode kernel).  Within the
port, every shard count is within 1e-5 of the unsharded rollout (bitwise
where the CPU's matmul blocking does not change with the batch; each case
prints which).  The LM
rules are JAX's ``param_shardings`` / ``cache_shardings`` /
``batch_shardings`` / ``opt_state_shardings`` on an ``AbstractMesh`` of
the production shapes, compared spec for spec.
"""
import dataclasses
import functools
import math
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import AbstractMesh  # noqa: E402

from repro.configs import SHAPES as JSHAPES  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import get_smoke as jget_smoke  # noqa: E402
from repro.core import analogue as jan  # noqa: E402
from repro.core import faults as jfaults  # noqa: E402
from repro.core.backends import DigitalBackend as JDigital  # noqa: E402
from repro.core.backends import FusedAnalogueBackend  # noqa: E402
from repro.core.backends import FusedPallasBackend  # noqa: E402
from repro.core.twin import TwinFleet as JFleet  # noqa: E402
from repro.core.twin import make_autonomous_twin as jmake  # noqa: E402
from repro.core.twin import make_driven_twin as jdriven  # noqa: E402
from repro.data import tokens as jtokens  # noqa: E402
from repro.launch import fleet_serving as jserve  # noqa: E402
from repro.launch import sharding as jsharding  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.train import checkpoint as jckpt  # noqa: E402
from repro.train import optimizer as joptim  # noqa: E402
from repro_torch.configs import ARCH_NAMES, SHAPES, get_config  # noqa: E402
from repro_torch.configs import get_smoke, runnable_shapes  # noqa: E402
from repro_torch.core import analogue as tan  # noqa: E402
from repro_torch.core import backends as tbackends  # noqa: E402
from repro_torch.core import faults as tfaults  # noqa: E402
from repro_torch.core.backends import (DigitalBackend,  # noqa: E402
                                       FusedAnalogueCudaBackend,
                                       FusedCudaBackend)
from repro_torch.core.twin import TwinFleet  # noqa: E402
from repro_torch.core.twin import make_autonomous_twin  # noqa: E402
from repro_torch.core.twin import make_driven_twin  # noqa: E402
from repro_torch.data import tokens as ttokens  # noqa: E402
from repro_torch.interop import params_from_numpy  # noqa: E402
from repro_torch.launch import fleet_serving as tserve  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.launch import sharding as tsharding  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.train import checkpoint as tckpt  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

TOL = 1e-5
CPU = torch.device("cpu")
SHARDS = (1, 2, 3, 4)
FLEET_SIZES = (8, 7)
#: (shards, N): one fleet per shard count, even on 2 shards, uneven on 3
#: and 4 (8 and 7 twins each pad one row)
SHARD_FLEETS = ((1, 7), (2, 8), (3, 8), (4, 7))
HORIZON = 24
TIER_NAMES = {"digital": "digital", "analogue_fused": "analogue_fused_cuda",
              "analogue_fused_clean": "analogue_fused_cuda_clean",
              "fused_pallas": "fused_cuda"}


def rel(a, b) -> float:
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


def t(x):
    return torch.from_numpy(np.array(x, dtype=np.float32, copy=True))


def jax_mesh():
    return jax.sharding.Mesh(np.array(jax.devices()[:1]), ("twins",))


def cpu_mesh(n):
    return tmesh.make_twin_mesh(n, device="cpu")


# ---------------------------------------------------------------------------
# The mesh
# ---------------------------------------------------------------------------

def test_twin_mesh_on_the_cpu_and_its_rules():
    mesh = cpu_mesh(3)
    assert mesh.axis_names == ("twins",) and mesh.shape == {"twins": 3}
    assert mesh.devices == (CPU,) * 3
    assert tmesh.twin_shard_count(mesh) == 3
    assert tmesh.twin_devices(mesh) == (CPU,) * 3
    assert cpu_mesh(None).shape == {"twins": 1}
    # repeated devices: four shards on one device
    four = tmesh.Mesh(("twins",), (4,), ["cpu"] * 4)
    assert four.shape == {"twins": 4} and len(set(four.devices)) == 1
    # a twin mesh has the one axis "twins"
    other = tmesh.Mesh(("data",), (2,), ("cpu", "cpu"))
    assert tmesh.twin_shard_count(other) == 1
    with pytest.raises(ValueError, match="one axis 'twins'"):
        tmesh.twin_devices(other)
    with pytest.raises(ValueError, match="device"):
        tmesh.Mesh(("twins",), (3,), ("cpu",) * 2)
    with pytest.raises(ValueError, match="pair up"):
        tmesh.Mesh(("twins", "twins"), (1, 1))
    with pytest.raises(ValueError, match="asked for 0"):
        cpu_mesh(0)
    with pytest.raises(ValueError, match="no devices"):
        tmesh.twin_devices(tmesh.make_production_mesh())


def test_make_twin_mesh_defaults_to_cuda_and_never_falls_back(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for args in ((), (2,), (1,)):
        with pytest.raises(RuntimeError, match="is_available"):
            tmesh.make_twin_mesh(*args)
    with pytest.raises(RuntimeError, match="is_available"):
        tserve.FleetServer(TwinFleet(make_autonomous_twin(3, hidden=4)),
                           None, torch.linspace(0, 1, 3))


def test_make_twin_mesh_counts_the_visible_cards(monkeypatch):
    """Without cards here, the count is faked: the mesh names them and
    raises JAX's message when asked for more."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    mesh = tmesh.make_twin_mesh()
    assert mesh.devices == (torch.device("cuda", 0), torch.device("cuda", 1))
    assert tmesh.make_twin_mesh(1).devices == (torch.device("cuda", 0),)
    assert tmesh.make_twin_mesh(device="cuda:1").devices == (
        torch.device("cuda", 1),)
    with pytest.raises(ValueError,
                       match=r"make_twin_mesh: asked for 3 devices, have 2"):
        tmesh.make_twin_mesh(3)


@pytest.mark.parametrize("multi_pod", [False, True])
def test_production_meshes_and_axis_helpers_match_jax(multi_pod):
    mesh = tmesh.make_production_mesh(multi_pod=multi_pod)
    shape = (2, 16, 16) if multi_pod else (16, 16)
    names = ("pod", "data", "model") if multi_pod else ("data", "model")
    jm = AbstractMesh(shape, names)
    assert mesh.axis_names == jm.axis_names and mesh.devices == ()
    assert mesh.shape == dict(jm.shape)
    assert tmesh.batch_axes(mesh) == jsharding.batch_axes(jm)
    for name in ("pod", "data", "model", "twins"):
        assert tmesh.axis_size(mesh, name) == jsharding.axis_size(jm, name)
    host = tmesh.make_host_mesh(2, 4)
    assert host.shape == {"data": 2, "model": 4} and host.devices == ()


# ---------------------------------------------------------------------------
# shard_rollout_batch against the JAX package's rollout_batch
# ---------------------------------------------------------------------------

def jfam(s, th):
    return th[0] * jnp.sin(2.0 * jnp.pi * th[1] * s)


def tfam(s, th):
    return th[0] * torch.sin(2.0 * math.pi * th[1] * s)


def _faults(lib):
    return lib.make_fault_model(("stuck", dict(rate=0.01)), "drift", seed=2)


#: substrate -> (JAX backend, port backend, per-call solver kwargs).  The
#: analogue pair programs without programming noise (the packages'
#: programming generators differ) and reads with noise, stuck cells and
#: drift.
SUBSTRATES = {
    "digital": (lambda: JDigital(), lambda: DigitalBackend(), {}),
    "fused_cuda": (lambda: FusedPallasBackend(batch_tile=4, precision="f32"),
                   lambda: FusedCudaBackend(batch_tile=4), {}),
    "analogue_fused_cuda": (
        lambda: FusedAnalogueBackend(
            spec=jan.AnalogueSpec(prog_noise=0.0, read_noise=0.02),
            read_seed=5, faults=_faults(jfaults), batch_tile=4),
        lambda: FusedAnalogueCudaBackend(
            spec=tan.AnalogueSpec(prog_noise=0.0, read_noise=0.02),
            read_seed=5, faults=_faults(tfaults), batch_tile=4), {}),
    "bf16_f32acc": (lambda: FusedPallasBackend(batch_tile=4, precision="f32"),
                    lambda: FusedCudaBackend(batch_tile=4),
                    {"precision": "bf16_f32acc"}),
}
#: (substrate, driven): the analogue substrate driven (the HP twin, one
#: drive per twin), bf16 autonomous (the serving fleet's shape)
CASES = [("digital", False), ("digital", True), ("fused_cuda", False),
         ("fused_cuda", True), ("analogue_fused_cuda", True),
         ("bf16_f32acc", False)]


@functools.lru_cache(maxsize=None)
def twin_pair(driven: bool, hidden: int = 12):
    """(JAX twin, JAX params, port twin, port params, y0s, thetas, ts):
    an autonomous 6-state twin or a driven 1-state one, one drive per
    twin, JAX-made params with nonzero biases."""
    rng = np.random.default_rng(7 if driven else 8)
    if driven:
        jt = jdriven(1, drive=None, hidden=hidden)
        tt = make_driven_twin(1, drive=None, hidden=hidden)
        dim = 1
    else:
        jt = jmake(6, hidden=hidden)
        tt = make_autonomous_twin(6, hidden=hidden)
        dim = 6
    jp = [{"w": np.asarray(p["w"]),
           "b": (0.1 * rng.standard_normal(p["b"].shape)).astype(np.float32)}
          for p in jt.init(jax.random.PRNGKey(1))]
    y0s = (0.4 * rng.standard_normal((max(FLEET_SIZES), dim))
           ).astype(np.float32)
    thetas = (1.0 + rng.uniform(size=(max(FLEET_SIZES), 2))
              ).astype(np.float32) if driven else None
    ts = np.linspace(0.0, HORIZON * 0.01, HORIZON + 1).astype(np.float32)
    return jt, jp, tt, params_from_numpy(jp, "cpu"), y0s, thetas, ts


def _solver_kw(node):
    return dict(method=node.method, steps_per_interval=node.steps_per_interval,
                gradient="stopgrad")


@functools.lru_cache(maxsize=None)
def jax_rollout(substrate: str, driven: bool) -> np.ndarray:
    jt, jp, _, _, y0s, thetas, ts = twin_pair(driven)
    jbe = SUBSTRATES[substrate][0]()
    state = jbe.program(jt.node.field, [{k: jnp.asarray(v)
                                         for k, v in p.items()} for p in jp])
    kw = dict(_solver_kw(jt.node), **SUBSTRATES[substrate][2])
    out = jbe.rollout_batch(
        state, jnp.asarray(y0s), jnp.asarray(ts),
        drive_family=jfam if driven else None,
        drive_params=None if thetas is None else jnp.asarray(thetas),
        mesh=jax_mesh(), **kw)
    return np.asarray(out, np.float32)


@functools.lru_cache(maxsize=None)
def port_programmed(substrate: str, driven: bool):
    _, _, tt, tp, _, _, _ = twin_pair(driven)
    be = SUBSTRATES[substrate][1]()
    return be, be.program(tt.node.field, tp)


@functools.lru_cache(maxsize=None)
def port_unsharded(substrate: str, driven: bool, n: int) -> torch.Tensor:
    _, _, tt, _, y0s, thetas, ts = twin_pair(driven)
    be, state = port_programmed(substrate, driven)
    with torch.no_grad():
        return be.rollout_batch_local(
            state, t(y0s[:n]), t(ts), drive_family=tfam if driven else None,
            drive_params=None if thetas is None else t(thetas[:n]),
            **_solver_kw(tt.node), **SUBSTRATES[substrate][2])


@pytest.mark.parametrize("shards,n", SHARD_FLEETS)
@pytest.mark.parametrize("substrate,driven", CASES)
def test_shard_rollout_batch_matches_jax_unsharded(substrate, driven,
                                                   shards, n):
    _, _, tt, _, y0s, thetas, ts = twin_pair(driven)
    be, state = port_programmed(substrate, driven)
    kw = dict(_solver_kw(tt.node), **SUBSTRATES[substrate][2])
    with torch.no_grad():
        got = tserve.shard_rollout_batch(
            be, state, t(y0s[:n]), t(ts), mesh=cpu_mesh(shards),
            drive_family=tfam if driven else None,
            drive_params=None if thetas is None else t(thetas[:n]), **kw)
    want = jax_rollout(substrate, driven)[:n]
    assert tuple(got.shape) == want.shape == (n, HORIZON + 1,
                                              y0s.shape[1])
    if substrate == "bf16_f32acc":
        assert got.dtype == torch.bfloat16
        np.testing.assert_array_equal(got.float().numpy(), want)
    else:
        assert rel(got.numpy(), want) <= TOL
    # sharding changes only where the work runs: bitwise the one-shard run
    one = port_unsharded(substrate, driven, n)
    print(f"{substrate} driven={driven} {shards} shard(s) N={n}: bitwise "
          f"the unsharded port rollout: {torch.equal(got, one)}")
    assert rel(got.float().numpy(), one.float().numpy()) <= TOL


def test_sharded_analogue_substrate_is_programmed_once(monkeypatch):
    """``rollout_batch(mesh=)`` programs the crossbars once per call,
    whatever the shard count (the count of programmings), and every shard
    reads that programming: within 1e-6 of the unsharded run."""
    calls = []
    real = tbackends._program_arrays

    def counting(backend, params):
        calls.append(type(backend).__name__)
        return real(backend, params)

    monkeypatch.setattr(tbackends, "_program_arrays", counting)
    _, _, tt, tp, y0s, _, ts = twin_pair(False)
    fleet = TwinFleet(tt.with_backend(FusedAnalogueCudaBackend(
        spec=tan.AnalogueSpec(read_noise=0.02), prog_seed=3, read_seed=5,
        faults=_faults(tfaults), batch_tile=4)))
    with torch.no_grad():
        one = fleet.rollout_batch(tp, t(y0s), t(ts))
        for shards in SHARDS:
            got = fleet.rollout_batch(tp, t(y0s), t(ts),
                                      mesh=cpu_mesh(shards))
            assert rel(got.numpy(), one.numpy()) <= 1e-6, shards
        via_twin = tt.with_backend(fleet.backend).simulate_batch(
            tp, t(y0s), t(ts), mesh=cpu_mesh(3))
    assert rel(via_twin.numpy(), one.numpy()) <= 1e-6
    assert calls == ["FusedAnalogueCudaBackend"] * (2 + len(SHARDS))


def test_shard_rollout_batch_validates_and_keeps_placed_states():
    _, _, tt, _, y0s, _, ts = twin_pair(False)
    be, state = port_programmed("fused_cuda", False)
    bad = t(y0s)
    bad[0, 0] = float("nan")
    with pytest.raises(ValueError, match="shard_rollout_batch: y0s"):
        tserve.shard_rollout_batch(be, state, bad, t(ts), mesh=cpu_mesh(2))
    with pytest.raises(ValueError, match="strictly increasing"):
        tserve.shard_rollout_batch(be, state, t(y0s), t(ts[::-1]),
                                   mesh=cpu_mesh(2))
    placed = tsharding.replicate(state, cpu_mesh(4))
    assert len(placed) == 4 and len({id(p) for p in placed}) == 1
    # one device: the copy is the state itself, tensor for tensor
    assert placed[0].extra["weights"][0] is state.extra["weights"][0]
    with pytest.raises(ValueError, match="placed on 4 position"):
        tserve.shard_rollout_batch(be, placed, t(y0s), t(ts),
                                   mesh=cpu_mesh(2))
    with torch.no_grad():
        got = tserve.shard_rollout_batch(be, placed, t(y0s), t(ts),
                                         mesh=cpu_mesh(4),
                                         **_solver_kw(tt.node))
    assert rel(got.numpy(),
               port_unsharded("fused_cuda", False, len(y0s)).numpy()) <= TOL


# ---------------------------------------------------------------------------
# FleetServer(mesh=) and serve_fleet(mesh=) against the JAX package's
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def saved_twin(tmp_root: str, hidden: int) -> str:
    jt = jmake(6, hidden=hidden)
    rng = np.random.default_rng(hidden)
    params = [{"w": p["w"], "b": jnp.asarray(
        0.1 * rng.standard_normal(p["b"].shape), jnp.float32)}
        for p in jt.init(jax.random.PRNGKey(hidden))]
    jckpt.save_twin(tmp_root, params)
    return tmp_root


@pytest.mark.parametrize("hidden,fleet,horizon,shards", [
    (64, 16, 30, 4),      # the Lorenz96 twin's widths 6->64->64->6
    (12, 11, 20, 3),      # uneven on the mesh and on the tile
    (12, 10, 20, 1),
])
def test_serve_fleet_on_a_mesh_matches_jax(tmp_path, hidden, fleet, horizon,
                                           shards):
    ckpt = saved_twin(str(tmp_path), hidden)
    ts = np.linspace(0.0, horizon * 0.0025, horizon + 1).astype(np.float32)
    rng = np.random.default_rng(2)
    reqs = [(0.5 * rng.standard_normal((fleet, 6))).astype(np.float32)
            for _ in range(2)]
    jfleet = JFleet(jmake(6, hidden=hidden)).with_backend(
        FusedPallasBackend(batch_tile=4, precision="f32"))
    want = [np.asarray(o) for o in jserve.serve_fleet(
        ckpt, jfleet, jnp.asarray(ts), [jnp.asarray(r) for r in reqs],
        mesh=jax_mesh())]
    tfleet = TwinFleet(make_autonomous_twin(6, hidden=hidden)).with_backend(
        FusedCudaBackend(batch_tile=4))
    got = list(tserve.serve_fleet(ckpt, tfleet, t(ts), [t(r) for r in reqs],
                                  mesh=cpu_mesh(shards)))
    one = list(tserve.serve_fleet(ckpt, tfleet, t(ts), [t(r) for r in reqs],
                                  device="cpu"))
    assert len(got) == len(want) == 2
    for g, w, o in zip(got, want, one):
        assert tuple(g.shape) == w.shape == (fleet, horizon + 1, 6)
        assert g.device == CPU
        assert rel(g.numpy(), w) <= TOL
        assert rel(g.numpy(), o.numpy()) <= TOL


ANALOGUE_SPEC = dict(prog_noise=0.0, read_noise=0.02)


def analogue_server(tmp_path, shards, slo_kw):
    """The driven HP-style twin loaded from a JAX checkpoint onto the
    noisy faulty analogue substrate (K4's plain version)."""
    jt, jp, tt, _, y0s, thetas, ts = twin_pair(True)
    jckpt.save_twin(str(tmp_path), [{k: jnp.asarray(v) for k, v in p.items()}
                                    for p in jp])
    params = tckpt.load_twin(str(tmp_path), tt.init(
        torch.Generator().manual_seed(0), device="cpu"), device="cpu")
    fleet = TwinFleet(tt, drive_family=tfam).with_backend(
        SUBSTRATES["analogue_fused_cuda"][1]())
    slo = None if slo_kw is None else tserve.ServingSLO(**slo_kw)
    mesh = None if shards is None else cpu_mesh(shards)
    return (tserve.FleetServer(fleet, params, t(ts), slo=slo, mesh=mesh,
                               device=None if mesh else "cpu"), y0s, thetas)


@pytest.mark.parametrize("shards", (2, 3))
@pytest.mark.parametrize("slo", [None, dict(max_rel_error=0.3, probe_every=2,
                                            probe_horizon=11, probe_fleet=2)])
def test_fleet_server_on_a_mesh_matches_jax(tmp_path, monkeypatch, shards,
                                            slo):
    """The noisy faulty analogue primary on a mesh, with and without the
    SLO chain: every request (8, 7 and 6 twins: even and uneven) served
    by the primary within 1e-5 of the JAX package's rollout of it, the
    tier decisions of the same server without a mesh (which
    ``test_torch_fleet_slo.py`` holds to the JAX server's), and the
    programming count: each tier once at construction with an SLO, once
    per request without one, never once per shard."""
    calls = []
    real = tbackends._program_arrays
    monkeypatch.setattr(tbackends, "_program_arrays",
                        lambda b, p: calls.append(1) or real(b, p))
    tsrv, y0s, thetas = analogue_server(tmp_path / "m", shards, slo)
    ref, _, _ = analogue_server(tmp_path / "r", None, slo)
    assert tsrv.n_shards == shards and tsrv.device == CPU
    assert ref.n_shards == 1
    programmed = len(calls)
    assert programmed == (0 if slo is None else 4)   # 2 tiers x 2 servers
    want = jax_rollout("analogue_fused_cuda", True)
    for n in (8, 7, 6):
        got = tsrv.serve(t(y0s[:n]), t(thetas[:n]))
        assert tuple(got.shape) == (n, HORIZON + 1, 1)
        assert rel(got.numpy(), want[:n]) <= TOL
        assert rel(got.numpy(), ref.serve(t(y0s[:n]), t(thetas[:n]))
                   .numpy()) <= TOL
    assert len(calls) == programmed + (6 if slo is None else 0)
    assert tsrv.stats.as_dict() == ref.stats.as_dict()
    assert tsrv.stats.served_by == (
        {"primary": 3} if slo is None else {"analogue_fused_cuda": 3})
    if slo is not None:
        assert tsrv.stats.probes == 2 and tsrv.active_tier == \
            "analogue_fused_cuda"
        # the programs are placed once per distinct device: here, the CPU
        assert all(len(p) == shards and len({id(s) for s in p}) == 1
                   for p in tsrv._placed)


def test_fleet_server_mesh_and_device_must_agree():
    _, _, tt, tp, _, _, ts = twin_pair(False)
    fleet = TwinFleet(tt)
    srv = tserve.FleetServer(fleet, tp, t(ts), device="cpu",
                             mesh=cpu_mesh(2))
    assert srv.n_shards == 2 and srv.device == CPU
    assert tserve.FleetServer(fleet, tp, t(ts), device="cpu").n_shards == 1
    meta_mesh = tmesh.Mesh(("twins",), (1,), ["meta"])
    with pytest.raises(ValueError, match="first device"):
        tserve.FleetServer(fleet, tp, t(ts), device="cpu", mesh=meta_mesh)


def test_cli_serves_over_a_cpu_mesh():
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.fleet_serving",
         "--device", "cpu", "--fleet", "10", "--horizon", "12",
         "--batches", "2"],
        capture_output=True, text=True, timeout=300,
        env={**__import__("os").environ, "PYTHONPATH": "src"})
    assert res.returncode == 0, res.stdout + res.stderr
    assert ("mesh: 1 device(s) on axis 'twins'; backend fused_cuda "
            "precision f32") in res.stdout
    assert "batch 1: (10, 13, 6) trajectories" in res.stdout
    assert "served 2 x 10 twins x 12 steps" in res.stdout


def test_mesh_check_passes_on_cpu_shards(capsys):
    """The several-card check, on three CPU shards at a small size."""
    from repro_torch.launch import mesh_check
    assert mesh_check.main(["--device", "cpu", "--shards", "3", "--fleet",
                            "7", "--horizon", "6"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 4 and '"ok": true' in lines[-1]
    assert mesh_check.main(["--device", "cpu", "--shards", "1"]) == 1


# ---------------------------------------------------------------------------
# Placement and the elastic reshard
# ---------------------------------------------------------------------------

def test_device_put_places_blocks_and_replicates_once_per_device():
    x = torch.arange(48, dtype=torch.float32).reshape(6, 8)
    mesh = tmesh.Mesh(("model",), (4,), ("cpu", "meta", "cpu", "meta"))
    sh = tsharding.NamedSharding(mesh, tsharding.P(None, "model"))
    placed = tsharding.device_put({"x": x}, {"x": sh})
    assert placed.mesh is mesh and placed.shardings == {"x": sh}
    assert [p["x"].shape for p in placed] == [(6, 2)] * 4
    assert [p["x"].device for p in placed] == list(mesh.devices)
    cpu_blocks = [p["x"] for p in placed if p["x"].device == CPU]
    assert torch.equal(torch.cat(cpu_blocks, 1), x[:, [0, 1, 4, 5]])
    rep = tsharding.device_put({"x": x, "y": x[0]},
                               tsharding.replicated(mesh, {"x": x, "y": x[0]}))
    # one copy per distinct device, shared by the positions there
    assert rep[0]["x"] is rep[2]["x"] and rep[1]["x"] is rep[3]["x"]
    assert rep[1]["y"].device.type == "meta"
    cpu4 = tmesh.Mesh(("model",), (4,), ("cpu",) * 4)
    assert repr(tsharding.P(("pod", "data"), None)) == \
        "PartitionSpec(('pod', 'data'), None)"
    assert tsharding.P(("data",), (), "model") == ("data", None, "model")
    assert tsharding.fleet_batch_spec(3) == ("twins", None, None)
    with pytest.raises(ValueError, match="does not split"):
        tsharding.device_put(torch.zeros(5, 8), tsharding.NamedSharding(
            cpu4, tsharding.P("model")))
    with pytest.raises(ValueError, match="no axis 'data'"):
        tsharding.device_put(x, tsharding.NamedSharding(
            cpu4, tsharding.P("data")))
    with pytest.raises(ValueError, match="no devices"):
        tsharding.device_put(x, tsharding.NamedSharding(
            tmesh.make_host_mesh(2, 4), tsharding.P("data")))
    with pytest.raises(ValueError, match="one-axis meshes"):
        tsharding.device_put(x, tsharding.NamedSharding(
            tmesh.Mesh(("data", "model"), (2, 2), ("cpu",) * 4),
            tsharding.P("data")))
    with pytest.raises(ValueError, match="2 meshes"):
        tsharding.device_put({"a": x, "b": x}, {
            "a": tsharding.NamedSharding(cpu4, tsharding.P()),
            "b": tsharding.NamedSharding(mesh, tsharding.P())})


def test_checkpoint_elastic_reshard(tmp_path):
    """Save from a 4-shard placement, restore onto 8 shards with another
    spec: values equal, placement as asked (JAX's
    ``test_checkpoint_elastic_reshard_subprocess`` on the port)."""
    tree = {"w": torch.arange(64, dtype=torch.float32).reshape(8, 8)}
    mesh4 = tmesh.Mesh(("model",), (4,), ("cpu",) * 4)
    sh4 = {"w": tsharding.NamedSharding(mesh4, tsharding.P("model", None))}
    placed = tsharding.device_put(tree, sh4)
    assert [p["w"].shape for p in placed] == [(2, 8)] * 4
    assert torch.equal(placed[1]["w"], tree["w"][2:4])
    tckpt.save(str(tmp_path), 1, placed.gather())
    mesh8 = tmesh.Mesh(("model",), (8,), ("cpu",) * 8)
    sh8 = {"w": tsharding.NamedSharding(mesh8, tsharding.P(None, "model"))}
    out = tckpt.restore(str(tmp_path), 1, tree, shardings=sh8)
    assert out.mesh is mesh8 and out.shardings == sh8
    assert [p["w"].shape for p in out] == [(8, 1)] * 8
    for k, p in enumerate(out):
        assert torch.equal(p["w"], tree["w"][:, k:k + 1])
    assert torch.equal(out.gather()["w"], tree["w"])
    # the JAX package reads what the port saved from a placement
    np.testing.assert_array_equal(
        np.asarray(jckpt.restore(str(tmp_path), 1,
                                 {"w": jnp.zeros((8, 8))})["w"]),
        tree["w"].numpy())
    with pytest.raises(ValueError, match="not both"):
        tckpt.restore(str(tmp_path), 1, tree, shardings=sh8, device="cpu")


def test_serve_from_load_twin_onto_the_serving_mesh(tmp_path):
    """``load_twin(shardings=fleet_param_shardings(...))``: a replicated
    placement whose copies equal the JAX package's load, which
    ``FleetServer(mesh=)`` serves from, with and without an SLO, against
    the JAX package's server on the same checkpoint."""
    ckpt = saved_twin(str(tmp_path), 12)
    template = make_autonomous_twin(6, hidden=12).init(
        torch.Generator().manual_seed(0), device="cpu")
    mesh = cpu_mesh(3)
    shardings = tsharding.fleet_param_shardings(mesh, template)
    placed = tckpt.load_twin(ckpt, template, shardings=shardings)
    jp = jckpt.load_twin(ckpt, jmake(6, hidden=12).init(
        jax.random.PRNGKey(0)))
    assert len(placed) == 3 and placed.shardings == shardings
    for i, (p, w) in enumerate(zip(placed[0], jp)):
        for k in ("w", "b"):
            assert placed.shardings[i][k].spec == (None,) * p[k].dim()
            assert all(q[i][k] is p[k] for q in placed)   # one copy
            np.testing.assert_array_equal(p[k].numpy(), np.asarray(w[k]))
    ts = np.linspace(0.0, 20 * 0.0025, 21).astype(np.float32)
    y0s = (0.5 * np.random.default_rng(3).standard_normal((10, 6))
           ).astype(np.float32)
    jsrv = jserve.FleetServer(
        JFleet(jmake(6, hidden=12)).with_backend(
            FusedPallasBackend(batch_tile=4, precision="f32")),
        jp, jnp.asarray(ts), mesh=jax_mesh())
    tfleet = TwinFleet(make_autonomous_twin(6, hidden=12)).with_backend(
        FusedCudaBackend(batch_tile=4))
    servers = [tserve.FleetServer(tfleet, placed, t(ts), mesh=mesh, slo=slo)
               for slo in (None, tserve.ServingSLO(max_rel_error=0.5))]
    for srv in servers:
        assert srv.params[0]["w"] is placed[0][0]["w"]   # served in place
    for n in (10, 7):
        want = np.asarray(jsrv.serve(jnp.asarray(y0s[:n])))
        for srv in servers:
            got = srv.serve(t(y0s[:n]))
            assert tuple(got.shape) == want.shape == (n, 21, 6)
            assert rel(got.numpy(), want) <= TOL
    assert servers[1].stats.served_by == {"fused_cuda": 2}
    with pytest.raises(ValueError, match="not both"):
        tckpt.load_twin(ckpt, template, device="cpu", shardings=shardings)


def _tensor_leaves(obj) -> list:
    """Every tensor an object holds, walked as ``to_device`` walks it."""
    if isinstance(obj, torch.Tensor):
        return [obj]
    if isinstance(obj, dict):
        obj = list(obj.values())
    elif dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        obj = [getattr(obj, f.name) for f in dataclasses.fields(obj)]
    if isinstance(obj, (list, tuple)):
        return [x for v in obj for x in _tensor_leaves(v)]
    return []


PROGRAMMED = {
    "digital": lambda: DigitalBackend(),
    "fused_cuda": lambda: FusedCudaBackend(batch_tile=4),
    "analogue": lambda: tbackends.AnalogueBackend(
        spec=tan.AnalogueSpec(prog_noise=0.02, read_noise=0.02),
        prog_seed=3, read_seed=5, faults=_faults(tfaults)),
    "analogue_fused_cuda": lambda: FusedAnalogueCudaBackend(
        spec=tan.AnalogueSpec(prog_noise=0.02, read_noise=0.02),
        prog_seed=3, read_seed=5, faults=_faults(tfaults), batch_tile=4),
}


@pytest.mark.parametrize("driven", [False, True])
@pytest.mark.parametrize("substrate", sorted(PROGRAMMED) + ["slo_tiers"])
def test_replicate_moves_every_tensor_of_a_programmed_state(substrate,
                                                           driven):
    """Shards on another device than the state's: every tensor of each
    programmed substrate (staged fused operands, the analogue ``staged``
    conductances, scales, fault arguments and repair reports, the
    programmed field's ``progs``) is on that device in its copy, of the
    original's shape and dtype, and the copy on the state's own device
    holds the state's tensors themselves."""
    _, _, tt, tp, _, _, ts = twin_pair(driven)
    if substrate == "slo_tiers":
        fleet = TwinFleet(tt, drive_family=tfam if driven else None
                          ).with_backend(PROGRAMMED["analogue_fused_cuda"]())
        srv = tserve.FleetServer(fleet, tp, t(ts), device="cpu",
                                 slo=tserve.ServingSLO(max_rel_error=0.3))
        states = [state for _, state in srv._programs]
        assert len(states) == 3
    else:
        states = [PROGRAMMED[substrate]().program(tt.node.field, tp)]
    mesh = tmesh.Mesh(("twins",), (3,), ("cpu", "meta", "meta"))
    for state in states:
        placed = tsharding.replicate(state, mesh)
        assert placed[1] is placed[2]
        here, there = _tensor_leaves(state), _tensor_leaves(placed[1])
        assert len(here) == len(there) > 0
        for a, b, c in zip(here, there, _tensor_leaves(placed[0])):
            assert a.device == CPU and b.device.type == "meta" and c is a
            assert (a.shape, a.dtype) == (b.shape, b.dtype)


# ---------------------------------------------------------------------------
# LM sharding rules, leaf for leaf
# ---------------------------------------------------------------------------

def _buildable(name: str) -> bool:
    try:
        tmodel.init_cache(get_config(name), 1, 8, device="meta")
        return True
    except NotImplementedError:
        return False


LM_NAMES = [n for n in ARCH_NAMES if _buildable(n)]
MESHES = {"pod": ((16, 16), ("data", "model"), False),
          "multi_pod": ((2, 16, 16), ("pod", "data", "model"), True)}


def _meta(tree):
    """A JAX shape tree as the port's tree of meta tensors."""
    return jax.tree_util.tree_map(
        lambda x: torch.empty(x.shape, device="meta"), tree)


def _assert_same_specs(jax_tree, port_tree):
    jl, _ = jax.tree_util.tree_flatten_with_path(jax_tree)
    pl = tree_leaves(port_tree)
    assert len(jl) == len(pl) > 0
    for (path, js), ps in zip(jl, pl):
        assert tuple(ps.spec) == tuple(js.spec), jax.tree_util.keystr(path)


@functools.lru_cache(maxsize=None)
def jax_param_shapes(name: str):
    cfg = jget_config(name)
    return jax.eval_shape(lambda: jmodel.init_params(
        cfg, jax.random.PRNGKey(0)))


def test_lm_configs_the_port_builds():
    assert "jamba-v0.1-52b" in LM_NAMES and "llama3-8b" in LM_NAMES
    # MLA is ported: both DeepSeek-V2 configs build; so does xLSTM, and
    # with it every config of the registry
    assert {"deepseek-v2-lite-16b", "deepseek-v2-236b"} <= set(LM_NAMES)
    assert "xlstm-125m" in LM_NAMES
    assert LM_NAMES == list(ARCH_NAMES)


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("name", LM_NAMES)
def test_param_and_opt_state_specs_match_jax(name, mesh_name):
    shape, names, multi = MESHES[mesh_name]
    jm = AbstractMesh(shape, names)
    mesh = tmesh.make_production_mesh(multi_pod=multi)
    sds = jax_param_shapes(name)
    _assert_same_specs(jsharding.param_shardings(jm, sds),
                       tsharding.param_shardings(mesh, _meta(sds)))
    _assert_same_specs(
        jsharding.param_shardings(jm, sds, no_attn_tp=True),
        tsharding.param_shardings(mesh, _meta(sds), no_attn_tp=True))
    opt = jax.eval_shape(joptim.adamw(1e-3).init, sds)
    port_opt = type(opt)(*[_meta(x) for x in opt])
    _assert_same_specs(jsharding.opt_state_shardings(jm, opt),
                       tsharding.opt_state_shardings(mesh, port_opt))


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("name", LM_NAMES)
def test_cache_and_batch_specs_match_jax(name, mesh_name):
    """The port's own ``init_cache`` tree on the meta device at each
    runnable decode shape (and prefill batch), against JAX's
    ``cache_shardings`` on its shapes; token batches of every shape."""
    shape, names, multi = MESHES[mesh_name]
    jm = AbstractMesh(shape, names)
    mesh = tmesh.make_production_mesh(multi_pod=multi)
    cfg, jcfg = get_config(name), jget_config(name)
    for sname in runnable_shapes(cfg):
        sh = SHAPES[sname]
        jc = jax.eval_shape(lambda: jmodel.init_cache(
            jcfg, sh.global_batch, sh.seq_len))
        tc = tmodel.init_cache(cfg, sh.global_batch, sh.seq_len,
                               device="meta")
        assert [tuple(x.shape) for x in tree_leaves(tc)] == \
            [x.shape for x in jax.tree_util.tree_leaves(jc)]
        _assert_same_specs(
            jsharding.cache_shardings(jm, jc, sh.global_batch),
            tsharding.cache_shardings(mesh, tc, sh.global_batch))
        jb = jtokens.input_specs(jcfg, JSHAPES[sname])
        tb = ttokens.input_specs(cfg, sh)
        _assert_same_specs(jsharding.batch_shardings(jm, jb),
                           tsharding.batch_shardings(mesh, tb))


@pytest.mark.parametrize("name", ["jamba-v0.1-52b", "llama3-8b"])
def test_port_params_have_the_trees_the_rules_read(name):
    """The smoke config's params built by the port: the same leaves,
    shapes and specs as JAX's shape tree of it."""
    jsds = jax.eval_shape(lambda: jmodel.init_params(
        jget_smoke(name), jax.random.PRNGKey(0)))
    tp = tmodel.init_params(get_smoke(name), seed=0, device="cpu")
    assert [tuple(x.shape) for x in tree_leaves(tp)] == \
        [x.shape for x in jax.tree_util.tree_leaves(jsds)]
    jm = AbstractMesh((2, 4), ("data", "model"))
    mesh = tmesh.make_host_mesh(2, 4)
    _assert_same_specs(jsharding.param_shardings(jm, jsds, fsdp_threshold=8),
                       tsharding.param_shardings(mesh, tp, fsdp_threshold=8))


# ---------------------------------------------------------------------------
# set_batch_axes and input_specs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("axes", [("pod", "data"), ("data",), (), None])
def test_set_batch_axes_keeps_the_axes_as_jax_does(axes):
    try:
        jmodel.set_batch_axes(axes)
        tmodel.set_batch_axes(axes)
        assert tmodel._BATCH_AXES == jmodel._BATCH_AXES
    finally:
        jmodel.set_batch_axes(None)
        tmodel.set_batch_axes(None)
    assert tmodel._BATCH_AXES is None


@pytest.mark.parametrize("sname", sorted(SHAPES))
def test_input_specs_match_jax(sname):
    cfg = get_config("llama3-8b")
    got = ttokens.input_specs(cfg, SHAPES[sname])["tokens"]
    want = jtokens.input_specs(jget_config("llama3-8b"),
                               JSHAPES[sname])["tokens"]
    assert got.device.type == "meta" and got.dtype == torch.int32
    assert tuple(got.shape) == want.shape and want.dtype == jnp.int32
