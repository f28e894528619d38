"""The port's serving slice against the JAX package, end to end on the CPU.

A checkpoint written by the JAX package's ``save_twin`` is served by
both packages' ``serve_fleet`` on the same numpy-made requests; the
trajectories agree to 1e-5 of their peak.  Also: the checkpoint format
in both directions, the port's fused backend against its digital one,
and the no-fallback device rule.
"""
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import lorenz96_twin as jcfg  # noqa: E402
from repro.core.backends import FusedPallasBackend  # noqa: E402
from repro.core.twin import TwinFleet as JFleet  # noqa: E402
from repro.core.twin import make_autonomous_twin as jmake  # noqa: E402
from repro.launch import fleet_serving as jserve  # noqa: E402
from repro.train import checkpoint as jckpt  # noqa: E402
from repro.train import recipes as jrecipes  # noqa: E402
from repro_torch import device as tdevice  # noqa: E402
from repro_torch.configs import lorenz96_twin as tcfg  # noqa: E402
from repro_torch.core.backends import FusedCudaBackend  # noqa: E402
from repro_torch.core.node import mlp_init  # noqa: E402
from repro_torch.core.twin import TwinFleet as TFleet  # noqa: E402
from repro_torch.core.twin import make_autonomous_twin as tmake  # noqa: E402
from repro_torch.kernels import fused_ode_mlp as tk  # noqa: E402
from repro_torch.launch import fleet_serving as tserve  # noqa: E402
from repro_torch.train import checkpoint as tckpt  # noqa: E402
from repro_torch.train import recipes as trecipes  # noqa: E402

TOL = 1e-5


def rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


def jax_params(hidden, state_dim=6, seed=0):
    """Random JAX params with nonzero biases, as numpy-convertible arrays."""
    params = jmake(state_dim, hidden=hidden).init(jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)
    return [{"w": p["w"], "b": jnp.asarray(
        0.1 * rng.standard_normal(p["b"].shape), jnp.float32)}
        for p in params]


def jax_mesh():
    """A one-device twin mesh with Auto axes.  ``make_twin_mesh`` builds
    Explicit axes on this JAX, which the JAX package's ``shard_map`` path
    rejects (ROADMAP queue 3); serving parity needs the working mesh."""
    return jax.sharding.Mesh(np.array(jax.devices()[:1]), ("twins",))


def requests(fleet, state_dim=6, n=2, seed=1):
    rng = np.random.default_rng(seed)
    return [(0.5 * rng.standard_normal((fleet, state_dim))).astype(np.float32)
            for _ in range(n)]


# ---------------------------------------------------------------------------
# The whole slice: JAX checkpoint -> both packages' serve_fleet
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fleet,horizon,hidden,bt", [
    (16, 50, 64, 64),     # the L96 twin's widths
    (11, 20, 16, 4),      # fleet not a tile multiple: padded in both
    (8, 30, 16, 8),
])
def test_serve_fleet_matches_jax_on_jax_checkpoint(tmp_path, fleet, horizon,
                                                   hidden, bt):
    jckpt.save_twin(str(tmp_path), jax_params(hidden))
    ts = np.linspace(0.0, horizon * 0.0025, horizon + 1).astype(np.float32)
    reqs = requests(fleet)
    jfleet = JFleet(jmake(6, hidden=hidden)).with_backend(
        FusedPallasBackend(batch_tile=bt, precision="f32"))
    want = [np.asarray(o) for o in jserve.serve_fleet(
        str(tmp_path), jfleet, jnp.asarray(ts),
        [jnp.asarray(r) for r in reqs], mesh=jax_mesh())]
    tfleet = TFleet(tmake(6, hidden=hidden)).with_backend(
        FusedCudaBackend(batch_tile=bt))
    got = list(tserve.serve_fleet(str(tmp_path), tfleet, torch.from_numpy(ts),
                                  [torch.from_numpy(r) for r in reqs],
                                  device="cpu"))
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape == (fleet, horizon + 1, 6)
        assert rel(g.numpy(), w) <= TOL
    # the digital substrate of both packages, same checkpoint and requests
    want_d = [np.asarray(o) for o in jserve.serve_fleet(
        str(tmp_path), JFleet(jmake(6, hidden=hidden)), jnp.asarray(ts),
        [jnp.asarray(r) for r in reqs], mesh=jax_mesh())]
    got_d = list(tserve.serve_fleet(str(tmp_path), TFleet(tmake(6, hidden=hidden)),
                                    torch.from_numpy(ts),
                                    [torch.from_numpy(r) for r in reqs],
                                    device="cpu"))
    for gd, wd, g in zip(got_d, want_d, got):
        assert rel(gd.numpy(), wd) <= TOL
        assert rel(g.numpy(), gd.numpy()) <= TOL   # fused vs digital, port


def test_l96_recipe_serves_like_jax_recipe(tmp_path):
    """The recipes' fleet (full L96 widths) on one JAX checkpoint."""
    jckpt.save_twin(str(tmp_path), jax_params(64, seed=3))
    ts = np.array(jrecipes.l96_fleet_ts(horizon=40))
    np.testing.assert_allclose(trecipes.l96_fleet_ts(horizon=40).numpy(), ts,
                               rtol=0, atol=1e-7)
    reqs = requests(16, seed=4)
    jfleet = jrecipes.make_l96_fleet(backend=FusedPallasBackend(
        batch_tile=8, precision="f32"))
    tfleet = trecipes.make_l96_fleet(backend=FusedCudaBackend(batch_tile=8))
    want = list(jserve.serve_fleet(str(tmp_path), jfleet, jnp.asarray(ts),
                                   [jnp.asarray(r) for r in reqs],
                                   mesh=jax_mesh()))
    got = list(tserve.serve_fleet(str(tmp_path), tfleet, torch.from_numpy(ts),
                                  [torch.from_numpy(r) for r in reqs],
                                  device="cpu"))
    for g, w in zip(got, want):
        assert rel(g.numpy(), np.asarray(w)) <= TOL


def test_fleet_server_counts_and_places_weights(tmp_path):
    fleet = trecipes.make_l96_fleet()
    params = fleet.twin.init(torch.Generator().manual_seed(0), device="cpu")
    srv = tserve.FleetServer(fleet, params, trecipes.l96_fleet_ts(horizon=10),
                             device="cpu")
    out = srv.serve(torch.zeros((3, 6)) + 0.1)
    assert tuple(out.shape) == (3, 11, 6) and not out.requires_grad
    assert srv.stats.requests == 1
    assert srv.params[0]["w"].device.type == "cpu"
    with pytest.raises(ValueError, match="non-finite"):
        srv.serve(torch.full((2, 6), float("nan")))


def test_config_copy_matches_jax_config():
    for name in ("Lorenz96TwinConfig", "Lorenz96FleetConfig"):
        j = jcfg.__dict__[name]()
        t = tcfg.__dict__[name]()
        jd, td = j.__dict__.copy(), t.__dict__.copy()
        if name == "Lorenz96FleetConfig":
            assert (jd.pop("backend"), td.pop("backend")) == (
                "fused_pallas", "fused_cuda")
        assert jd == td
    fleet = trecipes.make_l96_fleet()
    assert fleet.backend.name == "fused_cuda"
    assert fleet.backend.batch_tile == tcfg.FLEET.batch_tile
    assert trecipes.make_l96_fleet(backend="digital").backend.name == "digital"


def test_l96_requests_are_seeded():
    a = list(trecipes.l96_fleet_requests(fleet_size=5, num_batches=2,
                                         seed=3, device="cpu"))
    b = list(trecipes.l96_fleet_requests(fleet_size=5, num_batches=2,
                                         seed=3, device="cpu"))
    assert len(a) == 2 and tuple(a[0].shape) == (5, 6)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a[0], a[1])


def test_cli_serves_on_cpu(capsys):
    outs = tserve.main(["--device", "cpu", "--fleet", "9", "--horizon", "12",
                        "--batches", "2"])
    assert [tuple(o.shape) for o in outs] == [(9, 13, 6)] * 2
    assert "served 2 x 9 twins x 12 steps" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# Checkpoints: the JAX package's format, both directions
# ---------------------------------------------------------------------------

def test_checkpoint_round_trips_between_packages(tmp_path):
    jp = jax_params(16)
    jckpt.save_twin(str(tmp_path / "from_jax"), jp, step=7)
    template = mlp_init(torch.Generator().manual_seed(1), (6, 16, 16, 6),
                        device="cpu")
    tp = tckpt.load_twin(str(tmp_path / "from_jax"), template)
    for a, b in zip(jp, tp):
        for k in ("w", "b"):
            assert b[k].dtype == torch.float32
            np.testing.assert_array_equal(b[k].numpy(), np.asarray(a[k]))
    # the port writes the same layout, file for file
    tckpt.save_twin(str(tmp_path / "from_torch"), tp, step=7)
    for name in ("manifest.json",):
        j = json.load(open(tmp_path / "from_jax" / "step_0000000007" / name))
        t = json.load(open(tmp_path / "from_torch" / "step_0000000007" / name))
        assert j == t
    back = jckpt.load_twin(str(tmp_path / "from_torch"),
                           jmake(6, hidden=16).init(jax.random.PRNGKey(5)))
    for a, b in zip(jp, back):
        for k in ("w", "b"):
            np.testing.assert_array_equal(np.asarray(b[k]), np.asarray(a[k]))


def test_checkpoint_steps_and_retention(tmp_path):
    d = str(tmp_path)
    assert tckpt.latest_step(d) is None and tckpt.all_steps(d) == []
    tree = {"a": torch.arange(3.0), "b": [torch.ones(2, 2)]}
    for s in (1, 5, 9, 12):
        tckpt.save(d, s, tree, keep=3)
    assert tckpt.all_steps(d) == [5, 9, 12] and tckpt.latest_step(d) == 12
    os.makedirs(os.path.join(d, "step_0000000099.tmp1_0"))   # in flight
    assert tckpt.latest_step(d) == 12
    arrays, manifest = tckpt.load_arrays(os.path.join(d, "step_0000000012"))
    assert sorted(arrays) == ["a", "b/0"] and manifest["step"] == 12
    back = tckpt.restore(d, 9, tree)
    assert torch.equal(back["a"], tree["a"]) and isinstance(back["b"], list)


def test_checkpoint_damage_taxonomy(tmp_path):
    d = str(tmp_path)
    params = mlp_init(torch.Generator().manual_seed(0), (6, 8, 6),
                      device="cpu")
    path = tckpt.save_twin(d, params, step=1)
    with pytest.raises(FileNotFoundError, match="no twin checkpoint"):
        tckpt.load_twin(str(tmp_path / "nowhere"), params)
    with pytest.raises(FileNotFoundError, match="does not exist"):
        tckpt.read_manifest(str(tmp_path / "step_0000000002"))
    other = mlp_init(torch.Generator().manual_seed(0), (6, 9, 6),
                     device="cpu")
    with pytest.raises(ValueError, match="different architecture"):
        tckpt.load_twin(d, other)
    with pytest.raises(KeyError, match="template does not match"):
        tckpt.load_twin(d, params + params)
    mpath = os.path.join(path, "manifest.json")
    body = json.load(open(mpath))
    json.dump({**body, "schema": 2}, open(mpath, "w"))
    with pytest.raises(ValueError, match="schema 2"):
        tckpt.load_twin(d, params)
    open(mpath, "w").write("{not json")
    with pytest.raises(ValueError, match="corrupt"):
        tckpt.load_twin(d, params)
    json.dump(body, open(mpath, "w"))
    os.remove(os.path.join(path, "arr_00000.npy"))
    with pytest.raises(FileNotFoundError, match="truncated"):
        tckpt.load_twin(d, params)
    os.remove(mpath)
    with pytest.raises(FileNotFoundError, match="no manifest.json"):
        tckpt.load_arrays(path)


# ---------------------------------------------------------------------------
# Front-door validation and padding, as in the JAX package
# ---------------------------------------------------------------------------

def test_padding_matches_jax():
    for n, k in [(12, 4), (13, 4), (1, 4), (5, 1)]:
        assert tserve.padded_size(n, k) == jserve.padded_size(n, k)
    y = np.arange(14.0, dtype=np.float32).reshape(7, 2)
    th = np.arange(21.0, dtype=np.float32).reshape(7, 3)
    jy, jt, jm = jserve.pad_fleet_inputs(jnp.asarray(y), jnp.asarray(th), 4)
    ty, tt, tm = tserve.pad_fleet_inputs(torch.from_numpy(y),
                                         torch.from_numpy(th), 4)
    np.testing.assert_array_equal(ty.numpy(), np.asarray(jy))
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(tm, jm)
    with pytest.raises(ValueError, match="drive_params batch 3 != y0s batch 7"):
        tserve.pad_fleet_inputs(torch.from_numpy(y), torch.zeros(3, 1), 4)


@pytest.mark.parametrize("kw,match", [
    ({"y0s": torch.zeros(2, 3, dtype=torch.int32)}, "y0s has non-floating"),
    ({"y0s": torch.tensor([[0.0, float("inf")]])}, "y0s contains 1 non-finite"),
    ({"drive_params": torch.tensor([[float("nan")]])},
     "drive_params contains 1 non-finite"),
    ({"ts": torch.tensor([0.0])}, ">= 2 points"),
    ({"ts": torch.tensor([0.0, float("nan")])}, "non-finite values"),
    ({"ts": torch.tensor([0.0, 0.2, 0.1])}, "strictly increasing"),
])
def test_validate_fleet_request_names_the_argument(kw, match):
    with pytest.raises(ValueError, match=match):
        tserve.validate_fleet_request("caller", **kw)
    tserve.validate_fleet_request("caller", y0s=torch.zeros(2, 3),
                                  ts=torch.linspace(0, 1, 3))


# ---------------------------------------------------------------------------
# No fallback: the default device is CUDA, and it is required
# ---------------------------------------------------------------------------

def test_default_device_raises_without_cuda(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        tdevice.resolve_device(None)
    with pytest.raises(RuntimeError, match="is_available"):
        tdevice.resolve_device("cuda:0")
    assert tdevice.resolve_device("cpu") == torch.device("cpu")
    fleet = trecipes.make_l96_fleet()
    params = fleet.twin.init(torch.Generator().manual_seed(0), device="cpu")
    tckpt.save_twin(str(tmp_path), params)
    ts = trecipes.l96_fleet_ts(horizon=4)
    with pytest.raises(RuntimeError, match="is_available"):
        next(tserve.serve_fleet(str(tmp_path), fleet, ts, [torch.zeros(2, 6)]))
    with pytest.raises(RuntimeError, match="is_available"):
        tserve.FleetServer(fleet, params, ts)
    with pytest.raises(RuntimeError, match="is_available"):
        next(trecipes.l96_fleet_requests(fleet_size=2))
    with pytest.raises(RuntimeError, match="is_available"):
        fleet.twin.init(torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="is_available"):
        tserve.main(["--fleet", "2", "--horizon", "2"])


def test_launch_counter_moves_only_on_cuda_launches():
    before = tk.LAUNCHES
    fleet = trecipes.make_l96_fleet()
    params = fleet.twin.init(torch.Generator().manual_seed(0), device="cpu")
    tserve.FleetServer(fleet, params, trecipes.l96_fleet_ts(horizon=3),
                       device="cpu").serve(torch.zeros(4, 6))
    assert tk.LAUNCHES == before      # the CPU ran the plain version
