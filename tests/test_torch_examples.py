"""The reference helpers the examples use, and the examples of the port
(``examples/torch/``), on the CPU.

``recipes.hp_backend_matrix`` on one set of seeded HP weights (JAX's
init, carried over as numpy; no training): its ``digital`` and
``fused_cuda`` MREs within 1e-4 of JAX's ``digital`` / ``fused_pallas``
entries; the ``analogue`` entry finite (the programming-noise
generators of the two packages differ, so its value does too).
``ops.fused_node_rollout_ref`` and ``ref.crossbar_matmul_q_ref`` within
1e-6 of the peak of JAX's.  Every example parses ``--help``, and
``fleet_serving_sharded.py --smoke --device cpu`` runs end to end (~5 s
here); the others train twins for minutes on the CPU and run on the
card (``chip_smoke.py``).
"""
import importlib.util
import math
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import twin as jtwin  # noqa: E402
from repro.data import hp_memristor as jhp  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.train import recipes as jrecipes  # noqa: E402
from repro_torch.core import twin as ttwin  # noqa: E402
from repro_torch.data import hp_memristor as thp  # noqa: E402
from repro_torch.interop import params_from_numpy  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.train import recipes as trecipes  # noqa: E402

EXAMPLES = Path(__file__).resolve().parents[1] / "examples" / "torch"
NAMES = ["quickstart", "hp_memristor_twin", "lorenz96_twin",
         "analogue_inference", "twin_fleet_serving", "fleet_serving_sharded"]


def peak_err(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def load_example(name: str):
    spec = importlib.util.spec_from_file_location(
        f"torch_example_{name}", EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_hp_backend_matrix_matches_jax():
    kw = dict(amp=jrecipes.HP_AMP, freq=jrecipes.HP_FREQ)
    jt = jtwin.make_driven_twin(1, jhp.WAVEFORMS["sine"](**kw), hidden=14)
    tt = ttwin.make_driven_twin(1, thp.WAVEFORMS["sine"](**kw), hidden=14)
    jp = jt.init(jax.random.PRNGKey(42))
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    want = jrecipes.hp_backend_matrix(jt, jp)
    got = trecipes.hp_backend_matrix(tt, tp, device="cpu")
    assert set(got) == {"digital", "fused_cuda", "analogue"}
    assert set(want) == {"digital", "fused_pallas", "analogue"}
    for ours, theirs in (("digital", "digital"),
                         ("fused_cuda", "fused_pallas")):
        assert abs(got[ours] - want[theirs]) <= 1e-4 * max(
            1.0, abs(want[theirs])), (ours, got[ours], want[theirs])
    assert abs(got["digital"] - got["fused_cuda"]) <= 1e-4
    assert all(math.isfinite(v) for v in got.values())


@pytest.mark.parametrize("drive", ["shared", "per_twin", "none"])
def test_fused_node_rollout_ref_matches_jax(drive):
    rng = np.random.default_rng(0)
    du = 0 if drive == "none" else 2
    sizes = [du + 3, 16, 16, 3]
    params = [{"w": (rng.standard_normal((a, b)) / math.sqrt(a)).astype(
                  np.float32),
               "b": (0.1 * rng.standard_normal(b)).astype(np.float32)}
              for a, b in zip(sizes[:-1], sizes[1:])]
    B, T = 5, 20
    y0 = rng.standard_normal((B, 3)).astype(np.float32)
    shape = (B, 2 * T + 1, du) if drive == "per_twin" else (2 * T + 1, du)
    u = rng.standard_normal(shape).astype(np.float32)
    want = jops.fused_node_rollout_ref(
        jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(y0),
        jnp.asarray(u), 0.01)
    got = tops.fused_node_rollout_ref(
        params_from_numpy(params, "cpu"), torch.from_numpy(y0),
        torch.from_numpy(u), 0.01)
    assert got.shape == (T + 1, B, 3) and got.dtype == torch.float32
    assert peak_err(got.numpy(), want) <= 1e-6


@pytest.mark.parametrize("clamp", [None, 0.5])
def test_crossbar_matmul_q_ref_matches_jax(clamp):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((7, 33)).astype(np.float32)
    gp = rng.integers(0, 64, (33, 19), dtype=np.uint8)
    gm = rng.integers(0, 64, (33, 19), dtype=np.uint8)
    want = jref.crossbar_matmul_q_ref(jnp.asarray(x), jnp.asarray(gp),
                                      jnp.asarray(gm), 1.5e-6, 2.0e4, clamp)
    got = tref.crossbar_matmul_q_ref(torch.from_numpy(x), torch.from_numpy(gp),
                                     torch.from_numpy(gm), 1.5e-6, 2.0e4,
                                     clamp)
    assert got.dtype == torch.float32
    assert peak_err(got.numpy(), want) <= 1e-6
    if clamp is not None:
        assert float(got.abs().max()) <= clamp


@pytest.mark.parametrize("name", NAMES)
def test_example_parses_help(name, capsys):
    mod = load_example(name)
    with pytest.raises(SystemExit) as exc:
        mod.main(["--help"])
    assert exc.value.code == 0
    out = capsys.readouterr().out
    assert "--device" in out


def test_fleet_serving_sharded_smoke_on_cpu():
    out = load_example("fleet_serving_sharded").main(
        ["--smoke", "--device", "cpu"])
    assert out["sharded_vs_single"] <= 1e-5
    assert out["fused_vs_digital"] <= 1e-4


def test_examples_default_to_the_card():
    """No fallback: without a card the default device raises."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        load_example("quickstart").main([])
