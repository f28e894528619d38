"""The port stands alone: no module of ``repro_torch``, not
``chip_smoke.py`` and no example under ``examples/torch/`` imports JAX
or the JAX package ``repro``."""
import os
import subprocess
import sys
import textwrap

import pytest

pytest.importorskip("torch")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_port_and_chip_smoke_import_neither_jax_nor_repro():
    code = textwrap.dedent("""
        import importlib, pkgutil, sys
        import repro_torch
        names = ["repro_torch"] + [m.name for m in pkgutil.walk_packages(
            repro_torch.__path__, "repro_torch.")]
        for name in names:
            importlib.import_module(name)
        import chip_smoke
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "repro"))
        assert not bad, bad
        assert len(names) >= 58, names
        print(len(names), "modules")
    """)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([os.path.join(REPO, "src"), REPO])
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "modules" in res.stdout


def test_torch_examples_import_neither_jax_nor_repro():
    code = textwrap.dedent("""
        import importlib.util, pathlib, sys
        files = sorted(pathlib.Path("examples/torch").glob("*.py"))
        for path in files:
            spec = importlib.util.spec_from_file_location(
                "example_" + path.stem, path)
            spec.loader.exec_module(importlib.util.module_from_spec(spec))
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "repro"))
        assert not bad, bad
        assert len(files) >= 6, files
        print(len(files), "examples")
    """)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(REPO, "src")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "examples" in res.stdout


def test_chip_smoke_refuses_to_run_without_a_card():
    if_cuda = "import torch, sys; sys.exit(0 if torch.cuda.is_available() else 1)"
    if subprocess.run([sys.executable, "-c", if_cuda]).returncode == 0:
        pytest.skip("a CUDA card is present: chip_smoke.py would run")
    res = subprocess.run([sys.executable, os.path.join(REPO, "chip_smoke.py")],
                         cwd=REPO, capture_output=True, text=True, timeout=300)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout
