"""Time K4, the fused analogue RK4 rollout, on one CUDA card at the shapes
of its main paths: the Lorenz96 fleet request (1024 twins x 200 steps,
6->64->64->6) clean and noisy faulty (uint8, read noise 0.02, 1% stuck
cells, drift), as analogue fleet serving runs it, and the HP twin
(2->14->14->1, 500 steps, shared drive) at P1's settings: one twin clean
(quantised only) and noisy (programming and read noise), 100 twins noisy.

    python3 src/repro_torch/launch/k4_timing.py [--src DIR]

``--src`` names the ``src`` directory whose ``repro_torch`` is timed
(default: the one this file lies in), so one command can time two trees
of the package with the same cases: they reach K4 only through
``FusedAnalogueCudaBackend.program`` and ``ops.fused_analogue_rollout``.
Each case prints one JSON line: the CUDA-event mean of ``REPS`` rollouts
after two unmeasured ones (a noisy rollout's read-noise pre-pass
included), with the card's name and power limit from ``nvidia-smi``.
Needs a CUDA card; exits 1 without one.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

SEED = 0
REPS = 10


def _cases(torch, dev):
    """name -> (staged arrays, y0, u, dt, read noise): the inputs drawn as
    ``chip_smoke.py`` phase 10 draws them."""
    from repro_torch.core.analogue import AnalogueSpec
    from repro_torch.core.backends import FusedAnalogueCudaBackend
    from repro_torch.core.faults import make_fault_model
    from repro_torch.core.twin import make_autonomous_twin, make_driven_twin

    gen = torch.Generator().manual_seed(SEED)
    fleet = make_autonomous_twin(6, hidden=64)
    fleet_params = fleet.init(torch.Generator().manual_seed(SEED), device=dev)
    hp_twin = make_driven_twin(1, None, hidden=14)
    hp_params = hp_twin.init(torch.Generator().manual_seed(SEED), device=dev)
    for p in hp_params:
        p["b"] = (0.1 * torch.randn(p["b"].shape, generator=gen)).to(dev)
    p1_noisy = dict(spec=AnalogueSpec(prog_noise=0.0436, read_noise=0.02))
    noisy_faulty = dict(
        spec=AnalogueSpec(prog_noise=0.0, read_noise=0.02), storage="uint8",
        faults=make_fault_model(("stuck", dict(rate=0.01)), "drift",
                                seed=SEED))
    specs = {
        # name: (twin, params, backend kwargs, B, T, shared drive, dt)
        "fleet_float_clean": (fleet, fleet_params,
                              dict(spec=AnalogueSpec()), 1024, 200, False,
                              0.0025),
        "fleet_uint8_noise_stuck_drift": (fleet, fleet_params, noisy_faulty,
                                          1024, 200, False, 0.0025),
        "hp_p1_B1_shared_clean": (hp_twin, hp_params, dict(
            spec=AnalogueSpec(prog_noise=0.0)), 1, 500, True, 1e-3),
        "hp_p1_B1_shared_noise": (hp_twin, hp_params, p1_noisy, 1, 500, True,
                                  1e-3),
        "hp_p1_B100_shared_noise": (hp_twin, hp_params, p1_noisy, 100, 500,
                                    True, 1e-3),
    }
    out = {}
    for name, (tw, prm, kw, B, T, shared, dt) in specs.items():
        staged = FusedAnalogueCudaBackend(prog_seed=SEED, **kw).program(
            tw.node.field, prm).extra
        D = tw.field.sizes[-1]
        y0 = (0.5 * torch.randn((B, D), generator=gen)).to(dev)
        th = torch.arange(2 * T + 1, dtype=torch.float64) / (2 * T)
        u = (torch.sin(2 * torch.pi * 2.0 * th)[:, None] if shared
             else torch.zeros((2 * T + 1, 0)))
        out[name] = (staged, y0, u.to(torch.float32).to(dev), dt,
                     kw["spec"].read_noise)
    return out


def main(argv=None) -> int:
    here = Path(__file__).resolve().parents[2]
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(here),
                    help="directory holding the repro_torch package to time")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(Path(args.src).resolve()))
    import torch

    if not torch.cuda.is_available():
        print("k4_timing: no CUDA card", file=sys.stderr)
        return 1
    from repro_torch.kernels import fused_analogue, ops

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    for name, (staged, y0, u, dt, sigma) in _cases(torch, dev).items():
        def run():
            return ops.fused_analogue_rollout(
                staged, y0, u, dt, batch_tile=y0.shape[0], read_noise=sigma,
                noise_seed=SEED)
        for _ in range(2):
            run()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        before = fused_analogue.LAUNCHES
        start.record()
        for _ in range(REPS):
            run()
        end.record()
        torch.cuda.synchronize()
        print(json.dumps({
            "case": name, "B": y0.shape[0], "T": u.shape[0] // 2,
            "ms": start.elapsed_time(end) / REPS,
            "launches_per_rollout": (fused_analogue.LAUNCHES - before)
            / REPS,
            "src": str(Path(args.src).resolve()), "card": smi}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
