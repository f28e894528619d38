"""Fleet-of-twins serving on the PyTorch port: one trained model, N
physical assets, one device program per rollout, on every execution
backend.

Production digital-twin deployments serve many asset instances of the
same model class (Hartmann 2023; Fuller et al. 2019): each asset has its
own sensed initial condition and its own stimulus parameters, but the
trained weights are shared.  ``TwinFleet`` batches all of that:

  * the digital and analogue backends roll the N twins out as one batch;
  * the fused CUDA backend runs the whole fleet in one launch of K1,
    every block keeping the weights resident (the crossbar analogy).

Run:  PYTHONPATH=src python examples/torch/twin_fleet_serving.py
      [--device cpu]
"""
import argparse
import math
import time

import torch

from repro_torch.core.analogue import AnalogueSpec
from repro_torch.core.backends import AnalogueBackend, FusedCudaBackend
from repro_torch.core.twin import TwinFleet
from repro_torch.device import resolve_device
from repro_torch.train import recipes

FLEET_SIZE = 64
HORIZON = 200          # RK4 steps per rollout


def sine_family(t, theta):
    """Per-asset stimulus: theta = (amp, freq) sensed at the asset."""
    amp, freq = theta[0], theta[1]
    return amp * torch.sin(2.0 * math.pi * freq * t)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description="fleet-of-twins serving")
    ap.add_argument("--device", default="cuda",
                    help="torch device (cpu runs the kernels' plain "
                         "PyTorch versions)")
    device = resolve_device(ap.parse_args(argv).device)

    print("== train once (shared weights for the whole fleet) ==")
    twin, params, loss = recipes.train_hp_twin(pretrain_steps=200,
                                               train_steps=300, device=device)
    print(f"  final training loss {loss:.5f}")

    gen = torch.Generator().manual_seed(0)
    ts = torch.linspace(0.0, HORIZON * 1e-3, HORIZON + 1)
    y0s = (0.1 + 0.2 * torch.rand((FLEET_SIZE, 1), generator=gen)).to(device)
    thetas = torch.stack([
        1.0 + torch.rand((FLEET_SIZE,), generator=gen),          # amp [1,2)
        1.0 + 2.0 * torch.rand((FLEET_SIZE,), generator=gen),    # freq [1,3)
    ], dim=-1).to(device)

    fleet = TwinFleet(twin, drive_family=sine_family)
    backends = {
        "digital": None,
        "fused_cuda": FusedCudaBackend(batch_tile=min(64, FLEET_SIZE)),
        "analogue": AnalogueBackend(spec=AnalogueSpec(prog_noise=0.0),
                                    prog_seed=7),
    }

    print(f"\n== serve {FLEET_SIZE} assets x {HORIZON} RK4 steps ==")
    ref, rows = None, {}
    for name, backend in backends.items():
        fl = fleet if backend is None else fleet.with_backend(backend)
        with torch.no_grad():
            out = fl.simulate(params, y0s, ts, thetas)       # warm-up
            _sync(device)
            t0 = time.perf_counter()
            out = fl.simulate(params, y0s, ts, thetas)
            _sync(device)
        dt_s = time.perf_counter() - t0
        steps_per_s = FLEET_SIZE * HORIZON / dt_s
        if ref is None:
            ref, agree = out, 0.0
        else:
            agree = float((out - ref).abs().max())
        rows[name] = {"ms": dt_s * 1e3, "max_abs_vs_digital": agree}
        print(f"  {name:13s} {dt_s*1e3:8.2f} ms/rollout  "
              f"{steps_per_s:12.0f} twin-steps/s  "
              f"max|Δ| vs digital {agree:.2e}")
    print("\n  (fused/digital agree to solver precision; the analogue gap "
          "is 6-bit quantisation, the paper's deployment cost)")
    return rows


if __name__ == "__main__":
    main()
