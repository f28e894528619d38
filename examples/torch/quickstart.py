"""Quickstart on the PyTorch port: train a continuous-time digital twin of
the HP memristor, then deploy it onto simulated analogue memristor arrays.

Run:  PYTHONPATH=src python examples/torch/quickstart.py [--device cpu]

The default device is ``cuda`` (the hand-written kernels); ``--device
cpu`` runs their plain PyTorch versions.
"""
import argparse

import torch

from repro_torch.core import energy
from repro_torch.core.analogue import AnalogueSpec
from repro_torch.core.backends import AnalogueBackend
from repro_torch.core.losses import mre
from repro_torch.device import resolve_device
from repro_torch.train import recipes


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device (cpu runs the kernels' plain "
                         "PyTorch versions)")
    device = resolve_device(ap.parse_args(argv).device)

    print("=== training neural-ODE digital twin of the HP memristor ===")
    twin, params, loss = recipes.train_hp_twin(pretrain_steps=300,
                                               train_steps=400,
                                               device=device)
    print(f"final training loss (L1): {loss:.5f}")

    print("\n=== evaluation across stimulation waveforms (paper Fig. 3f/j) ===")
    for wf in ["sine", "triangular", "rectangular", "modulated_sine"]:
        m = recipes.eval_hp_twin(twin, params, wf, device=device)
        print(f"  {wf:>15s}:  MRE {m['mre']:.3f}   DTW/pt {m['dtw']:.4f}")

    print("\n=== analogue deployment (6-bit, 4.36% programming noise) ===")
    spec = AnalogueSpec(prog_noise=0.0436, read_noise=0.02)
    a_twin = twin.with_backend(
        AnalogueBackend(spec=spec, prog_seed=0, read_seed=1))
    m = recipes.eval_hp_twin(twin, params, "sine", device=device)
    with torch.no_grad():
        pred = a_twin.simulate(params, m["true"][:1], m["ts"])[:, 0]
    analogue_mre = float(mre(pred, m["true"]))
    print(f"  analogue twin MRE vs ground truth: {analogue_mre:.3f}")

    row = energy.hp_projection()[-1]
    print("\n=== projected gains at hidden 64 (paper Fig. 3k,l) ===")
    print(f"  speed vs NODE-on-GPU:  x{row['node_gpu_speed_gain']:.1f} "
          f"(paper: 4.2)")
    print(f"  energy vs NODE-on-GPU: x{row['node_gpu_energy_gain']:.1f} "
          f"(paper: 41.4)")
    return {"loss": loss, "analogue_mre": analogue_mre}


if __name__ == "__main__":
    main()
