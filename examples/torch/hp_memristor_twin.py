"""End-to-end driver on the PyTorch port: digital twin of the HP memristor
(paper Fig. 3).

Trains the neural-ODE twin AND the recurrent-ResNet digital baseline on
the sine drive, evaluates both across the paper's four stimulation
waveforms, deploys the twin on simulated analogue crossbars, and prints
the projected speed/energy table.

Run:  PYTHONPATH=src python examples/torch/hp_memristor_twin.py [--fast]
      [--device cpu]
"""
import argparse

import torch

from repro_torch.core import energy
from repro_torch.core.analogue import AnalogueSpec
from repro_torch.core.backends import AnalogueBackend
from repro_torch.core.losses import mre
from repro_torch.device import resolve_device
from repro_torch.train import recipes

WAVEFORMS = ["sine", "triangular", "rectangular", "modulated_sine"]


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description="HP memristor twin (Fig. 3)")
    ap.add_argument("--fast", action="store_true",
                    help="a quarter of the training budgets")
    ap.add_argument("--device", default="cuda",
                    help="torch device (cpu runs the kernels' plain "
                         "PyTorch versions)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    scale = 0.25 if args.fast else 1.0

    print("== training neural-ODE twin (adjoint, RK4, L1 — paper Methods) ==")
    twin, params, node_loss = recipes.train_hp_twin(
        pretrain_steps=int(400 * scale), train_steps=int(600 * scale),
        device=device)
    print(f"NODE final loss {node_loss:.5f}")

    print("== training recurrent-ResNet baseline (paper Eq. 8) ==")
    resnet, rparams, res_loss = recipes.train_hp_resnet(
        train_steps=int(800 * scale), device=device)
    print(f"ResNet final loss {res_loss:.5f}")

    print("\n== Fig. 3j: modelling error across stimulation waveforms ==")
    node_m, res_m = [], []
    for wf in WAVEFORMS:
        mn = recipes.eval_hp_twin(twin, params, wf, device=device)
        mr = recipes.eval_hp_resnet(resnet, rparams, wf, device=device)
        node_m.append(mn["mre"])
        res_m.append(mr["mre"])
        print(f"  {wf:>15s}:  NODE MRE {mn['mre']:.3f} DTW/pt {mn['dtw']:.4f}"
              f"  |  ResNet MRE {mr['mre']:.3f} DTW/pt {mr['dtw']:.4f}")
    print(f"  mean MRE: NODE {sum(node_m)/4:.3f} vs ResNet {sum(res_m)/4:.3f}"
          f"   (paper: 0.17 vs 0.61)")

    print("\n== analogue deployment (paper device statistics) ==")
    m = recipes.eval_hp_twin(twin, params, "sine", device=device)
    analogue = {}
    for pn, rn in [(0.0, 0.0), (0.0436, 0.0), (0.0436, 0.02)]:
        spec = AnalogueSpec(prog_noise=pn, read_noise=rn)
        at = twin.with_backend(
            AnalogueBackend(spec=spec, prog_seed=0, read_seed=1))
        with torch.no_grad():
            pred = at.simulate(params, m["true"][:1], m["ts"])[:, 0]
        analogue[pn, rn] = float(mre(pred, m["true"]))
        print(f"  prog {pn*100:4.1f}%  read {rn*100:3.1f}%:  "
              f"MRE vs truth {analogue[pn, rn]:.4f}")

    print("\n== Fig. 3k,l: projected speed/energy scalability ==")
    for row in energy.hp_projection():
        print(f"  hidden {row['hidden']:4d}: analogue {row['analogue_time_us']:6.1f} us"
              f" {row['analogue_energy_uj']:7.2f} uJ | NODE-GPU x{row['node_gpu_speed_gain']:.1f}"
              f" speed x{row['node_gpu_energy_gain']:.1f} energy"
              f" | ResNet-GPU x{row['resnet_gpu_energy_gain']:.1f} energy")
    return {"node_mre": node_m, "resnet_mre": res_m, "analogue": analogue}


if __name__ == "__main__":
    main()
