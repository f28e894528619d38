"""Analogue-crossbar execution deep-dive on the PyTorch port: run a trained
twin through the simulated memristor arrays under device non-idealities,
and through the fused CUDA kernel path (K1, the card's counterpart of
in-memory computing), all reached through the pluggable
``twin.with_backend(...)`` layer.

Run:  PYTHONPATH=src python examples/torch/analogue_inference.py
      [--device cpu]
"""
import argparse

import torch

from repro_torch.core.analogue import (AnalogueSpec, program_tensor,
                                       programming_error)
from repro_torch.core.backends import AnalogueBackend, FusedCudaBackend
from repro_torch.core.losses import mre
from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.train import recipes


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description="analogue crossbar deep-dive")
    ap.add_argument("--device", default="cuda",
                    help="torch device (cpu runs the kernels' plain "
                         "PyTorch versions)")
    device = resolve_device(ap.parse_args(argv).device)

    twin, params, _ = recipes.train_hp_twin(pretrain_steps=200,
                                            train_steps=300, device=device)
    m = recipes.eval_hp_twin(twin, params, "sine", device=device)
    ts, true = m["ts"], m["true"]
    y0 = true[:1]

    print("== device-statistics sweep (paper Fig. 2h-k constraints) ==")
    for levels, pn in [(256, 0.0), (64, 0.0), (64, 0.0436), (16, 0.0436)]:
        spec = AnalogueSpec(levels=levels, prog_noise=pn)
        at = twin.with_backend(AnalogueBackend(spec=spec, prog_seed=0))
        with torch.no_grad():
            pred = at.simulate(params, y0, ts)[:, 0]
        print(f"  {levels:3d} levels, prog noise {pn*100:4.1f}%:  "
              f"MRE vs truth {float(mre(pred, true)):.4f}")

    print("\n== backend matrix: one set of weights, three substrates ==")
    matrix = recipes.hp_backend_matrix(twin, params, device=device)
    for name, v in matrix.items():
        print(f"  {name:13s} MRE vs truth {v:.6f}")

    print("\n== programming-error statistics (paper Fig. 3e: ~2.2%) ==")
    spec = AnalogueSpec(prog_noise=0.0436)
    errs = []
    for i, layer in enumerate(params):
        prog = program_tensor(torch.Generator().manual_seed(i),
                              layer["w"].detach(), spec)
        pe = programming_error(prog, layer["w"].detach(), spec)
        errs.append(float(pe.mean()))
        print(f"  layer {i}: mean relative programming error "
              f"{float(pe.mean())*100:.2f}% of range")
    print(f"  average: {sum(errs)/len(errs)*100:.2f}%  (paper: 2.2%)")

    print("\n== fused weights-stationary kernel vs step-by-step solver ==")
    with torch.no_grad():
        traj_kernel = twin.with_backend(FusedCudaBackend()).simulate(
            params, y0, ts)
        traj_solver = twin.simulate(params, y0, ts)
    err = float((traj_kernel - traj_solver).abs().max())
    print(f"  kernel-vs-odeint max abs deviation: {err:.2e}")

    print("\n== quantised-storage crossbar read (uint8 levels, fused dequant) ==")
    spec = AnalogueSpec()
    w = params[1]["w"].detach()
    gpq, gmq, scale = ops.quantize_to_levels(w, spec)
    x = torch.randn((8, w.shape[0]), generator=torch.Generator().manual_seed(
        2)).to(device)
    y_q = ops.crossbar_vmm_quantized(x, gpq, gmq, spec, scale)
    rel = float(torch.linalg.norm(y_q - x @ w) / torch.linalg.norm(x @ w))
    print(f"  6-bit differential storage vs fp32 matmul rel-err: {rel:.4f}")
    return {"backend_matrix": matrix, "kernel_vs_solver": err,
            "quantised_rel_err": rel}


if __name__ == "__main__":
    main()
