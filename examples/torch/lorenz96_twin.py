"""End-to-end driver on the PyTorch port: Lorenz96 multivariate-time-series
twin (paper Fig. 4).

Trains the autonomous neural-ODE twin on the first 1800 points
(interpolation window), extrapolates the remaining 600, compares against
LSTM/GRU/RNN forecasters, and runs the analogue noise-robustness grid
(Fig. 4j).

Run:  PYTHONPATH=src python examples/torch/lorenz96_twin.py [--fast]
      [--no-baselines] [--device cpu]
"""
import argparse

from repro_torch.core import energy
from repro_torch.device import resolve_device
from repro_torch.train import recipes


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description="Lorenz96 twin (Fig. 4)")
    ap.add_argument("--fast", action="store_true",
                    help="a fifth of the training budgets, one programming "
                         "per noise setting")
    ap.add_argument("--no-baselines", action="store_true",
                    help="skip the LSTM/GRU/RNN forecasters (Fig. 4g)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (cpu runs the kernels' plain "
                         "PyTorch versions)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    data = recipes.l96_data(device=device)
    info = recipes.l96_lyapunov_info(device=device)
    print(f"Lorenz96 n=6 F=8: MLE {info['mle']:.2f}, "
          f"Lyapunov time {info['lyapunov_time']:.2f} time units")

    scale = 0.2 if args.fast else 1.0
    print("\n== training neural-ODE twin (soft-DTW/L1, adjoint, RK4) ==")
    twin, params = recipes.train_l96_twin(
        pretrain_steps=int(5000 * scale),
        train_steps=((60, int(600 * scale), 1e-3),
                     (200, int(600 * scale), 4e-4)),
        data=data, device=device)
    m = recipes.eval_l96_twin(twin, params, data=data)
    print(f"NODE: interp L1 {m['interp_l1']:.3f}  extrap L1 "
          f"{m['extrap_l1']:.3f}   (paper: 0.512 / 0.321)")

    baselines = {}
    if not args.no_baselines:
        print("\n== Fig. 4g: recurrent baselines ==")
        for cell in ["lstm", "gru", "rnn"]:
            b = recipes.eval_l96_baseline(
                cell, train_steps=int(2500 * scale), data=data,
                device=device)
            baselines[cell] = b
            print(f"  {cell:>5s}: interp L1 {b['interp_l1']:.3f}  "
                  f"extrap L1 {b['extrap_l1']:.3f}")

    print("\n== Fig. 4j: analogue noise robustness (extrapolation L1) ==")
    grid = recipes.noise_robustness_grid(
        twin, params, read_noises=[0.0, 0.02], prog_noises=[0.0, 0.01],
        data=data, repeats=1 if args.fast else 3)
    for row in grid:
        print(f"  prog {row['prog_noise']*100:4.1f}%  "
              f"read {row['read_noise']*100:3.1f}%:  "
              f"extrap L1 {row['extrap_l1']:.3f}")

    print("\n== Fig. 4h,i: projected execution time / energy ==")
    for row in energy.lorenz96_projection():
        print(f"  hidden {row['hidden']:4d}: analogue {row['analogue_time_us']:5.1f} us |"
              f" NODE x{row['node_gpu_speed_gain']:4.1f}/x{row['node_gpu_energy_gain']:5.0f}"
              f" LSTM x{row['lstm_gpu_speed_gain']:4.1f}/x{row['lstm_gpu_energy_gain']:5.0f}"
              f" GRU x{row['gru_gpu_speed_gain']:4.1f}/x{row['gru_gpu_energy_gain']:5.0f}"
              f" RNN x{row['rnn_gpu_speed_gain']:4.1f}/x{row['rnn_gpu_energy_gain']:5.0f}"
              f"  (speed/energy)")
    return {"node": m, "baselines": baselines, "grid": grid, **info}


if __name__ == "__main__":
    main()
