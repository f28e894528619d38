"""Sharded fleet serving on the PyTorch port, end to end: checkpoint ->
mesh -> 1024 twins.

The production deployment story in one script (the Lorenz96 scenario,
paper Fig. 4 scaled out):

  1. obtain trained twin weights (a quick derivative-matching fit here;
     any ``train_l96_twin`` result drops in) and persist them with
     ``checkpoint.save_twin``: the hand-off from training to serving;
  2. build the twin mesh over every visible card and stream request
     batches through ``serve_fleet``: weights are placed once per card,
     the fleet axis (per-asset initial conditions) is split over the
     cards, and each card rolls its slice out on K1 (the fused CUDA
     backend);
  3. verify the sharded trajectories match a plain single-device
     ``TwinFleet`` rollout (<= 1e-5): sharding changes placement, not
     numerics.

On one card the mesh has one shard (the sharded path is the same
program); on more cards the same script splits the fleet across them.

Run:  PYTHONPATH=src python examples/torch/fleet_serving_sharded.py
      [--smoke] [--fleet N] [--device cpu]
"""
import argparse
import tempfile
import time

import torch

from repro_torch.core.twin import TwinFleet
from repro_torch.device import resolve_device
from repro_torch.launch.fleet_serving import serve_fleet
from repro_torch.launch.mesh import make_twin_mesh, twin_shard_count
from repro_torch.train import checkpoint as ckpt_lib
from repro_torch.train import recipes, trainer
from repro_torch.train.optimizer import adam

PARITY_TOL = 1e-5


def quick_train(fleet, steps: int, device):
    """Derivative-matching fit on the paper's Lorenz96 data: cheap but
    real trained weights (the full recipe is ``recipes.train_l96_twin``)."""
    params = fleet.twin.init(torch.Generator().manual_seed(7), device=device)
    if steps <= 0:
        return params
    ts, ys, split = recipes.l96_data(device=device)
    params, hist = trainer.pretrain_derivatives(
        fleet.twin.field, params, ts[:split], ys[:split],
        optimizer=adam(3e-3), num_steps=steps)
    print(f"  trained {steps} derivative-matching steps "
          f"(loss {float(hist[-1]):.4f})")
    return params


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description="sharded fleet serving")
    ap.add_argument("--smoke", action="store_true",
                    help="CI-sized run (small fleet, no training)")
    ap.add_argument("--fleet", type=int, default=0,
                    help="override fleet size (default 1024; smoke 64)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (cpu runs the kernels' plain "
                         "PyTorch versions)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    n = args.fleet or (64 if args.smoke else 1024)
    horizon = 50 if args.smoke else 200
    train_steps = 0 if args.smoke else 500

    print("== 1. train + checkpoint (the training->serving hand-off) ==")
    fleet = recipes.make_l96_fleet()            # fused CUDA backend (K1)
    params = quick_train(fleet, train_steps, device)
    with tempfile.TemporaryDirectory(prefix="l96_fleet_ckpt_") as ckpt_dir:
        ckpt_lib.save_twin(ckpt_dir, params)
        print(f"  weights -> {ckpt_dir}")

        print("\n== 2. serve the fleet over the twin mesh ==")
        mesh = make_twin_mesh(device=device)
        ts = recipes.l96_fleet_ts(horizon=horizon)
        requests = list(recipes.l96_fleet_requests(
            fleet_size=n, num_batches=2, device=device))
        print(f"  {twin_shard_count(mesh)} device(s); {len(requests)} "
              f"request batches x {n} assets x {horizon} RK4 steps")

        trajs, t0 = [], time.perf_counter()
        for i, traj in enumerate(serve_fleet(ckpt_dir, fleet, ts, requests,
                                             mesh=mesh)):
            _sync(device)
            trajs.append(traj)
            print(f"  batch {i}: {tuple(traj.shape)}")
        dt_s = time.perf_counter() - t0
    print(f"  served in {dt_s:.2f}s "
          f"({len(requests) * n * horizon / dt_s:,.0f} twin-steps/s)")

    print("\n== 3. sharded == single-device parity ==")
    with torch.no_grad():
        ref = fleet.simulate(params, requests[0], ts)
        gap = float((trajs[0] - ref).abs().max())
        print(f"  max|sharded - single-device| = {gap:.2e}  "
              f"(tolerance {PARITY_TOL:.0e})")
        assert gap <= PARITY_TOL, gap
        digital = TwinFleet(fleet.twin.with_backend("digital"))
        dref = digital.simulate(params, requests[0][:32], ts)
        dgap = float((trajs[0][:32] - dref).abs().max())
    print(f"  max|fused - digital| (32 assets) = {dgap:.2e}  "
          f"(solver-precision cross-check)")
    print("OK")
    return {"sharded_vs_single": gap, "fused_vs_digital": dgap,
            "served_s": dt_s}


if __name__ == "__main__":
    main()
