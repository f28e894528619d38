"""Fleet serving: one trained twin, many assets, one device (port of ``repro/launch/fleet_serving.py``).

Layers (bottom-up):

  ``FleetServer``   programmed server: weights placed on the device once,
                    request batches in, trajectories out
  ``serve_fleet``   end-to-end pipeline: checkpoint -> server -> streamed
                    request batches -> results, in order

On the ``fused_cuda`` backend each request batch is one launch of the
hand-written CUDA kernel K1 (:mod:`repro_torch.kernels.fused_ode_mlp`); on
``analogue_fused_cuda`` the twin is deployed on memristor crossbars and
each batch is one launch of K4 (:mod:`repro_torch.kernels.fused_analogue`).

Not ported yet (ROADMAP.md, queue 1): the multi-device mesh
(``shard_rollout_batch``), ``ServingSLO`` with its ``fallback_chain``
(they come with the analogue tiers) and ``StreamingFleetServer``.

CLI (Lorenz96 fleet; ``--device cpu`` runs the kernel's plain version):

  PYTHONPATH=src python -m repro_torch.launch.fleet_serving --device cpu \\
      --fleet 16 --horizon 20
"""
from __future__ import annotations

import argparse
import dataclasses
import tempfile
import time
from typing import Any, Iterable, Iterator, Optional, Union

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.train import checkpoint as ckpt_lib

Params = Any
Request = Union[torch.Tensor, tuple]


# ---------------------------------------------------------------------------
# Front-door input validation
# ---------------------------------------------------------------------------

def validate_fleet_request(caller: str, y0s=None, ts=None,
                           drive_params=None) -> None:
    """Reject malformed serving inputs with errors naming the offending
    argument — a NaN initial condition or a backwards time grid would
    otherwise propagate silently through the whole rollout."""
    for name, x in (("y0s", y0s), ("drive_params", drive_params)):
        if x is None:
            continue
        x = torch.as_tensor(x)
        if not torch.is_floating_point(x):
            raise ValueError(
                f"{caller}: {name} has non-floating dtype {x.dtype}")
        bad = int((~torch.isfinite(x)).sum())
        if bad:
            raise ValueError(
                f"{caller}: {name} contains {bad} non-finite "
                f"(NaN/Inf) value(s) — rejecting the request instead of "
                f"rolling garbage through the fleet")
    if ts is not None:
        tsn = np.asarray(torch.as_tensor(ts).detach().cpu())
        if tsn.ndim != 1 or tsn.size < 2:
            raise ValueError(
                f"{caller}: ts must be a 1-D time grid with >= 2 points, "
                f"got shape {tsn.shape}")
        if not bool(np.isfinite(tsn).all()):
            raise ValueError(f"{caller}: ts contains non-finite values")
        if not bool((np.diff(tsn) > 0).all()):
            raise ValueError(
                f"{caller}: ts must be strictly increasing (non-monotone "
                f"time grids silently break the fixed-step integrators)")


# ---------------------------------------------------------------------------
# Uneven-N padding
# ---------------------------------------------------------------------------

def padded_size(n: int, n_shards: int) -> int:
    """Smallest multiple of ``n_shards`` >= n."""
    return -(-n // n_shards) * n_shards


def pad_fleet_inputs(y0s: torch.Tensor,
                     drive_params: Optional[torch.Tensor], n_shards: int):
    """Pad the fleet axis up to a multiple of the shard count.

    Padding rows replicate the LAST real asset (in-distribution values).
    Returns ``(y0s_padded, drive_params_padded, mask)`` where ``mask`` is
    a length-``padded_size`` bool numpy vector marking the real rows.
    """
    n = y0s.shape[0]
    if drive_params is not None and drive_params.shape[0] != n:
        raise ValueError(
            f"drive_params batch {drive_params.shape[0]} != y0s batch {n}")
    np_ = padded_size(n, n_shards)
    mask = np.arange(np_) < n

    def pad(x):
        if x is None or np_ == n:
            return x
        return torch.cat([x, x[-1:].expand(np_ - n, *x.shape[1:])])

    return pad(y0s), pad(drive_params), mask


# ---------------------------------------------------------------------------
# Programmed fleet server
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ServingStats:
    """What a server has done."""
    requests: int = 0


@dataclasses.dataclass
class FleetServer:
    """A twin fleet programmed for serving on one device.

    Construction places ``params`` on ``device`` (default ``cuda``) once
    and freezes the time grid; each :meth:`serve` call validates a
    request batch, rolls it out under ``torch.inference_mode()`` and
    returns the (N, T+1, D) trajectories on the device.
    """
    fleet: Any                        # repro_torch.core.twin.TwinFleet
    params: Params
    ts: Any                           # concrete uniform time grid
    device: Any = None                # None -> cuda

    def __post_init__(self):
        self.device = resolve_device(self.device)
        self.ts = torch.as_tensor(self.ts).detach().cpu()
        validate_fleet_request("FleetServer", ts=self.ts)
        self.params = [{k: v.to(self.device) for k, v in layer.items()}
                       for layer in self.params]
        self.stats = ServingStats()

    def serve(self, y0s: torch.Tensor,
              drive_params: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Roll out one request batch -> (N, T+1, D) trajectories."""
        y0s = torch.as_tensor(y0s, device=self.device)
        if drive_params is not None:
            drive_params = torch.as_tensor(drive_params, device=self.device)
        validate_fleet_request("FleetServer.serve", y0s=y0s,
                               drive_params=drive_params)
        with torch.inference_mode():
            out = self.fleet.rollout_batch(self.params, y0s, self.ts,
                                           drive_params)
        self.stats.requests += 1
        return out


def serve_fleet(ckpt_dir: str, fleet, ts, requests: Iterable[Request], *,
                step: Optional[int] = None,
                params_template: Optional[Params] = None,
                device=None) -> Iterator[torch.Tensor]:
    """End-to-end serving pipeline over a stream of request batches.

    checkpoint load (:func:`repro_torch.train.checkpoint.load_twin`, which
    also reads the JAX package's checkpoints) -> weights placed on
    ``device`` once (:class:`FleetServer`) -> each request batch rolled
    out -> trajectories yielded in order.

    ``requests`` yields either ``y0s`` tensors (autonomous fleets) or
    ``(y0s, drive_params)`` tuples (driven fleets).  ``params_template``
    gives the weight structure for the restore; by default it is built
    with ``fleet.twin.init`` on the CPU (the values are overwritten).
    """
    device = resolve_device(device)
    if params_template is None:
        params_template = fleet.twin.init(torch.Generator().manual_seed(0),
                                          device="cpu")
    params = ckpt_lib.load_twin(ckpt_dir, params_template, step=step,
                                device=device)
    server = FleetServer(fleet, params, ts, device=device)
    for req in requests:
        y0s, thetas = req if isinstance(req, tuple) else (req, None)
        yield server.serve(y0s, thetas)


# ---------------------------------------------------------------------------
# CLI: the Lorenz96 fleet workload on one device
# ---------------------------------------------------------------------------

def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Serve a Lorenz96 twin fleet on one device")
    ap.add_argument("--fleet", type=int, default=256,
                    help="assets per request batch")
    ap.add_argument("--horizon", type=int, default=100,
                    help="RK4 steps per rollout")
    ap.add_argument("--batches", type=int, default=2,
                    help="request batches to stream")
    ap.add_argument("--backend", default="fused_cuda",
                    choices=["digital", "fused_cuda", "analogue_fused_cuda"],
                    help="analogue_fused_cuda serves on K4 with the "
                         "paper's device statistics (6-bit levels, 4.36%% "
                         "programming noise)")
    ap.add_argument("--ckpt-dir", default="",
                    help="trained-twin checkpoint (default: untrained "
                         "weights saved to a temp dir — substrate smoke)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (cpu runs the plain PyTorch path)")
    args = ap.parse_args(argv)

    from repro_torch.train import recipes
    device = resolve_device(args.device)
    fleet = recipes.make_l96_fleet(backend=args.backend)
    ts = recipes.l96_fleet_ts(horizon=args.horizon)
    print(f"device {device}; backend {args.backend}")

    with tempfile.TemporaryDirectory(prefix="l96_fleet_ckpt_") as tmp:
        ckpt_dir = args.ckpt_dir
        if not ckpt_dir:
            ckpt_dir = tmp
            params = fleet.twin.init(torch.Generator().manual_seed(0),
                                     device="cpu")
            ckpt_lib.save_twin(ckpt_dir, params)
            print("no --ckpt-dir: serving an untrained twin (seed 0)")
        reqs = recipes.l96_fleet_requests(fleet_size=args.fleet,
                                          num_batches=args.batches,
                                          device=device)
        t0 = time.perf_counter()
        outs = []
        for i, traj in enumerate(serve_fleet(ckpt_dir, fleet, ts, reqs,
                                             device=device)):
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            outs.append(traj)
            dt_s = time.perf_counter() - t0
            rate = (i + 1) * args.fleet * args.horizon / dt_s
            print(f"  batch {i}: {tuple(traj.shape)} trajectories "
                  f"({rate:,.0f} twin-steps/s cumulative)")
    if not all(bool(torch.isfinite(o).all()) for o in outs):
        raise RuntimeError("served trajectories contain non-finite values")
    print(f"served {args.batches} x {args.fleet} twins x {args.horizon} "
          f"steps in {time.perf_counter() - t0:.2f}s")
    return outs


if __name__ == "__main__":
    main()
