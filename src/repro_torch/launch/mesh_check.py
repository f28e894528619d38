"""Check the twin mesh across several devices: a fleet split over the
cards gives what one card gives, every card launches its own shards'
kernels, and every card holds its own copy of the programmed substrate.

    PYTHONPATH=src python3 -m repro_torch.launch.mesh_check [--shards N]
        [--fleet 1021] [--horizon 200] [--device cuda|cpu]

On ``make_twin_mesh(N)`` (default: every visible card; two or more), with
the Lorenz96 fleet twin (6->64->64->6, seeded weights saved with
``save_twin``):

1. ``serve_fleet(mesh=)`` on ``fused_cuda``, two request batches of
   ``--fleet`` twins x ``--horizon`` RK4 steps, against ``serve_fleet`` on
   the first card alone: the result on the first card, within 1e-4 of the
   peak (bitwise or not, printed); each batch's K1 launches and the
   devices they ran on (every card of the mesh); the wall ms of each batch
   both ways, every card synchronised;
2. ``rollout_batch(mesh=, precision="bf16_f32acc")``, the policy passed
   per call, against the unsharded bf16 rollout: within 2e-3 of the peak
   with at least 0.999 of the elements bitwise;
3. ``FleetServer(mesh=, slo=)`` on the noisy faulty analogue substrate
   (uint8, read noise 0.02, 1% stuck cells, drift), its weights from
   ``load_twin(shardings=fleet_param_shardings(mesh, ...))``: every tier's
   program as each card holds it against the unsharded server's, tensor
   for tensor (on that card, bitwise); one request against the unsharded
   server's (within 1e-4 of the peak), its K4 launches and their devices.

Every line is one JSON object with the cards' names and power limits from
``nvidia-smi``; the last is ``{"ok": true, ...}``.  Exits 1 when a check
fails or fewer than two cards are visible.  ``--device cpu --shards 4``
runs the same checks on four CPU shards with the kernels' plain versions.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import tempfile
import time

import torch

from repro_torch.core.analogue import AnalogueSpec
from repro_torch.core.backends import (FusedAnalogueCudaBackend,
                                       FusedCudaBackend)
from repro_torch.core.faults import make_fault_model
from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.launch.fleet_serving import (FleetServer, ServingSLO,
                                              serve_fleet)
from repro_torch.launch.mesh import make_twin_mesh
from repro_torch.launch.sharding import (fleet_param_shardings,
                                        tensor_leaves)
from repro_torch.train import checkpoint, recipes

SEED = 0
TOL = 1e-4                            # of the peak (chip_smoke.py phase 4)
BF16_TOL, BF16_SHARE = 2e-3, 0.999    # chip_smoke.py phase 25's K1 limits


class CheckFailed(RuntimeError):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise CheckFailed(what)


def rel_err(a: torch.Tensor, b: torch.Tensor) -> tuple:
    """(max |a - b|, that over max |b|), in float32."""
    a, b = a.float(), b.float().to(a.device)
    err = float((a - b).abs().max())
    return err, err / float(b.abs().max())


def bitwise_share(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float() == b.float().to(a.device)).float().mean())


def max_abs_diff(a: torch.Tensor, b: torch.Tensor) -> float:
    if not a.numel():
        return 0.0
    return float((a.cpu().double() - b.cpu().double()).abs().max())


def programs_diff(u_srv, s_srv, mesh) -> tuple:
    """Every tier's program as each shard of the server ``s_srv`` (on
    ``mesh``) holds it, against the unsharded server ``u_srv``'s, tensor
    for tensor: (largest absolute difference, tensors compared, all
    bitwise).  Each copy must sit on its shard's device with the
    original's shape and dtype."""
    diff, n, same = 0.0, 0, True
    for i, (_, u_state) in enumerate(u_srv._programs):
        want = tensor_leaves(u_state)
        for k, placed in enumerate(s_srv._placed[i]):
            have = tensor_leaves(placed)
            check(len(have) == len(want) > 0,
                  f"tier {i} shard {k}: {len(have)} tensors, the unsharded "
                  f"program {len(want)}")
            for h, w in zip(have, want):
                check(h.device == mesh.devices[k] and h.dtype == w.dtype
                      and h.shape == w.shape,
                      f"tier {i} shard {k}: {h.device} {h.dtype} "
                      f"{tuple(h.shape)} vs {w.dtype} {tuple(w.shape)}")
                same &= torch.equal(h.cpu(), w.cpu())
                diff = max(diff, max_abs_diff(h, w))
                n += 1
    return diff, n, same


def sync(devices) -> None:
    for d in dict.fromkeys(devices):
        if d.type == "cuda":
            torch.cuda.synchronize(d)


def recording(name: str, into: list):
    """Wrap ``ops.<name>`` so that each call appends the device its state
    lies on; returns the undo."""
    fn = getattr(ops, name)

    def run(*a, **k):
        into.append(a[1].device)
        return fn(*a, **k)
    setattr(ops, name, run)
    return lambda: setattr(ops, name, fn)


def timed_batches(stream, devices) -> tuple:
    """Drain a serving generator: its outputs and each batch's wall ms."""
    outs, ms = [], []
    while True:
        t0 = time.perf_counter()
        out = next(stream, None)
        sync(devices)
        if out is None:
            return outs, ms
        ms.append((time.perf_counter() - t0) * 1e3)
        outs.append(out)


def run_checks(mesh, fleet_size: int, horizon: int, emit) -> None:
    devs = mesh.devices
    first = devs[0]
    cfg = recipes.FLEET
    ts = recipes.l96_fleet_ts(horizon=horizon)
    fleet = recipes.make_l96_fleet(
        backend=FusedCudaBackend(batch_tile=cfg.batch_tile))
    template = fleet.twin.init(torch.Generator().manual_seed(SEED),
                               device="cpu")
    reqs = list(recipes.l96_fleet_requests(fleet_size=fleet_size,
                                           num_batches=2, seed=SEED + 1,
                                           device=first))
    with tempfile.TemporaryDirectory(prefix="mesh_check_") as ckpt:
        checkpoint.save_twin(ckpt, template)

        # 1. serve_fleet over the mesh against the first card alone
        one, ms_one = timed_batches(
            serve_fleet(ckpt, fleet, ts, reqs, device=first), devs)
        k1_devices = []
        undo = recording("fused_node_rollout", k1_devices)
        try:
            got, ms_mesh = timed_batches(
                serve_fleet(ckpt, fleet, ts, reqs, mesh=mesh), devs)
        finally:
            undo()
        errs = [rel_err(g, o) for g, o in zip(got, one)]
        same = all(torch.equal(g, o) for g, o in zip(got, one))
        emit({"check": "serve_fleet(mesh=) fused_cuda", "shards": len(devs),
              "fleet": fleet_size, "horizon": horizon,
              "k1_launches": len(k1_devices),
              "k1_devices": sorted({str(d) for d in k1_devices}),
              "max_err_of_peak": max(e[1] for e in errs), "bitwise": same,
              "wall_ms_one_card": ms_one, "wall_ms_mesh": ms_mesh})
        check(all(g.device == first for g in got),
              "serve_fleet(mesh=): a result is not on the first card")
        check(len(k1_devices) == 2 * len(devs)
              and set(k1_devices) == set(devs),
              f"serve_fleet(mesh=): K1 ran {len(k1_devices)} times on "
              f"{sorted({str(d) for d in k1_devices})}")
        check(max(e[1] for e in errs) <= TOL,
              "serve_fleet(mesh=) disagrees with one card")

        # 2. a per-call bf16 policy through rollout_batch(mesh=)
        params = checkpoint.load_twin(ckpt, template, device=first)
        be = fleet.backend
        state = be.program(fleet.twin.node.field, params)
        kw = dict(method="rk4", gradient="stopgrad", precision="bf16_f32acc")
        with torch.no_grad():
            unsh = be.rollout_batch(state, reqs[0], ts, **kw)
            sh = be.rollout_batch(state, reqs[0], ts, mesh=mesh, **kw)
        sync(devs)
        err16, share16 = rel_err(sh, unsh), bitwise_share(sh, unsh)
        emit({"check": "rollout_batch(mesh=, precision='bf16_f32acc')",
              "dtype": str(sh.dtype).replace("torch.", ""),
              "max_err_of_peak": err16[1], "bitwise_share": share16})
        check(sh.dtype == torch.bfloat16 and sh.device == first,
              f"bf16 over the mesh: {sh.dtype} on {sh.device}")
        check(err16[1] <= BF16_TOL and share16 >= BF16_SHARE,
              "bf16 over the mesh disagrees with one card")

        # 3. FleetServer(mesh=, slo=) on the noisy faulty analogue substrate
        afleet = recipes.make_l96_fleet(backend=FusedAnalogueCudaBackend(
            batch_tile=cfg.batch_tile, prog_seed=SEED, read_seed=SEED,
            spec=AnalogueSpec(prog_noise=0.0, read_noise=0.02),
            storage="uint8", faults=make_fault_model(
                ("stuck", dict(rate=0.01)), "drift", seed=SEED)))
        slo = ServingSLO(max_rel_error=0.5)
        placed = checkpoint.load_twin(
            ckpt, template, shardings=fleet_param_shardings(mesh, template))
        u_srv = FleetServer(afleet, params, ts, device=first, slo=slo)
        s_srv = FleetServer(afleet, placed, ts, mesh=mesh, slo=slo)
        prog_err, n_tensors, prog_same = programs_diff(u_srv, s_srv, mesh)
        u_out = u_srv.serve(reqs[0])
        k4_devices = []
        undo = recording("fused_analogue_rollout", k4_devices)
        try:
            s_out = s_srv.serve(reqs[0])
        finally:
            undo()
        sync(devs)
        err4 = rel_err(s_out, u_out)
        emit({"check": "FleetServer(mesh=, slo=) analogue_fused_cuda",
              "tiers": len(u_srv._programs), "program_tensors": n_tensors,
              "programs_bitwise": prog_same,
              "programs_max_abs": prog_err,
              "served_by": s_srv.stats.served_by,
              "k4_launches": len(k4_devices),
              "k4_devices": sorted({str(d) for d in k4_devices}),
              "max_err_of_peak": err4[1],
              "bitwise": torch.equal(s_out, u_out)})
        check(prog_same and prog_err == 0.0,
              "a card's program differs from the unsharded server's")
        check(s_srv.stats.served_by == u_srv.stats.served_by,
              f"tiers {s_srv.stats.served_by} vs {u_srv.stats.served_by}")
        check(set(devs) <= set(k4_devices),
              f"K4 ran on {sorted({str(d) for d in k4_devices})}")
        check(err4[1] <= TOL, "the analogue mesh serve disagrees")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--shards", type=int, default=None,
                    help="shards of the mesh (default: every visible card)")
    ap.add_argument("--fleet", type=int, default=1021,
                    help="twins per request batch")
    ap.add_argument("--horizon", type=int, default=200,
                    help="RK4 steps per request")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    cards = "not a CUDA run"
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        cards = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()
    mesh = make_twin_mesh(args.shards, device=device)
    if len(mesh.devices) < 2:
        print(f"mesh_check: {len(mesh.devices)} shard(s); needs two or "
              f"more", file=sys.stderr)
        return 1

    def emit(rec):
        print(json.dumps({**rec, "cards": cards}), flush=True)
    try:
        run_checks(mesh, args.fleet, args.horizon, emit)
    except CheckFailed as e:
        print(f"mesh_check: FAILED: {e}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "shards": len(mesh.devices),
                      "devices": [str(d) for d in mesh.devices],
                      "cards": cards}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
