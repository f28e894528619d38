"""Time one family of the port's hand-written kernels on one CUDA card, on
this tree or on another tree's ``src``, so that one command can time a
parent and a change on the same inputs.

    python3 src/repro_torch/launch/kernel_timing.py --kernel k1|k3|k4|k8|sdtw [--src DIR]

``--src`` names the ``src`` directory whose ``repro_torch`` is timed
(default: the one this file lies in).  Every line is one JSON object with
the card's name and power limit from ``nvidia-smi`` and the ``src`` timed.

``k1``: K1, the fused RK4 rollout, through
``fused_ode_mlp.fused_node_rollout`` at the shapes of its main paths:
the Lorenz96 fleet request (1024 twins x 200 steps, 6->64->64->6,
autonomous), Lorenz96 training (29 x 60) and HP training (9 x 50,
2->14->14->1, a drive per twin), seeded weights.  A line per case and
precision policy (float32, and the bf16 policies where the tree takes
them, at the planner's rounding chunk): the CUDA-event mean of
``K1_REPS`` rollouts after two unmeasured ones, and the first 16 hex
digits of the SHA-256 of the trajectory's bytes, so that two trees'
trajectories can be compared bit for bit.

``k3``: K3 on the noisy analogue serving path P2 (the Lorenz96 fleet
twin, 6->64->64->6, uint8 storage, read noise 0.02, 1% stuck cells,
drift): one programming of ``FusedAnalogueCudaBackend`` (host-clock ms,
device sync, and K3 launches per programming), the host-clock ms per
call of ``noise.stuck_cell_masks`` on one 65 x 64 array (calls queued
behind a spin kernel: the wrapper's own cost) and its kernel's CUDA-event
mean, and the wall ms of each of ``K3_BATCHES`` request batches of 1024
twins x 200 steps through ``serve_fleet``, programming included.

``k4``: K4, the fused analogue RK4 rollout, at the shapes of its main
paths, reached only through ``FusedAnalogueCudaBackend.program`` and
``ops.fused_analogue_rollout``: the Lorenz96 fleet request (1024 twins x
200 steps, 6->64->64->6) clean and noisy faulty (uint8, read noise 0.02,
1% stuck cells, drift), and the HP twin (2->14->14->1, 500 steps, shared
drive) at P1's settings: one twin clean (quantised only) and noisy
(programming and read noise), 100 twins noisy.  A line a case: the
CUDA-event mean of ``K4_REPS`` rollouts after two unmeasured ones (a
noisy rollout's read-noise pre-pass included) and K4's launches per
rollout.

``k8``: K8, causal flash attention, through
``flash_attention.flash_attention`` on the model's (B, S, heads, d)
layout seen as (B, heads, S, d), seeded normal inputs, float32 and bf16:
the JAX package's three test shapes, the Jamba prefill's (B, H, Hkv, S,
d) = (2, 32, 8, 4096, 128) and, where the tree takes dv != d, DeepSeek-V2
MLA's (2, 16, 1, 4096, 576 -> 512) with V the first 512 columns of K's
latent (a tree that refuses a pair skips it).  A line a case: the
CUDA-event mean of ``K8_REPS`` launches and the first 16 hex digits of
the SHA-256 of the output's bytes, so that two trees' outputs can be
compared bit for bit.

``sdtw``: K5 and K6, the soft-DTW wavefront kernels, at the Lorenz96
training shapes (29, 61, 61) and (8, 201, 201), gamma 0.1.  A tree with
the row-major entry points (``softdtw.softdtw_rowmajor``) is timed
through them on the (B, n, m) costs, an older tree through
``softdtw.softdtw_wavefront`` on the diagonal layout it takes (laid out
before timing).  Per kernel and shape a line: the CUDA-event mean of
``SDTW_REPS`` launches queued behind a spin kernel (kernel_ms) and back
to back with the wrapper (call_ms).  Per shape one more: the host-clock
ms per call of ``mean(ops.soft_dtw(x, y, 0.1)).backward()`` on (B, n, 6)
series, ended by a device sync, and the device kernels of one call in a
``torch.profiler`` trace.

Needs a CUDA card; exits 1 without one.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

SEED = 0
K1_REPS = 20
K3_REPS = 20
K3_BATCHES = 3
K4_REPS = 10
K8_REPS = 5
#: (B, H, Hkv, S, d, dv): the JAX package's test shapes, the Jamba
#: prefill's and DeepSeek-V2-Lite's absorbed MLA prefill.
K8_CASES = [(1, 2, 2, 32, 16, 16), (2, 4, 2, 64, 32, 32),
            (1, 8, 2, 128, 64, 64), (2, 32, 8, 4096, 128, 128),
            (2, 16, 1, 4096, 576, 512)]
SDTW_REPS = 50
SDTW_SHAPES = [(29, 61, 61), (8, 201, 201)]


def _events_ms(torch, fn, reps: int, queue_ahead: bool = False) -> float:
    """CUDA-event mean of ``reps`` calls after two unmeasured ones; with
    ``queue_ahead`` the calls queue behind a spin kernel, so the host's
    launch cost is hidden."""
    for _ in range(2):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    if queue_ahead:
        torch.cuda._sleep(20_000_000)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _k4_cases(torch, dev):
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


def _k1_cases(torch, dev):
    """name -> (weights, biases, y0, u, dt), seeded: He-scaled weights,
    biases of 0.1 N(0, 1), y0 of 0.5 N(0, 1), and for HP a sine drive per
    twin of random amplitude and frequency."""
    gen = torch.Generator().manual_seed(SEED)
    specs = {"l96_fleet_1024x200": ((6, 64, 64, 6), 1024, 200, 0.0025),
             "l96_train_29x60": ((6, 64, 64, 6), 29, 60, 0.0025),
             "hp_train_9x50": ((2, 14, 14, 1), 9, 50, 1e-3)}
    out = {}
    for name, (sizes, B, T, dt) in specs.items():
        ws = [(torch.randn((a, b), generator=gen) * (2.0 / a) ** 0.5).to(dev)
              for a, b in zip(sizes[:-1], sizes[1:])]
        bs = [(0.1 * torch.randn((b,), generator=gen)).to(dev)
              for b in sizes[1:]]
        y0 = (0.5 * torch.randn((B, sizes[-1]), generator=gen)).to(dev)
        th = torch.arange(2 * T + 1, dtype=torch.float64) / (2 * T)
        du = sizes[0] - sizes[-1]
        if du:
            amp = 0.5 + torch.rand((B, 1), generator=gen, dtype=torch.float64)
            freq = 1.0 + 3.0 * torch.rand((B, 1), generator=gen,
                                          dtype=torch.float64)
            u = (amp * torch.sin(2 * torch.pi * freq * th[None]))[..., None]
        else:
            u = torch.zeros((2 * T + 1, 0))
        out[name] = (ws, bs, y0, u.to(torch.float32).to(dev), dt)
    return out


def time_k1(torch, dev, tag: dict) -> None:
    import hashlib

    from repro_torch.kernels import fused_ode_mlp

    policies = ["f32"]
    if hasattr(fused_ode_mlp, "PRECISIONS"):
        policies += ["bf16_f32acc", "bf16"]
    for name, (ws, bs, y0, u, dt) in _k1_cases(torch, dev).items():
        for prec in policies:
            kw = {} if prec == "f32" else {"precision": prec}

            def run():
                return fused_ode_mlp.fused_node_rollout(
                    y0, u, ws, bs, dt, batch_tile=y0.shape[0], **kw)
            try:
                out = run().contiguous()
            except NotImplementedError:     # a tree that refuses the policy
                continue
            digest = hashlib.sha256(
                out.view(torch.uint8).cpu().numpy().tobytes()).hexdigest()
            print(json.dumps({
                "kernel": "K1", "case": name, "precision": prec,
                "B": y0.shape[0], "T": out.shape[0] - 1,
                "ms": _events_ms(torch, run, K1_REPS),
                "sha256_16": digest[:16], **tag}))


def time_k8(torch, dev, tag: dict) -> None:
    import hashlib

    from repro_torch.kernels import flash_attention

    gen = torch.Generator(device=dev).manual_seed(SEED)
    for b, h, hkv, s, d, dv in K8_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            q, k = (torch.randn((b, s, n, d), generator=gen, device=dev).to(
                dtype).transpose(1, 2) for n in (h, hkv))
            v = k[..., :dv]
            scale = (d // 3 if dv != d else d) ** -0.5

            def run():
                return flash_attention.flash_attention(q, k, v, scale=scale)
            try:
                out = run().contiguous()
            except ValueError:       # a tree that refuses the pair
                continue
            digest = hashlib.sha256(out.view(torch.uint8).cpu().numpy()
                                    .tobytes()).hexdigest()
            print(json.dumps({
                "kernel": "K8", "shape": [b, h, hkv, s, d, dv],
                "dtype": str(dtype).replace("torch.", ""),
                "ms": _events_ms(torch, run, K8_REPS),
                "sha256_16": digest[:16], **tag}))


def time_k3(torch, dev, tag: dict) -> None:
    import tempfile

    from repro_torch.core.analogue import AnalogueSpec
    from repro_torch.core.backends import FusedAnalogueCudaBackend
    from repro_torch.core.faults import make_fault_model
    from repro_torch.kernels import noise
    from repro_torch.launch.fleet_serving import serve_fleet
    from repro_torch.train import checkpoint, recipes

    def k3_launches():
        # a tree without the batched mask fill counts only fills
        return noise.LAUNCHES + getattr(noise, "MASK_LAUNCHES", 0)

    cfg = recipes.FLEET
    faulty = dict(spec=AnalogueSpec(prog_noise=0.0, read_noise=0.02),
                  storage="uint8", prog_seed=SEED, read_seed=SEED,
                  faults=make_fault_model(("stuck", dict(rate=0.01)), "drift",
                                          seed=SEED))
    backend = FusedAnalogueCudaBackend(batch_tile=cfg.batch_tile, **faulty)
    fleet = recipes.make_l96_fleet(backend=backend)
    params = fleet.twin.init(torch.Generator().manual_seed(SEED), device=dev)
    field = fleet.twin.node.field
    backend.program(field, params)
    torch.cuda.synchronize()
    before = k3_launches()
    t0 = time.perf_counter()
    for _ in range(K3_REPS):
        backend.program(field, params)
    torch.cuda.synchronize()
    print(json.dumps({
        "case": "P2 programming (noisy faulty, 6->64->64->6)",
        "host_ms": (time.perf_counter() - t0) / K3_REPS * 1e3,
        "k3_launches_per_programming": (k3_launches() - before) / K3_REPS,
        **tag}))

    def fill():
        return noise.stuck_cell_masks(SEED, 0x0F00_0002, (65, 64), 0.01,
                                      device=dev)
    for _ in range(2):
        fill()
    torch.cuda.synchronize()
    torch.cuda._sleep(20_000_000)
    t0 = time.perf_counter()
    for _ in range(K3_REPS * 5):
        fill()
    host_ms = (time.perf_counter() - t0) / (K3_REPS * 5) * 1e3
    torch.cuda.synchronize()
    print(json.dumps({
        "case": "noise.stuck_cell_masks 65x64 (the fill)",
        "host_ms": host_ms,
        "kernel_ms": _events_ms(torch, fill, K3_REPS * 5, True), **tag}))

    with tempfile.TemporaryDirectory(prefix="kernel_timing_ckpt_") as ckpt:
        checkpoint.save_twin(ckpt, fleet.twin.init(
            torch.Generator().manual_seed(SEED), device="cpu"))
        stream = serve_fleet(ckpt, fleet, recipes.l96_fleet_ts(),
                             recipes.l96_fleet_requests(
                                 num_batches=K3_BATCHES, seed=SEED,
                                 device=dev), device=dev)
        batch_ms = []
        while True:
            t0 = time.perf_counter()
            out = next(stream, None)
            torch.cuda.synchronize()
            if out is None:
                break
            batch_ms.append((time.perf_counter() - t0) * 1e3)
    print(json.dumps({
        "case": "P2 serve_fleet noisy faulty, 1024 twins x 200 steps",
        "batch_ms": batch_ms, **tag}))


def time_k4(torch, dev, tag: dict) -> None:
    from repro_torch.kernels import fused_analogue, ops

    for name, (staged, y0, u, dt, sigma) in _k4_cases(torch, dev).items():
        def run():
            return ops.fused_analogue_rollout(
                staged, y0, u, dt, batch_tile=y0.shape[0], read_noise=sigma,
                noise_seed=SEED)
        before = fused_analogue.LAUNCHES
        ms = _events_ms(torch, run, K4_REPS)
        print(json.dumps({
            "case": name, "B": y0.shape[0], "T": u.shape[0] // 2, "ms": ms,
            "launches_per_rollout": (fused_analogue.LAUNCHES - before)
            / (K4_REPS + 2), **tag}))


def time_sdtw(torch, dev, tag: dict) -> None:
    from repro_torch.core.losses import _pairwise_dist
    from repro_torch.kernels import ops, softdtw

    rowmajor = hasattr(softdtw, "softdtw_rowmajor")
    gen = torch.Generator().manual_seed(SEED)
    for B, n, m in SDTW_SHAPES:
        x = torch.randn((B, n, 2), generator=gen).to(dev)
        y = torch.randn((B, m, 2), generator=gen).to(dev)
        D = _pairwise_dist(x, y).contiguous()
        if rowmajor:
            def k5():
                return softdtw.softdtw_rowmajor(D, gamma=0.1, return_r=True)
            R = k5()[1]

            def k6():
                return softdtw.softdtw_rowmajor_bwd(D, R, gamma=0.1)
        else:
            dd = ops._diag_layout_batch(D)

            def k5():
                return softdtw.softdtw_wavefront(dd, n, m, gamma=0.1,
                                                 return_r=True)
            rd = k5()[1]

            def k6():
                return softdtw.softdtw_wavefront_bwd(dd, rd, n, m, gamma=0.1)
        for name, fn in (("K5", k5), ("K6", k6)):
            print(json.dumps({
                "kernel": name, "B": B, "n": n, "m": m,
                "kernel_ms": _events_ms(torch, fn, SDTW_REPS, True),
                "call_ms": _events_ms(torch, fn, SDTW_REPS),
                "layout": "row-major" if rowmajor else "diagonal", **tag}))
        preds = torch.randn((B, n, 6), generator=gen).to(dev)
        targets = torch.randn((B, n, 6), generator=gen).to(dev)
        leaf = preds.clone().requires_grad_()

        def term():
            torch.mean(ops.soft_dtw(leaf, targets, 0.1)).backward()

        term()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(20):
            term()
        torch.cuda.synchronize()
        term_ms = (time.perf_counter() - t0) / 20 * 1e3
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(5):
                term()
            torch.cuda.synchronize()
        kernels = sum(1 for ev in prof.events()
                      if ev.device_type == torch.autograd.DeviceType.CUDA)
        print(json.dumps({
            "term": "mean(ops.soft_dtw).backward()", "B": B, "n": n,
            "host_ms": term_ms, "device_kernels": kernels / 5, **tag}))


def main(argv=None) -> int:
    here = Path(__file__).resolve().parents[2]
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kernel", required=True,
                    choices=("k1", "k3", "k4", "k8", "sdtw"),
                    help="k1: the fused rollout; k3: the counter noise on "
                         "analogue serving; k4: the analogue rollout; k8: "
                         "flash attention; sdtw: K5 and K6")
    ap.add_argument("--src", default=str(here),
                    help="directory holding the repro_torch package to time")
    args = ap.parse_args(argv)
    src = str(Path(args.src).resolve())
    sys.path.insert(0, src)
    import torch

    if not torch.cuda.is_available():
        print("kernel_timing: no CUDA card", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    timer = {"k1": time_k1, "k3": time_k3, "k4": time_k4, "k8": time_k8,
             "sdtw": time_sdtw}[args.kernel]
    timer(torch, torch.device("cuda"), {"src": src, "card": smi})
    return 0


if __name__ == "__main__":
    sys.exit(main())
