#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

Run from the root of a checkout, on a machine with one CUDA card and the
CUDA toolkit:

    python3 chip_smoke.py

Phases; any failure raises and the script exits non-zero without the
result line:

1. environment: a CUDA card is required; prints its name and power
   limit; TF32 is switched off so the plain versions run in full float32;
2. build: every kernel under ``src/repro_torch/kernels/csrc`` is compiled
   with ``nvcc`` (one process per source, in parallel);
3. kernel vs plain version on the card, at the main path's shapes, in
   two drive modes, and at a width whose weights need more than 48 KB of
   shared memory; error relative to each trajectory's peak <= 1e-4;
4. the main path: a seeded He-init Lorenz96 twin is saved with the
   port's ``save_twin`` and served by ``serve_fleet`` on the ``fused_cuda``
   backend, 2 request batches of 1024 twins x 200 RK4 steps; launch
   counts are zeroed just before and read just after; the result is held
   against the same requests served on the digital backend (<= 1e-4);
5. timing with CUDA events: kernel, plain version, and the card's bound.

The second-to-last line is the ``{"kernels": [...]}`` JSON record, the
last line ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.core.backends import DigitalBackend, FusedCudaBackend  # noqa: E402
from repro_torch.core.node import mlp_init  # noqa: E402
from repro_torch.kernels import _build, fused_ode_mlp, ref  # noqa: E402
from repro_torch.launch.fleet_serving import serve_fleet  # noqa: E402
from repro_torch.train import checkpoint, recipes  # noqa: E402

TOL = 1e-4          # kernel vs plain, fused vs digital: of the peak |y|
SEED = 0

# The H100 SXM's published peaks (NVIDIA data sheet, 700 W): FP32 without
# tensor cores, and device-memory bandwidth.  The bound uses them whatever
# the power limit printed beside it.
FP32_PEAK = 67.0e12
HBM_BW = 3.35e12


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def rel_err(a: torch.Tensor, b: torch.Tensor):
    """(max |a - b|, that over max |b|)."""
    abs_err = float((a - b).abs().max())
    return abs_err, abs_err / float(b.abs().max())


def make_case(gen, sizes, B, T, du_mode, device):
    """Seeded He-init weights with random biases, y0 and a drive."""
    params = mlp_init(gen, sizes, device=device)
    for p in params:
        p["b"] = (0.1 * torch.randn(p["b"].shape, generator=gen)).to(device)
    D = sizes[-1]
    y0 = (0.5 * torch.randn((B, D), generator=gen)).to(device)
    th = torch.arange(2 * T + 1, dtype=torch.float64) / (2 * T)
    if du_mode == "none":
        u = torch.zeros((2 * T + 1, 0))
    elif du_mode == "shared":
        u = torch.sin(2 * torch.pi * 2.0 * th)[:, None]
    else:
        amp = 0.5 + torch.rand((B, 1), generator=gen, dtype=torch.float64)
        freq = 1.0 + 3.0 * torch.rand((B, 1), generator=gen,
                                      dtype=torch.float64)
        u = (amp * torch.sin(2 * torch.pi * freq * th[None, :]))[..., None]
    return params, y0, u.to(torch.float32).to(device)


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main() -> int:
    # -- 1. environment ----------------------------------------------------
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs a CUDA card", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    print(smi)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    print("TF32 off: matmul.allow_tf32=False, cudnn.allow_tf32=False, "
          "float32_matmul_precision='highest'")
    dev = torch.device("cuda")
    name = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; {name}; "
          f"bounds against H100 SXM peaks: {FP32_PEAK / 1e12:g} TFLOP/s "
          f"fp32, {HBM_BW / 1e12:g} TB/s")

    # -- 2. build ------------------------------------------------------------
    t0 = time.perf_counter()
    libs = _build.build()
    print(f"build: {len(libs)} kernel source(s) in "
          f"{time.perf_counter() - t0:.2f} s")
    for src, log in _build.BUILD_LOGS.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                print(f"  {src}: {line.strip()}")

    # -- 3. kernel vs plain version -------------------------------------------
    gen = torch.Generator().manual_seed(SEED)
    cases = {
        "l96_autonomous": ((6, 64, 64, 6), 1024, 200, "none", 0.0025),
        "hp_shared_drive": ((2, 14, 14, 1), 64, 500, "shared", 1e-3),
        "hp_per_twin_drive_B100": ((2, 14, 14, 1), 100, 200, "per_twin",
                                   1e-3),
        # 73 KB of weights: past the 48 KB static limit, so the launch
        # raises the block's dynamic shared-memory allowance first
        "wide_h128_over_48KB": ((6, 128, 128, 6), 256, 50, "none", 0.0025),
    }
    errs, inputs = {}, {}
    for case, (sizes, B, T, mode, dt) in cases.items():
        params, y0, u = make_case(gen, sizes, B, T, mode, dev)
        ws = [p["w"] for p in params]
        bs = [p["b"] for p in params]
        y0p, up, bt, _ = fused_ode_mlp.pad_fleet_to_tile(y0, u, 64)
        got = fused_ode_mlp.fused_node_rollout(y0p, up, ws, bs, dt,
                                               batch_tile=bt)[:, :B]
        want = ref.fused_node_rollout_ref(y0, u, ws, bs, dt)
        torch.cuda.synchronize()
        check(got.shape == (T + 1, B, sizes[-1]), f"{case}: shape {got.shape}")
        check(bool(torch.isfinite(got).all()), f"{case}: non-finite output")
        a, r = rel_err(got, want)
        errs[case] = (a, r)
        inputs[case] = (y0p, up, ws, bs, dt, bt, sizes, B, T)
        print(f"kernel vs plain [{case}] B={B} T={T} sizes={sizes}: "
              f"max abs err {a:.3e}, of peak {r:.3e} (limit {TOL:g})")
        check(r <= TOL, f"{case}: kernel disagrees with its plain version")

    # -- 4. the main path ------------------------------------------------------
    cfg = recipes.FLEET
    fleet = recipes.make_l96_fleet(
        backend=FusedCudaBackend(batch_tile=cfg.batch_tile))
    ts = recipes.l96_fleet_ts()
    n_batches = 2
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ckpt_") as ckpt:
        params = fleet.twin.init(torch.Generator().manual_seed(SEED),
                                 device="cpu")
        checkpoint.save_twin(ckpt, params)

        fused_ode_mlp.LAUNCHES = 0
        outs, times = [], []
        stream = serve_fleet(ckpt, fleet, ts, recipes.l96_fleet_requests(
            num_batches=n_batches, seed=SEED, device=dev), device=dev)
        while True:
            t_b = time.perf_counter()
            out = next(stream, None)
            torch.cuda.synchronize()
            if out is None:
                break
            times.append(time.perf_counter() - t_b)
            outs.append(out)
        launches = fused_ode_mlp.LAUNCHES

        want_shape = (cfg.fleet_size, cfg.horizon + 1, cfg.state_dim)
        check(len(outs) == n_batches, f"served {len(outs)} batches")
        for i, (o, s) in enumerate(zip(outs, times)):
            check(tuple(o.shape) == want_shape, f"batch {i}: shape {o.shape}")
            check(bool(torch.isfinite(o).all()), f"batch {i}: non-finite")
            print(f"main path batch {i}: {tuple(o.shape)} in {s * 1e3:.3f} ms "
                  f"({cfg.fleet_size * cfg.horizon / s:,.0f} twin-steps/s)")
        print(f"main path: fused_node_rollout launches = {launches} "
              f"for {n_batches} request batches")
        check(launches == n_batches,
              f"expected {n_batches} kernel launches, counted {launches}")

        digital = list(serve_fleet(
            ckpt, fleet.with_backend(DigitalBackend()), ts,
            recipes.l96_fleet_requests(num_batches=n_batches, seed=SEED,
                                       device=dev), device=dev))
        torch.cuda.synchronize()
        for i, (o, d) in enumerate(zip(outs, digital)):
            a, r = rel_err(o, d)
            print(f"main path batch {i}: fused vs digital max abs err "
                  f"{a:.3e}, of peak {r:.3e} (limit {TOL:g})")
            check(r <= TOL, f"batch {i}: fused_cuda disagrees with digital")

    # -- 5. timing ---------------------------------------------------------------
    y0p, up, ws, bs, dt, bt, sizes, B, T = inputs["l96_autonomous"]
    kernel_ms = cuda_ms(lambda: fused_ode_mlp.fused_node_rollout(
        y0p, up, ws, bs, dt, batch_tile=bt), reps=20, warmup=3)
    plain_ms = cuda_ms(lambda: ref.fused_node_rollout_ref(
        y0p, up, ws, bs, dt), reps=5, warmup=1)
    macs = sum(a * b for a, b in zip(sizes[:-1], sizes[1:]))
    flops = 2 * macs * 4 * T * B
    nbytes = 4 * (y0p.numel() + up.numel() + sum(w.numel() for w in ws)
                  + sum(b.numel() for b in bs) + (T + 1) * B * sizes[-1])
    t_ops, t_bytes = flops / FP32_PEAK * 1e3, nbytes / HBM_BW * 1e3
    bound_ms = max(t_ops, t_bytes)
    bound_by = "operations" if t_ops >= t_bytes else "bytes"
    print(f"[{smi}] K1 fused_node_rollout B={B} T={T} sizes={sizes}: "
          f"kernel_ms {kernel_ms:.4f}, plain_ms {plain_ms:.4f}, "
          f"bound_ms {bound_ms:.4f} ({bound_by}: {flops / 1e9:.3f} GFLOP, "
          f"{nbytes / 1e6:.3f} MB), launches per request 1, "
          f"library_ms n/a (no single PyTorch call computes an RK4 rollout)")

    record = {"kernels": [{
        "name": "fused_node_rollout",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/fused_ode_mlp.cu",
        "replaces": "src/repro/kernels/fused_ode_mlp.py:390",
        "launches": launches,
        "max_abs_err": errs["l96_autonomous"][0],
        "max_rel_err_of_peak": errs["l96_autonomous"][1],
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
    }]}
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
