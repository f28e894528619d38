#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

Run from the root of a checkout, on a machine with one CUDA card and the
CUDA toolkit:

    python3 chip_smoke.py

Phases; any failure raises and the script exits non-zero without the
result line:

1. environment: a CUDA card is required; prints its name and power
   limit; TF32 is switched off so the plain versions run in full float32;
2. build: every kernel under ``src/repro_torch/kernels/csrc`` (K1, K2) is
   compiled with ``nvcc`` (one process per source, in parallel), with
   ptxas's registers and spills printed;
3. K1 vs its plain version on the card, at the serving path's shapes,
   in two drive modes, and at a width whose weights need more than 48 KB
   of shared memory; error relative to each trajectory's peak <= 1e-4;
4. the serving path: a seeded He-init Lorenz96 twin is saved with the
   port's ``save_twin`` and served by ``serve_fleet`` on the ``fused_cuda``
   backend, 2 request batches of 1024 twins x 200 RK4 steps; launch
   counts are zeroed just before and read just after; the result is held
   against the same requests served on the digital backend (<= 1e-4);
5. K1 timing with CUDA events: kernel, plain version, and the card's
   bound;
6. K2 vs its plain version on the card at the Lorenz96 training shapes
   (paper and CI windows), the HP training shape (per-twin drive), the
   fleet shape and the 128-wide case; each gradient within 1e-4 of its
   peak, and two calls bitwise identical;
7. the training paths, each with the K1 and K2 counts zeroed just before
   and read just after: ``train_hp_twin(200, 250, "fused_cuda")`` to the
   HP gates of ``tests/test_twins.py``; 40 HP steps on fused_cuda vs the
   digital adjoint (loss histories <= 1e-3 rel); ``train_l96_twin`` at
   the CI budget to the Lorenz96 gates; gradient steps per second of
   each trajectory phase;
8. K2 timing with CUDA events at the Lorenz96 training and fleet shapes:
   kernel, plain version (autograd through ``fused_node_rollout_ref``)
   and the card's bound.

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
from repro_torch.core.twin import make_driven_twin  # noqa: E402
from repro_torch.data import hp_memristor as hp  # noqa: E402
from repro_torch.kernels import _build, fused_ode_mlp, fused_ode_mlp_bwd, ref  # noqa: E402
from repro_torch.launch.fleet_serving import serve_fleet  # noqa: E402
from repro_torch.train import checkpoint, recipes, trainer  # noqa: E402
from repro_torch.train.optimizer import adam  # noqa: E402

TOL = 1e-4          # kernel vs plain, fused vs digital: of the peak |y|
HIST_TOL = 1e-3     # fused vs digital-adjoint loss history, rel per step
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


def k2_bound(sizes, B, T, u):
    """(bound_ms, bound_by, GFLOP, MB) of one K2 call: per twin-step the
    four stages' forward recompute, weight-gradient and input-cotangent
    products (the last only for the y columns of layer 0); the bytes of
    the trajectory, drive, cotangent and weights read once, and of dy0
    and the gradients written once."""
    pairs = list(zip(sizes[:-1], sizes[1:]))
    macs = sum(a * b for a, b in pairs)
    P = sum(a * b + b for a, b in pairs)
    D, du = sizes[-1], u.shape[-1]
    flops = 4 * 2 * (3 * macs - du * sizes[1]) * B * T
    nbytes = 4 * (2 * (T + 1) * B * D + u.numel() + 2 * P + B * D)
    t_ops, t_bytes = flops / FP32_PEAK * 1e3, nbytes / HBM_BW * 1e3
    return (max(t_ops, t_bytes), "operations" if t_ops >= t_bytes
            else "bytes", flops / 1e9, nbytes / 1e6)


def grads_rel_err(got, want):
    """Max abs error and error over the peak, per gradient of
    (dy0, dweights, dbiases), and their worst."""
    pairs = list(zip([got[0], *got[1], *got[2]],
                     [want[0], *want[1], *want[2]]))
    abs_errs = [float((a - b).abs().max()) for a, b in pairs]
    rels = [e / float(b.abs().max()) for e, (_, b) in zip(abs_errs, pairs)]
    return max(abs_errs), max(rels), rels


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

    # -- 6. K2 vs plain version -------------------------------------------------
    k2_cases = {
        # the Lorenz96 training shape (paper window: 29 segments of 60)
        "l96_train_autonomous": ((6, 64, 64, 6), 29, 60, "none", 0.0025),
        # the shape phase 7's Lorenz96 training launches (CI window: 14
        # segments of 60)
        "l96_train_ci_autonomous": ((6, 64, 64, 6), 14, 60, "none", 0.0025),
        # the HP training shape: 9 segments of 50, one drive per segment
        "hp_train_per_twin_drive": ((2, 14, 14, 1), 9, 50, "per_twin",
                                    1e-3),
        "fleet_l96": ((6, 64, 64, 6), 1024, 200, "none", 0.0025),
        "wide_h128": ((6, 128, 128, 6), 64, 50, "none", 0.0025),
    }
    k2_errs, k2_inputs = {}, {}
    for case, (sizes, B, T, mode, dt) in k2_cases.items():
        params, y0, u = make_case(gen, sizes, B, T, mode, dev)
        ws = [p["w"] for p in params]
        bs = [p["b"] for p in params]
        try:
            need = fused_ode_mlp_bwd.smem_bytes_bwd(sizes)
        except ValueError as e:
            print(f"K2 [{case}] sizes={sizes}: refused: {e}")
            continue
        traj = fused_ode_mlp.fused_node_rollout(y0, u, ws, bs, dt,
                                                batch_tile=B)
        g = torch.randn(traj.shape, generator=gen).to(dev)
        got = fused_ode_mlp_bwd.fused_node_rollout_bwd(traj, u, ws, bs, g, dt)
        again = fused_ode_mlp_bwd.fused_node_rollout_bwd(traj, u, ws, bs, g,
                                                         dt)
        want = ref.fused_node_rollout_bwd_ref(traj, u, ws, bs, g, dt)
        torch.cuda.synchronize()
        for x in [got[0], *got[1], *got[2]]:
            check(bool(torch.isfinite(x).all()), f"K2 {case}: non-finite")
        a, r, rels = grads_rel_err(got, want)
        bitwise = all(torch.equal(x, y) for x, y in zip(
            [got[0], *got[1], *got[2]], [again[0], *again[1], *again[2]]))
        k2_errs[case] = (a, r)
        k2_inputs[case] = (traj, u, ws, bs, g, dt, sizes, B, T)
        print(f"K2 vs plain [{case}] B={B} T={T} sizes={sizes} "
              f"smem={need} B: max abs err {a:.3e}, worst of peak {r:.3e} "
              f"(limit {TOL:g}; per gradient "
              f"{', '.join(f'{x:.1e}' for x in rels)}); repeat bitwise "
              f"identical: {bitwise}")
        check(r <= TOL, f"K2 {case}: kernel disagrees with its plain version")
        check(bitwise, f"K2 {case}: two calls differ")

    # -- 7. the training paths ---------------------------------------------------
    phases = []             # (path, steps, seconds) per trajectory phase
    path = [""]
    train_twin = trainer.train_twin

    def timed_train_twin(*args, **kw):
        torch.cuda.synchronize()
        t_p = time.perf_counter()
        out = train_twin(*args, **kw)
        torch.cuda.synchronize()
        phases.append((path[0], kw["num_steps"], time.perf_counter() - t_p))
        return out

    def reset_counts(phase):
        path[0] = phase
        fused_ode_mlp.LAUNCHES = 0
        fused_ode_mlp_bwd.LAUNCHES = 0

    def read_counts(phase, steps):
        counts = (fused_ode_mlp.LAUNCHES, fused_ode_mlp_bwd.LAUNCHES)
        print(f"{phase}: K1 launches {counts[0]}, K2 launches {counts[1]} "
              f"for {steps} fused gradient steps")
        check(counts == (steps, steps),
              f"{phase}: expected {steps} K1 and K2 launches, got {counts}")
        return counts

    trainer.train_twin = timed_train_twin
    try:
        reset_counts("train_hp_twin")
        twin, params, loss = recipes.train_hp_twin(
            pretrain_steps=200, train_steps=250, backend="fused_cuda",
            device=dev)
        torch.cuda.synchronize()
        hp_counts = read_counts("train_hp_twin", 250)
        print(f"train_hp_twin: final loss {loss:.6f} (gate < 0.01)")
        check(loss < 0.01, "HP twin: final loss over the 0.01 gate")
        for wf in ("sine", "triangular", "rectangular", "modulated_sine"):
            m = recipes.eval_hp_twin(twin, params, wf, device=dev)
            gate = 0.1 if wf == "sine" else 0.25
            print(f"  HP {wf:15s} MRE {m['mre']:.4f} (gate < {gate}), "
                  f"DTW/pt {m['dtw']:.6f}")
            check(m["mre"] < gate, f"HP twin: {wf} MRE over its gate")
        m = recipes.eval_hp_twin(twin, params, "sine", device=dev,
                                 backend=FusedCudaBackend(batch_tile=1))
        print(f"  HP sine served on fused_cuda: MRE {m['mre']:.4f}")

        # the same 40 steps on the two substrates, from the same weights
        ts, xs, _, _ = hp.generate("sine", num_points=500, dt=1e-3,
                                   amp=recipes.HP_AMP, freq=recipes.HP_FREQ,
                                   device=dev)
        twin40 = make_driven_twin(1, hp.WAVEFORMS["sine"](
            amp=recipes.HP_AMP, freq=recipes.HP_FREQ), hidden=14)
        p0 = twin40.init(torch.Generator().manual_seed(42), device=dev)
        hists = {}
        for substrate, be in (("fused_cuda", "fused_cuda"),
                              ("digital", None)):
            path[0] = f"hp_40_steps_{substrate}"
            _, hists[substrate] = trainer.train_twin(
                twin40, p0, ts, xs[:, None], optimizer=adam(1e-3),
                num_steps=40, segment_len=50, loss="l1", noise_std=0.002,
                generator=torch.Generator().manual_seed(1), backend=be)
        hist_rel = float(((hists["fused_cuda"] - hists["digital"]).abs()
                          / hists["digital"].abs()).max())
        print(f"HP 40 steps, fused_cuda vs digital adjoint: loss "
              f"{float(hists['fused_cuda'][0]):.6f} -> "
              f"{float(hists['fused_cuda'][-1]):.6f}, max rel diff "
              f"{hist_rel:.3e} (limit {HIST_TOL:g})")
        check(hist_rel <= HIST_TOL, "fused vs digital loss histories differ")

        data = recipes.l96_data(num_points=1200, device=dev)
        reset_counts("train_l96_twin")
        l96_twin, l96_params = recipes.train_l96_twin(
            pretrain_steps=1500, train_steps=((60, 300, 1e-3),), data=data,
            backend="fused_cuda", device=dev)
        torch.cuda.synchronize()
        l96_counts = read_counts("train_l96_twin", 300)
    finally:
        trainer.train_twin = train_twin
    m = recipes.eval_l96_twin(l96_twin, l96_params, data=data)
    l96_ts, l96_ys, split = data
    with torch.no_grad():
        pred = l96_twin.simulate(l96_params, l96_ys[split - 1],
                                 l96_ts[split - 1:split + 199])
    short = float((pred[1:] - l96_ys[split:split + 199]).abs().mean())
    print(f"train_l96_twin: interpolation L1 {m['interp_l1']:.4f} "
          f"(gate < 0.3), extrapolation L1 over 199 steps {short:.4f} "
          f"(gate < 0.5), over the whole test window {m['extrap_l1']:.4f}")
    check(m["interp_l1"] < 0.3, "L96 twin: interpolation over its gate")
    check(short < 0.5, "L96 twin: short-horizon extrapolation over its gate")
    for phase, steps, sec in phases:
        print(f"[{smi}] trajectory phase {phase}: {steps} gradient steps in "
              f"{sec:.3f} s = {steps / sec:.2f} steps/s")

    # -- 8. K2 timing --------------------------------------------------------------
    k2_times = {}
    for case in ("l96_train_autonomous", "fleet_l96"):
        traj, u, ws, bs, g, dt, sizes, B, T = k2_inputs[case]
        k_ms = cuda_ms(lambda: fused_ode_mlp_bwd.fused_node_rollout_bwd(
            traj, u, ws, bs, g, dt), reps=20, warmup=3)
        y0r = traj[0].clone().requires_grad_()
        wr = [w.clone().requires_grad_() for w in ws]
        br = [b.clone().requires_grad_() for b in bs]
        out = ref.fused_node_rollout_ref(y0r, u, wr, br, dt)
        p_ms = cuda_ms(lambda: torch.autograd.grad(
            out, [y0r, *wr, *br], g, retain_graph=True), reps=5, warmup=1)
        b_ms, b_by, gflop, mb = k2_bound(sizes, B, T, u)
        k2_times[case] = (k_ms, p_ms, b_ms, b_by)
        print(f"[{smi}] K2 fused_node_rollout_bwd [{case}] B={B} T={T} "
              f"sizes={sizes}: kernel_ms {k_ms:.4f}, plain_ms {p_ms:.4f} "
              f"(autograd through fused_node_rollout_ref), bound_ms "
              f"{b_ms:.4f} ({b_by}: {gflop:.3f} GFLOP, {mb:.3f} MB), "
              f"launches per call 2 (sweep + reduction), library_ms n/a "
              f"(no single PyTorch call computes this VJP)")

    k1_paths = {"serve_fleet": launches, "train_hp_twin": hp_counts[0],
                "train_l96_twin": l96_counts[0]}
    k2_paths = {"train_hp_twin": hp_counts[1],
                "train_l96_twin": l96_counts[1]}
    k_ms, p_ms, b_ms, b_by = k2_times["l96_train_autonomous"]
    fk_ms, fp_ms, fb_ms, fb_by = k2_times["fleet_l96"]
    record = {"kernels": [{
        "name": "fused_node_rollout",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/fused_ode_mlp.cu",
        "replaces": "src/repro/kernels/fused_ode_mlp.py:390",
        "launches": sum(k1_paths.values()),
        "launches_by_path": k1_paths,
        "max_abs_err": errs["l96_autonomous"][0],
        "max_rel_err_of_peak": errs["l96_autonomous"][1],
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
    }, {
        "name": "fused_node_rollout_bwd",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/fused_ode_mlp_bwd.cu",
        "replaces": "src/repro/kernels/fused_ode_mlp_bwd.py:210",
        "launches": sum(k2_paths.values()),
        "launches_by_path": k2_paths,
        "shape": "l96_train_autonomous B=29 T=60 6-64-64-6",
        "max_abs_err": k2_errs["l96_train_autonomous"][0],
        "max_rel_err_of_peak": k2_errs["l96_train_autonomous"][1],
        "ms": k_ms,
        "plain_ms": p_ms,
        "bound_ms": b_ms,
        "bound_by": b_by,
        "library_ms": None,
        "fleet_shape": {"B": 1024, "T": 200, "ms": fk_ms,
                        "plain_ms": fp_ms, "bound_ms": fb_ms,
                        "bound_by": fb_by,
                        "max_rel_err_of_peak": k2_errs["fleet_l96"][1]},
    }]}
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
