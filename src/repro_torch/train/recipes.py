"""Experiment recipes (port of ``repro/train/recipes.py``).

The HP-memristor twin (paper Fig. 3) and the Lorenz96 twin (Fig. 4):
ground truth, derivative-matching warm start, multiple-shooting
trajectory training on a chosen substrate (``backend="fused_cuda"``
trains through the hand-written kernels K1 and K2; ``hw_aware=`` trains
through the analogue write path, K3), and the paper's
evaluation protocols and the Lorenz96 system's Lyapunov time; the
paper's digital baselines (the recurrent ResNet of Fig. 3j, the LSTM /
GRU / RNN forecasters of Fig. 4g); the analogue noise-robustness grid
(Fig. 4j); plus the Lorenz96 fleet-serving scenario.  Each recipe takes
``device=`` (default ``cuda``; ``"cpu"`` runs the kernels' plain
versions) and draws from ``torch.Generator``s seeded from ``seed``, so
the port's weights are not the JAX package's for the same seed.

CLI (``--device cpu`` runs the kernels' plain versions):

  PYTHONPATH=src python -m repro_torch.train.recipes --twin hp --device cpu
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from repro_torch.configs.lorenz96_twin import FLEET
from repro_torch.core.analogue import AnalogueSpec
from repro_torch.core.backends import (AnalogueBackend,
                                       FusedAnalogueCudaBackend,
                                       FusedCudaBackend, resolve_backend)
from repro_torch.core.losses import (dtw, l1, lyapunov_time,
                                     max_lyapunov_exponent, mre)
from repro_torch.core.twin import (TwinFleet, make_autonomous_twin,
                                   make_driven_twin, reference_trajectory)
from repro_torch.data import hp_memristor as hp
from repro_torch.data import lorenz96 as l96
from repro_torch.device import resolve_device
from repro_torch.train import trainer
from repro_torch.train.optimizer import adam, warmup_cosine_schedule

HP_AMP, HP_FREQ = 2.0, 2.0
L96_DT = 0.0025


# ---------------------------------------------------------------------------
# HP memristor twin (paper Fig. 3)
# ---------------------------------------------------------------------------

def train_hp_twin(seed: int = 42, pretrain_steps: int = 400,
                  train_steps: int = 600, hidden: int = 14,
                  backend=None, hw_aware=None, device=None):
    """Train the HP twin on the sine drive (paper Methods: 500 pts, 1e-3 s).

    ``backend``: training substrate for the trajectory phase (Backend
    instance or registry name); ``"fused_cuda"`` trains on the serving
    substrate, K1 forward and K2 backward.  The derivative-matching warm
    start evaluates the bare field and stays digital.  ``hw_aware``: an
    optional :class:`repro_torch.train.hw_aware.HwAwareConfig`; the
    trajectory phase then trains through the analogue write path, the warm
    start stays clean.  Returns ``(twin, params, final loss)``."""
    device = resolve_device(device)
    ts, xs, _, _ = hp.generate("sine", num_points=500, dt=1e-3,
                               amp=HP_AMP, freq=HP_FREQ, device=device)
    ys = xs[:, None]
    twin = make_driven_twin(1, hp.WAVEFORMS["sine"](amp=HP_AMP, freq=HP_FREQ),
                            hidden=hidden)
    params = twin.init(torch.Generator().manual_seed(seed), device=device)
    params, _ = trainer.pretrain_derivatives(
        twin.field, params, ts, ys, optimizer=adam(1e-2),
        num_steps=pretrain_steps)
    params, hist = trainer.train_twin(
        twin, params, ts, ys,
        optimizer=adam(warmup_cosine_schedule(3e-3, 50, train_steps)),
        num_steps=train_steps, segment_len=50, loss="l1", noise_std=0.002,
        generator=torch.Generator().manual_seed(seed + 1), backend=backend,
        hw_aware=hw_aware)
    return twin, params, float(hist[-1])


def hp_waveform_config(waveform: str) -> dict:
    if waveform == "modulated_sine":
        return dict(amp=HP_AMP, freq=2 * HP_FREQ)
    return dict(amp=HP_AMP, freq=HP_FREQ)


def eval_hp_twin(twin, params, waveform: str, num_points: int = 500,
                 backend=None, device=None):
    """MRE + DTW of the twin's state trajectory vs ground truth on a drive
    it was NOT trained on (except sine).  ``backend``: optional execution
    substrate for the same trained weights (default: the twin's own)."""
    kw = hp_waveform_config(waveform)
    ts, xw, _, _ = hp.generate(waveform, num_points=num_points, dt=1e-3,
                               device=device, **kw)
    drive = hp.WAVEFORMS[waveform](**kw)
    field_w = dataclasses.replace(twin.field, drive=drive)
    node_w = dataclasses.replace(twin.node, field=field_w)
    if backend is not None:
        node_w = dataclasses.replace(node_w, backend=resolve_backend(backend))
    with torch.no_grad():
        pred = node_w.trajectory(params, xw[:1], ts)[:, 0]
        return {"mre": float(mre(pred, xw)),
                "dtw": float(dtw(pred, xw) / num_points),
                "pred": pred, "true": xw, "ts": ts}


def hp_backend_matrix(twin, params, waveform: str = "sine",
                      analogue_spec: AnalogueSpec = AnalogueSpec(),
                      seed: int = 0, device=None) -> dict:
    """The substrate-portability claim as numbers: the same trained
    weights evaluated on every backend, MRE vs ground truth each time:
    ``digital``, ``fused_cuda`` (K1) and ``analogue`` (the crossbar
    simulator, programmed from a generator seeded with ``seed``)."""
    backends = {
        "digital": None,
        "fused_cuda": FusedCudaBackend(batch_tile=1),
        "analogue": AnalogueBackend(spec=analogue_spec, prog_seed=seed),
    }
    return {name: eval_hp_twin(twin, params, waveform, backend=b,
                               device=device)["mre"]
            for name, b in backends.items()}


def train_hp_resnet(seed: int = 42, train_steps: int = 600,
                    hidden: int = 14, device=None):
    """The paper's digital baseline: the recurrent ResNet at the twin's
    sizes, trained on the sine drive in teacher-forced segments of 50.
    Returns ``(model, params, final loss)``."""
    from repro_torch.models.baselines import RecurrentResNet
    device = resolve_device(device)
    ts, xs, vs, _ = hp.generate("sine", num_points=500, dt=1e-3,
                                amp=HP_AMP, freq=HP_FREQ, device=device)
    model = RecurrentResNet(sizes=(2, hidden, hidden, 1), state_dim=1)
    params = model.init(torch.Generator().manual_seed(seed), device=device)
    params, hist = trainer.train_recurrent_resnet(
        model, params, vs[:, None], xs[:, None],
        optimizer=adam(warmup_cosine_schedule(3e-3, 50, train_steps)),
        num_steps=train_steps, segment_len=50)
    return model, params, float(hist[-1])


def eval_hp_resnet(model, params, waveform: str, num_points: int = 500,
                   device=None):
    """MRE + DTW per point of the ResNet's closed-loop rollout under a
    drive vs the ground truth (paper Fig. 3j's baseline column)."""
    kw = hp_waveform_config(waveform)
    ts, xw, _, _ = hp.generate(waveform, num_points=num_points, dt=1e-3,
                               device=device, **kw)
    drive = hp.WAVEFORMS[waveform](**kw)
    us = drive(ts)[:-1, None]
    with torch.no_grad():
        pred = model.rollout(params, xw[:1], us)[:, 0]
    return {"mre": float(mre(pred, xw)),
            "dtw": float(dtw(pred, xw) / num_points)}


# ---------------------------------------------------------------------------
# Lorenz96 twin (paper Fig. 4)
# ---------------------------------------------------------------------------

def l96_data(num_points: int = 2400, dt: float = L96_DT, device=None):
    """Normalised Lorenz96 ground truth: (ts, ys, split)."""
    ts, ys_raw, split = l96.generate(num_points=num_points, dt=dt,
                                     device=device)
    ys, _, _ = l96.normalize(ys_raw)
    return ts, ys, split


def train_l96_twin(seed: int = 7, pretrain_steps: int = 5000,
                   train_steps: tuple = ((60, 600, 1e-3), (200, 600, 4e-4)),
                   hidden: int = 64, tube_noise: float = 0.03,
                   data=None, backend=None, hw_aware=None, device=None):
    """Noisy-tube derivative pretraining + multiple-shooting curriculum.

    ``train_steps``: ``(segment_len, steps, peak lr)`` per phase.
    ``backend``: trajectory-phase training substrate (see
    :func:`repro_torch.train.trainer.segment_loss_fn`).  ``hw_aware``: an
    optional :class:`repro_torch.train.hw_aware.HwAwareConfig`; the
    curriculum phases train through the analogue write path.  Returns
    ``(twin, params)``."""
    device = resolve_device(device)
    ts, ys, split = data if data is not None else l96_data(device=device)
    ts_tr, ys_tr = ts[:split], ys[:split]
    twin = make_autonomous_twin(6, hidden=hidden)
    params = twin.init(torch.Generator().manual_seed(seed), device=device)

    tsm, ysm, dys = trainer.finite_difference_derivatives(ts_tr, ys_tr)

    def pre_loss(p, generator):
        noise = tube_noise * trainer.normal_like(generator, ysm)
        preds = twin.field(tsm, ysm + noise, p)
        return torch.mean(torch.abs(preds - dys))

    params, _ = trainer.fit(
        pre_loss, params,
        adam(warmup_cosine_schedule(5e-3, 100, pretrain_steps),
             weight_decay=1e-4),
        pretrain_steps, generator=torch.Generator().manual_seed(seed + 1))

    for seg, steps, lr in train_steps:
        params, _ = trainer.train_twin(
            twin, params, ts_tr, ys_tr,
            optimizer=adam(warmup_cosine_schedule(lr, 50, steps),
                           weight_decay=1e-4),
            num_steps=steps, segment_len=seg, loss="l1", noise_std=0.02,
            generator=torch.Generator().manual_seed(seed + 2),
            backend=backend, hw_aware=hw_aware)
    return twin, params


def eval_l96_twin(twin, params, data=None, device=None):
    """Paper protocol: interpolation = closed loop from t=0 over the
    training window; extrapolation = forecast from the observation-synced
    state at the train/test split."""
    ts, ys, split = data if data is not None else l96_data(device=device)
    with torch.no_grad():
        pred_i = twin.simulate(params, ys[0], ts[:split])
        interp = float(l1(pred_i, ys[:split]))
        pred_x = twin.simulate(params, ys[split - 1], ts[split - 1:])
        extrap = float(l1(pred_x[1:], ys[split:]))
    return {"interp_l1": interp, "extrap_l1": extrap,
            "pred_extrap": pred_x[1:], "true_extrap": ys[split:]}


def eval_l96_baseline(cell: str, seed: int = 3, train_steps: int = 2500,
                      hidden: int = 64, data=None, device=None) -> dict:
    """A recurrent forecaster (``cell``: "lstm", "gru" or "rnn") trained
    teacher-forced on the training window, evaluated by the twin's
    protocol: interpolation = closed loop from the first point over the
    window; extrapolation = closed loop from the split after the window
    warms the carry up.  Returns ``interp_l1`` and ``extrap_l1``."""
    from repro_torch.models.baselines import RecurrentForecaster
    device = resolve_device(device)
    ts, ys, split = data if data is not None else l96_data(device=device)
    model = RecurrentForecaster(cell=cell, in_dim=6, hidden=hidden,
                                out_dim=6)
    params = model.init(torch.Generator().manual_seed(seed), device=device)
    params, _ = trainer.train_forecaster(
        model, params, ys[:split],
        optimizer=adam(warmup_cosine_schedule(3e-3, 100, train_steps)),
        num_steps=train_steps, noise_std=0.01,
        generator=torch.Generator().manual_seed(seed + 1))
    with torch.no_grad():
        interp = model.closed_loop(params, ys[0], split - 1)
        e_i = float(l1(interp, ys[:split]))
        extrap = model.closed_loop(params, ys[split - 1],
                                   ys.shape[0] - split,
                                   warmup=ys[:split - 1])
        e_x = float(l1(extrap[1:], ys[split:]))
    return {"interp_l1": e_i, "extrap_l1": e_x}


def l96_lyapunov_info(device=None) -> dict:
    """The maximal Lyapunov exponent of the paper's Lorenz96 system
    (F = 8) and its Lyapunov time: 4,000 RK4 steps of 0.0025 onto the
    attractor (500 points of 0.02, 8 steps each), then the tangent
    rescaling method over 20,000 steps of 0.01, renormalised every 20,
    from a start direction drawn by a CPU generator seeded with 0.
    Returns ``{"mle": float, "lyapunov_time": float}``.

    Runs in float64, where the JAX package runs float32: a perturbation
    of eps = 1e-6 is one or two ulp of a float32 state of size ~5, so in
    float32 the estimate measures rounding noise (or, when the perturbed
    state rounds onto the state, collapses for good)."""
    device = resolve_device(device)
    f = l96.lorenz96_field(8.0)
    f64 = torch.float64
    y0 = torch.tensor(l96.PAPER_Y0, dtype=f64, device=device)
    ts = torch.arange(500, dtype=f64, device=device) * 0.02
    with torch.no_grad():
        ys = reference_trajectory(f, y0, ts, steps_per_interval=8)
    mle = max_lyapunov_exponent(f, ys[-1], None, dt=0.01, num_steps=20000,
                                renorm_every=20)
    return {"mle": float(mle), "lyapunov_time": float(lyapunov_time(mle))}


# ---------------------------------------------------------------------------
# Analogue deployment + noise robustness (paper Fig. 4j)
# ---------------------------------------------------------------------------

def noise_robustness_grid(twin, params, read_noises, prog_noises,
                          data=None, repeats: int = 3, seed: int = 0,
                          device=None):
    """L1 extrapolation error of the twin deployed on ``AnalogueBackend``
    under each (read, programming) noise combination, averaged over
    ``repeats`` programmings (generator seeds ``seed + 101 r`` and read
    seeds ``seed + 13 r + 1``, as the JAX package folds its keys)."""
    ts, ys, split = data if data is not None else l96_data(device=device)
    rows = []
    for pn in prog_noises:
        for rn in read_noises:
            errs = []
            for r in range(repeats):
                backend = AnalogueBackend(
                    spec=AnalogueSpec(prog_noise=pn, read_noise=rn),
                    prog_seed=seed + 101 * r, read_seed=seed + 13 * r + 1)
                with torch.no_grad():
                    pred = twin.with_backend(backend).simulate(
                        params, ys[split - 1], ts[split - 1:])
                errs.append(float(l1(pred[1:], ys[split:])))
            rows.append({"prog_noise": pn, "read_noise": rn,
                         "extrap_l1": sum(errs) / len(errs)})
    return rows


# ---------------------------------------------------------------------------
# Lorenz96 fleet serving (the multi-asset scale-up scenario)
# ---------------------------------------------------------------------------

#: The fused substrates, which take the config's ``batch_tile``.
_TILED = {"fused_cuda": FusedCudaBackend,
          "analogue_fused_cuda": FusedAnalogueCudaBackend}


def make_l96_fleet(cfg=None, backend=None) -> TwinFleet:
    """The Lorenz96 fleet-serving scenario: one autonomous twin at the
    paper's Fig. 4 sizes, wrapped in a :class:`TwinFleet` so N assets
    roll out as one program.

    ``cfg``: a ``Lorenz96FleetConfig`` (default: ``FLEET``).  ``backend``:
    Backend instance or registry name (``"analogue_fused_cuda"`` deploys
    the twin on K4's crossbars with the default ``AnalogueSpec``); a name
    of a fused substrate gets the config's ``batch_tile``; ``None`` uses
    the config's choice."""
    cfg = cfg or FLEET
    twin = make_autonomous_twin(cfg.state_dim, hidden=cfg.hidden,
                                n_hidden_layers=cfg.n_hidden_layers)
    if backend is None:
        backend = cfg.backend
    if isinstance(backend, str) and backend in _TILED:
        backend = _TILED[backend](batch_tile=cfg.batch_tile)
    if backend != "digital":
        twin = twin.with_backend(backend)
    return TwinFleet(twin)


def l96_fleet_ts(cfg=None, horizon=None) -> torch.Tensor:
    """The serving time grid: ``horizon`` RK4 steps at the training dt,
    uniform and concrete (a float32 host tensor), as the fused kernel
    requires."""
    cfg = cfg or FLEET
    h = cfg.horizon if horizon is None else int(horizon)
    return torch.linspace(0.0, h * cfg.dt, h + 1, dtype=torch.float32)


def l96_fleet_requests(cfg=None, fleet_size=None, num_batches=1, seed=0,
                       device=None):
    """Stream request batches of per-asset initial conditions: each a
    (fleet_size, state_dim) tensor on ``device`` (default ``cuda``) of
    sensed states drawn around the normalised attractor, from a
    ``torch.Generator`` seeded with ``seed``."""
    cfg = cfg or FLEET
    device = resolve_device(device)
    n = cfg.fleet_size if fleet_size is None else int(fleet_size)
    gen = torch.Generator().manual_seed(seed)
    for _ in range(num_batches):
        y = torch.randn((n, cfg.state_dim), generator=gen)
        yield (cfg.y0_spread * y).to(device)


# ---------------------------------------------------------------------------
# CLI: train and evaluate a twin on one device
# ---------------------------------------------------------------------------

def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Train the HP or Lorenz96 twin and report its gate "
                    "metrics")
    ap.add_argument("--twin", choices=["hp", "l96"], default="hp")
    ap.add_argument("--backend", default="fused_cuda",
                    choices=["digital", "fused_cuda"],
                    help="trajectory-phase training substrate")
    ap.add_argument("--device", default="cuda",
                    help="torch device (cpu runs the kernels' plain "
                         "PyTorch versions)")
    ap.add_argument("--pretrain-steps", type=int, default=None)
    ap.add_argument("--train-steps", type=int, default=None)
    ap.add_argument("--num-points", type=int, default=1200,
                    help="Lorenz96 window (the paper's is 2400)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    t0 = time.perf_counter()
    if args.twin == "hp":
        twin, params, loss = train_hp_twin(
            pretrain_steps=args.pretrain_steps or 200,
            train_steps=args.train_steps or 250, backend=args.backend,
            device=device)
        print(f"HP twin on {device} ({args.backend}): final loss "
              f"{loss:.6f} in {time.perf_counter() - t0:.1f} s")
        for wf in ("sine", "triangular", "rectangular", "modulated_sine"):
            m = eval_hp_twin(twin, params, wf, device=device)
            print(f"  {wf:15s} MRE {m['mre']:.4f}  DTW/pt {m['dtw']:.6f}")
    else:
        data = l96_data(num_points=args.num_points, device=device)
        twin, params = train_l96_twin(
            pretrain_steps=args.pretrain_steps or 1500,
            train_steps=((60, args.train_steps or 300, 1e-3),), data=data,
            backend=args.backend, device=device)
        m = eval_l96_twin(twin, params, data=data)
        print(f"Lorenz96 twin on {device} ({args.backend}) in "
              f"{time.perf_counter() - t0:.1f} s: interpolation L1 "
              f"{m['interp_l1']:.4f}, extrapolation L1 {m['extrap_l1']:.4f}")


if __name__ == "__main__":
    main()
