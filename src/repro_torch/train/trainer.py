"""Training loops for the continuous-time digital twins (port of
``repro/train/trainer.py``).

Faithful to the paper's Methods: Adam, RK4 ODESolve, adjoint-state
gradients, an L1 or soft-DTW objective, and random state noise as a
regulariser during training (their ref. 46), plus the JAX package's two
practical additions:

* multiple-shooting segmentation — the trajectory is split into segments
  solved from ground-truth initial states;
* derivative-matching warm start — regress f_theta(x) onto finite-
  difference derivatives before trajectory training.

The trajectory loss is substrate-selectable (``segment_loss_fn``'s
``backend=``): the digital path solves the shooting segments as the
batch of one continuous-adjoint IVP (the JAX package vmaps one solve per
segment), while
``backend="fused_cuda"`` makes the segments the batch of one K1 launch
and differentiates through the reverse-time kernel K2 — training on the
substrate that serves; its soft-DTW objectives run through the wavefront
kernels K5 (forward) and K6 (E-matrix backward), where the digital path
differentiates the reference DP by autograd.

The engines are plain loops: PyTorch runs eagerly, so the JAX package's
scan-compiled chunks have no counterpart.  Random state noise draws from
a ``torch.Generator`` handed to ``fit`` (the JAX package splits a
``jax.random`` key per step), on the CPU and then moved, so one seed
gives the same noise on every device.

Hardware-aware training (``hw_aware=``, :mod:`repro_torch.train.hw_aware`)
passes the weights through the analogue write path inside the loss,
keyed by the global step: such a loss sets ``wants_step`` and the engines
call it as ``loss_fn(params, generator, step)``.  Training on
``FusedAnalogueCudaBackend`` implies it, with the backend's own device
model, as in the JAX package.

Not ported yet (ROADMAP.md, queue 1): the baseline trainers
(``train_forecaster``, ``train_recurrent_resnet``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch

from repro_torch.core.backends import (FusedAnalogueCudaBackend,
                                       FusedCudaBackend, resolve_backend,
                                       uniform_dt)
from repro_torch.core.losses import l1, soft_dtw_batch
from repro_torch.train.optimizer import Optimizer, apply_updates
from repro_torch.tree import tree_leaves, tree_unflatten

Tree = Any


def normal_like(generator: torch.Generator,
                like: torch.Tensor) -> torch.Tensor:
    """Standard normal noise of ``like``'s shape from a CPU generator,
    placed on ``like``'s device."""
    return torch.randn(like.shape, generator=generator,
                       dtype=like.dtype).to(like.device)


def _step_body(loss_fn: Callable, optimizer: Optimizer, params, opt_state,
               generator, step=None):
    """One descent step — the shared body of both engines: the loss and
    its gradient at ``params``, then the optimizer update.  ``step``, the
    global step counter, is passed on to step-keyed losses only."""
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    args = (generator,) if step is None else (generator, step)
    with torch.enable_grad():
        loss = loss_fn(tree_unflatten(params, leaves), *args)
        grads = torch.autograd.grad(loss, leaves)
    grads = tree_unflatten(params, list(grads))
    params = tree_unflatten(params, [p.detach() for p in leaves])
    updates, opt_state = optimizer.update(grads, opt_state, params)
    return apply_updates(params, updates), opt_state, loss.detach()


def _wants_step(loss_fn: Callable) -> bool:
    """Does the loss take the global step as a third argument?  Step-keyed
    losses (hardware-aware training) set ``loss_fn.wants_step = True``."""
    return bool(getattr(loss_fn, "wants_step", False))


def fit(loss_fn: Callable, params: Tree, optimizer: Optimizer,
        num_steps: int, generator: Optional[torch.Generator] = None
        ) -> tuple[Tree, torch.Tensor]:
    """Full-batch descent; ``loss_fn(params, generator) -> scalar``, or
    ``loss_fn(params, generator, step)`` with the global step from 0 when
    ``loss_fn.wants_step``.

    The loss history stays on the device and comes back to the host once
    at the end, as the JAX package's scan engine syncs only at chunk
    boundaries.  Step semantics are those of :func:`fit_per_step`.
    Returns ``(params, losses)`` with ``losses`` the (num_steps,) float32
    history."""
    opt_state = optimizer.init(params)
    keyed = _wants_step(loss_fn)
    losses = []
    for i in range(num_steps):
        params, opt_state, loss = _step_body(loss_fn, optimizer, params,
                                             opt_state, generator,
                                             i if keyed else None)
        losses.append(loss)
    if not losses:
        return params, torch.zeros((0,), dtype=torch.float32)
    return params, torch.stack(losses)


def fit_per_step(loss_fn: Callable, params: Tree, optimizer: Optimizer,
                 num_steps: int, generator: Optional[torch.Generator] = None
                 ) -> tuple[Tree, torch.Tensor]:
    """Reference loop that reads every step's loss back to the host; the
    equivalence oracle for :func:`fit`."""
    opt_state = optimizer.init(params)
    keyed = _wants_step(loss_fn)
    losses = []
    for i in range(num_steps):
        params, opt_state, loss = _step_body(loss_fn, optimizer, params,
                                             opt_state, generator,
                                             i if keyed else None)
        losses.append(float(loss))
    return params, torch.tensor(losses, dtype=torch.float32)


# ---------------------------------------------------------------------------
# Multiple-shooting segmentation
# ---------------------------------------------------------------------------

def make_segments(ts: torch.Tensor, ys: torch.Tensor, segment_len: int):
    """Split (T,)/(T,D) into overlapping shooting segments.

    Returns (ts_seg (S, L+1), ys_seg (S, L+1, D)) where consecutive
    segments share their boundary point.
    """
    T = ts.shape[0]
    L = segment_len
    S = (T - 1) // L
    idx = (torch.arange(S)[:, None] * L
           + torch.arange(L + 1)[None, :]).to(ts.device)
    return ts[idx], ys[idx]


#: The segment objectives: L1, soft-DTW over the segment length, and L1
#: plus a tenth of that.
OBJECTIVES = ("l1", "softdtw", "l1+softdtw")


def _segment_objective(loss: str, gamma: float, preds, ys_seg,
                       kernelised: bool = False):
    """Shared loss combinators over (S, L+1, D) predictions/targets.

    ``kernelised=True`` (the fused training path) sends soft-DTW through
    the wavefront kernels, K5 forward and the K6 E-matrix backward
    (:func:`repro_torch.kernels.ops.soft_dtw`), instead of the reference
    DP differentiated by autograd."""
    if loss not in OBJECTIVES:
        raise ValueError(loss)
    preds = preds.to(torch.float32)
    if loss == "l1":
        return l1(preds, ys_seg)
    if kernelised:
        from repro_torch.kernels import ops
        sdtw = torch.mean(ops.soft_dtw(preds, ys_seg, gamma))
    else:
        sdtw = torch.mean(soft_dtw_batch(preds, ys_seg, gamma))
    if loss == "softdtw":
        return sdtw / ys_seg.shape[1]
    return l1(preds, ys_seg) + 0.1 * sdtw / ys_seg.shape[1]


def _hw_aware_loss(rollout_loss: Callable, params, hw_aware, step):
    """The loss of ``params`` (``hw_aware`` None), or its mean over the
    ``k_draws`` device realisations of ``step``, drawn in one K3 launch on
    the card."""
    if hw_aware is None:
        return rollout_loss(params)
    from repro_torch.train.hw_aware import _step_draws, expectation_over_draws
    draws = _step_draws(params, hw_aware, step)
    return expectation_over_draws(lambda d: rollout_loss(draws[d]), hw_aware)


def _fused_segment_loss_fn(twin, backend, ts_seg, ys_seg, loss: str,
                           gamma: float, noise_std: float, hw_aware=None):
    """Multiple-shooting loss on the fused CUDA substrate.

    The segments become the kernel's BATCH dimension: one K1 launch
    integrates all S shooting segments at once (for a driven twin each
    segment gets its own drive, sampled at its absolute half-step times —
    the per-twin drive path), and K2 carries the gradients.  Differs from
    the digital path only by the substrate; the objective, segmentation
    and noise regularisation are identical.  ``hw_aware`` rolls out each
    of the step's device realisations (K1 forward and K2 backward each)
    and averages the losses."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.fused_ode_mlp import pad_fleet_to_tile

    # honour the twin's solver config: RK4 only (as the serving backend
    # enforces), with steps_per_interval densifying each segment's grid
    method = getattr(twin.node, "method", "rk4")
    if method != "rk4":
        raise ValueError(
            f"fused-backend training integrates RK4 only, got {method!r}")
    sub = int(getattr(twin.node, "steps_per_interval", 1))

    # every segment on one shared-dt line from its own start
    dt = uniform_dt(ts_seg, "fused-backend training") / sub
    drive = getattr(twin.field, "drive", None)
    dev = ts_seg.device
    if drive is None:
        uh = backend._u_half(None, backend._grid(ts_seg[0], sub, dev)[0])
    else:
        # the drive of each segment at its absolute (fine) half-step times
        uh = torch.stack([backend._u_half(drive, backend._grid(
            row, sub, dev)[0]) for row in ts_seg])
    S = ts_seg.shape[0]

    def loss_fn(params, generator, step=None):
        y0s = ys_seg[:, 0]
        if noise_std > 0 and generator is not None:
            y0s = y0s + noise_std * normal_like(generator, y0s)
        # pad segments up to a tile multiple, as rollout_batch_local does
        y0p, uhp, bt, _ = pad_fleet_to_tile(y0s, uh, backend.batch_tile)

        def rollout_loss(p):
            traj = ops.fused_node_rollout(p, y0p, uhp, dt, batch_tile=bt,
                                          gradient="fused_vjp")
            preds = traj[::sub, :S].transpose(0, 1)      # (S, L+1, D)
            return _segment_objective(loss, gamma, preds, ys_seg,
                                      kernelised=True)

        return _hw_aware_loss(rollout_loss, params, hw_aware, step)

    loss_fn.wants_step = hw_aware is not None
    return loss_fn


def segment_loss_fn(twin, ts_seg, ys_seg, loss: str = "l1",
                    gamma: float = 0.1, noise_std: float = 0.0,
                    backend=None, hw_aware=None):
    """Loss over shooting segments.

    ``loss``: one of :data:`OBJECTIVES`; ``gamma`` is soft-DTW's
    smoothing.  ``backend``: optional execution substrate (Backend
    instance or registry name); ``None`` uses the twin's own backend.
    The digital substrate batches the segments into one solve
    (:func:`_batched_segments`); the fused CUDA substrate batches them
    through one K1 launch with the K2 reverse-time VJP, and soft-DTW
    through K5 and K6 (train where you serve).

    ``hw_aware``: an optional :class:`repro_torch.train.hw_aware.HwAwareConfig`
    turning on hardware-aware training on either substrate: every
    evaluation sees the weights through the analogue write path (STE),
    keyed by the global step, averaged over ``k_draws`` realisations; the
    loss then sets ``wants_step``.  Training on a
    ``FusedAnalogueCudaBackend`` implies it, with the policy derived from
    the backend (``HwAwareConfig.from_backend``), and integrates on K1/K2
    with the device-degraded weights."""
    be = resolve_backend(backend) if backend is not None else twin.backend
    if hw_aware is None and isinstance(be, FusedAnalogueCudaBackend):
        from repro_torch.train.hw_aware import HwAwareConfig
        hw_aware = HwAwareConfig.from_backend(be)
    if isinstance(be, FusedCudaBackend):
        return _fused_segment_loss_fn(twin, be, ts_seg, ys_seg, loss,
                                      gamma, noise_std, hw_aware)
    if backend is not None:
        twin = twin.with_backend(be)
    twin, ts_rel = _batched_segments(twin, ts_seg)

    def loss_fn(params, generator, step=None):
        y0s = ys_seg[:, 0]
        if noise_std > 0 and generator is not None:
            y0s = y0s + noise_std * normal_like(generator, y0s)

        def rollout_loss(p):
            preds = twin.simulate(p, y0s, ts_rel).transpose(0, 1)
            return _segment_objective(loss, gamma, preds, ys_seg)

        return _hw_aware_loss(rollout_loss, params, hw_aware, step)

    loss_fn.wants_step = hw_aware is not None
    return loss_fn


def _batched_segments(twin, ts_seg):
    """The S shooting segments as the batch of ONE solve (the JAX package
    vmaps one solve per segment): on the segments' shared time grid
    relative to their start, with a driven twin's drive shifted to each
    segment's start time, u_s(t) = u(t0_s + t).  Returns the re-bound
    twin and the (L+1,) relative grid.  The drive then sees t0_s + t
    instead of the absolute grid point, which differs by float32
    rounding only.  The grid must be uniform, as on the fused path."""
    uniform_dt(ts_seg, "segment training")
    t_start = ts_seg[:, 0]
    ts_rel = ts_seg - t_start[:, None]
    drive = getattr(twin.field, "drive", None)
    if drive is not None:
        S = ts_seg.shape[0]
        field = dataclasses.replace(
            twin.field, drive=lambda t: drive(t_start + t).reshape(S, -1))
        twin = dataclasses.replace(
            twin, field=field, node=dataclasses.replace(twin.node,
                                                        field=field))
    return twin, ts_rel[0]


def train_twin(twin, params, ts: torch.Tensor, ys: torch.Tensor, *,
               optimizer: Optimizer, num_steps: int,
               segment_len: int = 50, loss: str = "l1",
               gamma: float = 0.1, noise_std: float = 0.0,
               generator: Optional[torch.Generator] = None,
               backend=None, hw_aware=None):
    """Train a twin on one observed trajectory (paper's training setup).

    ``backend`` selects the training substrate (see
    :func:`segment_loss_fn`): ``backend="fused_cuda"`` (or a
    ``FusedCudaBackend`` instance) runs every forward and backward solve
    through the hand-written kernels K1 and K2 (and a soft-DTW ``loss``
    through K5 and K6).  ``gamma`` is soft-DTW's smoothing.
    ``generator`` draws the state noise (default: a CPU generator seeded
    with 0).  ``hw_aware`` trains through the analogue write path (see
    :func:`segment_loss_fn`)."""
    ts_seg, ys_seg = make_segments(ts, ys, segment_len)
    loss_fn = segment_loss_fn(twin, ts_seg, ys_seg, loss=loss, gamma=gamma,
                              noise_std=noise_std, backend=backend,
                              hw_aware=hw_aware)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    return fit(loss_fn, params, optimizer, num_steps, generator)


# ---------------------------------------------------------------------------
# Derivative-matching warm start (collocation pretraining)
# ---------------------------------------------------------------------------

def finite_difference_derivatives(ts: torch.Tensor, ys: torch.Tensor):
    """Central differences on the interior points: (T-2,) ts, ys, dys."""
    dt = ts[2:] - ts[:-2]
    dys = (ys[2:] - ys[:-2]) / dt[:, None]
    return ts[1:-1], ys[1:-1], dys


def derivative_matching_loss(field, ts_mid, ys_mid, dys):
    """Mean |f(t_i, y_i) - dy_i| over the collocation points, the field
    evaluated on all of them at once (one time per row)."""
    def loss_fn(params, generator):
        del generator
        preds = field(ts_mid, ys_mid, params)
        return torch.mean(torch.abs(preds - dys))
    return loss_fn


def pretrain_derivatives(field, params, ts, ys, *, optimizer,
                         num_steps: int):
    ts_mid, ys_mid, dys = finite_difference_derivatives(ts, ys)
    loss_fn = derivative_matching_loss(field, ts_mid, ys_mid, dys)
    return fit(loss_fn, params, optimizer, num_steps)
