"""From-scratch optimizers (port of ``repro/train/optimizer.py``).

Written out instead of ``torch.optim`` so the arithmetic matches the JAX
package's step for step.  The same small GradientTransformation-style API:

    opt = adam(1e-3)
    state = opt.init(params)
    updates, state = opt.update(grads, state, params)
    params = apply_updates(params, updates)

Params, grads and updates are trees of tensors (the MLP's list of
``{"w", "b"}`` dicts); nothing is updated in place.  Step counters are
int32 tensors and schedules compute in float32, as in the JAX package.
``update`` reads nothing back to the host and copies nothing from it, so
the training engines can capture it in a CUDA graph.
"""
from __future__ import annotations

import math
from typing import Any, Callable, NamedTuple, Optional

import torch

from repro_torch.tree import tree_leaves, tree_map

Tree = Any


class Optimizer(NamedTuple):
    init: Callable[[Tree], Tree]
    update: Callable[..., tuple]


class AdamState(NamedTuple):
    step: torch.Tensor
    mu: Tree
    nu: Tree


def global_norm(tree: Tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.to(torch.float32)))
                          for x in tree_leaves(tree)))


def clip_by_global_norm(tree: Tree, max_norm: float) -> Tree:
    norm = global_norm(tree)
    scale = torch.clamp(max_norm / (norm + 1e-9), max=1.0)
    return tree_map(lambda x: x * scale, tree)


def constant_schedule(lr: float) -> Callable:
    """``lr`` as a float32 scalar on the step's device, made by a fill on
    the device (no host-to-device copy, so a CUDA graph can hold it)."""
    return lambda step: torch.full((), lr, dtype=torch.float32,
                                   device=step.device)


def warmup_cosine_schedule(peak_lr: float, warmup_steps: int,
                           total_steps: int,
                           final_frac: float = 0.1) -> Callable:
    """Linear warm-up to ``peak_lr``, then a cosine down to
    ``final_frac * peak_lr`` at ``total_steps``; ``step`` counts from 1
    (the optimizer passes its incremented counter), computed in float32."""
    def sched(step):
        step = step.to(torch.float32)
        warm = peak_lr * step / max(warmup_steps, 1)
        prog = torch.clamp((step - warmup_steps) /
                           max(total_steps - warmup_steps, 1), 0.0, 1.0)
        cos = peak_lr * (final_frac + (1 - final_frac) *
                         0.5 * (1 + torch.cos(math.pi * prog)))
        return torch.where(step < warmup_steps, warm, cos)
    return sched


def _step0(params) -> torch.Tensor:
    leaves = tree_leaves(params)
    device = leaves[0].device if leaves else None
    return torch.zeros((), dtype=torch.int32, device=device)


def adam(lr: float | Callable = 1e-3, b1: float = 0.9, b2: float = 0.999,
         eps: float = 1e-8, weight_decay: float = 0.0,
         grad_clip: Optional[float] = None,
         mu_dtype=None) -> Optimizer:
    """Adam / AdamW (decoupled weight decay) with optional global-norm clip."""
    sched = lr if callable(lr) else constant_schedule(lr)

    def init(params):
        mu = tree_map(lambda p: torch.zeros_like(p, dtype=mu_dtype or p.dtype),
                      params)
        nu = tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                      params)
        return AdamState(_step0(params), mu, nu)

    def update(grads, state: AdamState, params=None):
        if grad_clip is not None:
            grads = clip_by_global_norm(grads, grad_clip)
        step = state.step + 1
        mu = tree_map(lambda m, g: b1 * m + (1 - b1) * g.to(m.dtype),
                      state.mu, grads)
        nu = tree_map(
            lambda v, g: b2 * v + (1 - b2) *
            torch.square(g.to(torch.float32)), state.nu, grads)
        lr_t = sched(step)
        stepf = step.to(torch.float32)
        bc1 = 1 - torch.pow(b1, stepf)
        bc2 = 1 - torch.pow(b2, stepf)

        def upd(m, v, p):
            mhat = m.to(torch.float32) / bc1
            vhat = v / bc2
            u = -lr_t * mhat / (torch.sqrt(vhat) + eps)
            if weight_decay and p is not None:
                u = u - lr_t * weight_decay * p.to(torch.float32)
            return u.to(p.dtype if p is not None else m.dtype)

        if params is not None:
            updates = tree_map(upd, mu, nu, params)
        else:
            updates = tree_map(lambda m, v: upd(m, v, None), mu, nu)
        return updates, AdamState(step, mu, nu)

    return Optimizer(init, update)


def adamw(lr, weight_decay: float = 0.1, **kw) -> Optimizer:
    return adam(lr, weight_decay=weight_decay, **kw)


def apply_updates(params: Tree, updates: Tree) -> Tree:
    return tree_map(lambda p, u: p + u.to(p.dtype), params, updates)


def sgd(lr: float | Callable = 1e-2, momentum: float = 0.0,
        grad_clip: Optional[float] = None) -> Optimizer:
    sched = lr if callable(lr) else constant_schedule(lr)

    def init(params):
        return (_step0(params),
                tree_map(torch.zeros_like, params) if momentum else None)

    def update(grads, state, params=None):
        del params
        if grad_clip is not None:
            grads = clip_by_global_norm(grads, grad_clip)
        step, vel = state
        step = step + 1
        lr_t = sched(step)
        if momentum:
            vel = tree_map(lambda v, g: momentum * v + g, vel, grads)
            upd = tree_map(lambda v: -lr_t * v, vel)
        else:
            upd = tree_map(lambda g: -lr_t * g, grads)
        return upd, (step, vel)

    return Optimizer(init, update)
