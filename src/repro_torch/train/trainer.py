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

The engines are the JAX package's: :func:`make_step_fn` (one step a
dispatch) and :func:`make_scan_engine` (a chunk of steps, the
counterpart of its ``lax.scan`` in one jit), under :func:`fit` and
:func:`fit_per_step`.  On the card a step is captured once as a CUDA
graph over static buffers (params, optimizer state, the int32 step
counter, the losses and the state noise) and replayed, so the host
issues one graph launch per ``unroll`` steps instead of every kernel of
every step; on CPU tensors the same step runs uncaptured.
:func:`fit_eager` is the eager loop the graphs are held to bit for bit.
Random state noise draws from a ``torch.Generator`` handed to ``fit``
(the JAX package splits a ``jax.random`` key per step), on the CPU, so
one seed gives the same noise on every device; the engines draw a
block's noise before the block and hand it over in one copy
(:class:`StepNoise`).

Hardware-aware training (``hw_aware=``, :mod:`repro_torch.train.hw_aware`)
passes the weights through the analogue write path inside the loss,
keyed by the global step: such a loss sets ``wants_step`` and the engines
call it as ``loss_fn(params, generator, step)``.  Training on
``FusedAnalogueCudaBackend`` implies it, with the backend's own device
model, as in the JAX package.

The paper's digital baselines (:mod:`repro_torch.models.baselines`)
train through the same engines: :func:`train_recurrent_resnet` (teacher-
forced shooting segments, batched) and :func:`train_forecaster`
(teacher-forced next-step prediction, input noise by
:func:`normal_like`).
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import importlib
import math
from typing import Any, Callable, Optional

import torch

from repro_torch.core.backends import (FusedAnalogueCudaBackend,
                                       FusedCudaBackend, resolve_backend,
                                       uniform_dt)
from repro_torch.core.losses import l1, soft_dtw_batch
from repro_torch.train.optimizer import Optimizer, apply_updates
from repro_torch.tree import tree_leaves, tree_unflatten

Tree = Any


def normal_like(generator, like: torch.Tensor) -> torch.Tensor:
    """Standard normal noise of ``like``'s shape from a CPU generator,
    placed on ``like``'s device.

    Inside the training engines a loss is handed a :class:`StepNoise` in
    place of its generator: the draw is then a slot of a buffer the engine
    filled from the generator before the step (the same numbers, drawn in
    the same order, without a host-to-device copy inside the step)."""
    if isinstance(generator, StepNoise):
        return generator.take(like)
    return torch.randn(like.shape, generator=generator,
                       dtype=like.dtype).to(like.device)


def _step_body(loss_fn: Callable, optimizer: Optimizer, params, opt_state,
               generator, step=None):
    """One descent step — the shared body of every engine: the loss and
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


# ---------------------------------------------------------------------------
# Training engines: the step body as CUDA graphs on the card
# ---------------------------------------------------------------------------

#: The kernels' launch counters (module of ``repro_torch.kernels``, name):
#: each wrapper adds one where it launches, so a graph's launches are
#: counted once at its capture and added again at every replay.
_COUNTERS = (("fused_ode_mlp", "LAUNCHES"), ("fused_ode_mlp_bwd", "LAUNCHES"),
             ("fused_ode_mlp", "LAUNCHES_BF16"),
             ("fused_ode_mlp", "LAUNCHES_BF16_F32ACC"),
             ("fused_ode_mlp_bwd", "LAUNCHES_BF16"),
             ("fused_ode_mlp_bwd", "LAUNCHES_BF16_F32ACC"),
             ("softdtw", "LAUNCHES"), ("softdtw", "BWD_LAUNCHES"),
             ("softdtw", "LAUNCHES_BF16"), ("softdtw", "BWD_LAUNCHES_BF16"),
             ("noise", "LAUNCHES"), ("noise", "MASK_LAUNCHES"),
             ("noise", "WRITE_LAUNCHES"), ("fused_analogue", "LAUNCHES"),
             ("fused_analogue", "NOISE_LAUNCHES"),
             ("crossbar_vmm", "LAUNCHES"), ("crossbar_vmm", "READ_LAUNCHES"),
             ("flash_attention", "LAUNCHES"), ("ssm_scan", "LAUNCHES"))

#: Alignment of each request's slab in a noise buffer, in bytes.
_SLAB_ALIGN = 256


@functools.cache
def _counter_modules() -> tuple:
    return tuple((importlib.import_module(f"repro_torch.kernels.{mod}"), name)
                 for mod, name in _COUNTERS)


def _launch_counts() -> dict:
    """Every launch counter's value, keyed by (module, name)."""
    return {(m, name): getattr(m, name) for m, name in _counter_modules()}


def _set_launch_counts(counts: dict) -> None:
    for (m, name), v in counts.items():
        setattr(m, name, v)


class StepNoise:
    """The state noise of the engines' steps, handed to a loss in place of
    its generator: :func:`normal_like` takes each draw from a slot of a
    device buffer that the engine fills from the generator on the host
    before a block of steps, one host-to-device copy a block.

    The draws are the generator's, in the loss's order, one block after
    another, so the noise is bitwise that of the eager loop.  A warm-up
    step records the loss's requests (shape, dtype, device) while drawing
    from a copy of the generator; every later step must make the same
    requests.  A loss that draws from the generator in another way fails:
    this object is not a ``torch.Generator``."""

    def __init__(self, generator: Optional[torch.Generator]):
        self.generator = generator
        self.requests: Optional[list] = None   # recorded by the warm-up
        self.views: Optional[list] = None      # per request, (u, *shape)
        self.slot = 0
        self.calls = 0

    def take(self, like: torch.Tensor) -> torch.Tensor:
        key = (tuple(like.shape), like.dtype, like.device)
        if self.views is None:              # recording: the warm-up step
            self.requests.append(key)
            return torch.randn(key[0], generator=self.generator,
                               dtype=key[1]).to(key[2])
        k = self.calls
        if k >= len(self.requests) or self.requests[k] != key:
            raise RuntimeError(
                f"training engine: the loss's noise draw {k} is {key}; the "
                f"warm-up step recorded {self.requests}: a loss must draw "
                f"the same noise every step")
        self.calls += 1
        return self.views[k][self.slot]

    def at(self, views: list, slot: int) -> "StepNoise":
        """Point the draws of the next step at ``slot`` of ``views``."""
        self.views, self.slot, self.calls = views, slot, 0
        return self

    def done(self) -> None:
        if self.calls != len(self.requests):
            raise RuntimeError(
                f"training engine: the loss drew {self.calls} of the "
                f"{len(self.requests)} noise tensors the warm-up step drew")


class _Block:
    """``length`` steps run as one unit: on the card one CUDA graph (its
    launches counted at capture), on the CPU the same steps uncaptured.
    ``losses`` and the noise buffer are the block's static buffers."""

    def __init__(self, length: int, losses: torch.Tensor, noise,
                 views: list, host_views):
        self.length = length
        self.losses = losses
        self.noise, self.views, self.host_views = noise, views, host_views
        self.graph = None
        self.launches: dict = {}


class _Engine:
    """The capturable training step over static buffers.

    Params, optimizer state and the int32 step counter live in buffers the
    step updates in place; a block of ``u`` steps writes its losses into a
    static (u,) buffer and reads its noise from a static buffer.  On CUDA
    tensors each block length is captured once as a CUDA graph (after one
    warm-up step on copies that are thrown away, on the capture's side
    stream) and replayed; a capture that fails raises.  On CPU tensors the
    same steps run uncaptured: the plain version of the graph."""

    def __init__(self, loss_fn: Callable, optimizer: Optimizer,
                 has_key: bool, donate: bool = False):
        self.loss_fn, self.optimizer = loss_fn, optimizer
        self.has_key, self.donate = has_key, donate
        self.keyed = _wants_step(loss_fn)
        self.bufs = None            # params' and state's leaves
        self.noise = None
        self.blocks: dict = {}
        self.captures = self.replays = 0
        self.stream = self.pool = None

    # -- buffers --------------------------------------------------------------
    def load(self, params, opt_state, generator, step=None) -> None:
        """Make the buffers hold ``params``, ``opt_state`` and ``step``
        (the first call allocates them; an argument that is already the
        engine's buffer is not copied)."""
        leaves = tree_leaves(params) + tree_leaves(opt_state)
        if self.bufs is None:
            self.p_tmpl, self.s_tmpl = params, opt_state
            self.n_params = len(tree_leaves(params))
            self.bufs = [None if x is None else
                         x.detach() if self.donate else x.detach().clone()
                         for x in leaves]
            self.device = self.bufs[0].device
            self.step_t = torch.zeros((), dtype=torch.int32,
                                      device=self.device)
            self.noise = StepNoise(None)
        else:
            with torch.no_grad():
                for b, x in zip(self.bufs, leaves):
                    if b is not None and x is not b:
                        b.copy_(x)
        if step is not None and step is not self.step_t:
            with torch.no_grad():
                if isinstance(step, torch.Tensor):
                    self.step_t.copy_(step)
                else:
                    self.step_t.fill_(int(step))
        self.generator = generator

    def params(self):
        return tree_unflatten(self.p_tmpl, self.bufs[:self.n_params])

    def opt_state(self):
        return tree_unflatten(self.s_tmpl, self.bufs[self.n_params:])

    # -- the step -------------------------------------------------------------
    def _body(self, bufs, step_t, generator, losses, slot) -> None:
        """One step from ``bufs`` into ``bufs``, its loss into
        ``losses[slot]``; the step counter advanced by one."""
        n = self.n_params
        params = tree_unflatten(self.p_tmpl, bufs[:n])
        state = tree_unflatten(self.s_tmpl, bufs[n:])
        params, state, loss = _step_body(
            self.loss_fn, self.optimizer, params, state,
            generator if self.has_key else None,
            step_t if self.keyed else None)
        with torch.no_grad():
            for b, x in zip(bufs, tree_leaves(params) + tree_leaves(state)):
                if b is not None:
                    b.copy_(x)
            losses[slot].copy_(loss)
            if self.keyed:
                step_t.add_(1)

    def _warm_up(self) -> None:
        """One step on copies of the buffers, the counter and the
        generator, all thrown away: records the loss's noise requests and,
        on the card, runs the step's first launches (kernel builds, cuBLAS
        handles, autograd's device threads) outside the capture."""
        gen = self.generator
        if gen is not None:
            gen = torch.Generator(device=gen.device)
            gen.set_state(self.generator.get_state())
        noise = StepNoise(gen)
        noise.requests = []
        bufs = [None if b is None else b.clone() for b in self.bufs]
        losses = torch.empty((1,), dtype=torch.float32, device=self.device)
        try:
            with self._on_side_stream():
                self._body(bufs, self.step_t.clone(), noise, losses, 0)
        except TypeError as e:
            raise TypeError(
                f"training engine: the loss's step failed ({e}); inside the "
                f"engines a loss's generator argument is a StepNoise, so "
                f"state noise must be drawn with trainer.normal_like") from e
        if self.stream is not None:
            torch.cuda.current_stream(self.device).wait_stream(self.stream)
        self.noise.requests = noise.requests

    def _on_side_stream(self):
        if self.device.type != "cuda":
            return contextlib.nullcontext()
        if self.stream is None:
            self.stream = torch.cuda.Stream(self.device)
            self.pool = torch.cuda.graph_pool_handle()
        self.stream.wait_stream(torch.cuda.current_stream(self.device))
        return torch.cuda.stream(self.stream)

    def _new_block(self, u: int) -> _Block:
        """A block of ``u`` steps: its loss buffer and noise buffers (one
        slab per recorded request, (u, *shape), in one flat byte buffer,
        pinned on the host when the steps run on the card)."""
        slabs, total = [], 0
        for shape, dtype, device in self.noise.requests:
            if device != self.device:
                raise RuntimeError(
                    f"training engine: the loss draws noise on {device}, "
                    f"its params are on {self.device}")
            n = u * math.prod(shape) * torch.empty((), dtype=dtype
                                                   ).element_size()
            slabs.append((total, n, shape, dtype))
            total += -(-n // _SLAB_ALIGN) * _SLAB_ALIGN

        def views(flat):
            return [flat[o:o + n].view(dtype).view(u, *shape)
                    for o, n, shape, dtype in slabs]

        noise = torch.empty((total,), dtype=torch.uint8, device=self.device)
        losses = torch.empty((u,), dtype=torch.float32, device=self.device)
        return _Block(u, losses, noise, views(noise), views)

    def _capture(self, blk: _Block) -> None:
        """Capture ``blk``'s steps as one CUDA graph; restore the launch
        counters and keep what the capture added as the graph's launches."""
        before = _launch_counts()
        graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.graph(graph, pool=self.pool, stream=self.stream):
                self._steps(blk)
        except (RuntimeError, TypeError) as e:
            raise RuntimeError(
                f"training engine: capturing {blk.length} training step(s) "
                f"as a CUDA graph failed ({type(e).__name__}: {e}).  A "
                f"captured step may do no host work: no read of a device "
                f"value (.item(), float(), int(), bool()), no copy from "
                f"host memory, no draw from a CPU generator moved to the "
                f"card (draw state noise with trainer.normal_like from the "
                f"generator the engine hands the loss)") from e
        after = _launch_counts()
        blk.launches = {k: after[k] - before[k] for k in after}
        _set_launch_counts(before)
        blk.graph = graph
        self.captures += 1

    def _steps(self, blk: _Block) -> None:
        for j in range(blk.length):
            self._body(self.bufs, self.step_t,
                       self.noise.at(blk.views, j), blk.losses, j)
            self.noise.done()

    def block(self, u: int) -> _Block:
        """The block of ``u`` steps, made (and on the card captured) at
        its first use."""
        blk = self.blocks.get(u)
        if blk is None:
            if self.noise.requests is None:
                counts = _launch_counts()
                self._warm_up()
                _set_launch_counts(counts)
            blk = self.blocks[u] = self._new_block(u)
            if self.device.type == "cuda":
                self._capture(blk)
        return blk

    def run(self, u: int) -> torch.Tensor:
        """Run ``u`` steps from the buffers as one block: draw the block's
        noise from the generator, hand it over, replay (or run on the CPU).
        Returns the block's (u,) loss buffer, overwritten by its next run."""
        blk = self.block(u)
        if self.noise.requests:
            on_card = self.device.type == "cuda"
            host = (torch.empty(blk.noise.shape, dtype=torch.uint8,
                                pin_memory=True) if on_card else blk.noise)
            hv = blk.host_views(host)
            for j in range(u):
                for k, (shape, dtype, _) in enumerate(self.noise.requests):
                    hv[k][j].copy_(torch.randn(shape, generator=self.generator,
                                               dtype=dtype))
            if on_card:
                blk.noise.copy_(host, non_blocking=True)
        if blk.graph is None:
            self._steps(blk)
        else:
            blk.graph.replay()
            for (m, name), d in blk.launches.items():
                if d:
                    setattr(m, name, getattr(m, name) + d)
        self.replays += 1
        return blk.losses


def make_step_fn(loss_fn: Callable, optimizer: Optimizer,
                 has_key: bool) -> Callable:
    """Single step: (params, opt_state, generator) -> same + loss.

    The per-step engine, one replay per optimisation step: on the card the
    step is one CUDA graph, captured at the first call (the counterpart of
    the JAX package's jitted step); on CPU tensors the same step runs
    uncaptured.  For step-keyed losses (``loss_fn.wants_step``) the
    signature gains the step counter, an int or the returned int32 tensor:
    (params, opt_state, generator, step) -> same + loss.

    The returned params, optimizer state and step are the engine's
    buffers, which the next call updates in place (clone one to keep it);
    passing them back costs no copy.  The caller's own tensors are copied
    in, never written.  The loss is a new 0-dim tensor."""
    eng = _Engine(loss_fn, optimizer, has_key)

    def step(params, opt_state, generator):
        eng.load(params, opt_state, generator)
        loss = eng.run(1)[0].clone()
        return eng.params(), eng.opt_state(), generator, loss

    def step_keyed(params, opt_state, generator, step):
        eng.load(params, opt_state, generator, step)
        loss = eng.run(1)[0].clone()
        return eng.params(), eng.opt_state(), generator, eng.step_t, loss

    fn = step_keyed if eng.keyed else step
    fn.engine = eng
    return fn


def make_scan_engine(loss_fn: Callable, optimizer: Optimizer, has_key: bool,
                     donate: bool = False, unroll: int = 8) -> Callable:
    """Chunk engine: (params, opt_state, generator, n) -> carries + losses.

    Runs ``n`` optimisation steps with one host dispatch per ``u =
    min(unroll, n)`` steps: on the card the graph of ``u`` steps, captured
    once, replayed ``n // u`` times, and a graph of the ``n % u`` that
    remain (the counterpart of the JAX package's ``lax.scan`` unrolled
    ``unroll`` times in one jit; graphs are kept per length, so a fit
    captures at most two).  The losses come back as one (n,) device tensor.
    ``donate=True`` makes the first call's param and state tensors the
    engine's buffers, updated in place; otherwise they are copied.

    For step-keyed losses (``loss_fn.wants_step``) the engine is
    (params, opt_state, generator, step0, n) -> carries + step + losses,
    the int32 step counter advanced in device memory by every step, so
    each draw of the device model is keyed by the absolute step,
    independent of chunking.  The returned carries are the engine's
    buffers, as :func:`make_step_fn`'s."""
    eng = _Engine(loss_fn, optimizer, has_key, donate=donate)

    def chunk(n):
        losses = torch.empty((max(n, 0),), dtype=torch.float32,
                             device=eng.device)
        u, done = min(unroll, n), 0
        while done < n:             # blocks of u, then the remainder
            length = min(u, n - done)
            losses[done:done + length].copy_(eng.run(length))
            done += length
        return losses

    def run_chunk(params, opt_state, generator, n):
        eng.load(params, opt_state, generator)
        losses = chunk(n)
        return eng.params(), eng.opt_state(), generator, losses

    def run_chunk_keyed(params, opt_state, generator, step0, n):
        eng.load(params, opt_state, generator, step0)
        losses = chunk(n)
        return eng.params(), eng.opt_state(), generator, eng.step_t, losses

    fn = run_chunk_keyed if eng.keyed else run_chunk
    fn.engine = eng
    return fn


def fit(loss_fn: Callable, params: Tree, optimizer: Optimizer,
        num_steps: int, generator: Optional[torch.Generator] = None,
        log_every: int = 0, scan_chunk: Optional[int] = None
        ) -> tuple[Tree, torch.Tensor]:
    """Full-batch descent; ``loss_fn(params, generator) -> scalar``, or
    ``loss_fn(params, generator, step)`` with the global step from 0 when
    ``loss_fn.wants_step``.

    Runs :func:`make_scan_engine` over chunks of ``scan_chunk`` steps: on
    the card CUDA graphs of the step, replayed; the host syncs only at a
    chunk boundary, and only to log, from the chunk's loss history.
    ``scan_chunk=None`` runs one chunk when not logging, else chunks of
    ``max(log_every, 100)``.  Numerics are step for step those of the
    eager loop (:func:`fit_eager`, the oracle) and of :func:`fit_per_step`.
    The caller's params are not written.  Returns ``(params, losses)``
    with ``losses`` the (num_steps,) float32 history."""
    opt_state = optimizer.init(params)
    if num_steps <= 0:
        return params, torch.zeros((0,), dtype=torch.float32)
    if scan_chunk is None:
        scan_chunk = num_steps if not log_every else max(log_every, 100)
    scan_chunk = max(1, min(scan_chunk, num_steps))
    run_chunk = make_scan_engine(loss_fn, optimizer, generator is not None)
    keyed = _wants_step(loss_fn)
    step = 0
    chunks, done = [], 0
    while done < num_steps:
        n = min(scan_chunk, num_steps - done)
        if keyed:
            params, opt_state, generator, step, losses = run_chunk(
                params, opt_state, generator, step, n)
        else:
            params, opt_state, generator, losses = run_chunk(
                params, opt_state, generator, n)
        if log_every:
            hist = losses.cpu()             # one host sync per chunk
            for t in range(n):
                i = done + t
                if i % log_every == 0 or i == num_steps - 1:
                    print(f"  step {i:5d}  loss {float(hist[t]):.6f}")
        chunks.append(losses)
        done += n
    return params, torch.cat(chunks)


def fit_per_step(loss_fn: Callable, params: Tree, optimizer: Optimizer,
                 num_steps: int, generator: Optional[torch.Generator] = None,
                 log_every: int = 0) -> tuple[Tree, torch.Tensor]:
    """The per-step loop over :func:`make_step_fn`, one replay a step; the
    equivalence oracle of :func:`fit` among the engines."""
    opt_state = optimizer.init(params)
    step_fn = make_step_fn(loss_fn, optimizer, generator is not None)
    keyed = _wants_step(loss_fn)
    step, losses = 0, []
    for i in range(num_steps):
        if keyed:
            params, opt_state, generator, step, loss = step_fn(
                params, opt_state, generator, step)
        else:
            params, opt_state, generator, loss = step_fn(
                params, opt_state, generator)
        losses.append(loss)
        if log_every and (i % log_every == 0 or i == num_steps - 1):
            print(f"  step {i:5d}  loss {float(loss):.6f}")
    if not losses:
        return params, torch.zeros((0,), dtype=torch.float32)
    return params, torch.stack(losses)


def fit_eager(loss_fn: Callable, params: Tree, optimizer: Optimizer,
              num_steps: int, generator: Optional[torch.Generator] = None
              ) -> tuple[Tree, torch.Tensor]:
    """The eager loop, no engine: :func:`_step_body` once a step on fresh
    tensors, the step a Python int, the noise drawn and copied to the
    device inside the loss.  The oracle the engines' graphs are held to,
    bit for bit."""
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
                       kernelised: bool = False, precision=None):
    """Shared loss combinators over (S, L+1, D) predictions/targets.

    ``kernelised=True`` (the fused training path) sends soft-DTW through
    the wavefront kernels, K5 forward and the K6 E-matrix backward
    (:func:`repro_torch.kernels.ops.soft_dtw`), instead of the reference
    DP differentiated by autograd; ``precision`` is the backend's policy,
    which sets the cost matrix's dtype there (bf16 under the bf16
    policies; R and E stay float32)."""
    if loss not in OBJECTIVES:
        raise ValueError(loss)
    preds = preds.to(torch.float32)     # bf16 rollouts meet f32 targets
    if loss == "l1":
        return l1(preds, ys_seg)
    if kernelised:
        from repro_torch.kernels import ops
        sdtw = torch.mean(ops.soft_dtw(preds, ys_seg, gamma, precision))
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
    and averages the losses.  The backend's ``precision`` and
    ``time_chunk`` go to the rollout, and its ``precision`` to
    the soft-DTW cost matrix, as in the JAX trainer: a bf16 backend
    trains on the reduced substrate (bf16 slabs, float32 gradients)."""
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
            traj = ops.fused_node_rollout(
                p, y0p, uhp, dt, batch_tile=bt,
                time_chunk=backend.time_chunk,
                gradient="fused_vjp", precision=backend.precision)
            preds = traj[::sub, :S].transpose(0, 1)      # (S, L+1, D)
            return _segment_objective(loss, gamma, preds, ys_seg,
                                      kernelised=True,
                                      precision=backend.precision)

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
               log_every: int = 0, backend=None,
               scan_chunk: Optional[int] = None, hw_aware=None):
    """Train a twin on one observed trajectory (paper's training setup).

    ``backend`` selects the training substrate (see
    :func:`segment_loss_fn`): ``backend="fused_cuda"`` (or a
    ``FusedCudaBackend`` instance) runs every forward and backward solve
    through the hand-written kernels K1 and K2 (and a soft-DTW ``loss``
    through K5 and K6).  The backend's ``precision`` policy rides along:
    ``backend=FusedCudaBackend(precision="bf16_f32acc")`` trains on the
    reduced-precision substrate (bf16 slabs, float32 sums and gradients;
    the loss and the optimizer state stay float32).  ``gamma`` is
    soft-DTW's smoothing.
    ``generator`` draws the state noise (default: a CPU generator seeded
    with 0).  ``hw_aware`` trains through the analogue write path (see
    :func:`segment_loss_fn`).  ``log_every`` and ``scan_chunk`` are
    :func:`fit`'s."""
    ts_seg, ys_seg = make_segments(ts, ys, segment_len)
    loss_fn = segment_loss_fn(twin, ts_seg, ys_seg, loss=loss, gamma=gamma,
                              noise_std=noise_std, backend=backend,
                              hw_aware=hw_aware)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    return fit(loss_fn, params, optimizer, num_steps, generator, log_every,
               scan_chunk=scan_chunk)


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
                         num_steps: int, log_every: int = 0):
    ts_mid, ys_mid, dys = finite_difference_derivatives(ts, ys)
    loss_fn = derivative_matching_loss(field, ts_mid, ys_mid, dys)
    return fit(loss_fn, params, optimizer, num_steps, log_every=log_every)


# ---------------------------------------------------------------------------
# Baseline training (teacher-forced recurrent forecasters / ResNet)
# ---------------------------------------------------------------------------

def train_forecaster(model, params, ys: torch.Tensor, *,
                     optimizer: Optimizer, num_steps: int,
                     noise_std: float = 0.0,
                     generator: Optional[torch.Generator] = None,
                     log_every: int = 0):
    """Teacher-forced training of a recurrent forecaster on one series
    ``ys`` (T, D): the L1 of its predictions of ``ys[1:]``, the inputs
    perturbed by ``noise_std`` normals drawn with :func:`normal_like` from
    ``generator`` (default: a CPU generator seeded with 0).  Runs through
    :func:`fit`: on the card every step is a replayed CUDA graph."""
    def loss_fn(params, generator):
        inp = ys
        if noise_std > 0 and generator is not None:
            inp = ys + noise_std * normal_like(generator, ys)
        preds = model.teacher_forced(params, inp)
        return l1(preds, ys[1:])
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    return fit(loss_fn, params, optimizer, num_steps, generator, log_every)


def train_recurrent_resnet(model, params, us: torch.Tensor,
                           ys: torch.Tensor, *, optimizer: Optimizer,
                           num_steps: int, segment_len: int = 50,
                           generator: Optional[torch.Generator] = None,
                           log_every: int = 0):
    """Teacher-forced segment training of h_{t+1} = h_t + f([u_t, h_t]):
    the (T-1) // ``segment_len`` segments of ``ys`` (T, D), each rolled
    out from its observed first state under its drive samples ``us``
    (T, U), as the batch of one rollout (the JAX package vmaps them)."""
    T, L = ys.shape[0], segment_len
    S = (T - 1) // L
    idx = (torch.arange(S)[:, None] * L
           + torch.arange(L + 1)[None, :]).to(ys.device)
    ys_seg = ys[idx]                      # (S, L+1, D)
    us_seg = us[idx[:, :-1]]              # (S, L, U)

    def loss_fn(params, generator):
        del generator
        return l1(model.rollout(params, ys_seg[:, 0], us_seg), ys_seg)

    return fit(loss_fn, params, optimizer, num_steps, generator, log_every)
