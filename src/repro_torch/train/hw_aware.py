"""Hardware-aware training (port of ``repro/train/hw_aware.py``).

Every loss evaluation sees the weights through the analogue write path,
so training optimises the weights the array will realise:

  fold bias -> differential pair (G+, G-) -> 6-bit quantise ->
  multiplicative programming noise -> stuck-cell pinning ->
  drift snapshot -> multiplicative read noise -> back to weight units

wrapped in a straight-through estimator (STE): the forward value is
``folded + (w_hw - folded)``, the gradient the identity, so the chain
composes with any differentiable rollout (the digital adjoint, or K1/K2)
without touching its kernels.

Determinism: every perturbation comes from the counter stream K3, keyed by
``(noise_seed, global training step, draw, layer, pair, channel)`` in the
salt block :data:`HW_SALT_BASE`, exactly as the JAX package keys it, so
uniforms, stuck masks and quantised levels are the JAX package's bit for
bit and the normals agree to Box-Muller rounding (~1e-6).  The same seed
gives the same loss history.

On CUDA tensors the write path is K3's write-path kernel
(:func:`repro_torch.kernels.noise.hw_write_path`): the trainer's loss
draws all ``k_draws`` realisations of a step, every layer, in one launch,
keyed by the step as an int or as the training engines' int32 device
counter (which the kernel reads, so a CUDA graph of the step draws at
each replay's step), and nothing is read back to the host (the weights'
NaN check of ``conductance_pair`` is a synchronisation and stays out of
the per-step path, as it is out of JAX's traced one).  On CPU tensors the
plain version :func:`repro_torch.kernels.ref.hw_write_path_ref` runs,
with the same step, a tensor step as tensor arithmetic.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Optional

import torch

from repro_torch.core.analogue import AnalogueSpec, _require_floating
from repro_torch.core.faults import drift_factor
from repro_torch.kernels import noise as _k3
from repro_torch.kernels import ref

#: Base of the hardware-aware salt block: above the fused kernels' read-noise
#: salts (which count up from 0) and below the fault masks'
#: (``FAULT_SALT_BASE = 0x0F00_0000``).
HW_SALT_BASE = ref.HW_SALT_BASE


@dataclasses.dataclass(frozen=True)
class HwAwareConfig:
    """Policy of hardware-aware training (``hw_aware=`` of the trainer).

    ``spec`` is the device model trained against (load a measured one with
    :func:`repro_torch.core.analogue.spec_from_calibration`); ``read_sigma``
    overrides ``spec.read_noise`` for training only; ``k_draws``
    independent device realisations are averaged per step.  ``faults``
    adds the composed fault model of :mod:`repro_torch.core.faults` to the
    write path: stuck cells pinned at G_on/G_off and, with ``drift_reads >
    0``, drift snapshots spread over the draws (array ages 0 ..
    ``drift_reads``).  ``fault_ensemble=True`` redraws the stuck mask per
    (step, draw), so the weights become robust to the distribution of
    arrays, not to one array."""

    spec: AnalogueSpec = AnalogueSpec()
    k_draws: int = 4
    noise_seed: int = 0
    read_sigma: Optional[float] = None   # None = spec.read_noise
    faults: Optional[Any] = None         # FaultModel | None
    fault_ensemble: bool = False
    drift_reads: int = 0                 # max array age covered by draws

    def __post_init__(self):
        if self.k_draws < 1:
            raise ValueError(
                f"HwAwareConfig.k_draws must be >= 1, got {self.k_draws}")
        if self.read_sigma is not None and self.read_sigma < 0:
            raise ValueError(
                f"HwAwareConfig.read_sigma must be >= 0, "
                f"got {self.read_sigma}")
        if self.drift_reads < 0:
            raise ValueError(
                f"HwAwareConfig.drift_reads must be >= 0, "
                f"got {self.drift_reads}")
        if self.fault_ensemble and self.faults is None:
            raise ValueError(
                "HwAwareConfig.fault_ensemble=True needs a fault model "
                "(faults=...) to resample from")

    @property
    def effective_read_sigma(self) -> float:
        return (self.spec.read_noise if self.read_sigma is None
                else self.read_sigma)

    @classmethod
    def from_backend(cls, backend, **overrides) -> "HwAwareConfig":
        """The policy of a ``FusedAnalogueCudaBackend``: train against the
        substrate that will serve (its spec and fault model, the noise
        keyed by its ``read_seed``)."""
        kw = dict(spec=backend.spec, noise_seed=int(backend.read_seed),
                  faults=backend.faults)
        kw.update(overrides)
        return cls(**kw)


def _hw_salt(cfg: HwAwareConfig, step, draw: int, layer: int, pair: int,
             channel: int, num_layers: int) -> int:
    """The salt of (step, draw, layer, pair, channel), in uint32 that wraps."""
    return ref.hw_salt(cfg.k_draws, num_layers, step, draw, layer, pair,
                       channel)


@functools.lru_cache(maxsize=64)
def _write_path(cfg: HwAwareConfig, num_layers: int,
                draws: int) -> ref.WritePath:
    """The write path's scalars for draws 0 .. ``draws`` - 1, each draw's
    drift factor from :func:`drift_factor` (the float32 bits the kernel is
    handed)."""
    spec, fm = cfg.spec, cfg.faults
    stuck = fm is not None and fm.stuck_rate > 0
    drift = ()
    if fm is not None and fm.drift is not None and cfg.drift_reads > 0:
        drift = tuple(float(drift_factor(
            fm, cfg.drift_reads * d // max(cfg.k_draws - 1, 1)))
            for d in range(draws))
    return ref.WritePath(
        noise_seed=int(cfg.noise_seed) & ref.U32_MASK, k_draws=cfg.k_draws,
        num_layers=num_layers, g_min=spec.g_min, g_max=spec.g_max,
        levels=spec.levels, quantize=spec.quantize,
        prog_noise=spec.prog_noise, read_sigma=cfg.effective_read_sigma,
        stuck_rate=fm.stuck.rate if stuck else 0.0,
        on_frac=fm.stuck.on_frac if stuck else 0.5,
        fault_seed=int(fm.seed) & ref.U32_MASK if fm is not None else 0,
        fault_ensemble=cfg.fault_ensemble, drift=drift)


def write_path_tensor(folded: torch.Tensor, cfg: HwAwareConfig, step,
                      draw: int, layer: int,
                      num_layers: int) -> torch.Tensor:
    """One folded tensor (bias as the last row) through the write path,
    weight units in and out: a pure function of ``(folded, cfg, step,
    draw)``.  K3's write-path kernel on CUDA, its plain version on the
    CPU."""
    folded = _require_floating(folded, f"params[{layer}] (w|b folded)")
    wp = _write_path(cfg, num_layers, draw + 1)
    w, b = _k3.hw_write_path([folded[:-1]], [folded[-1]], wp, step,
                             range(draw, draw + 1), layer0=layer)[0][0]
    return torch.cat([w, b[None, :]])


class _WritePathSTE(torch.autograd.Function):
    """The straight-through write path of all layers for a range of draws:
    forward one K3 launch (or the plain version on the CPU) giving each
    draw's ``folded + (w_hw - folded)``; backward the identity, summed over
    the draws."""

    @staticmethod
    def forward(ctx, wp, step, draws, *leaves):
        L = len(leaves) // 2
        ctx.L, ctx.nd = L, len(draws)
        per_draw = _k3.hw_write_path(leaves[:L], leaves[L:], wp, step, draws,
                                     ste=True)
        # per draw: every layer's w, then every layer's b
        return tuple(t for pairs in per_draw
                     for t in [w for w, _ in pairs] + [b for _, b in pairs])

    @staticmethod
    def backward(ctx, *grads):
        n = 2 * ctx.L
        sums = []
        for j in range(n):
            g = None
            for d in range(ctx.nd):
                gd = grads[d * n + j]
                if gd is not None:
                    g = gd if g is None else g + gd
            sums.append(g)
        return (None, None, None, *sums)


def _draws(params, cfg: HwAwareConfig, step, draws: range) -> list:
    """``hw_aware_params`` for every draw of ``draws`` at once: one K3
    launch on CUDA.  Returns a list (per draw) of param lists."""
    L = len(params)
    ws = [_require_floating(p["w"], f"params[{i}] (w|b folded)")
          for i, p in enumerate(params)]
    bs = [_require_floating(p["b"], f"params[{i}] (w|b folded)")
          for i, p in enumerate(params)]
    wp = _write_path(cfg, L, draws.stop)
    if not isinstance(step, torch.Tensor):
        step = int(step)
    flat = _WritePathSTE.apply(wp, step, draws, *ws, *bs)
    return [[{"w": flat[d * 2 * L + i], "b": flat[d * 2 * L + L + i]}
             for i in range(L)] for d in range(len(draws))]


def hw_aware_params(params, cfg: HwAwareConfig, step, draw: int = 0) -> list:
    """The MLP param list through the write path, with the STE: forward the
    degraded weights the array would realise at training step ``step``,
    device realisation ``draw``; gradient the identity."""
    return _draws(params, cfg, step, range(draw, draw + 1))[0]


def _step_draws(params, cfg: HwAwareConfig, step) -> list:
    """All ``k_draws`` realisations of one training step, in one launch on
    CUDA: ``[hw_aware_params(params, cfg, step, d) for d in range(k)]``
    (the trainer's losses draw through it)."""
    return _draws(params, cfg, step, range(cfg.k_draws))


def expectation_over_draws(per_draw_loss, cfg: HwAwareConfig):
    """Mean loss over ``k_draws`` device realisations;
    ``per_draw_loss(draw) -> scalar``."""
    return torch.mean(torch.stack([per_draw_loss(d)
                                   for d in range(cfg.k_draws)]))
