"""What a rollout executes, counted the same way on the CPU and on the card.

``torch.utils.flop_counter.FlopCounterMode`` counts the floating-point
work of the aten operations a program dispatches (matrix products and
the like).  A hand-written kernel dispatches none, and its plain version,
which runs for CPU tensors, dispatches its own operations in another
pattern.  So each kernel entry point (K1 / K1w, K4 / K4w, K7) reports
its analytic work here once per call, whichever implementation runs, and
runs its plain version inside :func:`uncounted`.  Under a
:class:`WorkCounter` one rollout then counts the same on both devices.
This is the port's counterpart of the JAX package's HLO count
(``repro/roofline/hlo_parse.py``), which :mod:`repro_torch.core.scorecard`
reads.
"""
from __future__ import annotations

import contextlib
import dataclasses

_ACTIVE: list = []


@dataclasses.dataclass
class KernelWork:
    """One kernel's reported work under a counter: calls, FLOP (a
    multiply-add counts 2, as in FlopCounterMode) and bytes (each input
    read once, each output written once)."""
    calls: int = 0
    flops: float = 0.0
    nbytes: float = 0.0


class WorkCounter:
    """``with WorkCounter() as wc: ...`` counts the aten FLOP of the block
    (``aten_flops``) and the work the kernel entry points report
    (``kernels``, by name); ``flops`` is their sum."""

    def __init__(self):
        self.kernels: dict[str, KernelWork] = {}
        self._mode = None

    def __enter__(self) -> "WorkCounter":
        from torch.utils.flop_counter import FlopCounterMode
        self._mode = FlopCounterMode(display=False)
        self._mode.__enter__()
        _ACTIVE.append(self)
        return self

    def __exit__(self, *exc):
        _ACTIVE.remove(self)
        return self._mode.__exit__(*exc)

    @property
    def aten_flops(self) -> float:
        return float(self._mode.get_total_flops())

    @property
    def kernel_flops(self) -> float:
        return sum(k.flops for k in self.kernels.values())

    @property
    def kernel_bytes(self) -> float:
        return sum(k.nbytes for k in self.kernels.values())

    @property
    def flops(self) -> float:
        return self.aten_flops + self.kernel_flops


def report(name: str, flops: float, nbytes: float) -> None:
    """Add one call of kernel ``name`` doing ``flops`` FLOP over ``nbytes``
    bytes to every active counter (nothing when none is active)."""
    for counter in _ACTIVE:
        k = counter.kernels.setdefault(name, KernelWork())
        k.calls += 1
        k.flops += float(flops)
        k.nbytes += float(nbytes)


def uncounted():
    """A context in which no counter sees the aten operations: a kernel's
    plain version runs inside it, its work being the one reported."""
    if not _ACTIVE:
        return contextlib.nullcontext()
    from torch.utils._python_dispatch import _disable_current_modes
    return _disable_current_modes()
