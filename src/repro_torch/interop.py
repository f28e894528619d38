"""Carry MLP parameters and programmed crossbars between the JAX package
and the port as numpy.

Both packages keep the same layouts, a list of ``{"w": (in, out),
"b": (out,)}`` arrays for an MLP and a list of ``{"gp", "gm", "scale"}``
(plus ``gp_idx``/``gm_idx`` uint8 level indices when staged) per
programmed layer, so the hand-off is a 1:1 map.  Anything
``numpy.asarray`` accepts (JAX arrays included) goes in.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from repro_torch.device import resolve_device


def params_from_numpy(params: Sequence[dict], device=None) -> list[dict]:
    """``[{"w", "b"}, ...]`` of arrays -> the same list of tensors on
    ``device`` (default ``cuda``), values and dtypes unchanged."""
    device = resolve_device(device)
    return [{k: torch.from_numpy(np.array(v, copy=True)).to(device)
             for k, v in layer.items()} for layer in params]


def params_to_numpy(params: Sequence[dict]) -> list[dict]:
    """The inverse: tensors on any device -> numpy arrays on the host."""
    return [{k: v.detach().cpu().numpy() for k, v in layer.items()}
            for layer in params]


def progs_from_numpy(progs: Sequence[dict], device=None) -> list[dict]:
    """Programmed crossbars ``[{"gp", "gm", "scale", ...}, ...]`` of arrays
    -> the same list of tensors on ``device`` (default ``cuda``), values
    and dtypes unchanged (``scale`` a 0-d tensor), so both packages can
    read one noisy program."""
    return params_from_numpy(progs, device)


def progs_to_numpy(progs: Sequence[dict]) -> list[dict]:
    """The inverse: tensors on any device -> numpy arrays on the host."""
    return params_to_numpy(progs)
