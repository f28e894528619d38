"""Carry MLP parameters, programmed crossbars and parameter trees (the
LM models', the digital baselines') between the JAX package and the port
as numpy.

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
from repro_torch.tree import tree_map


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


def _leaf_from_numpy(x, device) -> torch.Tensor:
    arr = np.asarray(x)
    if arr.dtype.name == "bfloat16":
        # numpy's bf16 (from ml_dtypes) is no dtype torch.from_numpy takes:
        # widen to float32 and narrow again, exact both ways
        return torch.from_numpy(arr.astype(np.float32)).to(
            device=device, dtype=torch.bfloat16)
    return torch.from_numpy(np.array(arr, copy=True)).to(device)


def lm_params_from_numpy(tree, device=None):
    """A JAX param tree of arrays (nested dicts and lists: an LM's, with
    its ``prelude`` list and ``stack`` leaves with their leading n_periods
    axis, or a baseline's ``{"cell": {"wx": {"w", "b"}, ...}, "head":
    ...}``) -> the same tree of tensors on ``device`` (default ``cuda``),
    values and dtypes kept, bf16 included."""
    device = resolve_device(device)
    return tree_map(lambda x: _leaf_from_numpy(x, device), tree)


def lm_params_to_numpy(tree):
    """The inverse: tensors on any device -> numpy arrays on the host.  bf16
    leaves come back as float32 (numpy has no bf16 of its own); every
    other dtype is kept."""
    def leaf(t):
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.to(torch.float32)
        return t.numpy()
    return tree_map(leaf, tree)
