"""Digital baselines the paper compares its twin against (port of
``repro/models/baselines.py``): the recurrent ResNet of the HP twin
(Fig. 3j) and the LSTM / GRU / RNN forecasters of the Lorenz96 twin
(Fig. 4g-i).  From-scratch cells.

All models share one contract for the twin tasks:
  * driven (HP):    carry -> carry', given input u_t; observable via head.
  * autonomous (L96): next-state predictor y_t -> y_{t+1}; teacher-forced
    training, closed-loop rollout at evaluation.

Plain functions on tensors, as the twin's MLP is: the parameters keep the
JAX package's trees (the ResNet's list of ``{"w", "b"}`` dicts; a
forecaster's ``{"cell": {"wx": {"w", "b"}, "wh": {...}}, "head": {"w",
"b"}}``), so the training engines and :mod:`repro_torch.interop` carry
them unchanged.  Where the JAX package runs one series and vmaps, every
model here takes leading batch axes: the ResNet's shooting segments
train as one batched loop.  Initialisers draw from a CPU
``torch.Generator`` and move to ``device`` (default ``cuda``), so their
values are not ``jax.random``'s; the shapes and distributions are.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from repro_torch.core.node import dense_linear, mlp_apply, mlp_init
from repro_torch.device import resolve_device


# ---------------------------------------------------------------------------
# Recurrent ResNet (paper Eq. 8): h_{t+1} = h_t + f([u_t, h_t])
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class RecurrentResNet:
    """Finite-depth discrete-transition model — the paper's digital twin
    baseline.  Same MLP sizes as the neural ODE for parameter parity."""
    sizes: tuple          # (u_dim + state_dim, hidden..., state_dim)
    state_dim: int

    def init(self, generator: torch.Generator, *, device=None) -> list:
        # Near-identity residual init: zero the last layer so the T-step
        # transition starts as h_{t+1} = h_t.  With a generic last layer
        # the 50-step training segments compound O(1) residuals into
        # overflow before the first update and training diverges to NaN
        # (seed 42 did exactly that in the JAX package).
        params = mlp_init(generator, self.sizes, device=device)
        params[-1] = {"w": torch.zeros_like(params[-1]["w"]),
                      "b": params[-1]["b"]}
        return params

    def rollout(self, params: list, y0: torch.Tensor,
                us: torch.Tensor) -> torch.Tensor:
        """y0: (..., state); us: (..., T, u_dim) drive samples.  Returns
        (..., T+1, state)."""
        y, ys = y0, [y0]
        for t in range(us.shape[-2]):
            y = y + mlp_apply(params, torch.cat([us[..., t, :], y], dim=-1))
            ys.append(y)
        return torch.stack(ys, dim=-2)


# ---------------------------------------------------------------------------
# Gated recurrent cells (from scratch)
# ---------------------------------------------------------------------------

def _dense_init(generator: torch.Generator, din: int, dout: int,
                scale: Optional[float] = None, *, device=None) -> dict:
    scale = scale if scale is not None else 1.0 / math.sqrt(din)
    device = resolve_device(device)
    w = scale * torch.randn((din, dout), generator=generator)
    return {"w": w.to(device), "b": torch.zeros((dout,), device=device)}


def lstm_init(generator, in_dim: int, hidden: int, *, device=None) -> dict:
    return {"wx": _dense_init(generator, in_dim, 4 * hidden, device=device),
            "wh": _dense_init(generator, hidden, 4 * hidden, device=device)}


def lstm_step(params: dict, carry, x: torch.Tensor):
    h, c = carry
    z = (dense_linear(params["wx"]["w"], params["wx"]["b"], x)
         + dense_linear(params["wh"]["w"], params["wh"]["b"], h))
    i, f, g, o = torch.chunk(z, 4, dim=-1)
    c = torch.sigmoid(f + 1.0) * c + torch.sigmoid(i) * torch.tanh(g)
    h = torch.sigmoid(o) * torch.tanh(c)
    return (h, c), h


def gru_init(generator, in_dim: int, hidden: int, *, device=None) -> dict:
    return {"wx": _dense_init(generator, in_dim, 3 * hidden, device=device),
            "wh": _dense_init(generator, hidden, 3 * hidden, device=device)}


def gru_step(params: dict, carry, x: torch.Tensor):
    h = carry
    zx = dense_linear(params["wx"]["w"], params["wx"]["b"], x)
    zh = dense_linear(params["wh"]["w"], params["wh"]["b"], h)
    rx, ux, cx = torch.chunk(zx, 3, dim=-1)
    rh, uh, ch = torch.chunk(zh, 3, dim=-1)
    r = torch.sigmoid(rx + rh)
    u = torch.sigmoid(ux + uh)
    c = torch.tanh(cx + r * ch)
    h = u * h + (1 - u) * c
    return h, h


def rnn_init(generator, in_dim: int, hidden: int, *, device=None) -> dict:
    return {"wx": _dense_init(generator, in_dim, hidden, device=device),
            "wh": _dense_init(generator, hidden, hidden, device=device)}


def rnn_step(params: dict, carry, x: torch.Tensor):
    h = torch.tanh(dense_linear(params["wx"]["w"], params["wx"]["b"], x)
                   + dense_linear(params["wh"]["w"], params["wh"]["b"],
                                  carry))
    return h, h


def _zeros(hidden: int, x: torch.Tensor) -> torch.Tensor:
    """A zero state of ``hidden`` units for each row of ``x`` (..., D)."""
    return torch.zeros(x.shape[:-1] + (hidden,), dtype=x.dtype,
                       device=x.device)


#: name -> (init, step, initial carry for a (..., D) input)
CELLS = {
    "lstm": (lstm_init, lstm_step,
             lambda h, x: (_zeros(h, x), _zeros(h, x))),
    "gru": (gru_init, gru_step, _zeros),
    "rnn": (rnn_init, rnn_step, _zeros),
}


@dataclasses.dataclass(frozen=True)
class RecurrentForecaster:
    """cell + linear head; next-step prediction of a multivariate series."""
    cell: str
    in_dim: int
    hidden: int
    out_dim: int

    def init(self, generator: torch.Generator, *, device=None) -> dict:
        cinit, _, _ = CELLS[self.cell]
        return {"cell": cinit(generator, self.in_dim, self.hidden,
                              device=device),
                "head": _dense_init(generator, self.hidden, self.out_dim,
                                    device=device)}

    def _step(self, params: dict, carry, x: torch.Tensor):
        _, cstep, _ = CELLS[self.cell]
        carry, h = cstep(params["cell"], carry, x)
        y = dense_linear(params["head"]["w"], params["head"]["b"], h)
        return carry, y

    def teacher_forced(self, params: dict, ys: torch.Tensor) -> torch.Tensor:
        """Predict ys[..., 1:, :] from ys[..., :-1, :]; returns
        (..., T-1, out_dim)."""
        carry = CELLS[self.cell][2](self.hidden, ys[..., 0, :])
        preds = []
        for t in range(ys.shape[-2] - 1):
            carry, y = self._step(params, carry, ys[..., t, :])
            preds.append(y)
        return torch.stack(preds, dim=-2)

    def closed_loop(self, params: dict, y0: torch.Tensor, num_steps: int,
                    warmup: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Autoregressive rollout from y0 (optionally after a warm-up
        prefix (..., W, in_dim) that only advances the carry); returns
        (..., num_steps+1, out_dim) including y0."""
        carry = CELLS[self.cell][2](self.hidden, y0)
        if warmup is not None:
            for t in range(warmup.shape[-2]):
                carry, _ = self._step(params, carry, warmup[..., t, :])
        y, ys = y0, [y0]
        for _ in range(num_steps):
            carry, y = self._step(params, carry, y)
            ys.append(y)
        return torch.stack(ys, dim=-2)
