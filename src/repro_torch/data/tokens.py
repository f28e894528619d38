"""Synthetic token pipeline (port of ``repro/data/tokens.py``):
deterministic and stateless, every batch a function of (seed, step).

* ``random`` — i.i.d. uniform tokens.
* ``markov`` — the JAX package's fixed first-order chain: the next token
  is an LCG hash of the current one (int32 arithmetic, wrapping) modulo
  ``markov_states``, plus a draw in {0, 1, 2}, modulo the vocab.

The draws come from a seeded CPU ``torch.Generator``, so the tokens are
not ``jax.random``'s; the chain's transition is the JAX package's.
Tokens are int64 (torch's index type) on the CPU; callers move them.
"""
from __future__ import annotations

import dataclasses

import torch

_LCG_MUL, _LCG_ADD = 1103515245, 12345


def _wrap_int32(x: torch.Tensor) -> torch.Tensor:
    """int64 values reduced to int32's two's-complement range."""
    return (x + 2 ** 31) % 2 ** 32 - 2 ** 31


def markov_next(tok: torch.Tensor, eps: torch.Tensor, states: int,
                vocab: int) -> torch.Tensor:
    """One step of the chain: ((tok * 1103515245 + 12345) in int32) mod
    ``states``, plus eps mod 3, mod ``vocab`` (floor modulo, as jnp's)."""
    nxt = _wrap_int32(tok * _LCG_MUL + _LCG_ADD) % states
    return (nxt + eps % 3) % vocab


@dataclasses.dataclass(frozen=True)
class TokenPipeline:
    vocab: int
    seq_len: int
    batch: int
    seed: int = 0
    mode: str = "markov"        # markov | random
    markov_states: int = 64     # transition structure rank (<= vocab)

    def batch_at(self, step: int) -> dict:
        """Pure function of step -> {'tokens': (B, S+1) int64}."""
        gen = torch.Generator().manual_seed(
            (int(self.seed) * 1_000_003 + int(step)) % 2 ** 63)
        shape = (self.batch, self.seq_len + 1)
        if self.mode == "random":
            return {"tokens": torch.randint(0, self.vocab, shape,
                                            generator=gen)}
        m = min(self.markov_states, self.vocab)
        tok = torch.randint(0, self.vocab, (self.batch,), generator=gen)
        noise = torch.randint(0, 7919, shape, generator=gen)
        seq = torch.empty(shape, dtype=torch.int64)
        for t in range(shape[1]):
            tok = markov_next(tok, noise[:, t], m, self.vocab)
            seq[:, t] = tok
        return {"tokens": seq}

    def __iter__(self):
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


def input_specs(cfg, shape, mesh_axes=None) -> dict:
    """The step inputs of a dry run as ``meta``-device tensors (shape and
    dtype only, never allocated), the JAX package's
    ``ShapeDtypeStruct``s: train/prefill ``{'tokens': (B, S+1)}``,
    decode the single-token step ``{'tokens': (B, 1)}``, int32.
    ``cfg`` and ``mesh_axes`` keep the JAX signature; the shapes need
    neither, as in JAX."""
    del cfg, mesh_axes
    b, s = shape.global_batch, shape.seq_len
    rows = s + 1 if shape.kind in ("train", "prefill") else 1
    return {"tokens": torch.empty((b, rows), dtype=torch.int32,
                                  device="meta")}


def split_batch(batch: dict) -> tuple[torch.Tensor, torch.Tensor]:
    """(B, S+1) tokens -> (inputs (B, S), labels (B, S))."""
    toks = batch["tokens"]
    return toks[:, :-1], toks[:, 1:]
