"""LM serving step factories (port of the serving half of
``repro/train/lm_trainer.py``): the cross entropy, the prefill step, the
single-token serve step and a greedy decoding loop.  LM training
(``lm_loss``, ``make_train_step``) waits for its own slice (ROADMAP.md,
queue 1 item 13).  The steps run without autograd.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models.model import decode_step, forward, init_cache

Pytree = Any


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean next-token CE; logits float32 (B, S, V), labels (B, S)."""
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    return torch.mean(lse - ll)


def make_prefill_step(cfg: ArchConfig):
    """prefill(params, batch) -> (logits of the last position, caches);
    ``batch["tokens"]`` is (B, S+1), its last column the first label."""

    @torch.no_grad()
    def prefill_step(params, batch):
        tokens = batch["tokens"][:, :-1]
        logits, _, cache = forward(params, cfg, tokens, return_cache=True)
        return logits[:, -1, :], cache

    return prefill_step


def make_serve_step(cfg: ArchConfig):
    """decode(params, batch, pos, cache) -> (next-token logits, cache')."""

    @torch.no_grad()
    def serve_step(params, batch, pos, cache):
        logits, cache = decode_step(params, cfg, batch["tokens"], pos, cache)
        return logits[:, -1, :], cache

    return serve_step


@torch.no_grad()
def greedy_generate(params, cfg: ArchConfig, prompt: torch.Tensor,
                    num_tokens: int, max_seq: int) -> torch.Tensor:
    """Greedy decoding: the prompt (B, s) is stepped through token by token
    (the simple reference path), then ``num_tokens`` argmax tokens are
    generated.  Returns (B, num_tokens) int64 on the params' device."""
    b, s = prompt.shape
    device = params["embed"].device
    prompt = prompt.to(device)
    cache = init_cache(cfg, b, max_seq, device=device)
    logits = None
    for i in range(s):
        logits, cache = decode_step(params, cfg, prompt[:, i:i + 1], i,
                                    cache)
    toks = [torch.argmax(logits[:, -1, :], dim=-1)]
    for j in range(num_tokens - 1):
        logits, cache = decode_step(params, cfg, toks[-1][:, None], s + j,
                                    cache)
        toks.append(torch.argmax(logits[:, -1, :], dim=-1))
    return torch.stack(toks, dim=1)
