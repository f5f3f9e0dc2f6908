"""Samplers in the reference's decode order (counterpart of
freeze_omni_tpu/ops/sampling.py).

- `sample_top_k_top_p`: temperature -> softmax -> top-k (renormalise) ->
  top-p over the descending survivors, always keeping the argmax ->
  renormalise -> categorical (AudioLLM._post_decode, models/audioLLM.py:431-477).
- `sample_top_k`: softmax -> top-k -> renormalise -> categorical (the speech
  decoder's sampler, models/decoder/decoder.py:353-359).
- `apply_repetition_penalty`: logits of tokens present in the recent window
  are divided by `penalty` (decoder.py:349-351).

The JAX functions take a PRNG key; these take a `torch.Generator` on the
logits' device and draw from it. The two give different random numbers, so
sampled tokens agree with the JAX package in distribution, and greedy
(top_k = 1) draws agree exactly.
"""

from __future__ import annotations

import torch


def _categorical(gen: torch.Generator, vals: torch.Tensor,
                 idx: torch.Tensor) -> torch.Tensor:
    """One draw per row from the normalised weights `vals` [B, k]; returns
    the matching entries of `idx` [B, k] as int32 [B]."""
    choice = torch.multinomial(vals, 1, generator=gen)
    return torch.gather(idx, -1, choice)[:, 0].to(torch.int32)


def sample_top_k(gen: torch.Generator, logits: torch.Tensor,
                 top_k: int) -> torch.Tensor:
    """logits: [B, V]. Returns [B] int32."""
    probs = torch.softmax(logits.float(), dim=-1)
    vals, idx = torch.topk(probs, top_k, dim=-1)   # descending
    vals = vals / vals.sum(dim=-1, keepdim=True)
    return _categorical(gen, vals, idx)


def sample_top_k_top_p(gen: torch.Generator, logits: torch.Tensor,
                       temperature: float = 1.0, top_k: int = 0,
                       top_p: float = 0.0) -> torch.Tensor:
    """logits: [B, V]. Returns [B] int32."""
    x = logits.float()
    if temperature != 1.0:
        x = x / temperature
    probs = torch.softmax(x, dim=-1)
    k = top_k if top_k > 0 else probs.shape[-1]
    vals, idx = torch.topk(probs, k, dim=-1)        # descending
    vals = vals / vals.sum(dim=-1, keepdim=True)
    if top_p > 0.0:
        remove = torch.cumsum(vals, dim=-1) > top_p
        # the highest-probability token is always kept (audioLLM.py:468-470)
        remove = torch.cat([torch.zeros_like(remove[:, :1]), remove[:, :-1]],
                           dim=-1)
        vals = torch.where(remove, torch.zeros_like(vals), vals)
        vals = vals / vals.sum(dim=-1, keepdim=True)
    return _categorical(gen, vals, idx)


def present_tokens(window: torch.Tensor, vocab: int) -> torch.Tensor:
    """[B, W] token ids -> [B, vocab] bool, True where an id occurs in the
    row's window. Ids outside [0, vocab) mark nothing (empty ring slots)."""
    B = window.shape[0]
    ids = window.long()
    ids = torch.where((ids >= 0) & (ids < vocab), ids, torch.full_like(ids, vocab))
    present = torch.zeros((B, vocab + 1), dtype=torch.bool, device=window.device)
    present.scatter_(1, ids, True)
    return present[:, :vocab]


def apply_repetition_penalty(logits: torch.Tensor, window: torch.Tensor,
                             penalty: float) -> torch.Tensor:
    """logits: [B, V]; window: [B, W] token ids of the recent window (an
    out-of-range id, e.g. V, marks an empty slot). Tokens in the window get
    their logit divided by `penalty` (once, set semantics)."""
    present = present_tokens(window, logits.shape[-1])
    return torch.where(present, logits / penalty, logits)
