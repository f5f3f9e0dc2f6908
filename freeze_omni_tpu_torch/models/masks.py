"""Attention mask builders (counterpart of freeze_omni_tpu/models/masks.py;
models/masks.py of the reference).

All masks are boolean with True = attend. The dynamic-chunk training mask
(masks.py:125-183 of the reference) uses one chunk size per call: drawn from
an explicit `torch.Generator`, or passed in by the caller (`chunk`), so a
test can pin it.
"""

from __future__ import annotations

from typing import Optional

import torch


def make_pad_mask(lengths: torch.Tensor, max_len: int) -> torch.Tensor:
    """[B] lengths -> [B, T] True at PADDED positions (masks.py:3-21)."""
    return torch.arange(max_len, device=lengths.device)[None, :] >= lengths[:, None]


def make_valid_mask(lengths: torch.Tensor, max_len: int) -> torch.Tensor:
    """[B, T] True at valid positions."""
    return ~make_pad_mask(lengths, max_len)


def subsequent_mask(size: int, device=None) -> torch.Tensor:
    """[T, T] lower-triangular causal mask (masks.py:23-57)."""
    idx = torch.arange(size, device=device)
    return idx[None, :] <= idx[:, None]


def subsequent_chunk_mask(size: int, chunk_size: int, num_left_chunks: int = -1,
                          device=None) -> torch.Tensor:
    """[T, T]: position i attends within its chunk (up to the chunk's end)
    and to up to num_left_chunks earlier chunks, all of them when negative
    (masks.py:59-123)."""
    idx = torch.arange(size, device=device)
    chunk_of = idx // chunk_size
    hi = (chunk_of + 1) * chunk_size
    if num_left_chunks < 0:
        lo = torch.zeros_like(idx)
    else:
        lo = torch.clamp((chunk_of - num_left_chunks) * chunk_size, min=0)
    j = idx[None, :]
    return (j >= lo[:, None]) & (j < hi[:, None])


def add_optional_chunk_mask(size: int, pad_mask: torch.Tensor,
                            use_dynamic_chunk: bool,
                            decoding_chunk_size: int,
                            num_left_chunks: int,
                            gen: Optional[torch.Generator] = None,
                            max_dynamic_chunk: int = 25,
                            chunk: Optional[int] = None) -> torch.Tensor:
    """[B, T, T] chunk mask combined with the [B, T] validity mask
    `pad_mask` (True = valid), masks.py:125-151 semantics.

    use_dynamic_chunk takes one chunk size for the whole call: `chunk` if
    given, else a draw from `gen` in [1, max_dynamic_chunk]; otherwise the
    static (decoding_chunk_size, num_left_chunks) mask, or full attention
    when decoding_chunk_size <= 0."""
    dev = pad_mask.device
    if use_dynamic_chunk:
        if chunk is None:
            if gen is None:
                raise ValueError("dynamic chunking needs a torch.Generator "
                                 "or an explicit chunk")
            chunk = int(torch.randint(1, max_dynamic_chunk + 1, (), generator=gen))
        cm = subsequent_chunk_mask(size, chunk, -1, dev)
    elif decoding_chunk_size > 0:
        cm = subsequent_chunk_mask(size, decoding_chunk_size, num_left_chunks, dev)
    else:
        cm = torch.ones((size, size), dtype=torch.bool, device=dev)
    return cm[None] & pad_mask[:, None, :] & pad_mask[:, :, None]


def target_mask(ys_lengths: torch.Tensor, max_len: int) -> torch.Tensor:
    """[B, T, T] causal and valid decoder-target mask (masks.py:185-195)."""
    valid = make_valid_mask(ys_lengths, max_len)
    return (subsequent_mask(max_len, ys_lengths.device)[None]
            & valid[:, None, :] & valid[:, :, None])
