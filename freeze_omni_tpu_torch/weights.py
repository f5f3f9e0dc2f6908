"""Weight bridge between JAX parameter trees and the port.

The port keeps the JAX layouts leaf for leaf (linear `w` is [in, out], layer
and encoder-block leaves are stacked [L, ...], int8 leaves are `w_q` [K, O]
plus `scale` [O], int4 leaves are packed uint8 `w_q4` [K/2, O] plus f32
`scale4` [K/group, O], the int8 embedding is per row), so the bridge is a
plain map over the tree: nested dicts, lists and tuples of numpy arrays
become the same structure of tensors, and back, with dtypes kept (int8,
uint8 and f32 leaves round-trip bit for bit).

A JAX tree reaches the port as numpy (for example from the JAX package's
checkpoint loader, or `np.asarray` over a live tree); the port never imports
JAX. bfloat16 leaves (numpy dtype name 'bfloat16', as ml_dtypes defines it)
travel as their 16-bit patterns.

Full-width random weights on the card come from
`models.audio_llm.init_params(..., quantize_llm=True)`, whose backbone is
`ops.quant.init_quantized_llm`.
"""

from __future__ import annotations

import numpy as np
import torch

from .utils.device import resolve_device


def _to_tensor(leaf, device: torch.device) -> torch.Tensor:
    arr = np.asarray(leaf)
    if arr.dtype.name == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(arr).view(np.uint16).copy())
        return t.view(torch.bfloat16).to(device)
    return torch.from_numpy(np.ascontiguousarray(arr).copy()).to(device)


def _to_array(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes  # the numpy bfloat16 type JAX uses

        return t.view(torch.uint16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def from_jax(tree, device=None):
    """Tree of numpy (or array-like) leaves -> same tree of tensors on
    `device` (None means the CUDA card). dtypes and shapes are kept."""
    dev = resolve_device(device)

    def rec(node):
        if isinstance(node, dict):
            return {k: rec(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(rec(v) for v in node)
        if node is None:
            return None
        return _to_tensor(node, dev)

    return rec(tree)


def to_numpy(tree):
    """Tree of tensors -> same tree of host numpy arrays."""
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_numpy(v) for v in tree)
    if tree is None:
        return None
    return _to_array(tree)
