"""Parameter trees and optimizers for training.

Trainable parameters are nested dicts/lists of tensors in the JAX layouts,
as everywhere in the port. The optimizers are torch's own over the tree's
leaves, with the optax settings of the JAX package:

- `adamw`: `optax.adamw(lr, weight_decay)` (b1 0.9, b2 0.999, eps 1e-8,
  decay on every leaf, bias correction from one step count). torch's AdamW
  computes p - lr * (wd * p + m_hat / (sqrt(v_hat) + eps)) as optax does,
  in another order of rounding.
- `adam` + `clip_by_global_norm_`: `optax.chain(clip_by_global_norm(c),
  adam(lr, b1, b2))` of the codec GAN.

`opt_state` / `load_opt_state` move the moments and the step count in and
out of a tree {"mu", "nu", "count"} for `utils/checkpoint.save_native`.
"""

from __future__ import annotations

from typing import Callable, List

import torch


def leaves(tree) -> List[torch.Tensor]:
    """The tensors of a tree, depth first, dict keys in insertion order."""
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in leaves(v)]
    return [] if tree is None else [tree]


def map_tree(fn: Callable, tree):
    if isinstance(tree, dict):
        return {k: map_tree(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_tree(fn, v) for v in tree)
    return None if tree is None else fn(tree)


def trainable(tree):
    """A copy of `tree` whose leaves are new autograd leaves (the caller's
    tensors are left as they are)."""
    return map_tree(lambda t: t.detach().clone().requires_grad_(True), tree)


def adamw(tree, lr: float, weight_decay: float = 0.01) -> torch.optim.AdamW:
    return torch.optim.AdamW(leaves(tree), lr=lr, betas=(0.9, 0.999),
                             eps=1e-8, weight_decay=weight_decay)


def adam(tree, lr: float, b1: float, b2: float) -> torch.optim.Adam:
    return torch.optim.Adam(leaves(tree), lr=lr, betas=(b1, b2), eps=1e-8)


def set_grads(tree, grads) -> None:
    for p, g in zip(leaves(tree), grads):
        p.grad = g


def clip_by_global_norm_(grads: List[torch.Tensor], max_norm: float) -> None:
    """optax.clip_by_global_norm, in place: every gradient times
    max_norm / norm when the global norm exceeds max_norm."""
    norm = torch.sqrt(sum((g.float() * g.float()).sum() for g in grads))
    if float(norm) >= max_norm:
        for g in grads:
            g.copy_(g / norm * max_norm)


def opt_state(optimizer: torch.optim.Optimizer, tree) -> dict:
    """The (Adam/AdamW) moments of `tree`'s leaves, in its structure, and
    the step count (a one-element tensor: the npz format keeps no 0-d
    arrays)."""
    state = optimizer.state
    mu = map_tree(lambda p: state[p]["exp_avg"].detach().clone(), tree)
    nu = map_tree(lambda p: state[p]["exp_avg_sq"].detach().clone(), tree)
    count = int(state[leaves(tree)[0]]["step"])
    return {"mu": mu, "nu": nu, "count": torch.tensor([count], dtype=torch.int64)}


def load_opt_state(optimizer: torch.optim.Optimizer, tree, saved: dict) -> None:
    """Put saved moments and step count back under `tree`'s leaves, so the
    next step applies bias correction at count + 1, as an uninterrupted run
    does."""
    count = int(saved["count"][0])
    for p, m, v in zip(leaves(tree), leaves(saved["mu"]), leaves(saved["nu"])):
        optimizer.state[p] = {
            "step": torch.tensor(float(count), dtype=torch.float32),
            "exp_avg": torch.as_tensor(m, device=p.device).to(p.dtype).clone(),
            "exp_avg_sq": torch.as_tensor(v, device=p.device).to(p.dtype).clone(),
        }
