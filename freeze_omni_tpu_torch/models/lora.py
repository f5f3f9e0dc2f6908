"""LoRA adapters for the frozen Qwen2 backbone (counterpart of
freeze_omni_tpu/models/lora.py).

- `init`: low-rank (A, B) pairs per decoder-layer projection, stacked
  [L, ...] like the backbone. B starts at zero, so an untrained adapter
  changes nothing.
- `merge`: folds scale * A @ B into the weights for serving with no
  overhead. Dense leaves gain the delta in their own dtype; int8
  {"w_q", "scale"} and int4 {"w_q4", "scale4"} leaves are dequantized,
  merged in f32 and requantized with fresh scales (ops/quant), one layer at
  a time. The delta A @ B is summed in f32, as in the JAX merge; the card
  and the CPU requantize the same weights, and their scales can still
  differ by an ulp (on the card PyTorch divides by a scalar as a multiply
  by its reciprocal).
- `save` / `load`: one .npz of {name.a, name.b} arrays and `__scale__`, the
  JAX package's format, so an adapter trained there serves here.
- `delta`: one layer's scale * (h @ A) @ B, which `qwen2.forward(...,
  lora=...)` adds to a projection's output while the base weights stay
  frozen (training stage "lora", training/train_step.lora_lm_loss).
"""

from __future__ import annotations

import math
from typing import Dict, Sequence

import numpy as np
import torch

from ..config import LLMConfig
from ..ops import quant

# projections a LoRA pair may attach to (the stacked linears of
# qwen2.init_layer_stack)
TARGETS = ("q", "k", "v", "o", "gate", "up", "down")
DEFAULT_TARGETS = ("q", "v")


def _dims(cfg: LLMConfig, name: str) -> tuple:
    D, H, Hkv, dk = cfg.hidden, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    return {
        "q": (D, H * dk),
        "k": (D, Hkv * dk),
        "v": (D, Hkv * dk),
        "o": (H * dk, D),
        "gate": (D, cfg.ffn),
        "up": (D, cfg.ffn),
        "down": (cfg.ffn, D),
    }[name]


def _check_targets(targets) -> None:
    unknown = set(targets) - set(TARGETS)
    if unknown:
        raise ValueError(f"unknown LoRA targets {sorted(unknown)} "
                         f"(expected among {TARGETS})")


def init(cfg: LLMConfig, gen: torch.Generator, rank: int = 8,
         targets: Sequence[str] = DEFAULT_TARGETS, dtype=torch.float32,
         device=None) -> Dict[str, dict]:
    """{name: {"a": [L, in, r], "b": [L, r, out]}} for each target, drawn
    from `gen` on `device` (None: the card). A ~ U(-1/sqrt(in), 1/sqrt(in)),
    B = 0: the delta starts at exactly zero."""
    from ..utils.device import resolve_device

    _check_targets(targets)
    device = resolve_device(device)
    L = cfg.num_layers
    tree = {}
    for name in targets:
        d_in, d_out = _dims(cfg, name)
        bound = 1.0 / math.sqrt(d_in)
        u = torch.rand((L, d_in, rank), generator=gen, device=device)
        tree[name] = {"a": ((u * 2.0 - 1.0) * bound).to(dtype),
                      "b": torch.zeros((L, rank, d_out), dtype=dtype,
                                       device=device)}
    return tree


def delta(lora_l: dict, h: torch.Tensor, scale: float) -> torch.Tensor:
    """One layer's delta: scale * (h @ A) @ B in the adapter's dtype (f32
    while training over a bf16 backbone), returned in h's dtype so the
    residual stream keeps its dtype."""
    a, b = lora_l["a"], lora_l["b"]
    y = (h.to(a.dtype) @ a) @ b
    return (y * scale).to(h.dtype)


def _delta(a: torch.Tensor, b: torch.Tensor, scale: float) -> torch.Tensor:
    """One layer's scale * a @ b, f32 [in, out], summed in f32 as the JAX
    merge sums it. With TF32 off (PyTorch's default for matmuls) the card's
    sum is the CPU's, bit for bit, at Qwen2-7B widths and rank 16."""
    return (a.float() @ b.float()) * scale


def _merge_layer(pl: dict, d: torch.Tensor) -> dict:
    """One layer's projection leaves plus the f32 delta d [in, out]."""
    if "w_q4" in pl:
        group = (2 * pl["w_q4"].shape[-2]) // pl["scale4"].shape[-2]
        w = quant.dequantize_weight_int4(pl, dtype=torch.float32) + d
        return quant.quantize_linear_int4({"w": w}, group=group)
    if "w_q" in pl:
        w = pl["w_q"].float() * pl["scale"][..., None, :].float() + d
        return quant.quantize_linear({"w": w})
    return {"w": (pl["w"].float() + d).to(pl["w"].dtype)}


def merge(llm_params: dict, lora: Dict[str, dict], scale: float = 1.0) -> dict:
    """Fold the adapter into the backbone; returns a NEW llm tree (the input
    is not modified). Runs layer by layer, so the f32 transient is one
    layer's [in, out] (~271 MB for a 7B ffn projection), not the stack. The
    merge runs on the weights' device; the adapter is moved there."""
    _check_targets(lora)
    layers = dict(llm_params["layers"])
    for name, pair in lora.items():
        p = layers[name]
        weight_keys = [k for k in p if k != "b"]
        dev = p[weight_keys[0]].device
        a, b = (x.to(dev) if isinstance(x, torch.Tensor)
                else torch.from_numpy(np.array(x)).to(dev)
                for x in (pair["a"], pair["b"]))
        new = None
        for i in range(a.shape[0]):
            out = _merge_layer({k: p[k][i] for k in weight_keys},
                               _delta(a[i], b[i], scale))
            if new is None:
                new = {k: torch.empty((a.shape[0], *v.shape), dtype=v.dtype,
                                      device=dev) for k, v in out.items()}
            for k, v in out.items():
                new[k][i] = v
        if "b" in p:
            new["b"] = p["b"]
        layers[name] = new
    out = dict(llm_params)
    out["layers"] = layers
    return out


def save(path: str, lora: Dict[str, dict], scale: float = 1.0) -> None:
    """One .npz: flat {name.a, name.b} arrays + the merge scale."""
    flat = {"__scale__": np.asarray(scale, np.float32)}
    for name, pair in lora.items():
        for leaf in ("a", "b"):
            x = pair[leaf]
            flat[f"{name}.{leaf}"] = (x.detach().cpu().numpy()
                                      if isinstance(x, torch.Tensor)
                                      else np.asarray(x))
    np.savez(path, **flat)


def load(path: str) -> tuple:
    """-> (lora tree of host numpy arrays, scale)."""
    with np.load(path) as z:
        scale = float(z["__scale__"]) if "__scale__" in z.files else 1.0
        tree: Dict[str, dict] = {}
        for k in z.files:
            if k == "__scale__":
                continue
            name, leaf = k.rsplit(".", 1)
            tree.setdefault(name, {})[leaf] = z[k]
    return tree, scale
