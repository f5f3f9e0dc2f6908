"""Weight-only int8 quantization for the frozen LLM backbone (counterpart of
freeze_omni_tpu/ops/quant.py).

A quantized linear is {"w_q": int8 [in, out], "scale": f32 [out], "b"?};
models/layers.linear dispatches on the presence of "w_q". The int8 embedding
is per row: {"w_q": int8 [V, D], "scale": f32 [V]}. Rounding is
half-to-even in both `torch.round` and `jnp.round`, so both packages quantize
the same float weights to the same bytes.
"""

from __future__ import annotations

import math

import torch


def quantize_linear(p: dict) -> dict:
    """{"w": [..., in, out], "b"?} -> {"w_q": int8, "scale": f32 [..., out], "b"?}.
    Scales are per output channel (and per layer for stacked weights)."""
    w = p["w"].float()
    amax = w.abs().amax(dim=-2, keepdim=True)  # over the input dim
    scale = torch.clamp(amax / 127.0, min=1e-8)
    w_q = torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8)
    out = {"w_q": w_q, "scale": scale.squeeze(-2)}
    if "b" in p:
        out["b"] = p["b"]
    return out


def dequantize_weight(p: dict, dtype=torch.bfloat16) -> torch.Tensor:
    return (p["w_q"].float() * p["scale"][..., None, :]).to(dtype)


def quantize_embedding(p: dict) -> dict:
    """{"w": [V, D]} -> {"w_q": int8, "scale": f32 [V]} (per-row symmetric)."""
    w = p["w"].float()
    amax = w.abs().amax(dim=-1, keepdim=True)
    scale = torch.clamp(amax / 127.0, min=1e-8)
    return {"w_q": torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8),
            "scale": scale[..., 0]}


_LAYER_PROJS = ("q", "k", "v", "o", "gate", "up", "down")


def quantize_llm_params(params: dict, quantize_embeddings: bool = True) -> dict:
    """Quantize the stacked layer projections (q/k/v/o/gate/up/down) and, by
    default, the token embedding (per row) and lm_head (per column); norms stay
    in full precision. One weight group at a time, so only one group's f32
    staging copy exists at once."""
    out = dict(params)
    layers = dict(params["layers"])
    for name in _LAYER_PROJS:
        layers[name] = quantize_linear(layers[name])
    out["layers"] = layers
    if quantize_embeddings:
        out["embed"] = quantize_embedding(params["embed"])
        if "lm_head" in params:
            out["lm_head"] = quantize_linear(params["lm_head"])
    return out


def init_quantized_llm(cfg, generator: torch.Generator, device,
                       dtype=torch.bfloat16) -> dict:
    """Random-init a Qwen2 tree directly in int8 on `device` (counterpart of
    ops/quant.init_quantized_llm). Each projection group is drawn and
    quantized one layer at a time, so the peak above the final int8 footprint
    is one layer's f32 staging copy. The card has no JAX, so full-width
    weights there come from here; the numbers differ from the JAX init for
    the same seed (a different generator), which nothing goldens."""
    L, D = cfg.num_layers, cfg.hidden
    H, Hkv, dk = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim

    def uniform(shape, bound):
        u = torch.rand(shape, generator=generator, device=device)
        return ((u * 2.0 - 1.0) * bound).to(dtype)

    def q_group(i, o, bias):
        bound = 1.0 / math.sqrt(i)
        w_q = torch.empty((L, i, o), dtype=torch.int8, device=device)
        scale = torch.empty((L, o), dtype=torch.float32, device=device)
        for layer in range(L):
            q = quantize_linear({"w": uniform((i, o), bound)})
            w_q[layer], scale[layer] = q["w_q"], q["scale"]
        p = {"w_q": w_q, "scale": scale}
        if bias:
            p["b"] = uniform((L, o), bound)
        return p

    layers = {
        "ln1": {"scale": torch.ones((L, D), dtype=dtype, device=device)},
        "q": q_group(D, H * dk, cfg.qkv_bias),
        "k": q_group(D, Hkv * dk, cfg.qkv_bias),
        "v": q_group(D, Hkv * dk, cfg.qkv_bias),
        "o": q_group(H * dk, D, False),
        "ln2": {"scale": torch.ones((L, D), dtype=dtype, device=device)},
        "gate": q_group(D, cfg.ffn, False),
        "up": q_group(D, cfg.ffn, False),
        "down": q_group(cfg.ffn, D, False),
    }

    def normal_rows(shape):
        return (torch.randn(shape, generator=generator, device=device)
                * 0.02).to(dtype)

    params = {"layers": layers,
              "embed": quantize_embedding({"w": normal_rows((cfg.vocab_size, D))}),
              "final_norm": {"scale": torch.ones((D,), dtype=dtype, device=device)}}
    if not cfg.tie_embeddings:
        params["lm_head"] = quantize_linear({"w": normal_rows((D, cfg.vocab_size))})
    return params
