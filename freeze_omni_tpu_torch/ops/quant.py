"""Weight-only int8 and grouped int4 quantization for the frozen LLM backbone
(counterpart of freeze_omni_tpu/ops/quant.py).

A quantized linear is {"w_q": int8 [in, out], "scale": f32 [out], "b"?} or,
in int4, {"w_q4": uint8 [in/2, out], "scale4": f32 [in/group, out], "b"?};
models/layers.linear dispatches on the presence of "w_q4" or "w_q". The int8
embedding is per row: {"w_q": int8 [V, D], "scale": f32 [V]}. Rounding is
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


INT4_GROUP = 64  # input rows per int4 scale group


def quantize_linear_int4(p: dict, group: int = INT4_GROUP) -> dict:
    """{"w": [..., in, out], "b"?} -> {"w_q4": uint8 [..., in/2, out],
    "scale4": f32 [..., in/group, out], "b"?}. Symmetric 4-bit (-7..7) with
    one scale per (input group, output channel). Two values pack along the
    input dim: row 2i in the low nibble and row 2i+1 in the high nibble, each
    stored as q + 8."""
    w = p["w"].float()
    K, O = w.shape[-2], w.shape[-1]
    if K % 2 or K % group:
        raise ValueError(f"int4 quantization needs an even input dim divisible "
                         f"by the group: in={K}, group={group}")
    lead = w.shape[:-2]
    wg = w.reshape(*lead, K // group, group, O)
    scale = torch.clamp(wg.abs().amax(dim=-2) / 7.0, min=1e-8)
    q = torch.clamp(torch.round(wg / scale[..., None, :]), -7, 7)
    u = (q.reshape(*lead, K, O) + 8).to(torch.uint8)
    out = {"w_q4": u[..., 0::2, :] | (u[..., 1::2, :] << 4), "scale4": scale}
    if "b" in p:
        out["b"] = p["b"]
    return out


def dequantize_weight_int4(p: dict, dtype=torch.bfloat16) -> torch.Tensor:
    """Unpack {"w_q4", "scale4"} to [..., in, out] in `dtype` (the nibble
    times its group's scale, rounded once to `dtype`)."""
    packed = p["w_q4"]
    lead = packed.shape[:-2]
    K2, O = packed.shape[-2], packed.shape[-1]
    lo = (packed & 0xF).to(torch.int8) - 8
    hi = (packed >> 4).to(torch.int8) - 8
    w = torch.stack([lo, hi], dim=-2).reshape(*lead, 2 * K2, O)
    G = p["scale4"].shape[-2]
    wg = w.reshape(*lead, G, (2 * K2) // G, O).to(dtype)
    return (wg * p["scale4"][..., None, :].to(dtype)).reshape(*lead, 2 * K2, O)


def quantize_embedding(p: dict) -> dict:
    """{"w": [V, D]} -> {"w_q": int8, "scale": f32 [V]} (per-row symmetric)."""
    w = p["w"].float()
    amax = w.abs().amax(dim=-1, keepdim=True)
    scale = torch.clamp(amax / 127.0, min=1e-8)
    return {"w_q": torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8),
            "scale": scale[..., 0]}


_LAYER_PROJS = ("q", "k", "v", "o", "gate", "up", "down")


def _quantizer(bits: int):
    if bits not in (4, 8):
        raise ValueError(f"weight-only quantization takes 4 or 8 bits, got {bits}")
    return quantize_linear if bits == 8 else quantize_linear_int4


def quantize_llm_params(params: dict, quantize_embeddings: bool = True,
                        bits: int = 8) -> dict:
    """Quantize the stacked layer projections (q/k/v/o/gate/up/down) to int8
    or int4 and, by default, the token embedding (per-row int8) and the
    lm_head (in the same bits as the layers); norms stay in full precision.
    One weight group at a time, so only one group's f32 staging copy exists
    at once."""
    quantizer = _quantizer(bits)
    out = dict(params)
    layers = dict(params["layers"])
    for name in _LAYER_PROJS:
        layers[name] = quantizer(layers[name])
    out["layers"] = layers
    if quantize_embeddings:
        out["embed"] = quantize_embedding(params["embed"])
        if "lm_head" in params:
            out["lm_head"] = quantizer(params["lm_head"])
    return out


def init_quantized_llm(cfg, generator: torch.Generator, device,
                       dtype=torch.bfloat16, bits: int = 8) -> dict:
    """Random-init a Qwen2 tree directly in int8 or int4 on `device`
    (counterpart of ops/quant.init_quantized_llm). Each projection group is
    drawn and quantized one layer at a time, so the peak above the final
    footprint is one layer's f32 staging copy. The layers take `bits`; the
    lm_head stays int8 and the embedding per-row int8 whatever `bits` is, as
    in the JAX function (quantize_llm_params makes an int4 lm_head). The card
    has no JAX, so full-width weights there come from here; the numbers
    differ from the JAX init for the same seed (a different generator), which
    nothing goldens."""
    L, D = cfg.num_layers, cfg.hidden
    H, Hkv, dk = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim

    def uniform(shape, bound):
        u = torch.rand(shape, generator=generator, device=device)
        return ((u * 2.0 - 1.0) * bound).to(dtype)

    quantizer = _quantizer(bits)

    def q_group(i, o, bias):
        bound = 1.0 / math.sqrt(i)
        p = None
        for layer in range(L):
            q = quantizer({"w": uniform((i, o), bound)})
            if p is None:
                p = {k: torch.empty((L, *v.shape), dtype=v.dtype, device=device)
                     for k, v in q.items()}
            for k, v in q.items():
                p[k][layer] = v
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
