"""Shared NN building blocks as plain functions on tensors (counterpart of
freeze_omni_tpu/models/layers.py).

Parameters are nested dicts of tensors in the JAX package's layouts (linear
`w` is [in, out], convolutions are torch's [out, in, k...]), so a converted
JAX tree runs here unchanged. Initializers follow torch defaults
(kaiming-uniform bounds) and draw from an explicit `torch.Generator`; they
give other numbers than the JAX initializers for the same seed, so parity
tests convert one set of weights instead of initialising twice.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..utils.device import resolve_device

NEG_INF = -1e9


def _uniform(gen: torch.Generator, shape, bound: float, dtype, device):
    u = torch.rand(shape, generator=gen, device=resolve_device(device),
                   dtype=torch.float32)
    return ((u * 2.0 - 1.0) * bound).to(dtype)


def linear_init(gen, in_dim: int, out_dim: int, bias: bool = True,
                dtype=torch.float32, device=None):
    """torch.nn.Linear default init. Weight stored as [in, out]."""
    bound = 1.0 / math.sqrt(in_dim)
    p = {"w": _uniform(gen, (in_dim, out_dim), bound, dtype, device)}
    if bias:
        p["b"] = _uniform(gen, (out_dim,), bound, dtype, device)
    return p


def linear(p, x: torch.Tensor) -> torch.Tensor:
    """y = x @ w (+ b). Dispatches on the leaf names like the JAX version:
    `w_q4` + `scale4` is grouped int4 and `w_q` + `scale` weight-only int8;
    each always goes through its matmul wrapper (K5 or K1 for a CUDA tensor,
    the plain version for a CPU tensor). Both kernels take dense rows, so a
    strided view (e.g. the last position of a prefill, hidden[:, -1]) is
    copied."""
    if "w_q4" in p:
        from ..ops.quant_matmul import quant_matmul4

        Kp, O = p["w_q4"].shape
        group = (2 * Kp) // p["scale4"].shape[-2]
        lead = x.shape[:-1]
        y = quant_matmul4(x.reshape(-1, 2 * Kp).contiguous(), p["w_q4"],
                          p["scale4"], group).reshape(*lead, O)
    elif "w_q" in p:
        from ..ops.quant_matmul import quant_matmul

        K, O = p["w_q"].shape
        lead = x.shape[:-1]
        y = quant_matmul(x.reshape(-1, K).contiguous(), p["w_q"],
                         p["scale"]).reshape(*lead, O)
    else:
        w = p["w"]
        if w.dtype != x.dtype:  # jnp.einsum promotes mixed operands
            dt = torch.promote_types(w.dtype, x.dtype)
            x, w = x.to(dt), w.to(dt)
        y = torch.matmul(x, w)
    if "b" in p:
        # keep the activation dtype: an f32 bias must not upcast a bf16
        # activation
        y = y + p["b"].to(y.dtype)
    return y


def layer_norm_init(dim: int, dtype=torch.float32, device=None):
    kw = dict(dtype=dtype, device=resolve_device(device))
    return {"scale": torch.ones(dim, **kw), "bias": torch.zeros(dim, **kw)}


def layer_norm(p, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    mean = x.mean(dim=-1, keepdim=True)
    var = x.var(dim=-1, unbiased=False, keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps) * p["scale"] + p["bias"]


def rms_norm_init(dim: int, dtype=torch.float32, device=None):
    return {"scale": torch.ones(dim, dtype=dtype, device=resolve_device(device))}


def rms_norm(p, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """f32 statistics; the scale is applied in the activation dtype."""
    dt = x.dtype
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(dt) * p["scale"].to(dt)


def conv1d_init(gen, in_ch: int, out_ch: int, kernel: int, groups: int = 1,
                bias: bool = True, dtype=torch.float32, device=None):
    """torch.nn.Conv1d default init. Weight [out, in//groups, k]."""
    bound = 1.0 / math.sqrt((in_ch // groups) * kernel)
    p = {"w": _uniform(gen, (out_ch, in_ch // groups, kernel), bound, dtype,
                       device)}
    if bias:
        p["b"] = _uniform(gen, (out_ch,), bound, dtype, device)
    return p


def conv1d(p, x: torch.Tensor, stride: int = 1, padding=(0, 0),
           groups: int = 1, dilation: int = 1) -> torch.Tensor:
    """x: [B, C, T] (NCW); padding is (left, right)."""
    if padding[0] or padding[1]:
        x = F.pad(x, tuple(padding))
    return F.conv1d(x, p["w"], p.get("b"), stride=stride, dilation=dilation,
                    groups=groups)


def conv_transpose1d(p, x: torch.Tensor, stride: int, padding: int) -> torch.Tensor:
    """x: [B, C, T]; p['w']: [in, out, k], which is torch's ConvTranspose1d
    layout (the JAX version writes it as an lhs-dilated conv with a flipped
    kernel). Output length (T - 1) * stride - 2 * padding + k."""
    return F.conv_transpose1d(x, p["w"], p.get("b"), stride=stride,
                              padding=padding)


def conv_transpose1d_init(gen, in_ch: int, out_ch: int, kernel: int,
                          bias: bool = True, dtype=torch.float32, device=None):
    """Weight [in, out, k]; bound 1/sqrt(in * k) as the JAX initializer."""
    bound = 1.0 / math.sqrt(in_ch * kernel)
    p = {"w": _uniform(gen, (in_ch, out_ch, kernel), bound, dtype, device)}
    if bias:
        p["b"] = _uniform(gen, (out_ch,), bound, dtype, device)
    return p


def conv2d_init(gen, in_ch: int, out_ch: int, kernel: int,
                dtype=torch.float32, device=None):
    bound = 1.0 / math.sqrt(in_ch * kernel * kernel)
    return {"w": _uniform(gen, (out_ch, in_ch, kernel, kernel), bound, dtype,
                          device),
            "b": _uniform(gen, (out_ch,), bound, dtype, device)}


def conv2d(p, x: torch.Tensor, stride: int) -> torch.Tensor:
    """x: [B, C, H, W]; VALID padding."""
    return F.conv2d(x, p["w"], p["b"], stride=stride)


def batch_norm_init(dim: int, dtype=torch.float32, device=None):
    kw = dict(dtype=dtype, device=resolve_device(device))
    return {"scale": torch.ones(dim, **kw), "bias": torch.zeros(dim, **kw),
            "mean": torch.zeros(dim, **kw), "var": torch.ones(dim, **kw)}


def batch_norm_eval(p, x: torch.Tensor, eps: float, channel_axis: int):
    """Inference-mode batchnorm using running stats."""
    shape = [1] * x.ndim
    shape[channel_axis] = x.shape[channel_axis]
    scale = p["scale"].reshape(shape)
    bias = p["bias"].reshape(shape)
    mean = p["mean"].reshape(shape)
    var = p["var"].reshape(shape)
    return (x - mean) * torch.rsqrt(var + eps) * scale + bias


def embedding(p, ids: torch.Tensor) -> torch.Tensor:
    return p["w"][ids]


def sinusoidal_pe(positions: torch.Tensor, d_model: int) -> torch.Tensor:
    """Interleaved sin/cos rows for the given positions: pe[:, 0::2] = sin,
    pe[:, 1::2] = cos (models/encoder/attention.py:27-35). f32 [P, d]."""
    inv = torch.exp(torch.arange(0, d_model, 2, dtype=torch.float32,
                                 device=positions.device)
                    * -(math.log(10000.0) / d_model))
    ang = positions.float()[:, None] * inv[None, :]
    pe = torch.stack([torch.sin(ang), torch.cos(ang)], dim=-1)  # [P, half, 2]
    return pe.reshape(positions.shape[0], d_model)


def masked_softmax(scores: torch.Tensor,
                   mask: Optional[torch.Tensor]) -> torch.Tensor:
    """Softmax over the last axis with a boolean keep-mask (True = attend)."""
    if mask is not None:
        scores = torch.where(mask, scores, torch.full_like(scores, NEG_INF))
    out = torch.softmax(scores, dim=-1)
    if mask is not None:
        out = torch.where(mask, out, torch.zeros_like(out))
    return out


def rotary_embed(positions: torch.Tensor, head_dim: int, theta: float):
    """cos/sin tables [T, head_dim] (f32) in the HF Llama/Qwen half-rotated
    layout. The inverse frequencies are computed in numpy f32, as the JAX
    version does, so both packages start from the same table."""
    inv = 1.0 / (theta ** (np.arange(0, head_dim, 2, dtype=np.float32) / head_dim))
    inv_t = torch.from_numpy(np.asarray(inv, np.float32)).to(positions.device)
    freqs = positions.float()[:, None] * inv_t[None, :]
    emb = torch.cat([freqs, freqs], dim=-1)
    return torch.cos(emb), torch.sin(emb)


def layer_params(tree, i: int):
    """Layer i of a stacked [L, ...] parameter tree (the JAX package scans the
    stack with lax.scan; the port loops over layers)."""
    if isinstance(tree, dict):
        return {k: layer_params(v, i) for k, v in tree.items()}
    return tree[i]
