"""CNN subsampling adapter, encoder dim -> LLM embedding dim (counterpart of
freeze_omni_tpu/models/adapter.py; models/adapter.py:72-157 of the reference).

- two-stage (enc*4 < llm_dim): conv1d(C->2C, k, s1) + BN + act, then
  conv1d(2C->4C, k, s2) + BN + act, then Linear(4C -> llm_dim)
- one-stage: conv1d(C->2C, k, s2) + norm + act, Linear(2C -> llm_dim)

Streaming keeps kernel_size-1 left-context input columns per conv; a zero
cache is the reference's first-call zero padding. `step` returns a new
`AdapterState`; the session runtime copies it into its preallocated rows.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from ..config import AdapterConfig
from ..utils.device import resolve_device
from .layers import (batch_norm_eval, batch_norm_init, conv1d, conv1d_init,
                     layer_norm, layer_norm_init, linear, linear_init)


class AdapterState(NamedTuple):
    """Left-context columns for each conv (the reference's `cnn_cache`)."""

    c1: Optional[torch.Tensor]  # [B, C, k-1] input cols of conv1 (two-stage only)
    c2: torch.Tensor            # [B, C2, k-1] input cols of conv2


def init_state(cfg: AdapterConfig, batch: int = 1, dtype=torch.float32,
               device=None) -> AdapterState:
    k = cfg.kernel_size - 1
    kw = dict(dtype=dtype, device=resolve_device(device))
    if cfg.two_stage:
        return AdapterState(c1=torch.zeros((batch, cfg.enc_out_dim, k), **kw),
                            c2=torch.zeros((batch, 2 * cfg.enc_out_dim, k), **kw))
    return AdapterState(c1=None, c2=torch.zeros((batch, cfg.enc_out_dim, k), **kw))


def init_params(cfg: AdapterConfig, gen: torch.Generator, dtype=torch.float32,
                device=None) -> dict:
    C = cfg.enc_out_dim
    kw = dict(dtype=dtype, device=resolve_device(device))
    if cfg.two_stage:
        return {"conv1": conv1d_init(gen, C, 2 * C, cfg.kernel_size, **kw),
                "bn1": batch_norm_init(2 * C, **kw),
                "conv2": conv1d_init(gen, 2 * C, 4 * C, cfg.kernel_size, **kw),
                "bn2": batch_norm_init(4 * C, **kw),
                "proj": linear_init(gen, 4 * C, cfg.llm_dim, **kw)}
    norm = (batch_norm_init(2 * C, **kw) if cfg.norm == "batch"
            else layer_norm_init(2 * C, **kw))
    return {"conv2": conv1d_init(gen, C, 2 * C, cfg.kernel_size, **kw),
            "bn2": norm,
            "proj": linear_init(gen, 2 * C, cfg.llm_dim, **kw)}


def out_len(t_enc: int) -> int:
    """LLM embeddings per t_enc encoder frames (the stride-2 conv emits
    ceil(T/2) when streaming)."""
    return (t_enc + 1) // 2


def _act(cfg: AdapterConfig, x):
    # jax.nn.gelu defaults to the tanh approximation
    return F.gelu(x, approximate="tanh") if cfg.activation == "gelu" else torch.relu(x)


def _norm2(params, cfg: AdapterConfig, x):
    """x: [B, C, T]. BatchNorm eval (eps 1e-3) or LayerNorm over channels."""
    if cfg.norm == "batch" or cfg.two_stage:
        return batch_norm_eval(params, x, eps=1e-3, channel_axis=1)
    return layer_norm(params, x.transpose(1, 2), eps=1e-3).transpose(1, 2)


def step(params, cfg: AdapterConfig, x: torch.Tensor,
         state: AdapterState) -> Tuple[torch.Tensor, AdapterState]:
    """Streaming step. x: [B, T, C] encoder frames -> [B, ceil(T/2), llm_dim].
    The input state is not modified."""
    k = cfg.kernel_size
    x = x.transpose(1, 2)  # [B, C, T]
    if cfg.two_stage:
        full = torch.cat([state.c1, x], dim=2)
        new_c1 = full[:, :, full.shape[2] - (k - 1):]
        x = _act(cfg, batch_norm_eval(params["bn1"], conv1d(params["conv1"], full),
                                      eps=1e-3, channel_axis=1))
    else:
        new_c1 = None
    full = torch.cat([state.c2, x], dim=2)
    new_c2 = full[:, :, full.shape[2] - (k - 1):]
    x = _act(cfg, _norm2(params["bn2"], cfg,
                         conv1d(params["conv2"], full, stride=2)))
    x = linear(params["proj"], x.transpose(1, 2))
    return x, AdapterState(c1=new_c1, c2=new_c2)


def forward(params, cfg: AdapterConfig, x: torch.Tensor) -> torch.Tensor:
    """Full-sequence forward (zero left-padding == fresh state)."""
    return step(params, cfg, x, init_state(cfg, x.shape[0], x.dtype, x.device))[0]
