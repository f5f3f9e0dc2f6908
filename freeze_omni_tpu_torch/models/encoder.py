"""Chunk-streaming speech encoder (counterpart of freeze_omni_tpu/models/encoder.py).

Conv2dSubsampling4 (two stride-2 3x3 convs + linear) -> Linear+LN+ReLU embed
-> pre-LN transformer blocks with relative-positional attention
(Transformer-XL u/v biases, rel_shift dropped) or absolute PE, over a sliding
window of cached keys. The window cache is a fixed-shape, right-aligned,
time-ordered buffer [L, B, window, H, dk] with a per-row valid count, so
sessions at different lifetimes batch together and the streaming positional
encoding (pe_index wraparound) reproduces the reference.

Parameters keep the JAX layout: block leaves are stacked [num_blocks, ...].
`stream_step` returns a new `EncoderState`; the session runtime copies it
into its preallocated rows in place (models/audio_llm.py).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch

from ..config import EncoderConfig
from ..utils.device import resolve_device
from .layers import (_uniform, conv1d, conv1d_init, conv2d, conv2d_init,
                     layer_norm, layer_norm_init, layer_params, linear,
                     linear_init, masked_softmax, sinusoidal_pe)


class EncoderState(NamedTuple):
    """Per-session streaming state (the reference's per-layer [K, V] buffer
    list + pe_index)."""

    k_cache: torch.Tensor  # [L, B, window, H, dk] time-ordered, right-aligned
    v_cache: torch.Tensor  # [L, B, window, H, dk]
    valid: torch.Tensor    # [B] int32 — number of valid cached frames
    pe_index: torch.Tensor  # [B] int32 — streaming PE cursor
    ffn_cache: torch.Tensor  # [L, B, d, k-1] conv-FFN left context (empty if linear)


def init_state(cfg: EncoderConfig, batch: int = 1, dtype=torch.float32,
               device=None) -> EncoderState:
    device = resolve_device(device)
    shape = (cfg.num_blocks, batch, cfg.window, cfg.attention_heads, cfg.head_dim)
    lorder = (cfg.positionwise_conv_kernel - 1
              if cfg.positionwise == "conv1d-linear" else 0)
    return EncoderState(
        k_cache=torch.zeros(shape, dtype=dtype, device=device),
        v_cache=torch.zeros(shape, dtype=dtype, device=device),
        valid=torch.zeros(batch, dtype=torch.int32, device=device),
        pe_index=torch.zeros(batch, dtype=torch.int32, device=device),
        ffn_cache=torch.zeros((cfg.num_blocks, batch, cfg.attention_dim, lorder),
                              dtype=dtype, device=device),
    )


def init_params(cfg: EncoderConfig, gen: torch.Generator, dtype=torch.float32,
                device=None) -> dict:
    """Random init with torch-default bounds; block leaves stacked."""
    device = resolve_device(device)
    d = cfg.attention_dim
    f_sub = ((cfg.input_dim - 1) // 2 - 1) // 2
    kw = dict(dtype=dtype, device=device)
    sub = {"conv1": conv2d_init(gen, 1, d, 3, **kw),
           "conv2": conv2d_init(gen, d, d, 3, **kw),
           "out": linear_init(gen, d * f_sub, d, **kw)}
    embed = {"lin": linear_init(gen, d, d, **kw), "ln": layer_norm_init(d, **kw)}

    def block_init():
        bound = math.sqrt(6.0 / (cfg.attention_heads * cfg.head_dim + cfg.head_dim))
        p = {"ln1": layer_norm_init(d, **kw),
             "q": linear_init(gen, d, d, **kw), "k": linear_init(gen, d, d, **kw),
             "v": linear_init(gen, d, d, **kw), "o": linear_init(gen, d, d, **kw),
             "ln2": layer_norm_init(d, **kw)}
        if cfg.pos_enc == "rel-enc":
            hd = (cfg.attention_heads, cfg.head_dim)
            p["pos"] = linear_init(gen, d, d, bias=False, **kw)
            p["bias_u"] = _uniform(gen, hd, bound, dtype, device)
            p["bias_v"] = _uniform(gen, hd, bound, dtype, device)
        kk = cfg.positionwise_conv_kernel
        if cfg.positionwise == "conv1d-linear":
            p["ffn_dw"] = conv1d_init(gen, d, d, kk, groups=d, **kw)
            p["ffn_pw"] = conv1d_init(gen, d, cfg.linear_units, 1, **kw)
            p["ffn2"] = linear_init(gen, cfg.linear_units, d, **kw)
        elif cfg.positionwise == "conv1d":
            p["ffn_c1"] = conv1d_init(gen, d, cfg.linear_units, kk, **kw)
            p["ffn_c2"] = conv1d_init(gen, cfg.linear_units, d, kk, **kw)
        else:
            p["ffn1"] = linear_init(gen, d, cfg.linear_units, **kw)
            p["ffn2"] = linear_init(gen, cfg.linear_units, d, **kw)
        return p

    blocks = [block_init() for _ in range(cfg.num_blocks)]
    return {
        "sub": sub, "embed": embed, "blocks": _stack(blocks),
        "after_norm": layer_norm_init(d, **kw),
        "cmvn": {"mean": torch.zeros(cfg.input_dim, **kw),
                 "istd": torch.ones(cfg.input_dim, **kw)},
    }


def _stack(trees):
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def subsampled_len(t_in: int) -> int:
    """Frames out of Conv2dSubsampling4 for t_in fbank frames."""
    return ((t_in - 1) // 2 - 1) // 2


def _subsample(params, x):
    """Conv2dSubsampling4. x: [B, T, F] -> [B, T', d]."""
    x = x[:, None, :, :]
    x = torch.relu(conv2d(params["conv1"], x, stride=2))
    x = torch.relu(conv2d(params["conv2"], x, stride=2))
    b, c, t, f = x.shape
    x = x.permute(0, 2, 1, 3).reshape(b, t, c * f)
    return linear(params["out"], x)


def _embed(params, x):
    """input_layer='linear': Linear + LN + ReLU."""
    return torch.relu(layer_norm(params["ln"], linear(params["lin"], x)))


def _rel_attention(bp, x_q, k_all, v_all, pos_emb, mask, cfg: EncoderConfig):
    """MHA over an explicit key buffer: relative-position scores for
    'rel-enc', plain scaled dot product for 'abs-enc'. x_q: [B, T, d];
    k_all/v_all: [B, S, H, dk]; pos_emb: [S, d] or [B, S, d] (rel-enc only);
    mask: broadcastable to [B, H, T, S] or None. Returns [B, T, d]."""
    B, T, d = x_q.shape
    H, dk = cfg.attention_heads, cfg.head_dim
    q = linear(bp["q"], x_q).reshape(B, T, H, dk)

    if cfg.pos_enc == "abs-enc":
        scores = torch.einsum("bthd,bshd->bhts", q, k_all) / math.sqrt(dk)
    else:
        ac = torch.einsum("bthd,bshd->bhts", q + bp["bias_u"], k_all)
        if pos_emb.dim() == 2:
            p = linear(bp["pos"], pos_emb).reshape(-1, H, dk)
            bd = torch.einsum("bthd,shd->bhts", q + bp["bias_v"], p)
        else:
            p = linear(bp["pos"], pos_emb).reshape(B, -1, H, dk)
            bd = torch.einsum("bthd,bshd->bhts", q + bp["bias_v"], p)
        scores = (ac + bd) / math.sqrt(dk)
    attn = masked_softmax(scores, mask)
    out = torch.einsum("bhts,bshd->bthd", attn, v_all).reshape(B, T, d)
    return linear(bp["o"], out)


def _ffn(bp, x, cfg: EncoderConfig, cache=None):
    """Positionwise FFN variants: 'linear' w2(relu(w1 x)); 'conv1d' two
    symmetric-padded convs (batch only); 'conv1d-linear' depthwise+pointwise
    causal conv then linear, with a left-context cache when streaming.
    Returns (y, new_cache)."""
    if cfg.positionwise == "conv1d":
        pad = ((cfg.positionwise_conv_kernel - 1) // 2,) * 2
        y = torch.relu(conv1d(bp["ffn_c1"], x.transpose(1, 2), padding=pad))
        y = conv1d(bp["ffn_c2"], y, padding=pad)
        return y.transpose(1, 2), cache
    if cfg.positionwise != "conv1d-linear":
        return linear(bp["ffn2"], torch.relu(linear(bp["ffn1"], x))), cache

    k = cfg.positionwise_conv_kernel
    xc = x.transpose(1, 2)  # [B, d, T]
    if cache is None:
        xc = torch.nn.functional.pad(xc, (k - 1, 0))
        new_cache = None
    else:
        xc = torch.cat([cache, xc], dim=2)
        new_cache = xc[:, :, xc.shape[2] - (k - 1):]
    y = conv1d(bp["ffn_dw"], xc, groups=x.shape[-1])
    y = conv1d(bp["ffn_pw"], y)
    return linear(bp["ffn2"], torch.relu(y.transpose(1, 2))), new_cache


def chunk_causal_mask(size: int, chunk_size: int, left_chunks: int,
                      device=None) -> torch.Tensor:
    """wenet-style subsequent_chunk_mask: position i attends to
    [max(0, (i//cs - left)*cs), ((i//cs)+1)*cs). [T, T] bool."""
    idx = torch.arange(size, device=resolve_device(device))
    chunk_of = idx // chunk_size
    lo = torch.clamp((chunk_of - left_chunks) * chunk_size, min=0)
    hi = (chunk_of + 1) * chunk_size
    j = idx[None, :]
    return (j >= lo[:, None]) & (j < hi[:, None])


def forward(params, cfg: EncoderConfig, xs: torch.Tensor,
            mask: Optional[torch.Tensor] = None,
            apply_cmvn: bool = True) -> torch.Tensor:
    """Full-sequence forward with a static chunk mask. xs: [B, T_in, F] raw
    fbank. Returns [B, T', d]."""
    xs = xs.to(params["cmvn"]["mean"].dtype)
    if apply_cmvn:
        xs = (xs - params["cmvn"]["mean"]) * params["cmvn"]["istd"]
    x = _embed(params["embed"], _subsample(params["sub"], xs))
    x = x * math.sqrt(cfg.attention_dim)
    B, T, _ = x.shape
    pos_emb = sinusoidal_pe(torch.arange(T, device=x.device),
                            cfg.attention_dim).to(x.dtype)
    if cfg.pos_enc == "abs-enc":
        x = x + pos_emb[None]
    if mask is None:
        mask = chunk_causal_mask(T, cfg.chunk_size, cfg.left_chunks, x.device)
    mask = mask[None, None] if mask.dim() == 2 else mask

    H, dk = cfg.attention_heads, cfg.head_dim
    for i in range(cfg.num_blocks):
        bp = layer_params(params["blocks"], i)
        h = layer_norm(bp["ln1"], x)
        k = linear(bp["k"], h).reshape(B, T, H, dk)
        v = linear(bp["v"], h).reshape(B, T, H, dk)
        x = x + _rel_attention(bp, h, k, v, pos_emb, mask, cfg)
        y, _ = _ffn(bp, layer_norm(bp["ln2"], x), cfg)
        x = x + y
    return layer_norm(params["after_norm"], x)


def stream_step(params, cfg: EncoderConfig, xs: torch.Tensor,
                state: EncoderState) -> Tuple[torch.Tensor, EncoderState]:
    """One streaming chunk. xs: [B, T_in, F] fbank window (e.g. 19 or 32
    frames); returns ([B, T, d], new state) with T = ((T_in-1)//2 - 1)//2.

    Queries attend over the cached window plus the current chunk with no
    intra-chunk causal mask; the cache then keeps the newest `window` keys.
    valid/pe_index are per row. The compute dtype follows the params
    (audio_llm.cast_frontend). The input state is not modified."""
    xs = xs.to(params["cmvn"]["mean"].dtype)
    xs = (xs - params["cmvn"]["mean"]) * params["cmvn"]["istd"]
    x = _embed(params["embed"], _subsample(params["sub"], xs))
    x = x * math.sqrt(cfg.attention_dim)

    B, T, d = x.shape
    cap = cfg.window
    S = cap + T
    dev = x.device

    valid = torch.clamp(state.valid, max=cap)                      # [B]
    slot = torch.arange(S, device=dev)[None, :]                    # [1, S]
    if cfg.pos_enc == "abs-enc":
        # absolute PE at the chunk's utterance positions; pe_index counts
        # emitted frames and wraps at pe_max_len
        pe_idx = torch.remainder(state.pe_index, cfg.pe_max_len)
        positions = pe_idx[:, None] + torch.arange(T, device=dev)[None, :]
        x = x + sinusoidal_pe(positions.reshape(-1), d).reshape(B, T, d).to(x.dtype)
        pos_emb = None
        pe_next = pe_idx + T
    else:
        pe_idx = torch.remainder(state.pe_index, cfg.pe_wrap)
        start = torch.clamp(pe_idx - cfg.full_chunk_size, min=0)
        # slot s holds key number j = s - (cap - valid); its position is start + j
        positions = start[:, None] + slot - (cap - valid)[:, None]  # [B, S]
        pos_emb = sinusoidal_pe(positions.reshape(-1), d).reshape(B, S, d).to(x.dtype)
        pe_next = pe_idx + cfg.chunk_size
    keep = slot >= (cap - valid)[:, None]                          # [B, S]
    mask = keep[:, None, None, :]

    H, dk = cfg.attention_heads, cfg.head_dim
    conv_ffn = cfg.positionwise == "conv1d-linear"
    new_k, new_v, new_f = [], [], []
    for i in range(cfg.num_blocks):
        bp = layer_params(params["blocks"], i)
        h = layer_norm(bp["ln1"], x)
        k_all = torch.cat([state.k_cache[i],
                           linear(bp["k"], h).reshape(B, T, H, dk)], dim=1)
        v_all = torch.cat([state.v_cache[i],
                           linear(bp["v"], h).reshape(B, T, H, dk)], dim=1)
        x = x + _rel_attention(bp, h, k_all, v_all, pos_emb, mask, cfg)
        y, f_cache = _ffn(bp, layer_norm(bp["ln2"], x), cfg,
                          cache=state.ffn_cache[i] if conv_ffn else None)
        x = x + y
        new_k.append(k_all[:, -cap:])
        new_v.append(v_all[:, -cap:])
        new_f.append(f_cache if conv_ffn else state.ffn_cache[i])
    x = layer_norm(params["after_norm"], x)

    new_state = EncoderState(
        k_cache=torch.stack(new_k), v_cache=torch.stack(new_v),
        valid=torch.clamp(valid + T, max=cap).to(torch.int32),
        pe_index=pe_next.to(torch.int32),
        ffn_cache=torch.stack(new_f),
    )
    return x, new_state
