"""AR speech-token decoder, LLaMA architecture (counterpart of
freeze_omni_tpu/models/speech_decoder.py; models/decoder/decoder.py:32-367
`LLM2TTSCodecAR` of the reference).

- `pre_nn`: num_layers // 2 LLaMA layers, bidirectional over the LLM hidden
  states (decoder.py:156-188);
- `prefix_prefill`: a separate full stack runs over the prefix (LLM hidden
  states) and writes its K/V into the main cache, prefix tuning as in
  decoder.py:121-154;
- `prefill`: the main stack over [bos-emb, pre-NN output]; RoPE positions
  restart at 0 after the prefix (decoder.py:337-341);
- `decode_segment`: N decode steps (embed -> main stack -> RMSNorm -> out
  head -> repetition penalty over a ring of recent tokens -> top-k sample).
  The JAX `lax.scan` is a Python loop here; each step's attention over the
  f32 cache is the decode kernel K4 on the card (qwen2.forward at T = 1).

The stacks are qwen2 layer stacks (non-GQA, bias-free), and the cache is a
qwen2 `KVCache`, updated in place. Specials: bos/sos/eos/pad =
vocab..vocab+3 (decoder.py:79-87, 205-208).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from ..config import LLMConfig, SpeechDecoderConfig
from ..ops.sampling import present_tokens, sample_top_k
from ..utils.device import resolve_device
from . import qwen2
from .layers import (NEG_INF, embedding, layer_params, linear, linear_init,
                     rms_norm, rms_norm_init, rotary_embed)


def _llm_cfg(cfg: SpeechDecoderConfig) -> LLMConfig:
    """The decoder's stacks are standard (non-GQA, bias-free) LLaMA layers."""
    return LLMConfig(
        hidden=cfg.hidden, num_layers=cfg.num_layers, num_heads=cfg.num_heads,
        num_kv_heads=cfg.num_heads, ffn=cfg.ffn, vocab_size=cfg.full_vocab,
        rope_theta=cfg.rope_theta, rms_eps=cfg.rms_eps,
        max_kv_len=cfg.max_kv_len, qkv_bias=False)


class DecoderCache(NamedTuple):
    kv: qwen2.KVCache
    prefix_len: torch.Tensor  # [B] int32: RoPE offset of the main stack


def init_cache(cfg: SpeechDecoderConfig, batch: int = 1, dtype=torch.float32,
               device=None) -> DecoderCache:
    """Zeroed cache of cfg.max_kv_len slots on `device` (None: the card)."""
    device = resolve_device(device)
    return DecoderCache(
        kv=qwen2.init_cache(_llm_cfg(cfg), batch, dtype=dtype, device=device),
        prefix_len=torch.zeros(batch, dtype=torch.int32, device=device))


def init_params(cfg: SpeechDecoderConfig, gen: torch.Generator,
                dtype=torch.float32, device=None) -> dict:
    """Random weights drawn from `gen` on `device` (None: the card)."""
    if cfg.idim != cfg.hidden:
        raise ValueError("embedding dim must equal hidden")
    device = resolve_device(device)
    lcfg = _llm_cfg(cfg)
    params = {
        "embedding": {"w": (torch.randn((cfg.full_vocab, cfg.idim), generator=gen,
                                        device=device) * 0.02).to(dtype)},
        "pre_nn": qwen2.init_layer_stack(lcfg, gen, cfg.num_pre_nn_layers,
                                         dtype, device),
        "layers": qwen2.init_layer_stack(lcfg, gen, cfg.num_layers, dtype, device),
        "final_norm": rms_norm_init(cfg.hidden, dtype, device),
        "out": linear_init(gen, cfg.hidden, cfg.full_vocab, dtype=dtype,
                           device=device),
    }
    if cfg.use_prefix_kv:
        params["prefix"] = qwen2.init_layer_stack(lcfg, gen, cfg.num_layers,
                                                  dtype, device)
    return params


# ---------------------------------------------------------------------------
# pre-NN (bidirectional, no cache)
# ---------------------------------------------------------------------------


def pre_nn(params, cfg: SpeechDecoderConfig, hidden: torch.Tensor,
           mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """hidden: [B, T, D]; mask: [B, T] validity (full block attention among
    valid positions, decoder.py:170-175). Returns [B, T, D] un-normed."""
    B, T, D = hidden.shape
    H, dk = cfg.num_heads, cfg.head_dim
    dev = hidden.device
    if mask is None:
        mask = torch.ones((B, T), dtype=torch.bool, device=dev)
    attn_mask = mask[:, None, :] & mask[:, :, None]              # [B, T, T]
    cos, sin = rotary_embed(torch.arange(T, device=dev), dk, cfg.rope_theta)

    def rot(x):
        d2 = x.shape[-1] // 2
        r = torch.cat([-x[..., d2:], x[..., :d2]], dim=-1)
        return x * cos[None, :, None, :] + r * sin[None, :, None, :]

    x = hidden
    for i in range(params["pre_nn"]["q"]["w"].shape[0]):
        lp = layer_params(params["pre_nn"], i)
        h = rms_norm(lp["ln1"], x, cfg.rms_eps)
        q = rot(linear(lp["q"], h).reshape(B, T, H, dk))
        k = rot(linear(lp["k"], h).reshape(B, T, H, dk))
        v = linear(lp["v"], h).reshape(B, T, H, dk)
        scores = torch.einsum("bthd,bshd->bhts", q, k) / math.sqrt(dk)
        scores = torch.where(attn_mask[:, None], scores,
                             torch.full_like(scores, NEG_INF))
        attn = torch.softmax(scores.float(), dim=-1).to(x.dtype)
        o = torch.einsum("bhts,bshd->bthd", attn, v).reshape(B, T, H * dk)
        x = x + linear(lp["o"], o)
        h2 = rms_norm(lp["ln2"], x, cfg.rms_eps)
        x = x + linear(lp["down"], F.silu(linear(lp["gate"], h2)) * linear(lp["up"], h2))
    return x  # no final norm (decoder.py:188)


# ---------------------------------------------------------------------------
# prefix + prefill + decode
# ---------------------------------------------------------------------------


def prefix_prefill(params, cfg: SpeechDecoderConfig, prefix: torch.Tensor,
                   mask: torch.Tensor, cache: DecoderCache) -> DecoderCache:
    """Run the prefix stack over the LLM hidden states and deposit its K/V
    into the main cache in place (decoder.py:127-154)."""
    fake = {"layers": params["prefix"],
            "final_norm": {"scale": torch.ones(cfg.hidden, device=prefix.device)}}
    qwen2.forward(fake, _llm_cfg(cfg), prefix, mask, cache.kv)
    n_valid = mask.to(torch.int32).sum(dim=1)
    return DecoderCache(kv=cache.kv,
                        prefix_len=(cache.prefix_len + n_valid).to(torch.int32))


def prefill(params, cfg: SpeechDecoderConfig, embeds: torch.Tensor,
            mask: torch.Tensor, cache: DecoderCache
            ) -> Tuple[torch.Tensor, DecoderCache]:
    """Main stack over a block of embeddings (e.g. [bos, pre-NN hidden]),
    appended to the cache in place."""
    fake = {"layers": params["layers"], "final_norm": params["final_norm"]}
    hidden, _ = qwen2.forward(fake, _llm_cfg(cfg), embeds, mask, cache.kv,
                              pos_offset=cache.prefix_len)
    return hidden, cache


class DecodeState(NamedTuple):
    cache: DecoderCache
    cur_token: torch.Tensor   # [B] int32
    recent: torch.Tensor      # [B, W] ring of recent tokens (pad-filled)
    done: torch.Tensor        # [B] bool


def init_decode_state(cfg: SpeechDecoderConfig, cache: DecoderCache,
                      penalty_window: int) -> DecodeState:
    b = cache.kv.length.shape[0]
    dev = cache.kv.length.device
    w = max(penalty_window, 1)
    return DecodeState(
        cache=cache,
        cur_token=torch.full((b,), cfg.sos_id, dtype=torch.int32, device=dev),
        recent=torch.full((b, w), cfg.pad_id, dtype=torch.int32, device=dev),
        done=torch.zeros(b, dtype=torch.bool, device=dev))


def decode_segment(params, cfg: SpeechDecoderConfig, state: DecodeState,
                   gen: torch.Generator, n_steps: int, top_k: int,
                   penalty_window: int, penalty: float,
                   active: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, DecodeState]:
    """Generate up to n_steps tokens on the device. Returns ([B, n_steps]
    tokens, eos/pad after the stop position, and the new state; the cache
    inside it is updated in place).

    active: optional [B] bool; rows with active=False are frozen (their
    writes are masked, so the cache does not grow; cur_token, recent and done
    are kept; their output tokens are pad). This lets a resident pool of
    streaming-synthesis jobs share one batch while rows start and finish at
    different times (runtime/tts_batch.BatchedTTS)."""
    lcfg = _llm_cfg(cfg)
    fake = {"layers": params["layers"], "final_norm": params["final_norm"]}
    cur, recent, done = state.cur_token, state.recent, state.done
    dev = cur.device
    fwd_mask = (torch.ones_like(cur, dtype=torch.bool) if active is None
                else active.to(torch.bool))[:, None]
    pad = torch.full_like(cur, cfg.pad_id)
    out = []
    for _ in range(n_steps):
        emb = embedding(params["embedding"], cur.long())[:, None]
        hidden, _ = qwen2.forward(fake, lcfg, emb, fwd_mask, state.cache.kv,
                                  pos_offset=state.cache.prefix_len)
        lg = linear(params["out"], hidden[:, 0]).float()
        if penalty_window > 0:
            present = present_tokens(recent, cfg.full_vocab)
            # pad-filled empty ring slots must not penalize the pad logit
            present[:, cfg.pad_id] = False
            lg = torch.where(present, lg / penalty, lg)
        nxt = sample_top_k(gen, lg, top_k)
        nxt = torch.where(done, pad, nxt)
        new_done = done | (nxt == cfg.eos_id)
        new_recent = torch.cat([recent[:, 1:], nxt[:, None]], dim=1)
        if active is not None:
            act = active.to(torch.bool)
            out.append(torch.where(act, nxt, pad))
            nxt = torch.where(act, nxt, cur)
            new_done = torch.where(act, new_done, done)
            new_recent = torch.where(act[:, None], new_recent, recent)
        else:
            out.append(nxt)
        cur, recent, done = nxt, new_recent, new_done
    tokens = torch.stack(out, 1) if out else \
        torch.zeros((cur.shape[0], 0), dtype=torch.int32, device=dev)
    return tokens, DecodeState(cache=state.cache, cur_token=cur, recent=recent,
                               done=done)
