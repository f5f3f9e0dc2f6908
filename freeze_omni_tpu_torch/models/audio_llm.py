"""AudioLLM core: streaming encoders + adapters + frozen LLM + dialog-state head
(counterpart of freeze_omni_tpu/models/audio_llm.py; models/audioLLM.py of the
reference).

All per-session state is one `SessionCaches` (encoder window KV and adapter
conv caches for both identities, plus the LLM KV cache) batched on a leading
session axis. The JAX version returns updated caches functionally; here the
step functions update the preallocated cache tensors IN PLACE, rows gated by
`active`, and also return the caches to keep the JAX signatures.

Text generation (`prefill_and_sample`, `generate_step`, `generate_segment`,
`prefill_and_generate`) restores the upstream decode loop
(bin/inference.py:140-183): the JAX `lax.scan` is a Python loop here, and
the JAX key splits are draws from one `torch.Generator` in order.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from ..config import AudioLLMConfig, SamplingConfig
from ..ops.sampling import sample_top_k_top_p
from ..utils.device import resolve_device
from . import adapter as adapter_mod
from . import encoder as encoder_mod
from . import qwen2
from .layers import linear, linear_init


class SessionCaches(NamedTuple):
    enc_user: encoder_mod.EncoderState
    adp_user: adapter_mod.AdapterState
    enc_system: encoder_mod.EncoderState
    adp_system: adapter_mod.AdapterState
    kv: qwen2.KVCache


def init_session(cfg: AudioLLMConfig, batch: int = 1, kv_dtype=torch.float32,
                 kv_quant_bits: Optional[int] = None,
                 device=None) -> SessionCaches:
    """Encoder/adapter caches share the serving dtype; the LLM KV is float
    (kv_dtype) or int8 + scales (kv_quant_bits=8). device=None means the CUDA
    card and raises without one."""
    device = resolve_device(device)
    return SessionCaches(
        enc_user=encoder_mod.init_state(cfg.encoder, batch, kv_dtype, device),
        adp_user=adapter_mod.init_state(cfg.adapter, batch, kv_dtype, device),
        enc_system=encoder_mod.init_state(cfg.encoder, batch, kv_dtype, device),
        adp_system=adapter_mod.init_state(cfg.adapter, batch, kv_dtype, device),
        kv=qwen2.init_cache(cfg.llm, batch, dtype=kv_dtype,
                            quant_bits=kv_quant_bits, device=device),
    )


def reset_audio_caches(cfg: AudioLLMConfig, caches: SessionCaches) -> SessionCaches:
    """Fresh encoder/adapter caches of both identities in the session's dtype
    and on its device; the LLM KV is kept (bin/inference.py:133-135)."""
    b = caches.kv.length.shape[0]
    dt = caches.enc_user.k_cache.dtype
    dev = caches.kv.length.device
    return SessionCaches(
        enc_user=encoder_mod.init_state(cfg.encoder, b, dt, dev),
        adp_user=adapter_mod.init_state(cfg.adapter, b, dt, dev),
        enc_system=encoder_mod.init_state(cfg.encoder, b, dt, dev),
        adp_system=adapter_mod.init_state(cfg.adapter, b, dt, dev),
        kv=caches.kv,
    )


def init_params(cfg: AudioLLMConfig, seed: int = 0, device=None,
                llm_dtype=torch.float32, quantize_llm: bool = False,
                quant_bits: int = 8) -> dict:
    """Random init from a `torch.Generator` seeded with `seed`, on `device`
    (None: the CUDA card; raises without one). quantize_llm draws the frozen
    backbone directly in weight-only int8 or int4 (`quant_bits`;
    ops/quant.init_quantized_llm), never holding the bf16 tree. With
    cfg.prompt_finetune the prompt-tuning table `prompt_embeddings`
    [prompt_num, D] is drawn last, so every other leaf of a seed stays as
    it is without it."""
    from ..ops.quant import init_quantized_llm

    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    D = cfg.llm.hidden
    params = {
        "encoder_user": encoder_mod.init_params(cfg.encoder, gen, device=device),
        "encoder_system": encoder_mod.init_params(cfg.encoder, gen, device=device),
        "adapter_user": adapter_mod.init_params(cfg.adapter, gen, device=device),
        "adapter_system": adapter_mod.init_params(cfg.adapter, gen, device=device),
        "llm": (init_quantized_llm(cfg.llm, gen, device, bits=quant_bits)
                if quantize_llm
                else qwen2.init_params(cfg.llm, gen, dtype=llm_dtype, device=device)),
        "predictor": linear_init(gen, D, cfg.num_states, device=device),
        "task_embeddings": torch.randn((cfg.task_num, D), generator=gen,
                                       device=device) * 0.02,
    }
    if cfg.prompt_finetune:
        params["prompt_embeddings"] = torch.randn(
            (cfg.prompt_num, D), generator=gen, device=device) * 0.02
    return params


def cast_frontend(params: dict, dtype=torch.bfloat16) -> dict:
    """Cast the encoder/adapter trees (float leaves only) to `dtype`; serving
    runs the frontend in half precision."""
    def cast(tree):
        if isinstance(tree, dict):
            return {k: cast(v) for k, v in tree.items()}
        return tree.to(dtype) if tree.is_floating_point() else tree

    out = dict(params)
    for k in ("encoder_user", "encoder_system", "adapter_user", "adapter_system"):
        if k in out:
            out[k] = cast(out[k])
    return out


def chunk_tokens(t_fbank: int) -> int:
    """LLM embeddings appended to the KV per fbank window of t_fbank frames
    (Conv2dSubsampling4 then the adapter's stride-2 conv). The engine's host
    KV-length mirror must use this."""
    return adapter_mod.out_len(encoder_mod.subsampled_len(t_fbank))


def prefill_tokens(params, cfg: AudioLLMConfig, ids: torch.Tensor,
                   kv: qwen2.KVCache) -> qwen2.KVCache:
    """System-role prefill: embed `ids` [B, T] and append them to `kv` in place."""
    embeds = qwen2.embed_tokens(params["llm"], ids)
    qwen2.forward(params["llm"], cfg.llm, embeds,
                  torch.ones(ids.shape, dtype=torch.bool, device=ids.device), kv)
    return kv


def state_head(params, hidden_last: torch.Tensor) -> torch.Tensor:
    """4-logit head; softmax over the first 3 classes. [B, D] -> [B, 3]."""
    logits = linear(params["predictor"], hidden_last.float())
    return torch.softmax(logits[..., :-1], dim=-1)


def _rows(active: torch.Tensor, ndim: int, axis: int) -> torch.Tensor:
    shape = [1] * ndim
    shape[axis] = active.shape[0]
    return active.reshape(shape)


def _commit(old: torch.Tensor, new: torch.Tensor, active: torch.Tensor,
            axis: int) -> None:
    """old[rows where active] = new, in place (batch axis `axis`)."""
    if old.numel():
        old.copy_(torch.where(_rows(active, old.dim(), axis), new.to(old.dtype), old))


def _commit_encoder(active, new: encoder_mod.EncoderState,
                    old: encoder_mod.EncoderState) -> None:
    _commit(old.k_cache, new.k_cache, active, 1)
    _commit(old.v_cache, new.v_cache, active, 1)
    _commit(old.valid, new.valid, active, 0)
    _commit(old.pe_index, new.pe_index, active, 0)
    _commit(old.ffn_cache, new.ffn_cache, active, 1)


def _commit_adapter(active, new: adapter_mod.AdapterState,
                    old: adapter_mod.AdapterState) -> None:
    if old.c1 is not None:
        _commit(old.c1, new.c1, active, 0)
    _commit(old.c2, new.c2, active, 0)


def _identity(params, caches: SessionCaches, identity: str):
    if identity == "user":
        return (params["encoder_user"], params["adapter_user"],
                caches.enc_user, caches.adp_user)
    if identity == "system":
        return (params["encoder_system"], params["adapter_system"],
                caches.enc_system, caches.adp_system)
    raise ValueError(f"unknown identity {identity!r}")


def _frontend(params, cfg: AudioLLMConfig, identity: str, chunk, caches,
              active):
    """Encoder + adapter for one identity; commits the streaming state of
    active rows in place and returns the chunk's LLM embeddings."""
    enc_p, adp_p, enc_s, adp_s = _identity(params, caches, identity)
    enc_out, enc_new = encoder_mod.stream_step(enc_p, cfg.encoder, chunk, enc_s)
    embeds, adp_new = adapter_mod.step(adp_p, cfg.adapter, enc_out, adp_s)
    _commit_encoder(active, enc_new, enc_s)
    _commit_adapter(active, adp_new, adp_s)
    return embeds


def _probs_at(params, hidden, mask) -> torch.Tensor:
    last = torch.clamp(qwen2.last_valid_index(mask), min=0)        # [B]
    idx = last[:, None, None].expand(-1, 1, hidden.shape[-1])
    return state_head(params, torch.gather(hidden, 1, idx)[:, 0])


def recognize_step(params, cfg: AudioLLMConfig, identity: str,
                   fbank_chunk: torch.Tensor, is_sl: torch.Tensor,
                   prefix_embeds: torch.Tensor, caches: SessionCaches,
                   active: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, SessionCaches]:
    """One audio chunk [B, T_f, 80] through encoder -> adapter -> (chat prefix
    splice when is_sl) -> LLM prefill -> state head. Returns ([B, 3] state
    probabilities, meaningful for identity='user', and the caches, updated in
    place). Rows where active is False keep every cache untouched."""
    B = fbank_chunk.shape[0]
    if active is None:
        active = torch.ones(B, dtype=torch.bool, device=fbank_chunk.device)
    embeds = _frontend(params, cfg, identity, fbank_chunk, caches, active)
    T, D = embeds.shape[1], embeds.shape[2]
    P = prefix_embeds.shape[0]
    full = torch.cat([prefix_embeds[None].expand(B, P, D).to(embeds.dtype),
                      embeds], dim=1)
    mask = torch.cat([is_sl[:, None].expand(B, P),
                      torch.ones((B, T), dtype=torch.bool, device=embeds.device)],
                     dim=1) & active[:, None]
    hidden, _ = qwen2.forward(params["llm"], cfg.llm, full, mask, caches.kv)
    return _probs_at(params, hidden, mask), caches


def recognize_step_dual(params, cfg: AudioLLMConfig,
                        u_chunk, u_sl, u_active, s_chunk, s_sl, s_active,
                        u_prefix, s_prefix, caches: SessionCaches
                        ) -> Tuple[torch.Tensor, SessionCaches]:
    """Both identities' pending chunks through ONE LLM forward, as one token
    segment per row: [user prefix?; user chunk; system prefix?; system chunk],
    each piece masked (prefixes by is_sl, chunks by active). The rank/cumsum
    compaction in qwen2.forward keeps the serial order, so system queries see
    the user tokens and not the reverse. Returns ([B, 3] user state
    probabilities, read at the last valid user position, and the caches,
    updated in place)."""
    emb_u = _frontend(params, cfg, "user", u_chunk, caches, u_active)
    emb_s = _frontend(params, cfg, "system", s_chunk, caches, s_active)
    B, Tu, D = emb_u.shape
    Ts = emb_s.shape[1]
    Pu, Ps = u_prefix.shape[0], s_prefix.shape[0]
    full = torch.cat([u_prefix[None].expand(B, Pu, D).to(emb_u.dtype), emb_u,
                      s_prefix[None].expand(B, Ps, D).to(emb_u.dtype),
                      emb_s.to(emb_u.dtype)], dim=1)
    u_act, s_act = u_active[:, None], s_active[:, None]
    mask = torch.cat([(u_sl[:, None] & u_act).expand(B, Pu), u_act.expand(B, Tu),
                      (s_sl[:, None] & s_act).expand(B, Ps), s_act.expand(B, Ts)],
                     dim=1)
    hidden, _ = qwen2.forward(params["llm"], cfg.llm, full, mask, caches.kv)
    return _probs_at(params, hidden[:, : Pu + Tu], mask[:, : Pu + Tu]), caches


def _sample(gen, lg, sampling: SamplingConfig) -> torch.Tensor:
    return sample_top_k_top_p(gen, lg, sampling.temperature, sampling.top_k,
                              sampling.top_p)


def prefill_and_sample(params, cfg: AudioLLMConfig, ids: torch.Tensor,
                       kv: qwen2.KVCache, gen: torch.Generator,
                       sampling: SamplingConfig
                       ) -> Tuple[torch.Tensor, torch.Tensor, qwen2.KVCache]:
    """Stage 'dialog_ss': prefill the assistant chat prefix `ids` [B, T] into
    `kv` (in place) and sample the first response token from the last
    prefix position. Returns (token [B] int32, hidden [B, D], kv)."""
    embeds = qwen2.embed_tokens(params["llm"], ids)
    hidden, _ = qwen2.forward(params["llm"], cfg.llm, embeds,
                              torch.ones(ids.shape, dtype=torch.bool,
                                         device=ids.device), kv)
    h_last = hidden[:, -1]
    nxt = _sample(gen, qwen2.logits(params["llm"], cfg.llm, h_last), sampling)
    return nxt, h_last, kv


def generate_step(params, cfg: AudioLLMConfig, token: torch.Tensor,
                  kv: qwen2.KVCache, gen: torch.Generator,
                  sampling: SamplingConfig
                  ) -> Tuple[torch.Tensor, torch.Tensor, qwen2.KVCache]:
    """One text-decode step: embed token [B] -> LLM (appending to `kv` in
    place) -> sample. Returns (next_token [B], hidden [B, D], kv); the hidden
    state feeds the speech decoder (bin/inference.py:142-143, 162)."""
    embeds = qwen2.embed_tokens(params["llm"], token[:, None])
    mask = torch.ones((token.shape[0], 1), dtype=torch.bool, device=token.device)
    hidden, _ = qwen2.forward(params["llm"], cfg.llm, embeds, mask, kv)
    nxt = _sample(gen, qwen2.logits(params["llm"], cfg.llm, hidden[:, 0]),
                  sampling)
    return nxt, hidden[:, 0], kv


def generate_segment(params, cfg: AudioLLMConfig, token: torch.Tensor,
                     kv: qwen2.KVCache, gen: torch.Generator,
                     sampling: SamplingConfig, n_steps: int, eod_id: int
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                qwen2.KVCache]:
    """Up to n_steps text tokens on the device, nothing fetched to the host.
    Returns (tokens [B, n], hiddens [B, n, D], done [B], kv). After eod a row's
    token repeats eod and its cache stops growing (its writes are masked)."""
    tok = token.to(torch.int32)
    done = torch.zeros(tok.shape[0], dtype=torch.bool, device=tok.device)
    toks, hiddens = [], []
    for _ in range(n_steps):
        embeds = qwen2.embed_tokens(params["llm"], tok[:, None])
        hidden, _ = qwen2.forward(params["llm"], cfg.llm, embeds,
                                  (~done)[:, None], kv)
        nxt = _sample(gen, qwen2.logits(params["llm"], cfg.llm, hidden[:, 0]),
                      sampling)
        nxt = torch.where(done, torch.full_like(nxt, eod_id), nxt)
        done = done | (nxt == eod_id)
        tok = nxt
        toks.append(nxt)
        hiddens.append(hidden[:, 0])
    return torch.stack(toks, 1), torch.stack(hiddens, 1), done, kv


def prefill_and_generate(params, cfg: AudioLLMConfig, ids: torch.Tensor,
                         kv: qwen2.KVCache, gen: torch.Generator,
                         sampling: SamplingConfig, n_steps: int, eod_id: int):
    """'dialog_ss' plus the first text segment: assistant-prefix prefill,
    first-token sample, then n_steps of generation. Returns (tokens
    [B, 1+n], hiddens [B, 1+n, D], done [B], kv)."""
    tok0, h0, kv = prefill_and_sample(params, cfg, ids, kv, gen, sampling)
    toks, hiddens, done, kv = generate_segment(
        params, cfg, tok0, kv, gen, sampling, n_steps=n_steps, eod_id=eod_id)
    return (torch.cat([tok0[:, None], toks], 1),
            torch.cat([h0[:, None], hiddens], 1), done, kv)
