"""Inference pipeline facades (counterpart of freeze_omni_tpu/pipeline.py).

Both public APIs of the reference:

- `InferencePipeline.speech_dialogue(audio, **outputs)`: the upstream
  dict-style stage machine of bin/inference.py:129 ('pre' -> 'dialog_sl' /
  'dialog_cl' per chunk -> 'dialog_ss' -> 'dialog_cs' generation loop), with
  text generation;
- `DuplexPipeline.speech_dialogue(audio, identity, status, role,
  past_key_values, adapter_cache, encoder_cache, pe_index)`: the fork's
  5-tuple dialog-state API (models/pipeline.py:36-88), where the LLM only
  prefills and the 4-way state head is read for user audio.

Both run on one `_Core` (parameters, tokenizer, chat prefixes, role
prefills, sampling), which any number of pipelines, responders, serving
engines and session threads may share. Session state is explicit caches
passed in by the caller; unlike the JAX pytrees, the port's model steps
advance those caches IN PLACE (models/qwen2.forward), as the reference's HF
cache does, so a cache that must stay as it is gets copied first
(`qwen2.copy_cache`).
"""

from __future__ import annotations

import re
import threading
from typing import Optional

import numpy as np
import torch

from .config import SystemConfig
from .models import adapter as adapter_mod
from .models import audio_llm
from .models import encoder as encoder_mod
from .models import qwen2
from .utils.device import resolve_device
from .utils.tokenizer import ByteTokenizer, ChatTemplate


def post_process(text: str) -> str:
    """Normalize model text for TTS (models/pipeline.py:90-130 behavior):
    unify CJK/ASCII punctuation, strip markup and whitespace runs, reformat
    numbered lists, and guarantee terminal punctuation."""
    for a, b in [("、", "，"), ("(", ","), (")", ","), ("（", "，"), ("）", "，")]:
        text = text.replace(a, b)
    text = re.sub(r"[\n\r\t]", "", text)
    text = re.sub(r"[*_`~]", "", text)
    text = re.sub(r"(\.|\:)\s+", r"\1", text)
    if re.search(r"[一-龥]", text):
        text = re.sub(r"(\d+)\.\s*([一-龥A-Za-z])", r"\1：\2", text)
    else:
        text = re.sub(r"(\d+)\.\s*([\w])", r"\1:\2", text)
    if text and text[-1] not in ["。", "？", "！", ".", "?", "!"]:
        if text[-1] in [",", "，", ";", "；", ":", "：", "、"]:
            text = text[:-1] + "。"
        else:
            text += "。"
    return text


class _Core:
    """Shared holder of the parameters, tokenizer and chat template, the
    chat-prefix embeddings, the role prefills and the sampling generator."""

    def __init__(self, cfg: SystemConfig, params: Optional[dict] = None,
                 tokenizer=None, seed: int = 0, llm_dtype=torch.float32,
                 device=None):
        """params: a tree already on `device`; None draws random float
        weights from `seed`. device=None means the CUDA card and raises
        without one."""
        self.cfg = cfg
        self.acfg = cfg.audio_llm
        self.device = resolve_device(device)
        self.tokenizer = tokenizer or ByteTokenizer(cfg.audio_llm.llm.vocab_size)
        self.chat = ChatTemplate(self.tokenizer)
        if params is None:
            params = audio_llm.init_params(self.acfg, seed, self.device,
                                           llm_dtype=llm_dtype)
        self.params = params
        # sampling: every call draws from its own generator, seeded from this
        # one under the lock (the JAX core splits a PRNG key per call), so
        # session threads sharing the core never share a stream
        self._seeds = torch.Generator().manual_seed(seed + 1)
        self._lock = threading.Lock()
        self._role_kv = {}
        # chat-template prefix embeddings (audioLLM.py:245-251)
        self.user_prefix_embeds = qwen2.embed_tokens(
            params["llm"], self._ids(self.chat.user_prefix_ids))
        self.system_prefix_embeds = qwen2.embed_tokens(
            params["llm"], self._ids(self.chat.system_prefix_ids))

    def _ids(self, ids) -> torch.Tensor:
        return torch.as_tensor(np.asarray(ids, np.int64), device=self.device)

    def to_device(self, a) -> torch.Tensor:
        """A host float array on the core's device. To the card it goes
        through pinned memory without waiting for the stream: a copy from
        pageable memory would wait for all the work queued before it."""
        t = torch.as_tensor(np.asarray(a, np.float32))
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t

    def next_key(self) -> torch.Generator:
        """A fresh generator on the core's device for one call's draws."""
        with self._lock:
            seed = int(torch.randint(0, 2**62, (), generator=self._seeds))
        return torch.Generator(device=self.device).manual_seed(seed)

    @property
    def frontend_dtype(self) -> torch.dtype:
        """The encoder/adapter compute dtype (audio_llm.cast_frontend), which
        their streaming caches share."""
        return self.params["encoder_user"]["cmvn"]["mean"].dtype

    def audio_state(self, batch: int = 1):
        """Fresh (encoder, adapter) streaming caches of one identity."""
        return (encoder_mod.init_state(self.acfg.encoder, batch,
                                       self.frontend_dtype, self.device),
                adapter_mod.init_state(self.acfg.adapter, batch,
                                       self.frontend_dtype, self.device))

    def role_kv(self, role: str) -> qwen2.KVCache:
        """The role prompt prefilled into a batch-1 float cache whose dtype
        follows the activation dtype embed_tokens emits, computed once per
        role and shared: callers copy it before appending to it."""
        with self._lock:
            kv = self._role_kv.get(role)
            if kv is None:
                ids = self._ids(self.chat.role_prompt_ids(role))[None]
                # this rank's kv heads where the LLM is sharded
                kv = qwen2.init_cache(self.acfg.llm, 1,
                                      dtype=self.user_prefix_embeds.dtype,
                                      device=self.device,
                                      tp=qwen2.model_ranks(self.params["llm"]))
                with torch.no_grad():
                    kv = audio_llm.prefill_tokens(self.params, self.acfg, ids, kv)
                self._role_kv[role] = kv
        return kv


class InferencePipeline:
    """Upstream dict-style stage machine (the offline wav -> wav path). The
    'caches' entry is advanced in place by each stage and handed back."""

    def __init__(self, cfg: SystemConfig, params: Optional[dict] = None,
                 tokenizer=None, seed: int = 0, core: Optional[_Core] = None,
                 device=None):
        self.core = core or _Core(cfg, params, tokenizer, seed, device=device)
        self.cfg = self.core.cfg
        self.acfg = self.core.acfg

    def speech_dialogue(self, audio, **outputs) -> dict:
        core = self.core
        stat = outputs.get("stat", "pre")

        if stat == "pre":
            role = outputs.get("role", "You are a helpful assistant.")
            kv = qwen2.copy_cache(core.role_kv(role))
            (eu, au), (es, as_) = core.audio_state(), core.audio_state()
            caches = audio_llm.SessionCaches(eu, au, es, as_, kv)
            return {
                "stat": "dialog_sl", "role": role, "caches": caches,
                "adapter_cache": True, "encoder_cache": True, "pe_index": 0,
                "past_tokens": [], "is_first_chunk": True,
            }

        caches: audio_llm.SessionCaches = outputs["caches"]
        # reference callers reset audio caches by nulling these keys
        # (bin/inference.py:133-135)
        if outputs.get("adapter_cache", True) is None or \
           outputs.get("encoder_cache", True) is None:
            caches = audio_llm.reset_audio_caches(self.acfg, caches)
            outputs["adapter_cache"] = True
            outputs["encoder_cache"] = True
            outputs["is_first_chunk"] = True

        if stat in ("dialog_sl", "dialog_cl") and audio is not None:
            is_sl = torch.tensor(
                [bool(outputs.get("is_first_chunk", stat == "dialog_sl"))],
                device=core.device)
            with torch.no_grad():
                probs, caches = audio_llm.recognize_step(
                    core.params, self.acfg, "user", core.to_device(audio), is_sl,
                    core.user_prefix_embeds, caches)
            probs = probs[0].float().cpu().numpy()
            new_stat = "dialog_cl"
            # upstream server semantics: the state head can trigger the
            # response ('dialog_ss') or end without one ('dialog_el');
            # bin/inference.py forces transitions by hand, so this is opt-in
            if outputs.get("auto_transition"):
                thr = self.cfg.duplex.resp_threshold
                if probs[1] > thr:
                    new_stat = "dialog_ss"
                elif probs[2] > thr:
                    new_stat = "dialog_el"
            out = dict(outputs)
            out.update(stat=new_stat, caches=caches, state_probs=probs,
                       is_first_chunk=False)
            return out

        eod = core.tokenizer.eod_id
        if stat == "dialog_ss":
            with torch.no_grad():
                tok, hidden, _ = audio_llm.prefill_and_sample(
                    core.params, self.acfg,
                    core._ids(core.chat.system_prefix_ids)[None], caches.kv,
                    core.next_key(), self.cfg.sampling)
            past = [int(tok[0])]
            out = dict(outputs)
            out.update(stat="dialog_cs", caches=caches, past_tokens=past,
                       text=core.tokenizer.decode(past),
                       hidden_state=hidden.float().cpu().numpy()[None])  # [1,1,D]
            return out

        if stat == "dialog_cs":
            with torch.no_grad():
                tok, hidden, _ = audio_llm.generate_step(
                    core.params, self.acfg, core._ids([outputs["past_tokens"][-1]]),
                    caches.kv, core.next_key(), self.cfg.sampling)
            past = outputs["past_tokens"] + [int(tok[0])]
            out = dict(outputs)
            out.update(stat="dialog_sl" if past[-1] == eod else "dialog_cs",
                       caches=caches, past_tokens=past,
                       text=core.tokenizer.decode([t for t in past if t != eod]),
                       hidden_state=hidden.float().cpu().numpy()[None])
            return out

        raise ValueError(f"unhandled stat {stat!r}")

    def speech_dialogue_segment(self, outputs: dict, n_steps: int = 16) -> dict:
        """'dialog_cs' for up to n_steps tokens in one call of
        audio_llm.generate_segment, with one host fetch. Adds
        'segment_tokens' (list) and 'segment_hiddens' ([1, k, D] float32
        numpy, aligned with segment_tokens) to the outputs."""
        core = self.core
        caches: audio_llm.SessionCaches = outputs["caches"]
        eod = core.tokenizer.eod_id
        with torch.no_grad():
            toks, hiddens, _, _ = audio_llm.generate_segment(
                core.params, self.acfg, core._ids([outputs["past_tokens"][-1]]),
                caches.kv, core.next_key(), self.cfg.sampling,
                n_steps=n_steps, eod_id=eod)
        toks = [int(t) for t in toks[0].cpu()]
        hiddens = hiddens.float().cpu().numpy()
        if eod in toks:
            k = toks.index(eod) + 1  # keep the eod token (the stage flips)
            toks, hiddens = toks[:k], hiddens[:, :k]
        past = outputs["past_tokens"] + toks
        out = dict(outputs)
        out.update(stat="dialog_sl" if past[-1] == eod else "dialog_cs",
                   caches=caches, past_tokens=past,
                   text=core.tokenizer.decode([t for t in past if t != eod]),
                   segment_tokens=toks, segment_hiddens=hiddens)
        return out

    def post_process(self, text: str) -> str:
        return post_process(text)


class DuplexPipeline:
    """Fork-style 5-tuple API for duplex dialog-state prediction
    (models/pipeline.py:36-88)."""

    def __init__(self, cfg: SystemConfig, params: Optional[dict] = None,
                 tokenizer=None, seed: int = 0, core: Optional[_Core] = None,
                 device=None):
        self.core = core or _Core(cfg, params, tokenizer, seed, device=device)
        self.cfg = self.core.cfg
        self.acfg = self.core.acfg

    def speech_dialogue(self, audio, identity: str, status: str,
                        role: Optional[str] = None, past_key_values=None,
                        adapter_cache=None, encoder_cache=None, pe_index=0):
        """Returns (prediction_probs, past_key_values, adapter_cache,
        encoder_cache, pe_index), the fork's signature; the caches are the
        port's KVCache, AdapterState and EncoderState.

        status 'pre' returns the role prefill, shared by every caller of
        this role: copy it (qwen2.copy_cache) before the first chunk. Every
        other status advances the caches it is given IN PLACE, as the
        reference's HF cache does, and returns them. For user audio the
        probabilities and pe_index come to the host in one fetch; system
        audio has no prediction and fetches nothing (pe_index stays a
        device tensor)."""
        core = self.core
        if status == "pre":
            kv = core.role_kv(role or self.cfg.duplex.default_prompt)
            return None, kv, None, None, None

        if past_key_values is None:
            raise ValueError("must set the system role first (status 'pre')")
        b = past_key_values.length.shape[0]
        enc_state, adp_state = encoder_cache, adapter_cache
        if enc_state is None:
            enc_state = core.audio_state(b)[0]
        if adp_state is None:
            adp_state = core.audio_state(b)[1]
        # recognize_step reads and advances only this identity's states
        caches = audio_llm.SessionCaches(enc_state, adp_state, enc_state,
                                         adp_state, past_key_values)
        prefix = (core.user_prefix_embeds if identity == "user"
                  else core.system_prefix_embeds)
        is_sl = torch.full((b,), status == "ipu_sl", dtype=torch.bool,
                           device=core.device)
        with torch.no_grad():
            probs, _ = audio_llm.recognize_step(core.params, self.acfg, identity,
                                                core.to_device(audio), is_sl,
                                                prefix, caches)
        if identity != "user":
            # no prediction for system audio (audioLLM.py:396-397)
            return None, past_key_values, adp_state, enc_state, enc_state.pe_index
        # one device fetch for the prediction and pe_index together
        s1, s2, pe = torch.cat([probs[0, 1:3].double(),
                                enc_state.pe_index[:1].double()]).tolist()
        return ({"state_1": s1, "state_2": s2}, past_key_values, adp_state,
                enc_state, int(pe))

    def post_process(self, text: str) -> str:
        return post_process(text)
