"""Duplex responder: from dialog_ss to spoken output (counterpart of
freeze_omni_tpu/duplex/responder.py).

When a session decides to respond, text is generated from its shared LLM
context in segments, each completed sentence is synthesized (speech decoder
+ codec, StreamingTTS) and the speech is handed back to the session, which
feeds it in as system-identity audio so the dialog-state context hears the
system speaking: the full duplex loop. `split_sentences` is the sentence
accumulator this responder and the batched continuation path share.
"""

from __future__ import annotations

from typing import Iterator, Optional, Tuple

import numpy as np
import torch

from ..config import SystemConfig
from ..frontend.wav import resample
from ..models import audio_llm, qwen2
from ..pipeline import _Core, post_process
from ..tts import StreamingTTS

SENTENCE_SUFFIXES = ("。", "：", "？", "！", ".", "?", "!", "\n")


def split_sentences(tokenizer, eod_id: int, buf_toks: list, buf_hids: list,
                    toks, hids) -> list:
    """Feed new (token, hidden [1, 1, D]) pairs into the running buffers; a
    sentence-suffix piece or eod completes the buffer. Returns [(tokens,
    hiddens), ...] of completed sentences; the buffers keep any unterminated
    tail."""
    done_sents = []
    for j, t in enumerate(toks):
        if t != eod_id:
            buf_toks.append(int(t))
            buf_hids.append(hids[j])
        piece = tokenizer.decode([int(t)]) if t != eod_id else ""
        if (piece.endswith(SENTENCE_SUFFIXES) or t == eod_id) and buf_toks:
            done_sents.append((list(buf_toks), list(buf_hids)))
            buf_toks.clear()
            buf_hids.clear()
    return done_sents


class DuplexResponder:
    def __init__(self, core: _Core, tts: StreamingTTS, cfg: SystemConfig,
                 max_tokens: Optional[int] = None,
                 segment: Optional[int] = None, embed_fn=None):
        """embed_fn: token ids -> LLM embeddings as host f32 (the engine's
        embed_tokens); None looks them up in the core's table. The response
        length and cadence come from cfg.duplex unless given."""
        self.core = core
        self.tts = tts
        self.cfg = cfg
        self.embed_fn = embed_fn
        self.max_tokens = (max_tokens if max_tokens is not None
                           else cfg.duplex.resp_max_tokens)
        self.segment = (segment if segment is not None
                        else cfg.duplex.resp_segment)

    def respond(self, kv: qwen2.KVCache
                ) -> Iterator[Tuple[str, Optional[np.ndarray], qwen2.KVCache]]:
        """Generate a response on the session's KV. Yields (sentence_text,
        pcm_16k or None, kv) per sentence.

        `kv` advances in place as text is generated. The caller keeps the
        context up to the last sentence yielded, as with the JAX responder,
        whose caller keeps the last KV it yields: on exit (an exception or
        an early close included) the cache's length goes back to its value
        at the last yield, or at entry when nothing was yielded. Slots past
        the length are never visible, so nothing is copied."""
        core = self.core
        acfg = self.cfg.audio_llm
        eod = core.tokenizer.eod_id
        committed = kv.length.clone()
        try:
            with torch.no_grad():
                tok, hidden, _ = audio_llm.prefill_and_sample(
                    core.params, acfg, core._ids(core.chat.system_prefix_ids)[None],
                    kv, core.next_key(), self.cfg.sampling)
            last = int(tok[0])
            n = 1
            done = last == eod
            cur_tokens: list = []
            cur_hiddens: list = []
            if not done:
                cur_tokens.append(last)
                cur_hiddens.append(hidden.float().cpu().numpy()[:, None])

            while not done and n < self.max_tokens:
                with torch.no_grad():
                    toks, hids, _, _ = audio_llm.generate_segment(
                        core.params, acfg, core._ids([last]), kv,
                        core.next_key(), self.cfg.sampling,
                        n_steps=self.segment, eod_id=eod)
                seg = [int(t) for t in toks[0].cpu()]
                hids = hids.float().cpu().numpy()
                if eod in seg:
                    seg = seg[: seg.index(eod) + 1]
                    done = True
                per_tok = [hids[:, j: j + 1] for j in range(len(seg))]
                for st, sh in split_sentences(core.tokenizer, eod, cur_tokens,
                                              cur_hiddens, seg, per_tok):
                    out = self._synthesize(st, sh)
                    if out is not None:
                        committed = kv.length.clone()
                        yield out[0], out[1], kv
                n += len(seg)
                if seg:
                    last = seg[-1]
            if cur_tokens:
                out = self._synthesize(cur_tokens, cur_hiddens)
                if out is not None:
                    committed = kv.length.clone()
                    yield out[0], out[1], kv
        finally:
            kv.length.copy_(committed)

    def _synthesize(self, tokens, hiddens):
        """A sentence's tokens and hiddens -> (text, pcm16 | None), or None
        when its text is empty."""
        eod = self.core.tokenizer.eod_id
        text = self.core.tokenizer.decode([t for t in tokens if t != eod])
        if not text.strip():
            return None
        return text, self.speak(text, hiddens)

    def speak(self, text: str, hiddens) -> Optional[np.ndarray]:
        """16 kHz speech of `text` (post_process'd, re-embedded) with the
        sentence's LLM hiddens ([1, 1, D] each) as the decoder's prefix;
        None when there is nothing to say."""
        core = self.core
        dec_idim = self.cfg.tts.decoder.idim
        ids = core.tokenizer.encode(post_process(text))
        if not ids:
            return None
        if self.embed_fn is not None:
            emb = self.embed_fn(ids)
        else:
            emb = qwen2.embed_tokens(core.params["llm"], core._ids(ids))
            emb = emb.float().cpu().numpy()
        emb = np.asarray(emb, np.float32).reshape(-1, dec_idim)[None]
        prefix = np.concatenate(hiddens, axis=1)
        prefix = np.asarray(prefix, np.float32).reshape(-1, dec_idim)[None]
        segs = [s[0, 0] for s in self.tts.run(emb, prefix=prefix)]
        if not segs:
            return None
        pcm24 = np.concatenate(segs)
        return resample(pcm24, self.cfg.tts.codec.sample_rate, 16000)
