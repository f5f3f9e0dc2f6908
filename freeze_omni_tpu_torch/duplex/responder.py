"""Sentence accumulation of the duplex response path (counterpart of
split_sentences and SENTENCE_SUFFIXES in freeze_omni_tpu/duplex/responder.py).

Generated text tokens and their LLM hidden states accumulate per session; a
token whose text ends a sentence, or eod, completes it, and the completed
sentence goes to speech synthesis. The DuplexResponder of the JAX module
(per-session generation with StreamingTTS) comes with the service slice.
"""

from __future__ import annotations

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
