"""Training data utilities: synthetic duplex fixtures + batching (a copy of
freeze_omni_tpu/training/data.py; numpy only, so the draws for a seed are
the JAX package's, bit for bit).

The reference has no training data pipeline in-repo, and its chat.json is a
dev artifact, not dialogue data (SURVEY.md §0.4) — so workloads here are
synthetic duplex-audio fixtures: random speech-band fbank streams with
chunk-level dialog-state labels following the system.png scheme (0 =
mid-utterance/continue, 1 = respond, 2 = end-without-response), plus random
codec-token targets for the speech decoder CE.
"""

from __future__ import annotations

from typing import Dict, Iterator

import numpy as np

from ..config import AudioLLMConfig, SpeechDecoderConfig


def synth_audio_llm_batch(seed: int, cfg: AudioLLMConfig, batch: int,
                          fbank_frames: int = 67) -> Dict[str, np.ndarray]:
    """fbank [B, T_f, 80] + per-LLM-chunk labels. Label 1 or 2 goes on the
    final chunk of each utterance, 0 elsewhere (system.png label scheme)."""
    rng = np.random.RandomState(seed)
    t_enc = ((fbank_frames - 1) // 2 - 1) // 2
    t_llm = (t_enc + 1) // 2
    fbank = rng.randn(batch, fbank_frames, cfg.encoder.input_dim).astype(np.float32)
    labels = np.zeros((batch, t_llm), np.int32)
    final = rng.randint(1, 3, size=batch)  # 1=respond, 2=end-no-response
    labels[:, -1] = final
    return {
        "fbank": fbank,
        "labels": labels,
        "label_mask": np.ones((batch, t_llm), bool),
    }


def _token_fbank(rng, tokens: np.ndarray, n_mel: int,
                 frames_per_token: int) -> np.ndarray:
    """Audio whose spectrum encodes the transcript: token t lights up mel bin
    (3 + 5*t) % n_mel for its frame span, over a noise floor. Makes the
    ASR objectives separable so training tests can assert learning, not just
    finiteness."""
    B, N = tokens.shape
    T = N * frames_per_token
    fb = rng.randn(B, T, n_mel).astype(np.float32) * 0.3
    bins = (3 + 5 * tokens) % n_mel  # [B, N]
    for i in range(N):
        span = slice(i * frames_per_token, (i + 1) * frames_per_token)
        for b in range(B):
            fb[b, span, bins[b, i]] += 4.0
    return fb


def synth_ctc_batch(seed: int, cfg: AudioLLMConfig, batch: int,
                    vocab: int = 16, text_len: int = 4,
                    frames_per_token: int = 16) -> Dict[str, np.ndarray]:
    """Input-side stage 1 fixture: fbank + CTC token targets (< vocab,
    blank = vocab is excluded by construction)."""
    rng = np.random.RandomState(seed)
    tokens = rng.randint(0, vocab, size=(batch, text_len)).astype(np.int32)
    fbank = _token_fbank(rng, tokens, cfg.encoder.input_dim, frames_per_token)
    return {
        "fbank": fbank,
        "fbank_lens": np.full((batch,), fbank.shape[1], np.int32),
        "tokens": tokens,
        "token_lens": np.full((batch,), text_len, np.int32),
    }


def synth_asr_batch(seed: int, cfg: AudioLLMConfig, batch: int,
                    vocab: int | None = None, text_len: int = 4,
                    frames_per_token: int = 16) -> Dict[str, np.ndarray]:
    """Input-side stage 2/3 fixture: fbank whose spectrum encodes the
    transcript + the transcript ids for the causal-CE alignment loss."""
    rng = np.random.RandomState(seed)
    vocab = vocab if vocab is not None else min(cfg.llm.vocab_size, 32)
    text = rng.randint(2, vocab, size=(batch, text_len)).astype(np.int32)
    fbank = _token_fbank(rng, text, cfg.encoder.input_dim, frames_per_token)
    return {
        "fbank": fbank,
        "text_ids": text,
        "text_mask": np.ones((batch, text_len), bool),
    }


def synth_lora_batch(seed: int, cfg: AudioLLMConfig, batch: int,
                     text_len: int = 12, n_tokens: int = 8,
                     base: int = 2) -> Dict[str, np.ndarray]:
    """LoRA-stage fixture: sequences that follow a fixed deterministic
    successor map over a small token set (t -> (5t+1) mod n + base). A random
    frozen LLM cannot predict the successor; a low-rank adapter can learn the
    map (it is a rank-<=n_tokens linear structure), so tests can assert
    learning, not just finiteness."""
    rng = np.random.RandomState(seed)
    ids = np.zeros((batch, text_len), np.int32)
    ids[:, 0] = rng.randint(0, n_tokens, size=batch)
    for t in range(1, text_len):
        ids[:, t] = (ids[:, t - 1] * 5 + 1) % n_tokens
    return {
        "text_ids": ids + base,
        "text_mask": np.ones((batch, text_len), bool),
    }


def synth_decoder_batch(seed: int, cfg: SpeechDecoderConfig, batch: int,
                        hidden_len: int = 6, y_len: int = 8
                        ) -> Dict[str, np.ndarray]:
    rng = np.random.RandomState(seed)
    return {
        "dec_hidden": rng.randn(batch, hidden_len, cfg.idim).astype(np.float32),
        "dec_hidden_lens": np.full((batch,), hidden_len, np.int32),
        "dec_y": rng.randint(0, cfg.codec_vocab, (batch, y_len)).astype(np.int32),
        "dec_y_lens": np.full((batch,), y_len - 1, np.int32),
    }


def batches(cfg: AudioLLMConfig, dcfg: SpeechDecoderConfig, batch: int,
            steps: int, seed: int = 0, with_decoder: bool = True
            ) -> Iterator[Dict[str, np.ndarray]]:
    for i in range(steps):
        b = synth_audio_llm_batch(seed + i, cfg, batch)
        if with_decoder:
            b.update(synth_decoder_batch(seed + 1000 + i, dcfg, batch))
        yield b


def stage_batches(stage: str, cfg: AudioLLMConfig, dcfg: SpeechDecoderConfig,
                  batch: int, steps: int, seed: int = 0
                  ) -> Iterator[Dict[str, np.ndarray]]:
    """Synthetic batches for one curriculum stage (train_step.STAGES)."""
    for i in range(steps):
        if stage == "ctc":
            yield synth_ctc_batch(seed + i, cfg, batch)
        elif stage in ("align", "prompt"):
            yield synth_asr_batch(seed + i, cfg, batch)
        elif stage == "state":
            yield synth_audio_llm_batch(seed + i, cfg, batch)
        elif stage == "decoder":
            yield synth_decoder_batch(seed + i, dcfg, batch)
        elif stage == "lora":
            yield synth_lora_batch(seed + i, cfg, batch)
        elif stage == "all":
            b = synth_audio_llm_batch(seed + i, cfg, batch)
            b.update(synth_decoder_batch(seed + 1000 + i, dcfg, batch))
            yield b
        else:
            raise ValueError(f"unknown stage {stage!r}")
