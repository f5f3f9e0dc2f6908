"""Streaming fbank chunkers (counterpart of freeze_omni_tpu/frontend/chunker.py).

- `OfflineChunker`: 160 ms audio chunks -> [1, 19, 80] fbank windows with a
  3-frame feature overlap and a 240-sample waveform overlap
  (bin/inference.py:43-80 `audioEncoderProcessor` of the reference).
- `GatingChunker`: 224 ms duplex chunks -> [1, 32, 80] fbank windows (28 new
  steps + 4 context steps), with a history ring for IPU-onset replay
  (models/AudioFeatureGating.py).

State lives in host numpy. The fbank and the waveform/feature ring run in
the native C++ chunker (native/frontend/fbank.cc, frontend/native.py) when
its library is available, one C call per chunk; otherwise through the
port's torch fbank on the CPU.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from ..config import ChunkerConfig, FbankConfig, GatingConfig
from . import native
from .fbank import fbank


def _native_chunker(sample_rate, num_bins, frame_ms, shift_ms,
                    steps_per_chunk, context_steps, scale):
    """A NativeChunker where the native library is available, else None."""
    if not native.available():
        return None
    return native.NativeChunker(int(sample_rate), int(num_bins),
                                float(frame_ms), float(shift_ms),
                                int(steps_per_chunk), int(context_steps),
                                float(scale))


class OfflineChunker:
    """16-frame chunker with 3-frame context (the offline wav -> wav path)."""

    def __init__(self, cfg: ChunkerConfig = ChunkerConfig()):
        self.cfg = cfg
        self.fbank_cfg = FbankConfig(num_mel_bins=cfg.feat_dim)
        self.frame_overlap = cfg.frame_size - cfg.frame_shift
        self._native = _native_chunker(
            self.fbank_cfg.sample_rate, cfg.feat_dim,
            self.fbank_cfg.frame_length_ms, self.fbank_cfg.frame_shift_ms,
            cfg.chunk_size, cfg.chunk_overlap, 32768.0)
        self.reset()

    def get_chunk_size(self) -> int:
        return self.cfg.samples_per_chunk

    def reset(self) -> None:
        c = self.cfg
        self.input_sample = np.zeros(c.samples_per_chunk + self.frame_overlap, np.float32)
        self.input_chunk = np.zeros((1, c.frames_per_step, c.feat_dim), np.float32)
        if self._native is not None:
            self._native.reset()

    def process(self, audio: np.ndarray) -> np.ndarray:
        """audio: [samples_per_chunk] float in [-1, 1]. Returns [1, 19, 80]."""
        c = self.cfg
        if self._native is not None:
            return self._native.process(audio)
        sample_data = np.asarray(audio, np.float32).reshape(-1) * 32768.0
        self.input_sample[: self.frame_overlap] = self.input_sample[-self.frame_overlap :]
        self.input_sample[self.frame_overlap :] = sample_data
        xs = fbank(torch.from_numpy(self.input_sample), self.fbank_cfg).numpy()
        self.input_chunk[:, : c.chunk_overlap] = self.input_chunk[:, -c.chunk_overlap :]
        self.input_chunk[:, c.chunk_overlap :] = xs
        return self.input_chunk.copy()


class GatingChunker:
    """Duplex stateful fbank + gating (one per identity).

    `process_and_gate` matches AudioFeatureGating.process_and_gate: features
    are always extracted (state stays warm); chunks outside an IPU update the
    history ring and return None; `ipu_sl` chunks attach the onset history
    replay (`feature_last_chunk`, oldest first)."""

    def __init__(self, cfg: GatingConfig = GatingConfig()):
        self.cfg = cfg
        self.fbank_cfg = cfg.fbank()
        self.frame_overlap = self.fbank_cfg.frame_length - self.fbank_cfg.frame_shift
        self._native = _native_chunker(
            cfg.sample_rate, cfg.feat_dim, cfg.frame_length_s * 1000.0,
            cfg.frame_shift_s * 1000.0, cfg.steps_per_chunk, cfg.context_steps,
            32767.0)
        self.reset()

    def reset(self) -> None:
        c = self.cfg
        self.input_sample = np.zeros(c.samples_per_chunk + self.frame_overlap, np.float32)
        self.input_chunk = np.zeros((1, c.frames_per_step, c.feat_dim), np.float32)
        self.history = np.zeros((c.history_size, c.frames_per_step, c.feat_dim), np.float32)
        if self._native is not None:
            self._native.reset()

    def extract(self, audio: np.ndarray) -> np.ndarray:
        """audio: [samples_per_chunk] float in [-1, 1] -> [1, 32, 80]."""
        c = self.cfg
        if self._native is not None:
            return self._native.process(audio)
        sample_data = np.asarray(audio, np.float32).reshape(-1) * 32767.0
        self.input_sample[: self.frame_overlap] = self.input_sample[-self.frame_overlap :]
        self.input_sample[self.frame_overlap :] = sample_data
        xs = fbank(torch.from_numpy(self.input_sample), self.fbank_cfg).numpy()
        self.input_chunk[:, : c.context_steps] = self.input_chunk[:, -c.context_steps :]
        self.input_chunk[:, c.context_steps :] = xs
        return self.input_chunk.copy()

    def process_and_gate(self, annotated_audio: dict) -> Optional[dict]:
        status = annotated_audio["status"]
        feature = self.extract(annotated_audio["audio"])

        if status is None:
            self.history[:-1] = self.history[1:]
            self.history[-1] = feature[0]
            return None

        out = {"feature": feature, "status": status, "feature_last_chunk": []}
        if status == "ipu_sl" and self.cfg.onset_cache_size > 0:
            out["feature_last_chunk"] = [
                self.history[i][None] for i in range(-self.cfg.onset_cache_size, 0)
            ]
        return out


def gate_stream(chunker: GatingChunker, audio: np.ndarray,
                statuses) -> List[Tuple[np.ndarray, bool]]:
    """Cut `audio` into chunks of the chunker's size (the last one
    zero-padded), gate each with its status (None, 'ipu_sl', 'ipu_cl', ...),
    and return the engine submissions in order: [(fbank [1, T, 80], is_sl)].
    An `ipu_sl` chunk's onset replay is expanded as the duplex service does
    (dialog_state_pred.py:639-670): the history chunks first, the oldest as
    ipu_sl and the rest as ipu_cl, then the current chunk as ipu_cl."""
    n = chunker.cfg.samples_per_chunk
    items: List[Tuple[np.ndarray, bool]] = []
    for i, status in enumerate(statuses):
        chunk = np.zeros(n, np.float32)
        seg = audio[i * n:(i + 1) * n]
        chunk[:len(seg)] = seg
        gated = chunker.process_and_gate({"audio": chunk, "status": status})
        if gated is None:
            continue
        replay = gated["feature_last_chunk"]
        if replay and gated["status"] == "ipu_sl":
            items += [(f, j == 0) for j, f in enumerate(replay)]
            items.append((gated["feature"], False))
        else:
            items.append((gated["feature"], gated["status"] == "ipu_sl"))
    return items
