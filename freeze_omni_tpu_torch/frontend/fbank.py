"""Kaldi-compatible log-mel filterbank in PyTorch (counterpart of
freeze_omni_tpu/frontend/fbank.py).

frame gather -> DC removal -> pre-emphasis -> Povey window -> rFFT (torch.fft
on explicitly framed, zero-padded windows) -> power -> mel matmul -> log, in
float32. Runs on whatever device the waveform lies on; the chunkers call it
on the host. Both variants the reference uses are covered: 25 ms / 10 ms
(offline) and 16 ms / 8 ms (duplex), dither 0, snip-edges framing.

`fbank_ref` is the numpy version of the same algorithm (a copy of the JAX
module's golden); the learned VAD computes its 40-bin `VAD_FBANK` features
with it on the host.
"""

from __future__ import annotations

import math
from functools import lru_cache

import numpy as np
import torch

from ..config import FbankConfig

# float32 machine epsilon: Kaldi's log floor
_EPS = float(np.finfo(np.float32).eps)

# the learned VAD's features: 16 ms / 8 ms frames, 40 mel bins (the JAX
# package's training/vad.py trains the committed weights on these)
VAD_FBANK = FbankConfig(frame_length_ms=16.0, frame_shift_ms=8.0,
                        num_mel_bins=40)


def _mel(freq):
    return 1127.0 * np.log(1.0 + freq / 700.0)


@lru_cache(maxsize=8)
def mel_banks(cfg: FbankConfig) -> np.ndarray:
    """Triangular mel filterbank matrix [num_mel_bins, n_fft//2 + 1], as
    Kaldi's get_mel_banks (the nyquist column is zero)."""
    n_fft = cfg.padded_window_size
    num_fft_bins = n_fft // 2
    fft_bin_width = cfg.sample_rate / n_fft

    high_freq = cfg.high_freq if cfg.high_freq > 0 else cfg.sample_rate / 2 + cfg.high_freq
    mel_low = _mel(cfg.low_freq)
    mel_high = _mel(high_freq)
    mel_delta = (mel_high - mel_low) / (cfg.num_mel_bins + 1)

    bin_idx = np.arange(cfg.num_mel_bins)[:, None]
    left_mel = mel_low + bin_idx * mel_delta
    center_mel = left_mel + mel_delta
    right_mel = center_mel + mel_delta

    mels = _mel(fft_bin_width * np.arange(num_fft_bins)[None, :])
    up = (mels - left_mel) / (center_mel - left_mel)
    down = (right_mel - mels) / (right_mel - center_mel)
    banks = np.maximum(0.0, np.minimum(up, down)).astype(np.float32)

    out = np.zeros((cfg.num_mel_bins, num_fft_bins + 1), dtype=np.float32)
    out[:, :num_fft_bins] = banks
    return out


@lru_cache(maxsize=8)
def _window(cfg: FbankConfig) -> np.ndarray:
    n = cfg.frame_length
    a = 2.0 * math.pi / (n - 1)
    t = np.arange(n, dtype=np.float64)
    if cfg.window_type == "povey":
        w = (0.5 - 0.5 * np.cos(a * t)) ** 0.85
    elif cfg.window_type == "hanning":
        w = 0.5 - 0.5 * np.cos(a * t)
    elif cfg.window_type == "hamming":
        w = 0.54 - 0.46 * np.cos(a * t)
    elif cfg.window_type == "rectangular":
        w = np.ones(n)
    else:
        raise ValueError(f"unknown window_type {cfg.window_type}")
    return w.astype(np.float32)


def num_frames(cfg: FbankConfig, num_samples: int) -> int:
    if not cfg.snip_edges:
        raise NotImplementedError("only snip_edges=True is used by the reference")
    if num_samples < cfg.frame_length:
        return 0
    return 1 + (num_samples - cfg.frame_length) // cfg.frame_shift


def fbank_ref(waveform: np.ndarray, cfg: FbankConfig = FbankConfig()) -> np.ndarray:
    """Kaldi fbank in numpy. waveform: [n] float (already scaled by 32768 as
    the reference does). Returns [m, num_mel_bins] float32."""
    n = waveform.shape[-1]
    m = num_frames(cfg, n)
    fl, fs = cfg.frame_length, cfg.frame_shift
    frames = np.stack([waveform[i * fs : i * fs + fl] for i in range(m)]).astype(np.float32)

    if cfg.remove_dc_offset:
        frames = frames - frames.mean(axis=1, keepdims=True)
    if cfg.preemphasis != 0.0:
        prev = np.concatenate([frames[:, :1], frames[:, :-1]], axis=1)
        frames = frames - cfg.preemphasis * prev
    frames = frames * _window(cfg)[None, :]

    n_fft = cfg.padded_window_size
    padded = np.zeros((m, n_fft), dtype=np.float32)
    padded[:, :fl] = frames
    spec = np.abs(np.fft.rfft(padded, axis=1)).astype(np.float32)
    if cfg.use_power:
        spec = spec**2
    mel = spec @ mel_banks(cfg).T
    return np.log(np.maximum(mel, _EPS)).astype(np.float32)


def fbank(waveform: torch.Tensor, cfg: FbankConfig = FbankConfig()) -> torch.Tensor:
    """waveform [..., n] (already scaled by 32768 or 32767, as the reference
    does) -> [..., m, num_mel_bins] float32 log-mel energies."""
    waveform = waveform.float()
    fl, fs = cfg.frame_length, cfg.frame_shift
    m = num_frames(cfg, waveform.shape[-1])
    frames = waveform[..., : (m - 1) * fs + fl].unfold(-1, fl, fs) if m else \
        waveform.new_zeros(waveform.shape[:-1] + (0, fl))

    if cfg.remove_dc_offset:
        frames = frames - frames.mean(dim=-1, keepdim=True)
    if cfg.preemphasis != 0.0:
        prev = torch.cat([frames[..., :1], frames[..., :-1]], dim=-1)
        frames = frames - cfg.preemphasis * prev
    frames = frames * torch.from_numpy(_window(cfg)).to(frames.device)

    padded = torch.nn.functional.pad(frames, (0, cfg.padded_window_size - fl))
    spec = torch.fft.rfft(padded, dim=-1).abs()
    if cfg.use_power:
        spec = spec * spec
    mel = torch.matmul(spec, torch.from_numpy(mel_banks(cfg)).to(spec.device).T)
    return torch.log(torch.clamp(mel, min=_EPS))
