"""Minimal WAV I/O and a polyphase resampler (copy of the numpy paths of
freeze_omni_tpu/frontend/wav.py).

PCM16/PCM32/PCM8 through the standard library's `wave`; no soundfile or
torchaudio is assumed. Resampling is a windowed-sinc polyphase filter (the
design of torchaudio's sinc_interp_hann: lowpass_filter_width 6, Hann
window). Both `resample` and `StreamingResampler` run the native C++
resampler (native/frontend/resample.cc, frontend/native.py) when its
library is available, and the numpy path otherwise; the two give the same
samples (tests/test_torch_native.py).
"""

from __future__ import annotations

import math
import threading
import wave
from typing import Tuple

import numpy as np

from . import native


def read_wav(path: str) -> Tuple[np.ndarray, int]:
    """Returns (float32 samples in [-1, 1] shaped [n] or [n, ch], sample_rate)."""
    with wave.open(path, "rb") as w:
        sr = w.getframerate()
        n = w.getnframes()
        ch = w.getnchannels()
        width = w.getsampwidth()
        raw = w.readframes(n)
    if width == 2:
        data = np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0
    elif width == 4:
        data = np.frombuffer(raw, dtype="<i4").astype(np.float32) / 2147483648.0
    elif width == 1:
        data = (np.frombuffer(raw, dtype=np.uint8).astype(np.float32) - 128.0) / 128.0
    else:
        raise ValueError(f"unsupported sample width {width}")
    if ch > 1:
        data = data.reshape(-1, ch)
    return data, sr


def write_wav(path: str, samples: np.ndarray, sample_rate: int) -> None:
    """samples: float array in [-1, 1], shape [n] or [n, ch]; written as
    PCM16. Non-finite samples are written as 0 (np.clip passes NaN)."""
    samples = np.asarray(samples)
    ch = 1 if samples.ndim == 1 else samples.shape[1]
    pcm = np.clip(np.nan_to_num(samples), -1.0, 1.0)
    pcm = (pcm * 32767.0).astype("<i2")
    with wave.open(path, "wb") as w:
        w.setnchannels(ch)
        w.setsampwidth(2)
        w.setframerate(sample_rate)
        w.writeframes(pcm.tobytes())


def _design_kernel(orig_sr: int, new_sr: int, lowpass_filter_width: int,
                   rolloff: float):
    """Polyphase kernel [up, 2*width+up] and (up, down, width):
    kernel[p, k] is the weight of input sample (t0 + k - width) in output
    phase p."""
    gcd = math.gcd(orig_sr, new_sr)
    up, down = new_sr // gcd, orig_sr // gcd
    base_freq = min(orig_sr, new_sr) * rolloff / 2.0
    width = int(math.ceil(lowpass_filter_width * orig_sr / (2 * base_freq)))
    idx = np.arange(-width, width + up, dtype=np.float64)[None, :] / orig_sr
    t = np.arange(0, -up, -1, dtype=np.float64)[:, None] / new_sr + idx
    t = t * (2 * base_freq)
    t = np.clip(t, -lowpass_filter_width, lowpass_filter_width)
    window = np.cos(t * math.pi / lowpass_filter_width / 2) ** 2
    scale = 2 * base_freq / orig_sr
    kernel = np.where(t == 0, 1.0, np.sinc(t)) * window * scale
    return kernel, up, down, width


# one shared one-shot native resampler per design; a call resets its state
_native_resamplers: dict = {}
_native_lock = threading.Lock()


def resample(x: np.ndarray, orig_sr: int, new_sr: int,
             lowpass_filter_width: int = 6, rolloff: float = 0.99) -> np.ndarray:
    """x: [n] float -> [ceil(n * new_sr / orig_sr)] float32."""
    if orig_sr == new_sr:
        return x
    if native.available():
        key = (orig_sr, new_sr, lowpass_filter_width, rolloff)
        with _native_lock:
            rs = _native_resamplers.get(key)
            if rs is None:
                rs = _native_resamplers[key] = native.NativeResampler(*key)
            return rs(np.asarray(x, np.float32))
    return resample_numpy(x, orig_sr, new_sr, lowpass_filter_width, rolloff)


def resample_numpy(x: np.ndarray, orig_sr: int, new_sr: int,
                   lowpass_filter_width: int = 6,
                   rolloff: float = 0.99) -> np.ndarray:
    """The numpy path of `resample` (its oracle in the tests)."""
    kernel, up, down, width = _design_kernel(orig_sr, new_sr,
                                             lowpass_filter_width, rolloff)
    n = x.shape[0]
    x_pad = np.pad(x.astype(np.float64), (width, width + up))
    num_out_blocks = int(math.ceil(n / down))
    out = np.zeros((up, num_out_blocks), dtype=np.float64)
    for p in range(up):
        conv = np.convolve(x_pad, kernel[p, ::-1], mode="valid")
        out[p] = conv[: num_out_blocks * down : down][:num_out_blocks]
    y = out.T.reshape(-1)
    target_len = int(math.ceil(new_sr * n / orig_sr))
    return y[:target_len].astype(np.float32)


class StreamingResampler:
    """Streaming resampler for live ingest (arbitrary client rates).

    `push(chunk)` emits every output sample whose kernel support is already
    complete; `flush()` zero-pads the tail so push* + flush concatenates to
    `resample(full_signal)`. Backed by its own NativeResampler where the
    native library is available; the numpy path follows the same block
    emission rule. Not thread-safe: one instance per (stream, identity)."""

    def __init__(self, orig_sr: int, new_sr: int,
                 lowpass_filter_width: int = 6, rolloff: float = 0.99):
        self.orig_sr, self.new_sr = orig_sr, new_sr
        self.passthrough = orig_sr == new_sr
        self._native = None
        if self.passthrough:
            return
        if native.available():
            self._native = native.NativeResampler(
                orig_sr, new_sr, lowpass_filter_width, rolloff)
            return
        self._kernel, self._up, self._down, self._width = _design_kernel(
            orig_sr, new_sr, lowpass_filter_width, rolloff)
        self._klen = self._kernel.shape[1]
        self._hist = np.zeros(0, np.float64)
        self._hist_start = 0  # absolute input index of _hist[0]
        self._n_in = 0
        self._next_block = 0
        self._emitted = 0

    def push(self, x: np.ndarray) -> np.ndarray:
        x = np.asarray(x, np.float32).reshape(-1)
        if self.passthrough:
            return x
        if self._native is not None:
            return self._native.push(x)
        self._hist = np.concatenate([self._hist, x.astype(np.float64)])
        self._n_in += x.shape[0]
        return self._emit(ready=lambda j: j * self._down - self._width
                          + self._klen <= self._n_in)

    def flush(self) -> np.ndarray:
        if self.passthrough:
            return np.zeros(0, np.float32)
        if self._native is not None:
            return self._native.flush()
        total = -(-self.new_sr * self._n_in // self.orig_sr)
        out = self._emit(ready=lambda j: self._emitted < total)
        return out[: max(0, total - (self._emitted - out.shape[0]))]

    def _emit(self, ready) -> np.ndarray:
        blocks = []
        while ready(self._next_block):
            first = self._next_block * self._down - self._width
            win = np.zeros(self._klen, np.float64)
            lo = max(first, 0)
            hi = min(first + self._klen, self._n_in)
            if hi > lo:
                win[lo - first: hi - first] = \
                    self._hist[lo - self._hist_start: hi - self._hist_start]
            blocks.append(self._kernel @ win)
            self._next_block += 1
            self._emitted += self._up
        # keep only what later blocks can still read (clamped so _hist_start
        # stays aligned with the next append)
        need_from = min(self._next_block * self._down - self._width, self._n_in)
        if need_from > self._hist_start:
            self._hist = self._hist[need_from - self._hist_start:]
            self._hist_start = need_from
        if not blocks:
            return np.zeros(0, np.float32)
        return np.concatenate(blocks).astype(np.float32)
