"""ctypes bindings for the native (C++) host frontend (counterpart of
freeze_omni_tpu/frontend/native.py).

`NativeFbank` computes Kaldi-compatible log-mel frames, `NativeChunker` runs
the streaming waveform/feature ring of the chunkers in one C call per chunk,
`NativeVAD` the learned VAD's whole probability path (fbank, GRU, sigmoid)
and `NativeResampler` the polyphase resampler, all from the repository's
sources native/frontend/{fbank,resample,vad}.cc.

The library is compiled with g++ at first use into
freeze_omni_tpu_torch/.kernel_build/ (git-ignored), under a name that
carries a hash of the three sources, the flags and the host CPU (the flags
include -march=native, so a library built on another machine is never
loaded). g++ writes a per-process temporary file that is renamed into place,
so processes that build at once each load a whole library. With no g++ (or
no sources) `available()` is false and callers take their numpy/torch
paths; a failed build raises with g++'s output.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

SOURCES = tuple(Path(__file__).resolve().parents[2] / "native" / "frontend" / f
                for f in ("fbank.cc", "resample.cc", "vad.cc"))
BUILD_DIR = Path(__file__).resolve().parent.parent / ".kernel_build"
CXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


class NativeBuildFailure(RuntimeError):
    pass


def _cpu_identity() -> bytes:
    """The host CPU's model and feature flags (what -march=native reads)."""
    try:
        with open("/proc/cpuinfo", "rb") as f:
            lines = f.read().splitlines()
    except OSError:
        return os.uname().machine.encode()
    keep = [ln for ln in lines if ln.startswith((b"model name", b"flags"))]
    return b"\n".join(keep[:2]) or os.uname().machine.encode()


def library_path() -> Path:
    """Where the library for these sources, flags and CPU lives."""
    h = hashlib.sha1()
    for src in SOURCES:
        h.update(src.name.encode() + src.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode() + _cpu_identity())
    return BUILD_DIR / f"libfofrontend-{h.hexdigest()[:12]}.so"


def build() -> Optional[Path]:
    """Compile the library unless it is built already. Returns its path, or
    None where there is no g++ or no sources. Raises NativeBuildFailure with
    g++'s output when the compile fails."""
    gxx = shutil.which("g++")
    if gxx is None or not all(src.exists() for src in SOURCES):
        return None
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [gxx, *CXX_FLAGS, "-o", str(tmp), *map(str, SOURCES)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
        if proc.returncode != 0:
            raise NativeBuildFailure(
                f"g++ exited {proc.returncode}: {' '.join(cmd)}\n"
                f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)
    finally:
        if tmp.exists():
            tmp.unlink()
    return out


def _bind(lib: ctypes.CDLL) -> None:
    f32p = ctypes.POINTER(ctypes.c_float)
    vp, i, d, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_double, ctypes.c_longlong
    sigs = {
        "fbank_create": (vp, [i, i, d, d]),
        "fbank_destroy": (None, [vp]),
        "fbank_num_frames": (i, [vp, i]),
        "fbank_compute": (None, [vp, f32p, i, f32p]),
        "chunker_create": (vp, [i, i, d, d, i, i, d]),
        "chunker_destroy": (None, [vp]),
        "chunker_chunk_samples": (i, [vp]),
        "chunker_frames_per_step": (i, [vp]),
        "chunker_reset": (None, [vp]),
        "chunker_process": (None, [vp, f32p, f32p]),
        "resample_create": (vp, [i, i, i, d]),
        "resample_destroy": (None, [vp]),
        "resample_reset": (None, [vp]),
        "resample_out_len": (ll, [vp, ll]),
        "resample_push_cap": (ll, [vp, ll]),
        "resample_push": (ll, [vp, f32p, ll, f32p]),
        "resample_flush_cap": (ll, [vp]),
        "resample_flush": (ll, [vp, f32p]),
        "resample_compute": (None, [vp, f32p, ll, f32p]),
        "vad_create": (vp, [i, d, d, i, i] + [f32p] * 7
                       + [ctypes.c_float, f32p, f32p]),
        "vad_destroy": (None, [vp]),
        "vad_reset": (None, [vp]),
        "vad_push": (i, [vp, f32p, i, f32p]),
    }
    for name, (res, args) in sigs.items():
        fn = getattr(lib, name)
        fn.restype = res
        fn.argtypes = args


def _load() -> Optional[ctypes.CDLL]:
    global _lib
    with _lock:
        if _lib is None:
            path = build()
            if path is None:
                return None
            lib = ctypes.CDLL(str(path))
            _bind(lib)
            _lib = lib
        return _lib


def available() -> bool:
    """True when the library is built (building it first if needed); false
    only where there is no g++ or no sources. A failed build raises."""
    return _load() is not None


def _require() -> ctypes.CDLL:
    lib = _load()
    if lib is None:
        raise RuntimeError("native frontend unavailable: no g++ on PATH or "
                           "no native/frontend sources")
    return lib


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


class _Handle:
    """Owns one C object; `_destroy` names its destructor."""

    _destroy = ""

    def __del__(self):
        if getattr(self, "_h", None):
            getattr(self._lib, self._destroy)(self._h)
            self._h = None


class NativeFbank(_Handle):
    _destroy = "fbank_destroy"

    def __init__(self, sample_rate: int = 16000, num_bins: int = 80,
                 frame_ms: float = 25.0, shift_ms: float = 10.0):
        self._lib = _require()
        self._h = self._lib.fbank_create(sample_rate, num_bins, frame_ms,
                                         shift_ms)
        self.num_bins = num_bins

    def __call__(self, wave: np.ndarray) -> np.ndarray:
        """wave: [n] float32 (scaled, e.g. x32768) -> [m, num_bins]."""
        wave = np.ascontiguousarray(wave, np.float32)
        m = self._lib.fbank_num_frames(self._h, wave.shape[0])
        out = np.empty((m, self.num_bins), np.float32)
        if m:
            self._lib.fbank_compute(self._h, _ptr(wave), wave.shape[0], _ptr(out))
        return out


class NativeChunker(_Handle):
    """Streaming chunker: one C call per chunk returns the model input
    window. scale 32768 with 16 steps and 3 of context is the offline
    chunker; scale 32767 with 28 steps and 4 of context the duplex gating
    chunker."""

    _destroy = "chunker_destroy"

    def __init__(self, sample_rate: int = 16000, num_bins: int = 80,
                 frame_ms: float = 25.0, shift_ms: float = 10.0,
                 steps_per_chunk: int = 16, context_steps: int = 3,
                 scale: float = 32768.0):
        self._lib = _require()
        self._h = self._lib.chunker_create(sample_rate, num_bins, frame_ms,
                                           shift_ms, steps_per_chunk,
                                           context_steps, scale)
        self.num_bins = num_bins
        self.chunk_samples = self._lib.chunker_chunk_samples(self._h)
        self.frames = self._lib.chunker_frames_per_step(self._h)

    def reset(self) -> None:
        self._lib.chunker_reset(self._h)

    def process(self, audio: np.ndarray) -> np.ndarray:
        """audio: [chunk_samples] float in [-1, 1] -> [1, frames, num_bins]."""
        audio = np.ascontiguousarray(audio, np.float32).reshape(-1)
        if audio.shape[0] != self.chunk_samples:
            raise ValueError(f"expected {self.chunk_samples} samples, got "
                             f"{audio.shape[0]}")
        out = np.empty((self.frames, self.num_bins), np.float32)
        self._lib.chunker_process(self._h, _ptr(audio), _ptr(out))
        return out[None]


class NativeVAD(_Handle):
    """Streaming learned-VAD probability core (native/frontend/vad.cc): the
    probability path of duplex/vad.LearnedVAD (carry buffer, 16/8 ms log-mel
    fbank, per-frame GRU, output sigmoid) in one C call per chunk."""

    _destroy = "vad_destroy"

    def __init__(self, params: dict, sample_rate: int = 16000,
                 frame_ms: float = 16.0, shift_ms: float = 8.0):
        self._lib = _require()
        # contiguous f32 copies, kept alive for as long as the C object
        self._w = {k: np.ascontiguousarray(np.asarray(v, np.float32))
                   for k, v in params.items()}
        p = self._w
        self._h = self._lib.vad_create(
            sample_rate, frame_ms, shift_ms, p["mean"].shape[0],
            p["bz"].shape[0], _ptr(p["wz"]), _ptr(p["wr"]), _ptr(p["wh"]),
            _ptr(p["bz"]), _ptr(p["br"]), _ptr(p["bh"]), _ptr(p["wo"]),
            float(p["bo"].ravel()[0]), _ptr(p["mean"]), _ptr(p["scale"]))

    def reset(self) -> None:
        self._lib.vad_reset(self._h)

    def push(self, audio: np.ndarray) -> Optional[float]:
        """audio: [n] float in [-1, 1] -> mean frame speech probability, or
        None while the samples are buffered (short of one fbank frame)."""
        audio = np.ascontiguousarray(audio, np.float32).reshape(-1)
        out = np.empty((1,), np.float32)
        got = self._lib.vad_push(self._h, _ptr(audio), audio.shape[0],
                                 _ptr(out))
        return float(out[0]) if got else None


class NativeResampler(_Handle):
    """Streaming polyphase resampler (native/frontend/resample.cc), the
    design of frontend/wav.resample. `push` emits every output sample whose
    kernel support is complete; `flush` zero-pads the tail and truncates to
    the one-shot length, so push* + flush concatenates to
    `wav.resample(full_signal)`."""

    _destroy = "resample_destroy"

    def __init__(self, orig_sr: int, new_sr: int,
                 lowpass_filter_width: int = 6, rolloff: float = 0.99):
        self._lib = _require()
        self._h = self._lib.resample_create(orig_sr, new_sr,
                                            lowpass_filter_width, rolloff)
        if not self._h:
            raise ValueError(f"bad rates {orig_sr}->{new_sr}")

    def reset(self) -> None:
        self._lib.resample_reset(self._h)

    def push(self, audio: np.ndarray) -> np.ndarray:
        audio = np.ascontiguousarray(audio, np.float32).reshape(-1)
        n = audio.shape[0]
        out = np.empty(self._lib.resample_push_cap(self._h, n), np.float32)
        wrote = self._lib.resample_push(self._h, _ptr(audio), n, _ptr(out))
        return out[:wrote]

    def flush(self) -> np.ndarray:
        out = np.empty(max(1, self._lib.resample_flush_cap(self._h)),
                       np.float32)
        wrote = self._lib.resample_flush(self._h, _ptr(out))
        return out[:wrote]

    def __call__(self, audio: np.ndarray) -> np.ndarray:
        """One-shot: resample the whole signal on a fresh state."""
        audio = np.ascontiguousarray(audio, np.float32).reshape(-1)
        n = audio.shape[0]
        out = np.empty(self._lib.resample_out_len(self._h, n), np.float32)
        self._lib.resample_compute(self._h, _ptr(audio), n, _ptr(out))
        return out
