"""Plain numpy reference of the duplex host frontend: Kaldi fbank, the
learned (GRU) and energy VADs with their IPU lifecycle, the gating chunker
with its onset replay, and the timestamp serializer's one-feature-per-
identity tick rule. It follows the published Freeze-Omni duplex semantics
(dialog_state_pred.py, AudioFeatureGating.py, ContextSerializer.py) as the
port documents them, and imports nothing of the port.

`replay_call` re-derives, for one call, everything the service's frontend
decides from the call's audio and the schedule on which the service took
it in (how many 224 ms windows of each channel it read in each step).
"""

from __future__ import annotations

import heapq
import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

_EPS = float(np.finfo(np.float32).eps)
IDENTITIES = ("user", "system")


@dataclass(frozen=True)
class Fbank:
    frame_ms: float
    shift_ms: float
    bins: int
    sample_rate: int = 16000

    @property
    def frame_length(self) -> int:
        return int(self.sample_rate * self.frame_ms / 1000.0)

    @property
    def frame_shift(self) -> int:
        return int(self.sample_rate * self.shift_ms / 1000.0)

    @property
    def n_fft(self) -> int:
        p = 1
        while p < self.frame_length:
            p *= 2
        return p


def _mel(f):
    return 1127.0 * np.log(1.0 + f / 700.0)


def mel_banks(fb: Fbank) -> np.ndarray:
    n_fft = fb.n_fft
    half = n_fft // 2
    width = fb.sample_rate / n_fft
    lo, hi = _mel(20.0), _mel(fb.sample_rate / 2)
    delta = (hi - lo) / (fb.bins + 1)
    b = np.arange(fb.bins)[:, None]
    left = lo + b * delta
    center, right = left + delta, left + 2 * delta
    mels = _mel(width * np.arange(half)[None, :])
    banks = np.maximum(0.0, np.minimum((mels - left) / (center - left),
                                       (right - mels) / (right - center)))
    out = np.zeros((fb.bins, half + 1))
    out[:, :half] = banks
    return out


def bf16(x: np.ndarray) -> np.ndarray:
    """x rounded to bfloat16 (to nearest even), held in float64."""
    u = np.ascontiguousarray(x, np.float32).view(np.uint32)
    u = (u + np.uint32(0x7FFF) + ((u >> np.uint32(16)) & np.uint32(1))) \
        & np.uint32(0xFFFF0000)
    return u.view(np.float32).astype(np.float64)


def _keep(x):
    return x


def fbank(wave: np.ndarray, fb: Fbank, low: bool = False) -> np.ndarray:
    """Kaldi log-mel (dither 0, DC removal, pre-emphasis 0.97, Povey window,
    power spectrum, snip edges) in float64; `low` rounds every stage to
    bfloat16 (the control). wave: already scaled to the int16 range.
    Returns [frames, bins]."""
    r = bf16 if low else _keep
    fl, fs = fb.frame_length, fb.frame_shift
    m = 1 + (wave.shape[0] - fl) // fs if wave.shape[0] >= fl else 0
    idx = np.arange(m)[:, None] * fs + np.arange(fl)[None, :]
    fr = r(wave.astype(np.float64)[idx])
    fr = r(fr - fr.mean(axis=1, keepdims=True))
    fr = r(fr - 0.97 * np.concatenate([fr[:, :1], fr[:, :-1]], axis=1))
    t = np.arange(fl)
    fr = r(fr * r((0.5 - 0.5 * np.cos(2 * math.pi * t / (fl - 1))) ** 0.85))
    spec = r(np.abs(np.fft.rfft(fr, n=fb.n_fft, axis=1)) ** 2)
    return r(np.log(np.maximum(r(spec @ r(mel_banks(fb).T)), _EPS)))


GATING_FBANK = Fbank(16.0, 8.0, 80)
VAD_FBANK = Fbank(16.0, 8.0, 40)


# --------------------------------------------------------------------------
# VADs and the IPU lifecycle
# --------------------------------------------------------------------------

class VAD:
    """The IPU state machine over per-window speech probabilities: onset
    after `min_speech` windows above the threshold, end after
    `min_silence` windows below it (hangover), onset replay from a history
    ring. `prob` is the learned GRU or the adaptive energy detector."""

    def __init__(self, kind: str, cfg: dict, vad_weights: Optional[dict],
                 low: bool = False):
        self.kind = kind
        self.low = low
        self.thr = cfg["threshold"]
        chunk, sr = cfg["chunk"], cfg["sample_rate"]
        per_s = sr / chunk
        self.min_silence = max(1, int(cfg["min_silence_s"] * sr / chunk))
        self.min_speech = max(1, round(cfg["min_speech_s"] * sr / chunk))
        self.freeze = max(1, round(10.0 * per_s))
        self.rms_len = max(4, round(5.6 * per_s))
        pad = max(1, round(cfg["speech_pad_s"] * per_s))
        self.history_chunks = max(cfg["history_cache_chunks"],
                                  self.min_speech - 1 + pad)
        self.w = vad_weights
        self.in_speech = False
        self.silence_run = self.speech_run = self.pending_run = 0
        self.floor = 1e-4
        self.rms_window: List[float] = []
        self.history: List[np.ndarray] = []
        if kind == "learned":
            self.h = np.zeros(vad_weights["wz"].shape[1])
            self.carry = np.zeros(0)

    def _energy(self, audio: np.ndarray) -> float:
        rms = float(np.sqrt(np.mean(np.square(audio)) + 1e-12))
        if rms > 3e-5 and (not self.in_speech or self.speech_run > self.freeze):
            self.rms_window.append(rms)
            if len(self.rms_window) > self.rms_len:
                self.rms_window.pop(0)
        if self.rms_window:
            self.floor = float(np.clip(min(self.rms_window), 1e-5, 0.01))
        snr = rms / (self.floor + 1e-8)
        return float(1.0 / (1.0 + np.exp(-(snr - 4.0))))

    def _gru(self, audio: np.ndarray) -> float:
        p = self.w
        wav = np.concatenate([self.carry, audio.astype(np.float64)])
        fl, fs = VAD_FBANK.frame_length, VAD_FBANK.frame_shift
        if wav.shape[0] < fl:
            self.carry = wav
            return 0.0
        m = 1 + (wav.shape[0] - fl) // fs
        self.carry = wav[m * fs:]
        q = bf16 if self.low else _keep
        x = q((fbank(wav * 32768.0, VAD_FBANK, self.low) - p["mean"]) * p["scale"])
        if self.low:
            p = {k: bf16(v) for k, v in p.items()}
        sig = lambda v: 1.0 / (1.0 + np.exp(-v))  # noqa: E731
        h = self.h
        probs = np.empty(m)
        for i in range(m):
            xh = np.concatenate([x[i], h])
            z = q(sig(q(xh @ p["wz"] + p["bz"])))
            r = q(sig(q(xh @ p["wr"] + p["br"])))
            hh = q(np.tanh(q(np.concatenate([x[i], r * h]) @ p["wh"] + p["bh"])))
            h = q((1 - z) * h + z * hh)
            probs[i] = sig(q(h @ p["wo"] + p["bo"]))[0]
        self.h = h
        return float(probs.mean())

    def step(self, audio: np.ndarray, tie: Optional[float], tol: float):
        """One window -> (prob, status, ambiguous). Where this prob lies
        within `tol` of the threshold, the speech decision is taken from
        `tie` (the served probability), since the two agree to `tol`."""
        prob = self._gru(audio) if self.kind == "learned" else self._energy(audio)
        ambiguous = abs(prob - self.thr) <= tol
        is_speech = (tie if ambiguous and tie is not None else prob) > self.thr
        status = None
        if not self.in_speech:
            if is_speech:
                self.pending_run += 1
                if self.pending_run >= self.min_speech:
                    self.in_speech = True
                    self.silence_run = 0
                    self.speech_run = self.pending_run
                    self.pending_run = 0
                    status = "ipu_sl"
                else:
                    self._remember(audio)
            else:
                self.pending_run = 0
                self._remember(audio)
        else:
            self.speech_run += 1
            if is_speech:
                self.silence_run = 0
                status = "ipu_cl"
            else:
                self.silence_run += 1
                if self.silence_run >= self.min_silence:
                    self.in_speech = False
                    self.silence_run = self.speech_run = 0
                    self.history = []
                    status = "ipu_el"
                else:
                    status = "ipu_cl"
        return prob, status, ambiguous

    def _remember(self, audio):
        self.history.append(audio)
        if len(self.history) > self.history_chunks:
            self.history.pop(0)


class Gating:
    """The streaming 32-frame fbank window (28 new frames + 4 context) and
    the history ring whose last `onset` windows replay at an IPU start."""

    def __init__(self, cfg: dict, low: bool = False):
        self.low = low
        self.steps, self.ctx = cfg["steps_per_chunk"], cfg["context_steps"]
        self.onset = cfg["onset_cache_size"]
        fl, fs = GATING_FBANK.frame_length, GATING_FBANK.frame_shift
        self.overlap = fl - fs
        n = cfg["chunk"]
        self.samples = np.zeros(n + self.overlap)
        self.window = np.zeros((self.steps + self.ctx, GATING_FBANK.bins))
        self.history = np.zeros((cfg["history_size"], self.steps + self.ctx,
                                 GATING_FBANK.bins))

    def step(self, audio: np.ndarray, status):
        self.samples[:self.overlap] = self.samples[-self.overlap:]
        self.samples[self.overlap:] = audio.astype(np.float64) * 32767.0
        xs = fbank(self.samples, GATING_FBANK, self.low)
        self.window[:self.ctx] = self.window[-self.ctx:]
        self.window[self.ctx:] = xs
        feat = self.window.copy()
        if status is None:
            self.history[:-1] = self.history[1:]
            self.history[-1] = feat
            return []
        if status == "ipu_sl" and self.onset > 0:
            replay = [self.history[i].copy() for i in range(-self.onset, 0)]
            return ([(replay[0], "ipu_sl")] + [(f, "ipu_cl") for f in replay[1:]]
                    + [(feat, "ipu_cl")])
        return [(feat, status)]


# --------------------------------------------------------------------------
# one call, replayed on the service's schedule
# --------------------------------------------------------------------------

@dataclass
class CallReplay:
    probs: Dict[str, List[float]] = field(default_factory=dict)
    statuses: Dict[str, list] = field(default_factory=dict)
    ambiguous: Dict[str, List[bool]] = field(default_factory=dict)
    # one entry per submitted feature, in tick order:
    # (step, identity, is_sl, feature [32, 80], window index it came from)
    submits: list = field(default_factory=list)


def replay_call(audio: Dict[str, List[np.ndarray]], schedule: List[tuple],
                frontend_cfg: dict, vad_weights: dict,
                tie_probs: Dict[str, List[float]], tol: float,
                low: bool = False) -> CallReplay:
    """audio: per identity, the call's windows (float32 [chunk], as the
    service reads them). schedule: [(step, user windows read, system
    windows read)] for every step from the call's open to its close.
    tie_probs: the served per-window probabilities (used only within
    `tol` of the threshold). low: fbank and GRU in bfloat16 (the
    control)."""
    vads = {i: VAD(frontend_cfg[f"{i}_vad"], frontend_cfg, vad_weights, low)
            for i in IDENTITIES}
    gates = {i: Gating(frontend_cfg, low) for i in IDENTITIES}
    out = CallReplay(probs={i: [] for i in IDENTITIES},
                     statuses={i: [] for i in IDENTITIES},
                     ambiguous={i: [] for i in IDENTITIES})
    heap: list = []
    seq = 0
    user_in_ipu = False
    system_pseudo = False
    read = {i: 0 for i in IDENTITIES}
    for step, n_user, n_system in schedule:
        for ident, n in (("user", n_user), ("system", n_system)):
            for _ in range(n):
                j = read[ident]
                read[ident] += 1
                tie = tie_probs[ident][j] if j < len(tie_probs[ident]) else None
                p, st, amb = vads[ident].step(audio[ident][j], tie, tol)
                out.probs[ident].append(p)
                out.statuses[ident].append(st)
                out.ambiguous[ident].append(amb)
                for k, (feat, fst) in enumerate(gates[ident].step(audio[ident][j], st)):
                    key = (step, 0 if ident == "user" else 1, j, k)
                    heapq.heappush(heap, (key, seq, (ident, fst, feat, j)))
                    seq += 1
        taken = set()
        while len(taken) < 2 and heap:
            key, _, item = heapq.heappop(heap)
            ident, st, feat, j = item
            # the serializer's gate: user features always pass; system
            # features only outside the user's IPU, the first of a system
            # stretch forced to start one
            send, force_sl = False, False
            if ident == "user":
                send = True
                if st in ("ipu_sl", "ipu_cl"):
                    user_in_ipu = True
                elif st == "ipu_el":
                    user_in_ipu = False
                system_pseudo = False
            elif not user_in_ipu:
                send = True
                if not system_pseudo:
                    system_pseudo, force_sl = True, True
            if not send:
                continue
            if force_sl:
                st = "ipu_sl"
            if ident in taken:
                # back in the heap with its key, and with the status the
                # gate gave it
                heapq.heappush(heap, (key, seq, (ident, st, feat, j)))
                seq += 1
                break
            taken.add(ident)
            out.submits.append((step, ident, st == "ipu_sl", feat, j))
    return out
