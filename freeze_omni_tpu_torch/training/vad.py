"""Learned streaming VAD: training on synthetic speech/noise mixtures
(counterpart of freeze_omni_tpu/training/vad.py).

A small frame-level GRU trained on synthetic mixtures: harmonic voiced
speech with formants and syllabic modulation against stationary and
nonstationary noise (white/pink, tonal chords, bursts, hum, multi-talker
babble), with loud non-speech foreground segments so that the model learns
voicing, not level. The mixtures are numpy, copied from the JAX module, so
a seed gives the same audio, labels and weights in both packages.

Model (the math of duplex/vad.LearnedVAD and native/frontend/vad.cc):
  log-mel frames (16 ms / 8 ms Kaldi fbank, 40 bins) -> affine norm ->
  GRU(40 -> 64) with the gate equations of `gru_scan` -> sigmoid head ->
  per-frame speech probability.

Run:  python -m freeze_omni_tpu_torch.training.vad --out vad.npz [--device cpu]
(`--out` is required and may not name the JAX package's committed
freeze_omni_tpu/assets/vad.npz.)
"""

from __future__ import annotations

import argparse
import math
import os
from pathlib import Path

import numpy as np
import torch

from ..frontend.fbank import VAD_FBANK, fbank_ref
from ..utils.device import resolve_device
from ..models.layers import _uniform

SR = 16000
HIDDEN = 64
N_MEL = 40
# the JAX package's committed weights, which this trainer never overwrites
COMMITTED_WEIGHTS = (Path(__file__).resolve().parents[2] / "freeze_omni_tpu"
                     / "assets" / "vad.npz")


# ---------------------------------------------------------------------------
# synthetic data
# ---------------------------------------------------------------------------


def synth_speech(rng: np.random.RandomState, n: int) -> np.ndarray:
    """Voiced-speech surrogate: harmonic stack with a pitch contour, 1-2
    formant resonances, and 3-7 Hz syllabic amplitude modulation."""
    t = np.arange(n) / SR
    f0 = rng.uniform(80, 260)
    vibrato = f0 * 0.03 * np.sin(2 * np.pi * rng.uniform(4, 7) * t)
    drift = f0 * 0.15 * np.sin(2 * np.pi * rng.uniform(0.3, 1.2) * t)
    phase = 2 * np.pi * np.cumsum(f0 + vibrato + drift) / SR
    formants = rng.uniform(300, 3000, size=rng.randint(1, 3))
    bw = rng.uniform(80, 300, size=formants.shape)
    sig = np.zeros(n)
    for k in range(1, 13):
        fk = k * f0
        amp = sum(np.exp(-((fk - fc) ** 2) / (2 * b**2))
                  for fc, b in zip(formants, bw)) + 0.05 / k
        sig += amp * np.sin(k * phase + rng.uniform(0, 2 * np.pi))
    syllable = 0.55 + 0.45 * np.sin(
        2 * np.pi * rng.uniform(3, 7) * t + rng.uniform(0, 2 * np.pi))
    sig = sig * syllable
    return (sig / (np.abs(sig).max() + 1e-8)).astype(np.float32)


def synth_babble(rng: np.random.RandomState, n: int) -> np.ndarray:
    """Background babble: several overlapping speech streams at staggered
    onsets. Individually each stream has speech acoustics; summed, the pitch
    tracks and syllabic modulations decorrelate — the cue separating crowd
    chatter (must NOT open an IPU) from one foreground talker (must)."""
    x = np.zeros(n, np.float32)
    for _ in range(rng.randint(5, 10)):
        seg = rng.randint(3 * n // 4, n)  # dense: >=2 voices ~everywhere
        start = rng.randint(0, n - seg + 1)
        x[start : start + seg] += (synth_speech(rng, seg)
                                   * rng.uniform(0.2, 0.6))
    return (x / (np.abs(x).max() + 1e-8)).astype(np.float32)


def synth_noise(rng: np.random.RandomState, n: int) -> np.ndarray:
    """Nonspeech: white/pink noise, tonal chords (music-like), noise bursts
    (door slams / clicks), low-frequency hum, and multi-talker babble."""
    kind = rng.randint(5)
    t = np.arange(n) / SR
    if kind == 0:  # white / pink
        x = rng.randn(n)
        if rng.rand() < 0.5:
            # one-pole lowpass ~ pink-ish
            a = rng.uniform(0.9, 0.99)
            y = np.empty(n)
            acc = 0.0
            for i in range(n):  # small n; host-side data gen
                acc = a * acc + (1 - a) * x[i]
                y[i] = acc
            x = y
    elif kind == 1:  # chord: stable tones (no syllabic AM, no harmonic stack)
        freqs = rng.uniform(100, 2000, size=rng.randint(2, 5))
        x = sum(np.sin(2 * np.pi * f * t + rng.uniform(0, 2 * np.pi))
                for f in freqs)
        swell = 0.6 + 0.4 * np.sin(2 * np.pi * rng.uniform(0.1, 0.6) * t)
        x = x * swell
    elif kind == 2:  # bursts
        x = np.zeros(n)
        for _ in range(rng.randint(1, 4)):
            s = rng.randint(0, max(n - 400, 1))
            ln = rng.randint(100, 400)
            x[s : s + ln] += rng.randn(ln) * np.hanning(ln)
        x += 0.05 * rng.randn(n)
    elif kind == 3:  # hum + harmonics
        f = rng.uniform(50, 120)
        x = sum((1.0 / k) * np.sin(2 * np.pi * k * f * t) for k in range(1, 4))
    else:  # multi-talker babble
        return synth_babble(rng, n)
    return (x / (np.abs(x).max() + 1e-8)).astype(np.float32)


def make_mixture(rng: np.random.RandomState, seconds: float = 2.0):
    """-> (waveform [-1,1], per-frame labels, per-frame loss weights).
    Speech segments at random SNR over a noise bed; labels follow the speech
    gate at frame resolution.

    Segments alternate speech (labeled 1) with occasional LOUD negatives
    (babble/music/bursts at foreground amplitude, labeled 0): without them
    the only loud events in training are speech and the model learns
    level, not voicing — measured babble FPR 0.80 before, speech-level
    discrimination requires speech-level counterexamples. Hard-negative
    frames (loud non-speech foreground) carry 3x loss weight, and ~1 clip
    in 5 is WHOLE-CLIP foreground babble — the deployment false-trigger
    case (a crowd, no target talker) the segment mixer alone under-covers
    (measured: babble FPR 0.40 without these, VERDICT r3 #5)."""
    n = int(seconds * SR)
    noise = synth_noise(rng, n) * rng.uniform(0.01, 0.3)
    wav = noise.copy()
    gate = np.zeros(n, bool)
    hard = np.zeros(n, bool)
    if rng.rand() < 0.2:
        # pure-negative clip: sustained foreground babble (or, rarely,
        # another loud noise family), zero speech labels throughout
        neg = (synth_babble(rng, n) if rng.rand() < 0.75
               else synth_noise(rng, n))
        wav += neg * rng.uniform(0.2, 0.9)
        hard[:] = True
    else:
        pos = rng.randint(0, n // 4)
        while pos < n - SR // 4:
            seg = rng.randint(SR // 4, SR)
            draw = rng.rand()
            if draw < 0.6:
                seg = min(seg, n - pos)
                amp = rng.uniform(0.05, 0.8)
                wav[pos : pos + seg] += synth_speech(rng, seg) * amp
                gate[pos : pos + seg] = True
            elif draw < 0.8:  # loud non-speech foreground, labeled 0 —
                # half of them babble, the one negative that shares speech
                # acoustics and so needs the most counterexamples
                seg = min(seg, n - pos)
                neg = (synth_babble(rng, seg) if rng.rand() < 0.5
                       else synth_noise(rng, seg))
                wav[pos : pos + seg] += neg * rng.uniform(0.2, 0.8)
                hard[pos : pos + seg] = True
            pos += seg + rng.randint(SR // 8, SR // 2)
    peak = np.abs(wav).max() + 1e-8
    if peak > 1.0:
        wav = wav / peak
    if rng.rand() < 0.8:
        # int16 quantization: deployed audio ALWAYS arrives s16le (websocket
        # pcm_b64, wav files), and the quantization noise floor is broadband
        # — spectrally it resembles the babble/noise negatives, so a model
        # trained only on ideal float synthesis collapses on real client
        # audio (measured: speech prob 0.88 float -> 0.10 after one int16
        # round trip). Train mostly on the quantized grid, keeping a float
        # minority so both presentations stay in-distribution.
        wav = np.round(np.clip(wav, -1, 1) * 32767.0) / 32768.0
    fl, fs = VAD_FBANK.frame_length, VAD_FBANK.frame_shift
    m = 1 + (n - fl) // fs
    labels = np.array([gate[i * fs : i * fs + fl].mean() > 0.5
                       for i in range(m)], np.float32)
    hard_f = np.array([hard[i * fs : i * fs + fl].mean() > 0.5
                       for i in range(m)], bool)
    weights = np.where(hard_f & (labels < 0.5), 3.0, 1.0).astype(np.float32)
    return wav.astype(np.float32), labels, weights


def features(wav: np.ndarray) -> np.ndarray:
    """Kaldi log-mel frames on the host (duplex/vad.py's features)."""
    return fbank_ref(wav * 32768.0, VAD_FBANK)


# ---------------------------------------------------------------------------
# model
# ---------------------------------------------------------------------------


def init_vad_params(gen: torch.Generator, device=None) -> dict:
    device = resolve_device(device)
    s = 1.0 / math.sqrt(N_MEL + HIDDEN)
    f32 = torch.float32
    w = lambda shape: _uniform(gen, shape, s, f32, device)  # noqa: E731
    z = lambda n: torch.zeros(n, dtype=f32, device=device)  # noqa: E731
    return {"mean": z(N_MEL), "scale": torch.ones(N_MEL, dtype=f32, device=device),
            "wz": w((N_MEL + HIDDEN, HIDDEN)), "wr": w((N_MEL + HIDDEN, HIDDEN)),
            "wh": w((N_MEL + HIDDEN, HIDDEN)),
            "bz": z(HIDDEN), "br": z(HIDDEN), "bh": z(HIDDEN),
            "wo": w((HIDDEN, 1)), "bo": z(1)}


def gru_scan(params, feats: torch.Tensor, h0: torch.Tensor):
    """feats [..., T, N_MEL] normalized, h0 [..., HIDDEN] -> (probs [..., T],
    hT). The gate equations of the JAX scan (and of LearnedVAD):
    z = sig([x, h] Wz + bz), r = sig([x, h] Wr + br),
    hh = tanh([x, r h] Wh + bh), h = (1 - z) h + z hh, p = sig(h wo + bo).
    (torch.nn.GRU applies its reset gate after the hidden projection, a
    different cell.)"""
    h = h0
    logits = []
    for t in range(feats.shape[-2]):
        x = feats[..., t, :]
        xh = torch.cat([x, h], dim=-1)
        z = torch.sigmoid(xh @ params["wz"] + params["bz"])
        r = torch.sigmoid(xh @ params["wr"] + params["br"])
        hh = torch.tanh(torch.cat([x, r * h], dim=-1) @ params["wh"] + params["bh"])
        h = (1 - z) * h + z * hh
        logits.append((h @ params["wo"] + params["bo"])[..., 0])
    return torch.sigmoid(torch.stack(logits, dim=-1)), h


def forward(params, feats: torch.Tensor) -> torch.Tensor:
    """feats [..., T, N_MEL] raw log-mel -> per-frame probabilities."""
    x = (feats - params["mean"]) * params["scale"]
    h0 = torch.zeros(x.shape[:-2] + (HIDDEN,), dtype=x.dtype, device=x.device)
    return gru_scan(params, x, h0)[0]


def bce_loss(trainable, params, feats, labels, weights) -> torch.Tensor:
    """Weighted per-frame binary cross-entropy (eps 1e-6), as in JAX."""
    p = dict(trainable, mean=params["mean"], scale=params["scale"])
    probs = forward(p, feats)
    eps = 1e-6
    bce = -(labels * torch.log(probs + eps) + (1 - labels) * torch.log(1 - probs + eps))
    return (bce * weights).sum() / weights.sum()


def train(steps: int = 900, batch: int = 8, seed: int = 0, lr: float = 3e-3,
          device=None) -> dict:
    """Adam (optax.adam's defaults) on batches of fresh mixtures drawn from
    np.random.RandomState(seed); the normalization comes from 8 mixtures
    drawn first. Returns numpy weights in the vad.npz layout, with
    "losses": the loss of every step."""
    from . import optim

    device = resolve_device(device)
    rng = np.random.RandomState(seed)
    sample = np.concatenate([features(make_mixture(rng)[0]) for _ in range(8)],
                            axis=0)
    mean = sample.mean(0)
    scale = 1.0 / (sample.std(0) + 1e-3)

    params = init_vad_params(torch.Generator(device=device).manual_seed(seed),
                             device)
    params["mean"] = torch.as_tensor(mean, dtype=torch.float32, device=device)
    params["scale"] = torch.as_tensor(scale, dtype=torch.float32, device=device)
    trainable = optim.trainable({k: v for k, v in params.items()
                                 if k not in ("mean", "scale")})
    opt = optim.adam(trainable, lr, 0.9, 0.999)
    losses = []
    for it in range(steps):
        fb, lb, wb = [], [], []
        for _ in range(batch):
            wav, labels, weights = make_mixture(rng)
            fb.append(features(wav))
            lb.append(labels)
            wb.append(weights)
        as_t = lambda a: torch.as_tensor(np.stack(a), device=device)  # noqa: E731
        loss = bce_loss(trainable, params, as_t(fb), as_t(lb), as_t(wb))
        opt.zero_grad()
        loss.backward()
        opt.step()
        losses.append(float(loss.detach()))
        if it % 50 == 0 or it == steps - 1:
            print(f"step {it}: bce {losses[-1]:.4f}", flush=True)
    out = {k: v.detach().cpu().numpy() for k, v in trainable.items()}
    out.update(mean=mean.astype(np.float32), scale=scale.astype(np.float32))
    out["losses"] = np.asarray(losses, np.float32)
    return out


def _refuse_committed(path: str) -> None:
    if os.path.realpath(path) == os.path.realpath(COMMITTED_WEIGHTS):
        raise SystemExit(f"refusing to overwrite the committed weights "
                         f"{COMMITTED_WEIGHTS}; pass another --out")


def main(argv=None):
    p = argparse.ArgumentParser(description="train the learned VAD")
    p.add_argument("--out", required=True, help="weights .npz to write")
    p.add_argument("--steps", type=int, default=900)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card)")
    args = p.parse_args(argv)
    _refuse_committed(args.out)
    params = train(steps=args.steps, batch=args.batch, seed=args.seed,
                   device=args.device)
    params.pop("losses")
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    np.savez(args.out, **params)
    print(f"saved {args.out}")


if __name__ == "__main__":
    main()
