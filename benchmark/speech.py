"""Seeded audio for the traffic mixes: a voiced-speech surrogate and the
clip bank that calls are cut from.

`speech_surrogate` copies chip_smoke.py's surrogate (itself a copy of the
speech synthesiser the learned VAD's weights were trained on), on numpy's
`Generator` API: a harmonic stack with a pitch contour, one or two formant
resonances and 3-7 Hz syllabic amplitude modulation, peak-normalised.
"""

from __future__ import annotations

import numpy as np

SAMPLE_RATE = 16000


def speech_surrogate(rng: np.random.Generator, n: int,
                     sr: int = SAMPLE_RATE) -> np.ndarray:
    t = np.arange(n) / sr
    f0 = rng.uniform(80, 260)
    vibrato = f0 * 0.03 * np.sin(2 * np.pi * rng.uniform(4, 7) * t)
    drift = f0 * 0.15 * np.sin(2 * np.pi * rng.uniform(0.3, 1.2) * t)
    phase = 2 * np.pi * np.cumsum(f0 + vibrato + drift) / sr
    formants = rng.uniform(300, 3000, size=int(rng.integers(1, 3)))
    bw = rng.uniform(80, 300, size=formants.shape)
    sig = np.zeros(n)
    for k in range(1, 13):
        fk = k * f0
        amp = sum(np.exp(-((fk - fc) ** 2) / (2 * b ** 2))
                  for fc, b in zip(formants, bw)) + 0.05 / k
        sig += amp * np.sin(k * phase + rng.uniform(0, 2 * np.pi))
    sig = sig * (0.55 + 0.45 * np.sin(2 * np.pi * rng.uniform(3, 7) * t
                                      + rng.uniform(0, 2 * np.pi)))
    return (sig / (np.abs(sig).max() + 1e-8)).astype(np.float32)


def clip_bank(seed_words, count: int, seconds: float) -> np.ndarray:
    """`count` surrogate clips of `seconds` each, [count, n] float32."""
    n = int(round(seconds * SAMPLE_RATE))
    return np.stack([speech_surrogate(np.random.default_rng([*seed_words, i]), n)
                     for i in range(count)])
