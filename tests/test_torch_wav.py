"""The port's WAV writer and resamplers against the JAX package's numpy path.

The JAX module dispatches to a native C++ resampler when one is built; the
port has only the numpy path, so the JAX side runs with the native library
reported unavailable. Tolerance 1e-6: the same float64 arithmetic, cast to
float32 once.
"""

import numpy as np
import pytest

from freeze_omni_tpu.frontend import native as jax_native
from freeze_omni_tpu.frontend import wav as jwav
from freeze_omni_tpu_torch.frontend import wav as twav

TOL = 1e-6


@pytest.fixture
def jax_numpy_path(monkeypatch):
    monkeypatch.setattr(jax_native, "available", lambda: False)


def _signal(n, sr, seed=0):
    t = np.arange(n) / sr
    rng = np.random.RandomState(seed)
    return (0.4 * np.sin(2 * np.pi * 440 * t) + 0.1 * rng.randn(n)).astype(np.float32)


@pytest.mark.parametrize("orig_sr,new_sr,n", [(48000, 16000, 9601),
                                              (24000, 16000, 7203),
                                              (16000, 24000, 3001),
                                              (16000, 16000, 100)])
def test_resample_matches_jax(jax_numpy_path, orig_sr, new_sr, n):
    x = _signal(n, orig_sr)
    ours, ref = twav.resample(x, orig_sr, new_sr), jwav.resample(x, orig_sr, new_sr)
    assert ours.shape == ref.shape == (int(np.ceil(n * new_sr / orig_sr)),)
    np.testing.assert_allclose(ours, ref, rtol=0, atol=TOL)


@pytest.mark.parametrize("orig_sr,new_sr", [(48000, 16000), (24000, 16000)])
def test_streaming_resampler_matches_jax_and_the_one_shot_path(jax_numpy_path,
                                                               orig_sr, new_sr):
    x = _signal(12345, orig_sr, seed=1)
    cuts = [0, 1, 7, 480, 481, 3000, 7777, 12345]   # ragged chunked pushes
    ours, ref = twav.StreamingResampler(orig_sr, new_sr), \
        jwav.StreamingResampler(orig_sr, new_sr)
    assert ref._native is None
    out_t, out_j = [], []
    for a, b in zip(cuts[:-1], cuts[1:]):
        out_t.append(ours.push(x[a:b]))
        out_j.append(ref.push(x[a:b]))
        assert out_t[-1].shape == out_j[-1].shape
    out_t.append(ours.flush())
    out_j.append(ref.flush())
    t, j = np.concatenate(out_t), np.concatenate(out_j)
    np.testing.assert_allclose(t, j, rtol=0, atol=TOL)
    np.testing.assert_allclose(t, twav.resample(x, orig_sr, new_sr), rtol=0, atol=TOL)


def test_streaming_resampler_passthrough():
    rs = twav.StreamingResampler(16000, 16000)
    x = _signal(100, 16000)
    np.testing.assert_array_equal(rs.push(x), x)
    assert rs.flush().size == 0


@pytest.mark.parametrize("channels", [1, 2])
def test_write_wav_roundtrips_through_read_wav(tmp_path, channels):
    x = _signal(800, 16000)
    x[3] = np.nan    # written as 0
    x[4] = 5.0       # clipped to 1
    data = x if channels == 1 else np.stack([x, -x], axis=1)
    path = str(tmp_path / "a.wav")
    twav.write_wav(path, data, 16000)
    back, sr = twav.read_wav(path)
    jback, jsr = jwav.read_wav(path)
    assert sr == jsr == 16000 and back.shape == data.shape
    np.testing.assert_array_equal(back, jback)
    want = np.clip(np.nan_to_num(data), -1, 1)
    # s16 truncation on write, / 32768 on read
    np.testing.assert_allclose(back, want, atol=2.0 / 32767)
    jpath = str(tmp_path / "b.wav")
    jwav.write_wav(jpath, data, 16000)
    assert open(path, "rb").read() == open(jpath, "rb").read()
