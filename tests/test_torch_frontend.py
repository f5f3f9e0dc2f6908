"""Frontend of the PyTorch port (Kaldi fbank, GatingChunker, CMVN, WAV) against
the JAX package.

Tolerances. The port's own GatingChunker stream against its fbank on the whole
waveform: 1e-4 on every bin (the streamed frames are the same arithmetic).
Across packages the two float32 FFTs (XLA's and pocketfft) round differently
and the error is absolute, set by the frame's energy: log-mel bins within
40 dB of the frame's loudest bin agree to 1e-4, energies to 1e-5 of the
frame's peak; bins far below the peak carry only rounding noise in both (JAX
against its own numpy golden differs there by 1e-2).
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from freeze_omni_tpu.config import FbankConfig as JFbank
from freeze_omni_tpu.config import GatingConfig as JGating
from freeze_omni_tpu.frontend import cmvn as jcmvn
from freeze_omni_tpu.frontend import fbank as jfbank
from freeze_omni_tpu.frontend import wav as jwav
from freeze_omni_tpu.frontend.chunker import GatingChunker as JChunker
from freeze_omni_tpu_torch.config import FbankConfig, GatingConfig
from freeze_omni_tpu_torch.frontend import cmvn as tcmvn
from freeze_omni_tpu_torch.frontend import fbank as tfbank
from freeze_omni_tpu_torch.frontend import wav as twav
from freeze_omni_tpu_torch.frontend.chunker import GatingChunker

WAV = os.path.join(os.path.dirname(__file__), "..", "freeze_omni_tpu", "assets",
                   "tiny_s2s", "dev_wavs", "asr_000.wav")


def assert_fbank_close(t, j):
    t = np.asarray(t, np.float64)
    j = np.asarray(j, np.float64)
    loud = j > j.max(axis=-1, keepdims=True) - np.log(1e4)
    assert np.abs(t - j)[loud].max() <= 1e-4
    et, ej = np.exp(t), np.exp(j)
    assert (np.abs(et - ej).max(axis=-1) / ej.max(axis=-1)).max() <= 1e-5


@pytest.mark.parametrize("which", ["offline", "duplex"])
@pytest.mark.parametrize("signal", ["speech", "noise"])
def test_fbank_matches_jax(which, signal):
    if signal == "speech":
        x = twav.read_wav(WAV)[0] * 32767.0
    else:
        x = np.random.RandomState(0).randn(16000) * 3000.0
    x = x.astype(np.float32)
    tcfg = FbankConfig() if which == "offline" else GatingConfig().fbank()
    jcfg = JFbank() if which == "offline" else JGating().fbank()
    t = tfbank.fbank(torch.from_numpy(x), tcfg).numpy()
    assert t.shape == (tfbank.num_frames(tcfg, len(x)), 80)
    assert_fbank_close(t, jfbank.fbank(jnp.asarray(x), jcfg))
    assert_fbank_close(t, jfbank.fbank_ref(x, jcfg))


def test_mel_banks_and_window_identical():
    np.testing.assert_array_equal(tfbank.mel_banks(GatingConfig().fbank()),
                                  jfbank.mel_banks(JGating().fbank()))
    np.testing.assert_array_equal(tfbank._window(FbankConfig()),
                                  jfbank._window(JFbank()))


def _chunks(audio, n, count):
    out = []
    for i in range(count):
        c = np.zeros(n, np.float32)
        seg = audio[i * n:(i + 1) * n]
        c[:len(seg)] = seg
        out.append(c)
    return out


def test_gating_chunker_stream_matches_full_fbank_and_jax():
    audio, _ = twav.read_wav(WAV)
    cfg = GatingConfig()
    n = cfg.samples_per_chunk
    chunks = _chunks(audio, n, 6)
    tc = GatingChunker(cfg)
    tc._native = None   # the port's torch fbank (the native core: test_torch_native.py)
    jc = JChunker(JGating())
    jc._native = None   # the JAX fbank path, not the optional native C++ one
    jc.reset()
    streamed = []
    for c in chunks:
        ft, fj = tc.extract(c), jc.extract(c)
        assert ft.shape == (1, cfg.frames_per_step, 80)
        assert_fbank_close(ft[0], fj[0])
        streamed.append(ft[0, cfg.context_steps:])
    # the streamed frames equal the fbank of the whole (zero-led) waveform
    overlap = tc.frame_overlap
    full = np.concatenate([np.zeros(overlap, np.float32)] + chunks) * 32767.0
    ref = tfbank.fbank(torch.from_numpy(full), cfg.fbank()).numpy()
    np.testing.assert_allclose(np.concatenate(streamed), ref[:len(chunks) * 28],
                               rtol=0, atol=1e-4)


def test_gating_chunker_gates_and_replays_onset_history():
    audio, _ = twav.read_wav(WAV)
    cfg = GatingConfig()
    chunks = _chunks(audio, cfg.samples_per_chunk, 4)
    tc, jc = GatingChunker(cfg), JChunker(JGating())
    jc._native = None
    jc.reset()
    for status, c in zip([None, None, "ipu_sl", "ipu_cl"], chunks):
        gt = tc.process_and_gate({"audio": c, "status": status})
        gj = jc.process_and_gate({"audio": c, "status": status})
        if status is None:
            assert gt is None and gj is None
            continue
        assert gt["status"] == gj["status"]
        assert len(gt["feature_last_chunk"]) == len(gj["feature_last_chunk"]) \
            == (cfg.onset_cache_size if status == "ipu_sl" else 0)
        for a, b in zip(gt["feature_last_chunk"] + [gt["feature"]],
                        gj["feature_last_chunk"] + [gj["feature"]]):
            assert a.shape == b.shape
            assert_fbank_close(a[0], b[0])


def test_cmvn_loaders_and_apply(tmp_path):
    rng = np.random.RandomState(1)
    mean_stat = (rng.rand(80) * 100).tolist()
    var_stat = (rng.rand(80) * 1000 + 1000).tolist()
    js = tmp_path / "cmvn.json"
    js.write_text(json.dumps({"mean_stat": mean_stat, "var_stat": var_stat,
                              "frame_num": 100}))
    kal = tmp_path / "cmvn.ark"
    kal.write_text("[ " + " ".join(map(str, mean_stat + [100.0])) + "\n"
                   + " ".join(map(str, var_stat + [0])) + " ]\n")
    for path, is_json in ((js, True), (kal, False)):
        tm, ti = tcmvn.load_cmvn(str(path), is_json)
        jm, ji = jcmvn.load_cmvn(str(path), is_json)
        np.testing.assert_array_equal(tm, jm)
        np.testing.assert_array_equal(ti, ji)
    x = rng.randn(3, 80).astype(np.float32)
    np.testing.assert_allclose(
        tcmvn.apply_cmvn(torch.from_numpy(x), torch.from_numpy(tm),
                         torch.from_numpy(ti)).numpy(),
        np.asarray(jcmvn.apply_cmvn(jnp.asarray(x), jnp.asarray(jm),
                                    jnp.asarray(ji))), rtol=1e-6, atol=1e-6)


def test_read_wav_matches_jax(tmp_path):
    a_t, sr_t = twav.read_wav(WAV)
    a_j, sr_j = jwav.read_wav(WAV)
    assert sr_t == sr_j == 16000
    np.testing.assert_array_equal(a_t, a_j)
    stereo = tmp_path / "stereo.wav"
    jwav.write_wav(str(stereo), np.stack([a_j[:500], -a_j[:500]], 1), 8000)
    s_t, sr = twav.read_wav(str(stereo))
    assert sr == 8000 and s_t.shape == (500, 2)
    np.testing.assert_array_equal(s_t, jwav.read_wav(str(stereo))[0])
