"""The port's native host frontend (frontend/native.py over
native/frontend/{fbank,resample,vad}.cc) on the CPU.

Each native core is held to the JAX package's numpy oracles, never to the
JAX package's own library: the fbank to `fbank_ref` and the numpy chunkers
(rtol 1e-4, atol 1e-3, as tests/test_native.py), the resampler to the numpy
`wav.resample` (atol 1e-6), the learned VAD's probabilities to
`LearnedVAD._prob_py` (2e-3, the native fbank's log floor rounds slightly
differently) with identical IPU status sequences. The port's modules take
the native core by default. The build: six processes that build at once
into one clean directory each load a whole library; a failed g++ build
raises with g++'s output; without g++ the library is unavailable and the
modules take their numpy/torch paths.
"""

import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

import freeze_omni_tpu.frontend.native as jnative
from freeze_omni_tpu.config import FbankConfig as JFbank
from freeze_omni_tpu.config import GatingConfig as JGating
from freeze_omni_tpu.duplex.vad import LearnedVAD as JLearnedVAD
from freeze_omni_tpu.frontend import wav as jwav
from freeze_omni_tpu.frontend.chunker import GatingChunker as JGatingChunker
from freeze_omni_tpu.frontend.chunker import OfflineChunker as JOfflineChunker
from freeze_omni_tpu.frontend.fbank import fbank_ref as jfbank_ref
from freeze_omni_tpu.training.vad import synth_speech
from freeze_omni_tpu_torch.config import GatingConfig
from freeze_omni_tpu_torch.duplex.vad import LearnedVAD
from freeze_omni_tpu_torch.frontend import native, wav
from freeze_omni_tpu_torch.frontend.chunker import GatingChunker, OfflineChunker

REPO = Path(__file__).resolve().parents[1]
FBANK_TOL = dict(rtol=1e-4, atol=1e-3)
RESAMPLE_ATOL = 1e-6
VAD_TOL = 2e-3
RATES = [(48000, 16000), (44100, 16000), (22050, 16000), (8000, 16000),
         (16000, 24000), (24000, 16000)]


@pytest.fixture
def lib():
    """The port's native library, built here if needed (skips without g++)."""
    if native.build() is None:
        pytest.skip("no g++ on PATH: the native frontend cannot be built")
    assert native.available()


@pytest.fixture
def jax_numpy_resample(monkeypatch):
    """The JAX wav.resample's numpy path (its native dispatch off)."""
    monkeypatch.setattr(jnative, "available", lambda: False)


def test_fbank_matches_fbank_ref_25_10(lib):
    x = (np.random.RandomState(0).randn(4000) * 1500).astype(np.float32)
    out = native.NativeFbank()(x)
    ref = jfbank_ref(x, JFbank())
    assert out.shape == ref.shape == (23, 80)
    np.testing.assert_allclose(out, ref, **FBANK_TOL)
    assert native.NativeFbank()(np.zeros(100, np.float32)).shape == (0, 80)


def test_fbank_matches_fbank_ref_16_8(lib):
    x = (np.random.RandomState(1).randn(3712) * 900).astype(np.float32)
    out = native.NativeFbank(frame_ms=16, shift_ms=8)(x)
    ref = jfbank_ref(x, JGating().fbank())
    assert out.shape == (28, 80)
    np.testing.assert_allclose(out, ref, **FBANK_TOL)


@pytest.mark.parametrize("kind", ["offline", "gating"])
def test_chunkers_take_the_native_core_and_match_jax_numpy(lib, kind):
    rng = np.random.RandomState(2)
    if kind == "offline":
        ours, ref, n = OfflineChunker(), JOfflineChunker(), 2560
        step = lambda c, a: c.process(a)  # noqa: E731
    else:
        ours, ref, n = GatingChunker(), JGatingChunker(), 3584
        step = lambda c, a: c.extract(a)  # noqa: E731
    assert ours._native is not None
    ref._native = None   # the JAX numpy/jnp fbank, the oracle
    ref.reset()
    for _ in range(4):
        a = (rng.randn(n) * 0.05).astype(np.float32)
        got = step(ours, a)
        np.testing.assert_allclose(got, step(ref, a), **FBANK_TOL)
    ours.reset()     # back to a fresh ring, as the oracle's reset
    ref.reset()
    a = (rng.randn(n) * 0.05).astype(np.float32)
    np.testing.assert_allclose(step(ours, a), step(ref, a), **FBANK_TOL)


@pytest.mark.parametrize("rates", RATES, ids=[f"{a}-{b}" for a, b in RATES])
def test_resample_matches_jax_numpy(lib, jax_numpy_resample, rates):
    orig, new = rates
    x = (np.random.RandomState(3).randn(orig // 2 + 37) * 0.3).astype(np.float32)
    ref = jwav.resample(x, orig, new)
    got = wav.resample(x, orig, new)           # the shared native resampler
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0, atol=RESAMPLE_ATOL)
    np.testing.assert_allclose(wav.resample_numpy(x, orig, new), ref, rtol=0,
                               atol=RESAMPLE_ATOL)


def test_streaming_resampler_concatenates_to_one_shot(lib, jax_numpy_resample):
    rng = np.random.RandomState(4)
    for orig, new in RATES:
        x = (rng.randn(orig // 2 + 11) * 0.3).astype(np.float32)
        ref = jwav.resample(x, orig, new)
        rs = wav.StreamingResampler(orig, new)
        assert rs._native is not None
        parts, i = [], 0
        for sz in [160, 333, 1024, 7, 2560] * 200:
            if i >= len(x):
                break
            parts.append(rs.push(x[i:i + sz]))
            i += sz
        parts.append(rs.flush())
        got = np.concatenate(parts)
        assert got.shape == ref.shape, (orig, new)
        np.testing.assert_allclose(got, ref, rtol=0, atol=RESAMPLE_ATOL)


def _vad_corpus():
    rng = np.random.RandomState(0)
    segs = []
    for i in range(4):
        segs += [0.02 * rng.randn(512).astype(np.float32) for _ in range(12)]
        utt = np.asarray(0.5 * synth_speech(np.random.RandomState(100 + i),
                                            24 * 512), np.float32)
        segs += [utt[j * 512:(j + 1) * 512] for j in range(24)]
        segs += [np.zeros(512, np.float32)] * 30
    return segs


def test_learned_vad_native_matches_jax_numpy_gru(lib):
    ours, ref = LearnedVAD(), JLearnedVAD()
    assert ours._native is not None
    ref._native = None   # the JAX numpy GRU (_prob_py), the oracle
    ref.reset()
    probs, statuses = [], []
    for s in _vad_corpus():
        a = ours.predict({"audio": s, "time_stamp": None})
        b = ref.predict({"audio": s, "time_stamp": None})
        probs.append((a["prob"], b["prob"]))
        statuses.append((a["status"], b["status"]))
    err = np.abs(np.diff(np.asarray(probs), axis=1))
    assert err.max() < VAD_TOL, err.max()
    assert all(x == y for x, y in statuses)
    assert {"ipu_sl", "ipu_el"} <= {x for x, _ in statuses}


def test_learned_vad_native_buffers_sub_frame_pushes(lib):
    ours, py = LearnedVAD(), LearnedVAD()
    py._native = None    # the port's own numpy twin
    rng = np.random.RandomState(3)
    for n in (100, 27, 1, 200, 512, 5):
        a = (0.1 * rng.randn(n)).astype(np.float32)
        assert abs(ours._prob(a) - py._prob_py(a)) < VAD_TOL, n
    ours.reset()
    assert ours._prob(np.zeros(10, np.float32)) == 0.0   # buffered


_BUILDER = textwrap.dedent("""
    import sys
    from pathlib import Path
    import numpy as np
    import freeze_omni_tpu_torch.frontend.native as n
    n.BUILD_DIR = Path(sys.argv[1])
    x = (np.random.RandomState(0).randn(4000) * 1500).astype(np.float32)
    out = n.NativeFbank()(x)
    np.save(sys.argv[2], out)
""")


def test_six_concurrent_first_builds_each_load_a_whole_library(lib, tmp_path):
    build_dir = tmp_path / "kernel_build"
    env = dict(os.environ, PYTHONPATH=str(REPO))
    procs = [subprocess.Popen([sys.executable, "-c", _BUILDER, str(build_dir),
                               str(tmp_path / f"out{i}.npy")], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for i in range(6)]
    logs = [p.communicate(timeout=240)[0] for p in procs]
    assert [p.returncode for p in procs] == [0] * 6, logs
    ref = native.NativeFbank()(
        (np.random.RandomState(0).randn(4000) * 1500).astype(np.float32))
    for i in range(6):
        np.testing.assert_array_equal(np.load(tmp_path / f"out{i}.npy"), ref)
    built = sorted(p.name for p in build_dir.iterdir())
    assert built == [native.library_path().name], built   # no temp file left


def test_a_failed_build_raises_with_gxx_output(lib, tmp_path, monkeypatch):
    broken = []
    for src in native.SOURCES:
        dst = tmp_path / src.name
        dst.write_text(src.read_text() + ("\nthis is not c++;\n"
                                          if src.name == "vad.cc" else ""))
        broken.append(dst)
    monkeypatch.setattr(native, "SOURCES", tuple(broken))
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(native.NativeBuildFailure, match="vad.cc"):
        native.available()
    assert not any((tmp_path / "build").iterdir())   # nothing half written


def test_without_gxx_the_modules_take_their_numpy_paths(monkeypatch):
    monkeypatch.setattr(native.shutil, "which", lambda name: None)
    monkeypatch.setattr(native, "_lib", None)
    assert native.available() is False
    with pytest.raises(RuntimeError, match="unavailable"):
        native.NativeFbank()
    assert OfflineChunker()._native is None
    assert GatingChunker(GatingConfig())._native is None
    assert LearnedVAD()._native is None
    assert wav.StreamingResampler(48000, 16000)._native is None
    x = (np.random.RandomState(5).randn(999) * 0.3).astype(np.float32)
    np.testing.assert_array_equal(wav.resample(x, 48000, 16000),
                                  wav.resample_numpy(x, 48000, 16000))
