"""The port's VADs and their numpy fbank against the JAX package.

The JAX LearnedVAD runs a native C++ core when one is built; the port ports
its numpy GRU path (`_prob_py`), so each JAX instance here has `_native`
cleared and both run the same numpy arithmetic. Tolerances: fbank 1e-4 on
log-mel energies (the same float32 numpy code: equal up to summation order);
VAD probabilities 1e-5; IPU status sequences identical.
"""

import dataclasses

import numpy as np
import pytest

from freeze_omni_tpu.config import VADConfig as JaxVADConfig
from freeze_omni_tpu.duplex import vad as jvad
from freeze_omni_tpu.frontend.fbank import fbank_ref as jax_fbank_ref
from freeze_omni_tpu.training import vad as jtrain
from freeze_omni_tpu_torch.config import FbankConfig, VADConfig
from freeze_omni_tpu_torch.duplex import vad as tvad
from freeze_omni_tpu_torch.frontend.fbank import VAD_FBANK, fbank_ref

PROB_TOL = 1e-5


def test_vad_fbank_is_the_trained_features():
    assert dataclasses.asdict(VAD_FBANK) == dataclasses.asdict(jtrain.VAD_FBANK)


@pytest.mark.parametrize("cfg", [FbankConfig(), VAD_FBANK])
def test_fbank_ref_matches_jax(cfg):
    wav = 32768 * 0.3 * jtrain.synth_speech(np.random.RandomState(2), 9000)
    ours, ref = fbank_ref(wav, cfg), jax_fbank_ref(wav, cfg)
    assert ours.dtype == np.float32 and ours.shape == ref.shape
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-4)


def _stream(seed, chunk):
    """Quiet lead-in, then synthetic speech mixtures and noise, cut into
    `chunk`-sample pieces (the last one ragged)."""
    rng = np.random.RandomState(seed)
    parts = [0.002 * rng.randn(3 * chunk)]
    for _ in range(3):
        wav, _, _ = jtrain.make_mixture(rng, seconds=1.0)
        parts += [0.6 * wav, 0.002 * rng.randn(12 * chunk)]
    x = np.concatenate(parts).astype(np.float32)
    return [x[i:i + chunk] for i in range(0, len(x), chunk)]


def _run(vad, chunks):
    probs, statuses = [], []
    for c in chunks:
        out = vad.predict({"audio": c, "time_stamp": 0.0})
        probs.append(out["prob"])
        statuses.append(out["status"])
    return np.array(probs), statuses


@pytest.mark.parametrize("kind", ["energy", "learned"])
@pytest.mark.parametrize("chunk", [512, 3584])
def test_vad_matches_jax(kind, chunk):
    cfg, jcfg = VADConfig(chunk_size=chunk), JaxVADConfig(chunk_size=chunk)
    if kind == "energy":
        ours, ref = tvad.EnergyVAD(cfg), jvad.EnergyVAD(jcfg)
    else:
        ours, ref = tvad.LearnedVAD(cfg), jvad.LearnedVAD(jcfg)
        ours._native = None  # the port's numpy GRU (native: test_torch_native.py)
        ref._native = None   # the JAX numpy GRU (_prob_py)
    chunks = _stream(chunk, chunk)
    (pt, st), (pj, sj) = _run(ours, chunks), _run(ref, chunks)
    np.testing.assert_allclose(pt, pj, rtol=0, atol=PROB_TOL)
    assert st == sj
    assert "ipu_sl" in st and "ipu_el" in st, st


def test_learned_vad_carries_partial_frames():
    """Chunks shorter than one 16 ms frame carry over and report 0 until a
    frame is complete, as in the JAX numpy path."""
    ours, ref = tvad.LearnedVAD(VADConfig()), jvad.LearnedVAD(JaxVADConfig())
    ref._native = None
    chunks = [c[:100] for c in _stream(7, 512)[:10]]
    (pt, st), (pj, sj) = _run(ours, chunks), _run(ref, chunks)
    assert pt[0] == 0.0
    np.testing.assert_allclose(pt, pj, rtol=0, atol=PROB_TOL)
    assert st == sj


def test_make_vad_defaults_and_fallback():
    user = tvad.make_vad(VADConfig())
    assert isinstance(user, tvad.LearnedVAD)   # the committed weights exist
    assert type(tvad.make_vad(VADConfig(), identity="system")) is tvad.EnergyVAD
    assert type(tvad.make_vad(VADConfig(kind="energy"))) is tvad.EnergyVAD
    assert type(tvad.make_vad(VADConfig(weights="/nonexistent/vad.npz"))) \
        is tvad.EnergyVAD
    assert user.params.keys() == jvad.LearnedVAD(JaxVADConfig()).params.keys()
