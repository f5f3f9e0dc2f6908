"""The port's offline CLI and eval harnesses against the JAX package's, on the
CPU, with the committed trained tiny system: the port loads it through its
chunk index (`freeze_omni_tpu_torch/assets/tiny_s2s`,
utils/factory.load_native_system), JAX from its orbax tree.

Both packages run their numpy fbank: the JAX chunkers' native C++ fbank is
turned off by patching `freeze_omni_tpu.frontend.native.available` (nothing
in the JAX package changes). The two fbanks differ in bins more than 40 dB
below a frame's peak (tests/test_torch_frontend.py), which the trained
system's margins absorb:

- `offline_infer.run_inference`, greedy text sampling and a greedy speech
  decoder (`synthesize_sentence`'s top-k patched to 1 in both packages):
  the text identical, PCM within tests/test_torch_response.py's 1e-4;
- `asr_eval.batched_transcribe` on 8 of asr_dev.tsv's utterances and the
  serial `transcribe` on 2: hypotheses identical;
- the port's `asr_eval.main` and `qa_eval.main` on the full dev manifests
  with QUALITY.json's flags: CER <= 3.74 % (the recorded 2.74 plus one
  point) and QA >= 93.75 % (15 of 16; recorded 100), and the printed JSON
  has JAX's schema.
"""

import argparse
import contextlib
import dataclasses
import functools
import io
import json
import os

import numpy as np
import pytest

from freeze_omni_tpu.bin import asr_eval as jasr
from freeze_omni_tpu.bin import offline_infer as joff
from freeze_omni_tpu.bin import qa_eval as jqa
from freeze_omni_tpu.frontend import native as jnative
from freeze_omni_tpu.frontend.chunker import OfflineChunker as JChunker
from freeze_omni_tpu.pipeline import InferencePipeline as JPipeline
from freeze_omni_tpu.utils import factory as jfactory
from freeze_omni_tpu_torch.bin import asr_eval as tasr
from freeze_omni_tpu_torch.bin import offline_infer as toff
from freeze_omni_tpu_torch.bin import qa_eval as tqa
from freeze_omni_tpu_torch.frontend.chunker import OfflineChunker
from freeze_omni_tpu_torch.pipeline import InferencePipeline
from freeze_omni_tpu_torch.utils import factory as tfactory

ROOT = os.path.join(os.path.dirname(__file__), "..")
JAX_ASSET = os.path.join(ROOT, "freeze_omni_tpu", "assets", "tiny_s2s")
COPY = os.path.join(ROOT, "freeze_omni_tpu_torch", "assets", "tiny_s2s")
ASR_DEV = os.path.join(JAX_ASSET, "asr_dev.tsv")
QA_DEV = os.path.join(JAX_ASSET, "qa_dev.tsv")
PCM_TOL = 1e-4
CER_MAX, QA_MIN = 3.74, 93.75


def greedy(cfg):
    return dataclasses.replace(
        cfg, sampling=dataclasses.replace(cfg.sampling, top_k=1),
        tts=dataclasses.replace(cfg.tts, top_k=1))


@pytest.fixture(scope="module")
def numpy_fbank():
    """The JAX chunkers on their numpy fbank for this module's tests."""
    mp = pytest.MonkeyPatch()
    mp.setattr(jnative, "available", lambda: False)
    yield
    mp.undo()


@pytest.fixture(scope="module")
def systems(numpy_fbank):
    """((JAX cfg, pipeline, tts params), (port cfg, pipeline, tts params)),
    greedy, one JAX pipeline for every parity case (its jit caches)."""
    jc, ja, jt, jtok = jfactory.load_native_system(JAX_ASSET)
    tc, ta, tt, ttok = tfactory.load_native_system(COPY, device="cpu")
    jc, tc = greedy(jc), greedy(tc)
    return ((jc, JPipeline(jc, params=ja, tokenizer=jtok), jt),
            (tc, InferencePipeline(tc, params=ta, tokenizer=ttok, device="cpu"),
             tt))


def manifest(path, n):
    with open(path) as f:
        rows = [line.rstrip("\n").split("\t", 1) for line in f if line.strip()]
    return [(os.path.join(ROOT, p), ref) for p, ref in rows[:n]]


def test_run_inference_matches_jax(systems, tmp_path, monkeypatch):
    (jc, jp, jt), (tc, tp, tt) = systems
    for mod in (joff, toff):
        monkeypatch.setattr(mod, "synthesize_sentence", functools.partial(
            mod.synthesize_sentence, decoder_topk=1))
    wav = os.path.join(JAX_ASSET, "dev_wavs", "qa_000.wav")

    def args(name):
        return argparse.Namespace(input_wav=wav, output_wav=str(tmp_path / name),
                                  max_tokens=24, seed=0, model_path=None,
                                  voice_wav=None, device="cpu")

    j_text, j_pcm = joff.run_inference(jc, args("j.wav"), pipeline=jp,
                                       tts_params=jt)
    t_text, t_pcm = toff.run_inference(tc, args("t.wav"), pipeline=tp,
                                       tts_params=tt)
    assert t_text == j_text and t_text.strip()
    assert t_pcm.shape == np.asarray(j_pcm).shape and t_pcm.shape[0] > 1
    np.testing.assert_allclose(t_pcm, np.asarray(j_pcm), rtol=PCM_TOL,
                               atol=PCM_TOL)


def test_batched_and_serial_transcribe_match_jax(systems):
    (jc, jp, _), (tc, tp, _) = systems
    utts = manifest(ASR_DEV, 8)
    wavs = [tasr.load_wav(p) for p, _ in utts]
    t_hyps = tasr.batched_transcribe(tp, tc, wavs, 24)
    j_hyps = jasr.batched_transcribe(jp, jc, wavs, 24)
    assert t_hyps == j_hyps
    assert sum(h == ref for h, (_, ref) in zip(t_hyps, utts)) >= 6
    for wav in wavs[:2]:
        t = tasr.transcribe(tp, OfflineChunker(tc.chunker), wav, 24)
        j = jasr.transcribe(jp, JChunker(jc.chunker), wav, 24)
        assert t == j


def _json_line(fn, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fn(argv)
    return json.loads([ln for ln in buf.getvalue().splitlines()
                       if ln.startswith("{")][-1])


def _schema(doc):
    return {k: (_schema(v) if isinstance(v, dict) else type(v).__name__)
            for k, v in doc.items()}


@pytest.mark.parametrize("harness", ["asr", "qa"])
def test_eval_harness_scores_the_copy(harness, numpy_fbank, monkeypatch,
                                      tmp_path):
    """The full dev manifest through the port on the CPU; the JAX harness
    on 8 utterances gives the JSON schema to hold the port's to."""
    monkeypatch.setenv("FREEZE_OMNI_CACHE", str(tmp_path / "jax_cache"))
    # the manifests name their wavs from the repo's root
    tsv = tmp_path / "dev.tsv"
    rows = manifest(ASR_DEV if harness == "asr" else QA_DEV, None)
    tsv.write_text("".join(f"{p}\t{ref}\n" for p, ref in rows))
    if harness == "asr":
        flags = ["--manifest", str(tsv), "--char_level", "--batch", "8",
                 "--max_tokens", "24"]
        tmain, jmain = tasr.main, jasr.main
    else:
        flags = ["--manifest", str(tsv), "--batch", "8", "--max_tokens", "12"]
        tmain, jmain = tqa.main, jqa.main
    got = _json_line(tmain, ["--model_path", COPY, "--device", "cpu", *flags])
    want = _json_line(jmain, ["--model_path", JAX_ASSET, "--max_utts", "8",
                              *flags])
    assert _schema(got) == _schema(want)
    if harness == "asr":
        assert got["metric"] == "cer" and got["n_utts"] == 24
        assert got["value"] <= CER_MAX, got
    else:
        assert got["metric"] == "qa_accuracy" and got["n_utts"] == 16
        assert got["value"] >= QA_MIN, got
