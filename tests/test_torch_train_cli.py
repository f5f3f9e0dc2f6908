"""The port's training CLI (bin/train.py) and manifest input
(training/manifest.py) on the CPU at the tiny preset.

Every stage runs and prints the JAX CLI's summary keys; a run resumed from
its checkpoint gives the uninterrupted run's losses (within 1e-6 relative:
the same weights, moments, step count and batches on the same host); the
LoRA stage's lora.npz reads the same through both packages' `lora.load`
and merges into the tiny LLM (data-parallel and multi-host runs:
tests/test_torch_train_dp.py).
Manifest batches equal the JAX package's for the same manifest, tokenizer
and seed (fbank within 1e-3: one wav is resampled, through the port's
native resampler and the JAX numpy one, atol 1e-6 apart).
"""

import json
import os

import numpy as np
import pytest
import torch

import freeze_omni_tpu.frontend.native as jnative
from freeze_omni_tpu.config import tiny_system as jtiny
from freeze_omni_tpu.models import lora as jlora
from freeze_omni_tpu.training import manifest as jmani
from freeze_omni_tpu.utils.tokenizer import ByteTokenizer as JByteTokenizer
from freeze_omni_tpu_torch import weights
from freeze_omni_tpu_torch.bin import train as ttrain
from freeze_omni_tpu_torch.config import tiny_system
from freeze_omni_tpu_torch.frontend.wav import read_wav, resample, write_wav
from freeze_omni_tpu_torch.models import lora as tlora
from freeze_omni_tpu_torch.training import manifest as tmani
from freeze_omni_tpu_torch.training import train_step as tts
from freeze_omni_tpu_torch.utils import checkpoint as ckpt
from freeze_omni_tpu_torch.utils.tokenizer import ByteTokenizer

ASSET = os.path.abspath(os.path.join(os.path.dirname(__file__), "..",
                                     "freeze_omni_tpu", "assets", "tiny_s2s"))
SUMMARY = {"final_step", "first_loss", "final_loss"}


def train(*argv):
    return ttrain.main(["--preset", "tiny", "--device", "cpu", *argv])


@pytest.mark.parametrize("stage", tts.STAGES)
def test_every_stage_trains_and_prints_the_summary(stage, capsys):
    out = train("--stage", stage, "--steps", "2", "--batch", "2")
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(printed) == SUMMARY
    assert printed["final_step"] == 2
    assert np.isfinite(out["losses"]).all() and len(out["losses"]) == 2
    assert printed["first_loss"] == round(out["losses"][0], 4)


def test_resume_continues_the_uninterrupted_run(tmp_path):
    full = train("--stage", "all", "--steps", "4", "--batch", "2", "--seed", "3")
    ck = str(tmp_path / "ck")
    first = train("--stage", "all", "--steps", "2", "--batch", "2", "--seed", "3",
                  "--ckpt_dir", ck, "--save_every", "2")
    rest = train("--stage", "all", "--steps", "2", "--batch", "2", "--seed", "3",
                 "--ckpt_dir", ck, "--save_every", "2", "--resume")
    assert rest["final_step"] == 4
    np.testing.assert_allclose(first["losses"] + rest["losses"], full["losses"],
                               rtol=1e-6)
    with open(os.path.join(ck, "meta.json")) as f:
        assert json.load(f)["step"] == 4
    opt = ckpt.load_native(os.path.join(ck, "opt", "params.npz"))
    assert int(opt["count"][0]) == 4
    latest = ckpt.load_native(os.path.join(ck, "latest", "params.npz"))
    assert set(latest) == {"encoder_user", "adapter_user", "predictor",
                           "speech_decoder"}


def test_lora_stage_writes_an_adapter_both_packages_read(tmp_path):
    ck = str(tmp_path / "ck")
    train("--stage", "lora", "--steps", "3", "--batch", "2", "--ckpt_dir", ck,
          "--lora_rank", "4", "--lora_targets", "q,v,down")
    path = os.path.join(ck, "lora.npz")
    ours, s1 = tlora.load(path)
    theirs, s2 = jlora.load(path)
    assert s1 == s2 == 1.0 and set(ours) == set(theirs) == {"q", "v", "down"}
    cfg = tiny_system().audio_llm.llm
    for name, pair in ours.items():
        assert pair["a"].shape == (cfg.num_layers, tlora._dims(cfg, name)[0], 4)
        assert np.abs(pair["b"]).max() > 0       # trained away from B = 0
        for leaf in ("a", "b"):
            np.testing.assert_array_equal(pair[leaf], theirs[name][leaf])
    # serve --lora: merged into the tiny LLM
    from freeze_omni_tpu_torch.models import qwen2

    llm = qwen2.init_params(cfg, torch.Generator().manual_seed(0),
                            dtype=torch.float32, device="cpu")
    merged = tlora.merge(llm, weights.from_jax(ours, device="cpu"), s1)
    assert not torch.equal(merged["layers"]["q"]["w"], llm["layers"]["q"]["w"])


def _manifest(tmp_path):
    """Four dev utterances (one rewritten at 24 kHz) with absolute paths."""
    with open(os.path.join(ASSET, "asr_dev.tsv")) as f:
        rows = [ln.split("\t") for ln in f.read().splitlines()[:4]]
    out = []
    for i, (rel, text) in enumerate(rows):
        path = os.path.join(os.path.dirname(ASSET), "..", "..", rel)
        if i == 1:
            x, sr = read_wav(path)
            path = str(tmp_path / "resampled_24k.wav")
            write_wav(path, resample(x, sr, 24000), 24000)
        out.append(f"{os.path.abspath(path)}\t{text}")
    tsv = tmp_path / "train.tsv"
    tsv.write_text("\n".join(out) + "\n")
    return str(tsv)


@pytest.mark.parametrize("stage", ["ctc", "align"])
def test_manifest_batches_match_jax(stage, tmp_path, monkeypatch):
    monkeypatch.setattr(jnative, "available", lambda: False)   # JAX numpy resample
    tsv = _manifest(tmp_path)
    mc = dict(frame_buckets=(128, 256), text_buckets=(8, 16))
    ours = list(tmani.manifest_batches(
        stage, tsv, ByteTokenizer(256), tiny_system().audio_llm, 3,
        tmani.ManifestConfig(**mc), epochs=2, seed=5))
    theirs = list(jmani.manifest_batches(
        stage, tsv, JByteTokenizer(256), jtiny().audio_llm, 3,
        jmani.ManifestConfig(**mc), epochs=2, seed=5))
    assert len(ours) == len(theirs) > 0
    for a, b in zip(ours, theirs):
        assert a.keys() == b.keys()
        for k in a:
            if k == "fbank":
                np.testing.assert_allclose(a[k], b[k], rtol=0, atol=1e-3)
            else:
                np.testing.assert_array_equal(a[k], b[k])


def test_prefetch_keeps_order_and_raises_in_the_consumer():
    assert list(tmani.prefetch(iter(range(7)), depth=2)) == list(range(7))

    def bad():
        yield 1
        raise ValueError("loader failed")

    it = tmani.prefetch(bad())
    assert next(it) == 1
    with pytest.raises(ValueError, match="loader failed"):
        next(it)


def test_manifest_trains_the_ctc_stage(tmp_path):
    out = train("--stage", "ctc", "--steps", "2", "--batch", "2",
                "--manifest", _manifest(tmp_path))
    assert out["final_step"] == 2 and np.isfinite(out["losses"]).all()
    with pytest.raises(SystemExit, match="--manifest covers"):
        train("--stage", "state", "--steps", "1", "--manifest",
              _manifest(tmp_path))
