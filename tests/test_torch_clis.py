"""The port's voice-prompt and codec CLIs against the JAX package's, on the
CPU: `offline_infer --voice_wav`, `codec_tool` and `out_cer_eval`.

As in tests/test_torch_offline.py, the committed trained tiny system runs in
both packages with the JAX chunkers and resampler on their numpy paths. Its
codec was trained without the encoder branch, so a voice prompt gets one
encoder branch drawn by the JAX initializer and given to both packages.
"""

import argparse
import contextlib
import functools
import io
import json
import os

import jax
import numpy as np
import torch

from freeze_omni_tpu.bin import codec_tool as jtool
from freeze_omni_tpu.bin import offline_infer as joff
from freeze_omni_tpu.bin import out_cer_eval as jout
from freeze_omni_tpu.models import codec as jcodec
from freeze_omni_tpu_torch import weights
from freeze_omni_tpu_torch.bin import codec_tool as ttool
from freeze_omni_tpu_torch.bin import offline_infer as toff
from freeze_omni_tpu_torch.bin import out_cer_eval as tout
from freeze_omni_tpu_torch.config import tiny_system
from freeze_omni_tpu_torch.models import codec as tcodec
from tests.test_torch_offline import (COPY, JAX_ASSET, PCM_TOL,  # noqa: F401
                                      numpy_fbank, systems)

VOICE = os.path.join(JAX_ASSET, "dev_wavs", "asr_001.wav")
SENTENCES = os.path.join(JAX_ASSET, "sentences.txt")


def _stdout(fn, *a, **kw):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(*a, **kw)
    return out, buf.getvalue().splitlines()


def test_offline_infer_voice_wav_matches_jax(systems, tmp_path, monkeypatch):
    """One turn with --voice_wav in both packages (greedy text and speech):
    the same global tokens, the same text, PCM within PCM_TOL, and speech
    that the voice changed."""
    (jc, jp, jt), (tc, tp, tt) = systems
    enc = jax.tree.map(np.asarray, jcodec.init_params(
        jax.random.PRNGKey(5), jc.tts.codec, with_encoder=True)["encoder"])
    jt = dict(jt, codec=dict(jt["codec"], encoder=enc))
    tt = dict(tt, codec=dict(tt["codec"], encoder=weights.from_jax(enc, device="cpu")))
    for mod in (joff, toff):
        monkeypatch.setattr(mod, "synthesize_sentence", functools.partial(
            mod.synthesize_sentence, decoder_topk=1))

    def args(name, voice):
        return argparse.Namespace(
            input_wav=os.path.join(JAX_ASSET, "dev_wavs", "qa_000.wav"),
            output_wav=str(tmp_path / name), max_tokens=24, seed=0,
            model_path=None, voice_wav=voice, device="cpu")

    (j_text, j_pcm), j_out = _stdout(joff.run_inference, jc, args("j.wav", VOICE),
                                     pipeline=jp, tts_params=jt)
    (t_text, t_pcm), t_out = _stdout(toff.run_inference, tc, args("t.wav", VOICE),
                                     pipeline=tp, tts_params=tt)
    voice = [ln for ln in t_out if ln.startswith("voice prompt")]
    assert voice and voice == [ln for ln in j_out if ln.startswith("voice prompt")]
    assert t_text == j_text and t_text.strip()
    assert t_pcm.shape == np.asarray(j_pcm).shape
    np.testing.assert_allclose(t_pcm, np.asarray(j_pcm), rtol=PCM_TOL, atol=PCM_TOL)
    (_, plain), _ = _stdout(toff.run_inference, tc, args("p.wav", None),
                            pipeline=tp, tts_params=tt)
    # the trained codec's style embeddings are small (|gst| <= 0.021), so
    # the voice moves the PCM by little (9.1e-4 here), but by several times
    # the parity bound
    assert plain.shape != t_pcm.shape or np.abs(plain - t_pcm).max() > 5 * PCM_TOL


def _reference_codec(cfg, path):
    """The port's seeded codec with its encoder, saved as a reference
    final.pt ({generator, quantizer, encoder} under the reference's names)."""
    import chip_smoke

    p = tcodec.init_params(cfg, torch.Generator().manual_seed(9), device="cpu",
                           with_encoder=True)
    gen, quant = {}, {}
    conv = chip_smoke._ref_conv
    g = p["generator"]
    conv(gen, "conv_pre", g["conv_pre"])
    conv(gen, "conv_post", g["conv_post"])
    for i, up in enumerate(g["ups"]):
        conv(gen, f"ups.{i}", up)
    e = p["encoder"]
    enc = {}
    conv(enc, "conv_pre", e["conv_pre"])
    conv(enc, "conv_post", e["conv_post"])
    for i, up in enumerate(e["ups"]):
        conv(enc, f"ups.{i}", up)
    for tree, out in ((g, gen), (e, enc)):
        for i, rb in enumerate(tree["resblocks"]):
            for grp in ("convs1", "convs2"):
                for j, c in enumerate(rb[grp]):
                    conv(out, f"resblocks.{i}.{grp}.{j}", c)
    for i, gn in enumerate(e["group_norms"]):
        enc[f"normalize.{i}.weight"] = gn["scale"]
        enc[f"normalize.{i}.bias"] = gn["bias"]
    for k, name in (("conv1", "conv.0"), ("conv2", "conv.2"), ("conv3", "conv.4")):
        conv(enc, f"GlobalTokenEncoder.{name}", e["gte"][k])
    chip_smoke._ref_linear(enc, "GlobalTokenEncoder.fn.0", e["gte"]["fn"])
    chip_smoke._ref_norm(enc, "GlobalTokenEncoder.fn.2", e["gte"]["bn"])
    q = p["quantizer"]
    for layer, base in zip(q["codebooks"], ("quantizer_modules", "quantizer_modules2",
                                            "quantizer_modules3", "quantizer_modules4")):
        for gi in range(layer.shape[0]):
            quant[f"{base}.{gi}.embedding.weight"] = layer[gi]
    for gi in range(q["gst"].shape[0]):
        quant[f"quantizer_modules_globaltokens.{gi}.embedding.weight"] = q["gst"][gi]
    torch.save({"generator": gen, "quantizer": quant, "encoder": enc}, path)
    return p


def test_codec_tool_matches_jax(tmp_path, monkeypatch):
    """bin/codec_tool on one reference codec checkpoint (with its encoder) in
    both packages: the same printout (code shape, global tokens, token
    rate, reconstruction rmse) and the reconstruction within PCM_TOL."""
    from freeze_omni_tpu.frontend import native as jnative
    from freeze_omni_tpu_torch.frontend.wav import read_wav

    monkeypatch.setattr(jnative, "available", lambda: False)
    monkeypatch.setenv("FREEZE_OMNI_CACHE", str(tmp_path / "jax_cache"))
    ckpt = str(tmp_path / "codec.pt")
    _reference_codec(tiny_system().tts.codec, ckpt)
    flags = ["--preset", "tiny", "--input_wav", VOICE, "--ckpt", ckpt]
    _, j_out = _stdout(jtool.main, [*flags, "--output_wav", str(tmp_path / "j.wav")])
    (codes, gst, recon), t_out = _stdout(
        ttool.main, [*flags, "--device", "cpu", "--output_wav", str(tmp_path / "t.wav")])
    assert t_out[:-1] == j_out[:-1] and len(t_out) == len(j_out) == 5
    assert codes.shape[0] == 1 and gst.shape == (1, 1, 2)
    j_recon, _ = read_wav(str(tmp_path / "j.wav"))
    t_recon, _ = read_wav(str(tmp_path / "t.wav"))
    assert np.isfinite(recon).all()
    np.testing.assert_allclose(t_recon, j_recon, rtol=0, atol=2 / 32768)


def test_out_cer_eval_matches_jax(systems, tmp_path, monkeypatch):
    """bin/out_cer_eval: the synthesis it scores (greedy speech, the LLM's
    teacher-forced hiddens as prefix) within PCM_TOL of JAX's on the first
    two sentences, and `main --max_utts 2` in both packages with JAX's JSON
    schema. The ASR pass samples text at the config's top-k, with each
    package's own generator, so the two scores are not compared."""
    (jc, jp, jt), (tc, tp, tt) = systems
    from freeze_omni_tpu.tts import StreamingTTS as JTTS
    from freeze_omni_tpu_torch.tts import StreamingTTS

    with open(SENTENCES) as f:
        texts = [ln.strip() for ln in f if ln.strip()][:2]
    j_tts, t_tts = JTTS(jt, jc.tts, seed=0), StreamingTTS(tt, tc.tts, device="cpu")
    for text in texts:
        ids = tp.core.tokenizer.encode(tp.post_process(text))
        np.testing.assert_allclose(
            tout._text_hiddens(tp.core, tc.audio_llm, ids),
            jout._text_hiddens(jp.core, jc.audio_llm, ids), rtol=0, atol=1e-4)
        want = jout.synthesize_text(jp, j_tts, jc, text, top_k=1)
        got = tout.synthesize_text(tp, t_tts, tc, text, top_k=1)
        assert got.shape == want.shape and got.shape[0] > 0
        np.testing.assert_allclose(got, want, rtol=PCM_TOL, atol=PCM_TOL)

    monkeypatch.setenv("FREEZE_OMNI_CACHE", str(tmp_path / "jax_cache"))
    flags = ["--manifest", SENTENCES, "--top_k", "1", "--max_utts", "2",
             "--max_tokens", "24"]
    got, t_out = _stdout(tout.main, ["--model_path", COPY, "--device", "cpu", *flags])
    _, j_out = _stdout(jout.main, ["--model_path", JAX_ASSET, *flags])
    t_doc, j_doc = json.loads(t_out[-1]), json.loads(j_out[-1])
    assert set(t_doc) == set(j_doc) and set(t_doc["by_top_k"]) == {"1"}
    assert t_doc["n_utts"] == j_doc["n_utts"] == 2 and t_doc["metric"] == "out_cer"
    assert 0 <= t_doc["value"] < 1000 and len(got["hypotheses"][1]) == 2
