"""The port's per-session duplex path against the JAX package's, on the CPU:
`DuplexSession` on a `DuplexPipeline`, with and without a `DuplexResponder`,
and `ServingEngine.respond`.

The committed tiny checkpoint serves in two weight configurations (float32,
and int8 weight-only), with greedy text and codec sampling. The JAX user
VAD runs its numpy GRU (`_native` cleared) and its resampler the numpy path,
which is what the port ports. Both sessions gate their audio with the
port's GatingChunker, as tests/test_torch_engine.py feeds both engines the
port's windows: the two fbanks differ by up to 4e-2 in bins 40 dB below a
frame's peak (test_torch_frontend.py), which moves the probabilities by up
to 5e-4 over a dozen windows, so the comparison isolates the session and
the model. Compared: the sequence of events (VAD
statuses, decisions, KV rolls, response texts), state probabilities within
1e-4 (float32) or 2e-3 (int8), response PCM within 1e-4 (the vocoder
tolerance of tests/test_tts_batch.py) and the session's KV length after
every response, including responses that yield no sentence: a tokenizer
whose text is always empty stands for random flagship weights, whose text
ids are almost all >= 256, which the byte tokenizer drops; the tail then
has empty text and the context stays where it was.

On the port alone: the role prefill is never written by sessions or
resets, two sessions never share a cache, a poisoned predictor does not
kill the worker thread, and the pools keep the reference's API.
"""

import dataclasses
import os
import time

import jax
import numpy as np
import pytest
import torch

from freeze_omni_tpu import config as jcfg_mod
from freeze_omni_tpu import pipeline as jpipe
from freeze_omni_tpu.duplex.engine import DuplexSession as JaxSession
from freeze_omni_tpu.duplex.responder import DuplexResponder as JaxResponder
from freeze_omni_tpu.frontend import native as jax_native
from freeze_omni_tpu.ops.quant import quantize_llm_params as jax_quantize
from freeze_omni_tpu.runtime.engine import ServingEngine as JaxEngine
from freeze_omni_tpu.training.vad import synth_speech
from freeze_omni_tpu.tts import StreamingTTS as JaxTTS
from freeze_omni_tpu.utils.checkpoint import load_native
from freeze_omni_tpu.utils.tokenizer import ByteTokenizer as JaxByteTokenizer
from freeze_omni_tpu_torch import config as tcfg_mod
from freeze_omni_tpu_torch import weights
from freeze_omni_tpu_torch.duplex.engine import DuplexSession
from freeze_omni_tpu_torch.duplex.responder import DuplexResponder
from freeze_omni_tpu_torch.frontend.chunker import GatingChunker
from freeze_omni_tpu_torch.models import qwen2 as tq
from freeze_omni_tpu_torch.pipeline import DuplexPipeline
from freeze_omni_tpu_torch.runtime.engine import (PipelinePool, ServingEngine,
                                                  TTSPool)
from freeze_omni_tpu_torch.tts import StreamingTTS
from freeze_omni_tpu_torch.utils.tokenizer import ByteTokenizer

ASSET = os.path.abspath(os.path.join(os.path.dirname(__file__), "..",
                                     "freeze_omni_tpu", "assets", "tiny_s2s"))
PROB_TOL = {"f32": 1e-4, "int8": 2e-3, "silent": 1e-4}
PCM_TOL = 1e-4
# responses short enough for the tiny speech decoder's 256-slot cache
RESP = dict(max_tokens=16, segment=4)


def greedy(cfg):
    return dataclasses.replace(
        cfg, sampling=dataclasses.replace(cfg.sampling, top_k=1),
        tts=dataclasses.replace(cfg.tts, top_k=1))


@pytest.fixture(scope="module")
def tree():
    return load_native(os.path.join(ASSET, "params"))


@pytest.fixture(autouse=True)
def numpy_frontend(monkeypatch):
    monkeypatch.setattr(jax_native, "available", lambda: False)


def systems(tree, kind):
    """(JAX config, port config, JAX audio-LLM params, the port's, JAX TTS
    params, the port's) of the checkpoint: its audio LLM in float32 ("f32",
    "silent") or with int8 LLM weights ("int8"); its speech decoder and
    codec."""
    path = os.path.join(ASSET, "config.json")
    jcfg = greedy(jcfg_mod.load_system_config(path))
    tcfg = greedy(tcfg_mod.load_system_config(path))
    jp = dict(tree["audiollm"])
    if kind == "int8":
        jp["llm"] = jax_quantize(jp["llm"])
    jt = tree["tts"]
    tp = weights.from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    tt = weights.from_jax(jax.tree.map(np.asarray, jt), device="cpu")
    return jcfg, tcfg, jp, tp, jt, tt


def tokenizers(cfg, kind):
    """(JAX tokenizer, port tokenizer): the byte tokenizers, or for "silent"
    ones whose decoded text is always empty."""
    out = []
    for cls in (JaxByteTokenizer, ByteTokenizer):
        if kind == "silent":
            cls = type("Silent" + cls.__name__, (cls,),
                       {"decode": lambda self, ids: ""})
        out.append(cls(cfg.audio_llm.llm.vocab_size))
    return out


def session_pair(tree, kind, respond):
    jcfg, tcfg, jp, tp, jt, tt = systems(tree, kind)
    jtok, ttok = tokenizers(tcfg, kind)
    jpl = jpipe.DuplexPipeline(jcfg, params=jp, tokenizer=jtok)
    tpl = DuplexPipeline(tcfg, params=tp, tokenizer=ttok, device="cpu")
    jr = tr = None
    if respond:
        jr = JaxResponder(jpl.core, JaxTTS(jt, jcfg.tts), jcfg, **RESP)
        tr = DuplexResponder(tpl.core, StreamingTTS(tt, tcfg.tts, device="cpu"),
                             tcfg, **RESP)
    js = JaxSession(jpl, jcfg, responder=jr)
    js.vad["user"]._native = None
    js.gating = {i: GatingChunker(tcfg.duplex.gating) for i in js.gating}
    return js, DuplexSession(tpl, tcfg, responder=tr)


def audio(n):
    """Per identity, the pushes: quiet, speech, quiet."""
    return {"user": [np.zeros(n, np.float32),
                     0.5 * synth_speech(np.random.RandomState(7), 3 * n),
                     np.zeros(4 * n, np.float32)],
            "system": [np.zeros(2 * n, np.float32),
                       0.5 * synth_speech(np.random.RandomState(8), 3 * n),
                       np.zeros(3 * n, np.float32)]}


def drive(session, pushes, speak_once=False):
    """Push every chunk and pump until idle. With speak_once the first
    decision runs at threshold 0 (the session speaks) and the rest at 2."""
    if speak_once:
        session.resp_threshold = 0.0
        session.sink.on("dialog_ss_callback",
                        lambda _: setattr(session, "resp_threshold", 2.0))
    for k in range(3):
        for identity, chunks in pushes.items():
            session.enqueue_audio_data(identity, {"audio": chunks[k], "enc": "f32"})
        while session.pump():
            pass
    return session.sink


def summary(sink):
    kinds = ("vad_event", "dialog_state_update", "kv_roll", "response_text",
             "dialog_ss_callback")
    seq = [(e, p.get("identity"), p.get("status"), p.get("state"), p.get("text"))
           for e, p in sink.history if e in kinds]
    probs = np.array([[u["probs"]["state_1"], u["probs"]["state_2"]]
                      for u in sink.events_of("dialog_state_update")])
    pcm = [a["pcm"] for a in sink.events_of("response_audio")]
    return seq, probs, pcm


def kv_len(kv):
    return int(np.asarray(kv.length)[0])


@pytest.mark.parametrize("kind,respond", [("f32", False), ("int8", False),
                                          ("f32", True), ("int8", True),
                                          ("silent", True)])
def test_session_matches_jax(tree, kind, respond):
    js, ts = session_pair(tree, kind, respond)
    n = ts.cfg.duplex.gating.samples_per_chunk
    assert kv_len(js.past_key_values) == kv_len(ts.past_key_values)
    (jseq, jprob, jpcm), (tseq, tprob, tpcm) = [
        summary(drive(s, audio(n), speak_once=respond)) for s in (js, ts)]
    assert tseq == jseq
    assert ("vad_event", "user", "ipu_sl", None, None) in tseq
    assert ("vad_event", "user", "ipu_el", None, None) in tseq
    assert tprob.shape == jprob.shape and len(tprob) >= 2
    assert np.abs(tprob - jprob).max() <= PROB_TOL[kind]
    assert len(tpcm) == len(jpcm)
    for a, b in zip(tpcm, jpcm):
        np.testing.assert_allclose(a, b, rtol=PCM_TOL, atol=PCM_TOL)
    if respond:
        spoke = [e for e in tseq if e[0] == "response_text"]
        assert bool(spoke) == (kind != "silent"), tseq
        assert ("dialog_ss_callback", None, None, None, None) in tseq
    # the port's host mirror was read again after the response
    assert kv_len(ts.past_key_values) == kv_len(js.past_key_values)


def test_silent_response_keeps_the_context_as_jax(tree):
    """A response whose sentences all have empty text yields nothing: the
    JAX caller keeps its KV, and the port's responder sets the advanced
    cache's length back to its entry value; ServingEngine.respond scatters
    that."""
    jcfg, tcfg, jp, tp, jt, tt = systems(tree, "silent")
    jtok, ttok = tokenizers(tcfg, "silent")
    je = JaxEngine(jcfg, params=jp, tokenizer=jtok)
    te = ServingEngine(tcfg, params=tp, tokenizer=ttok, device="cpu")
    jr = JaxResponder(je.core, JaxTTS(jt, jcfg.tts), jcfg, **RESP)
    tr = DuplexResponder(te.core, StreamingTTS(tt, tcfg.tts, device="cpu"),
                         tcfg, **RESP)
    kv = tq.copy_cache(te.core.role_kv("Silent."))
    entry = kv_len(kv)
    assert list(tr.respond(kv)) == []
    assert kv_len(kv) == entry   # the generated tokens are not kept
    for e in (je, te):
        e.open_session("s")
    before = te.store.kv_length(0)
    assert te.respond("s", tr) == je.respond("s", jr) == []
    assert te.store.kv_length(0) == je.store.kv_length(0) == before


@pytest.mark.parametrize("kind", ["f32", "int8"])
def test_engine_respond_matches_jax(tree, kind):
    jcfg, tcfg, jp, tp, jt, tt = systems(tree, kind)
    je, te = JaxEngine(jcfg, params=jp), ServingEngine(tcfg, params=tp, device="cpu")
    jr = JaxResponder(je.core, JaxTTS(jt, jcfg.tts), jcfg, **RESP)
    tr = DuplexResponder(te.core, StreamingTTS(tt, tcfg.tts, device="cpu"), tcfg,
                         embed_fn=te.embed_tokens, **RESP)
    chunk = np.random.RandomState(0).randn(1, 32, 80).astype(np.float32)
    for e in (je, te):
        e.open_session("s")
        e.submit_chunk("s", "user", chunk, is_sl=True)
        e.tick()
    jo, to = je.respond("s", jr), te.respond("s", tr)
    assert [t for t, _ in to] == [t for t, _ in jo] and to
    for (_, a), (_, b) in zip(to, jo):
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_allclose(a, b, rtol=PCM_TOL, atol=PCM_TOL)
    assert te.store.kv_length(0) == je.store.kv_length(0)


def test_session_kv_roll_matches_jax(tree):
    """The port of tests/test_kv_guard.py's long-session test: the cache
    rolls at the same chunks as JAX's, to the same lengths, and predictions
    keep flowing after the rolls."""
    js, ts = session_pair(tree, "f32", respond=False)
    n = ts.cfg.duplex.gating.samples_per_chunk
    rng = np.random.RandomState(0)
    quiet = (0.0005 * rng.randn(3 * n)).astype(np.float32)
    loud = 0.5 * synth_speech(np.random.RandomState(7), 3 * n)
    lengths = {}
    for name, s in (("jax", js), ("port", ts)):
        seen = lengths[name] = []
        real = s._predict_stage

        def spy(feat, s=s, real=real, seen=seen):
            real(feat)
            seen.append(kv_len(s.past_key_values))

        s._predict_stage = spy
        s.enqueue_audio_data("user", {"audio": quiet, "enc": "f32"})
        s.pump()
        for _ in range(10):
            s.enqueue_audio_data("user", {"audio": loud, "enc": "f32"})
            s.enqueue_audio_data("user", {"audio": quiet * 0, "enc": "f32"})
            while s.pump():
                pass
    assert lengths["port"] == lengths["jax"]
    (jseq, jprob, _), (tseq, tprob, _) = summary(js.sink), summary(ts.sink)
    assert tseq == jseq
    kinds = [e[0] for e in tseq]
    assert "kv_roll" in kinds
    assert "dialog_state_update" in kinds[kinds.index("kv_roll") + 1:]
    assert max(lengths["port"]) <= ts.past_key_values.k.shape[2]
    assert np.abs(tprob - jprob).max() <= PROB_TOL["f32"]


def tiny_session(pipeline=None):
    cfg = tcfg_mod.tiny_system()
    pipeline = pipeline or DuplexPipeline(cfg, seed=0, device="cpu")
    return DuplexSession(pipeline, cfg)


def test_role_prefill_is_never_written():
    """Chunks, a KV roll and a reset leave the shared role prefill as it
    was, length and content; the session's own cache restarts from it."""
    s = tiny_session()
    role = s.system_role_kv
    before = tq.copy_cache(role)
    assert s.past_key_values.k.data_ptr() != role.k.data_ptr()
    n = s.cfg.duplex.gating.samples_per_chunk
    for _ in range(8):
        s.enqueue_audio_data("user", {"audio": 0.5 * synth_speech(
            np.random.RandomState(7), 3 * n), "enc": "f32"})
        s.enqueue_audio_data("user", {"audio": np.zeros(2 * n, np.float32),
                                      "enc": "f32"})
        while s.pump():
            pass
    assert s.sink.events_of("kv_roll")
    s.reset_context()
    for t, b in zip(role, before):
        assert (t is None and b is None) or torch.equal(t, b)
    assert torch.equal(s.past_key_values.length, before.length)
    L = int(before.length[0])
    assert torch.equal(s.past_key_values.k[:, :, :L], before.k[:, :, :L])


def test_sessions_do_not_share_a_cache():
    a = tiny_session()
    b = tiny_session(a.pipeline)
    assert a.system_role_kv is b.system_role_kv   # the one shared template
    for x, y in zip(a.past_key_values, b.past_key_values):
        if x is not None:
            assert x.data_ptr() != y.data_ptr()
    b_before = tq.copy_cache(b.past_key_values)
    n = a.cfg.duplex.gating.samples_per_chunk
    a.enqueue_audio_data("user", {"audio": 0.5 * synth_speech(
        np.random.RandomState(3), 3 * n), "enc": "f32"})
    while a.pump():
        pass
    assert a.sink.events_of("dialog_state_update")
    assert int(a.past_key_values.length[0]) > int(b.past_key_values.length[0])
    for x, y in zip(b.past_key_values, b_before):
        assert x is None or torch.equal(x, y)


def test_worker_survives_poisoned_predictor():
    """The port of tests/test_stress.py's failure-containment test: one
    failing prediction emits an error and the worker thread keeps going."""
    s = tiny_session()
    errors = []
    s.sink.on("error", errors.append)
    real = s.pipeline.speech_dialogue
    calls = {"n": 0}

    def flaky(*a, **kw):
        calls["n"] += 1
        if calls["n"] == 1:
            raise RuntimeError("injected predictor failure")
        return real(*a, **kw)

    s.pipeline.speech_dialogue = flaky
    s.start(interval=0.005)
    n = s.cfg.duplex.gating.samples_per_chunk
    speech = 0.5 * synth_speech(np.random.RandomState(7), 3 * n)
    try:
        s.enqueue_audio_data("user", {"audio": np.zeros(n, np.float32), "enc": "f32"})
        s.enqueue_audio_data("user", {"audio": speech, "enc": "f32"})
        deadline = time.time() + 30
        while not errors and time.time() < deadline:
            time.sleep(0.02)
        # more work after the failure: the worker must still be alive
        s.enqueue_audio_data("user", {"audio": speech, "enc": "f32"})
        while not s.sink.events_of("dialog_state_update") and time.time() < deadline:
            time.sleep(0.02)
    finally:
        worker = s._worker
        s.release()
    assert not worker.is_alive()
    assert any("injected predictor failure" in e["message"] for e in errors)
    assert s.sink.events_of("dialog_state_update")


def test_pools_keep_the_reference_api():
    """The port of tests/test_runtime.py's pool test, and TTSPool's
    first-free acquire."""
    cfg = tcfg_mod.tiny_system()
    pool = PipelinePool(size=1, cfg=cfg, device="cpu")
    h1, h2 = pool.acquire(), pool.acquire()
    assert h1 is h2 and h1.user_count == 2
    pool.release(h1)
    assert h1.user_count == 1
    assert isinstance(h1.pipeline_proc, ServingEngine)
    g = torch.Generator().manual_seed(0)
    from freeze_omni_tpu_torch.models import codec, speech_decoder
    params = {"decoder": speech_decoder.init_params(cfg.tts.decoder, g, device="cpu"),
              "codec": codec.init_params(cfg.tts.codec, g, device="cpu")}
    tts = TTSPool(2, params, cfg.tts, device="cpu")
    a, b = tts.acquire(), tts.acquire()
    assert a is not b and isinstance(a.tts_proc, StreamingTTS)
    with pytest.raises(RuntimeError, match="No available"):
        tts.acquire()
    tts.release(a)
    assert tts.acquire() is a
