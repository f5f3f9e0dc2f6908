"""The port's DuplexService against the JAX one, on the CPU.

Both services serve two sessions of the committed tiny checkpoint with an
int8 KV cache, in two weight configurations (int8, and int4 with an int4
lm_head: `quantize_llm_params(bits=...)` of the JAX package, converted leaf
for leaf), and get the same user and system audio. The JAX user VAD runs its
numpy GRU (`_native` cleared) and its resampler the numpy path, which is
what the port ports. Compared per session: the sequence of `vad_event`
(identity, status) pairs and of `dialog_state_update` decisions, identical,
and the state probabilities within 2e-3 (test_torch_engine.py gives the
reason); never the `time.time()` stamps. Then, on the port alone: the
pipelined service delivers the sync service's predictions one tick late;
with speech synthesis attached and the threshold at 0 the response audio
re-enters as system audio; a user onset during a response interrupts it;
close_session frees the slot.
"""

import dataclasses
import os

import jax
import numpy as np
import pytest

from freeze_omni_tpu import config as jcfg_mod
from freeze_omni_tpu.frontend import native as jax_native
from freeze_omni_tpu.ops.quant import quantize_llm_params as jax_quantize
from freeze_omni_tpu.runtime.service import DuplexService as JaxService
from freeze_omni_tpu.training.vad import synth_speech
from freeze_omni_tpu.utils.checkpoint import load_native
from freeze_omni_tpu_torch import config as tcfg_mod
from freeze_omni_tpu_torch import weights
from freeze_omni_tpu_torch.runtime.service import DuplexService

ASSET = os.path.abspath(os.path.join(os.path.dirname(__file__), "..",
                                     "freeze_omni_tpu", "assets", "tiny_s2s"))
PROB_ATOL = 2e-3
SIDS = ("a", "b")


def _cfg(cfg_mod, **serving):
    cfg = cfg_mod.load_system_config(os.path.join(ASSET, "config.json"))
    return dataclasses.replace(cfg, serving=dataclasses.replace(
        cfg.serving, kv_quant_bits=8, **serving))


@pytest.fixture(scope="module")
def tree():
    return load_native(os.path.join(ASSET, "params"))


def _params(tree, bits):
    p = dict(tree["audiollm"])
    p["llm"] = jax_quantize(p["llm"], bits=bits)
    return p


def _audio(n):
    """Per session and identity, a list of pushes: quiet, speech, quiet."""
    out = {}
    for i, sid in enumerate(SIDS):
        user = 0.5 * synth_speech(np.random.RandomState(10 + i), (2 + i) * n)
        system = 0.5 * synth_speech(np.random.RandomState(20 + i), 3 * n)
        out[sid] = {"user": [np.zeros(n, np.float32), user,
                             np.zeros(4 * n, np.float32)],
                    "system": [np.zeros(2 * n, np.float32), system,
                               np.zeros(3 * n, np.float32)]}
    return out


def _drive(svc, audio, steps=16):
    sinks = {sid: svc.open_session(sid) for sid in SIDS}
    if isinstance(svc, JaxService):
        for sid in SIDS:
            svc.sessions[sid].vad["user"]._native = None
    for k in range(3):
        for sid in SIDS:
            for ident in ("user", "system"):
                svc.enqueue_audio_data(sid, ident, {"audio": audio[sid][ident][k]})
        svc.step()
    for _ in range(steps):
        if not svc.step():
            break
    svc.drain_ticks()
    return sinks


def _summary(sink):
    vad = [(e["identity"], e["status"]) for e in sink.events_of("vad_event")]
    upd = sink.events_of("dialog_state_update")
    return (vad, [u["state"] for u in upd],
            np.array([[u["probs"]["state_1"], u["probs"]["state_2"]] for u in upd]))


@pytest.mark.parametrize("bits", [8, 4])
def test_service_matches_jax(tree, monkeypatch, bits):
    monkeypatch.setattr(jax_native, "available", lambda: False)
    jp = _params(tree, bits)
    tp = weights.from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    jcfg, tcfg = _cfg(jcfg_mod), _cfg(tcfg_mod)
    audio = _audio(tcfg.duplex.gating.samples_per_chunk)
    jsinks = _drive(JaxService(jcfg, seed=0, params=jp), audio)
    tsvc = DuplexService(tcfg, seed=0, params=tp, device="cpu")
    tsinks = _drive(tsvc, audio)
    for sid in SIDS:
        (tv, ts, tprob), (jv, js, jprob) = _summary(tsinks[sid]), \
            _summary(jsinks[sid])
        assert tv == jv, sid
        assert ("user", "ipu_sl") in tv and ("user", "ipu_el") in tv, tv
        assert ("system", "ipu_sl") in tv, tv
        assert ts == js and len(ts) >= 2, sid
        assert tprob.shape == jprob.shape
        assert np.abs(tprob - jprob).max() <= PROB_ATOL, (sid, tprob, jprob)
    layers = tsvc.engine.core.params["llm"]["layers"]
    assert ("w_q4" if bits == 4 else "w_q") in layers["down"]
    slot = tsvc.engine.store.slot_of("a")
    tsvc.close_session("a")
    assert tsvc.engine.num_active == 1 and "a" not in tsvc.sessions
    tsvc.open_session("c")
    assert tsvc.engine.store.slot_of("c") == slot


@pytest.fixture(scope="module")
def tiny_tts(tree):
    return weights.from_jax(jax.tree.map(np.asarray, tree["tts"]), device="cpu")


def _predictions(sink):
    return [round(u["probs"]["state_1"], 6)
            for u in sink.events_of("dialog_state_update")]


def test_pipelined_service_matches_sync(tree):
    tp = weights.from_jax(jax.tree.map(np.asarray, _params(tree, 8)),
                          device="cpu")
    out = {}
    for pipelined in (False, True):
        cfg = _cfg(tcfg_mod, pipeline_ticks=pipelined)
        svc = DuplexService(cfg, seed=0, params=tp, device="cpu")
        out[pipelined] = {sid: _predictions(s) for sid, s in
                          _drive(svc, _audio(cfg.duplex.gating.samples_per_chunk)
                                 ).items()}
    assert out[False] and out[False] == out[True]
    assert all(len(v) >= 2 for v in out[False].values())


def test_threshold_zero_closes_the_loop_then_continues_and_is_interrupted(
        tree, tiny_tts):
    """Threshold 0: a user prediction speaks (respond_fast_many) and the
    response audio, resampled to 16 kHz, re-enters as system audio that the
    system VAD hears. A registered continuation then advances by batched
    text segments into the synthesis pool until its cap, and flush_tts
    drains the pool. A user onset during a response interrupts it."""
    tp = weights.from_jax(jax.tree.map(np.asarray, _params(tree, 4)),
                          device="cpu")
    cfg = _cfg(tcfg_mod)
    cfg = dataclasses.replace(cfg, duplex=dataclasses.replace(
        cfg.duplex, resp_threshold=0.0, resp_segment=6, resp_max_tokens=18))
    svc = DuplexService(cfg, seed=0, params=tp, tts_params=tiny_tts,
                        device="cpu")
    assert svc.warmup_synthesis() == 0
    sink = svc.open_session("s")
    n = cfg.duplex.gating.samples_per_chunk
    speech = lambda seed: 0.5 * synth_speech(np.random.RandomState(seed), 2 * n)  # noqa: E731
    svc.enqueue_audio_data("s", "user", {"audio": np.zeros(n, np.float32)})
    # the system line's background (-66 dBFS) sets its VAD's noise floor;
    # digital zeros would not, and the first response chunk would instead
    svc.enqueue_audio_data("s", "system", {
        "audio": 5e-4 * np.random.RandomState(0).randn(n).astype(np.float32)})
    svc.step()
    svc.enqueue_audio_data("s", "user", {"audio": speech(3)})
    system_heard = lambda: [e for e in sink.events_of("vad_event")  # noqa: E731
                            if e["identity"] == "system"]
    for _ in range(10):
        svc.step()
        if system_heard():
            break
    audio = sink.events_of("response_audio")
    assert sink.events_of("response_text") and audio
    assert audio[0]["sr"] == cfg.tts.codec.sample_rate and audio[0]["pcm"].size
    assert all(np.isfinite(a["pcm"]).all() for a in audio)
    assert system_heard(), "the response audio never re-entered as system audio"

    # continuation: batched text segments, sentences into the pool
    svc.resp_threshold = 2.0
    svc.enqueue_audio_data("s", "user", {"audio": np.zeros(6 * n, np.float32)})
    for _ in range(4):
        svc.step()
    fe = svc.sessions["s"]
    slot = svc.engine.store.slot_of("s")
    before = svc.engine.store.kv_length(slot)
    texts = len(sink.events_of("response_text"))
    fe.resp = {"last": 3, "n": 0, "toks": [], "hids": []}
    for _ in range(4):
        if fe.resp is None:
            break
        svc.step()
    assert fe.resp is None   # eod or the 18-token cap ended it
    svc.flush_tts()
    assert svc.engine.store.kv_length(slot) > before
    assert len(sink.events_of("response_text")) > texts
    assert fe.tts_key is None and not fe.tts_queue and svc._tts.n_active == 0
    assert not sink.events_of("error")

    # barge-in: a response in flight and a new user onset
    fe.resp = {"last": 3, "n": 0, "toks": [], "hids": []}
    svc.enqueue_audio_data("s", "user", {"audio": speech(4)})
    svc.step()
    assert fe.resp is None
    assert sink.events_of("response_interrupted")
    svc.close_session("s")
    assert svc.engine.num_active == 0
