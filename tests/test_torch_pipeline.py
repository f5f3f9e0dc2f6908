"""The port's pipeline facades against the JAX package's, on the CPU, on the
committed tiny checkpoint with greedy sampling, in two weight
configurations: float32, and int8 weight-only (`quantize_llm_params` of the
JAX package, converted leaf for leaf).

- `InferencePipeline`'s stage machine (the port of tests/test_pipeline.py's
  stage-machine test): states, state probabilities, sampled tokens, hidden
  states and KV lengths after every stage, through the audio-cache reset
  and `speech_dialogue_segment`;
- `DuplexPipeline`'s 5-tuple (the port of tests/test_pipeline.py's fork API
  test): predictions, KV lengths and pe_index after each call. The port
  advances the caches in place, so lengths are read right after each call
  instead of comparing objects; the role prefill `pre` hands out is never
  written;
- `audio_llm.reset_audio_caches`.

Tolerances: probabilities 1e-4 in float32 and 2e-3 with int8 weights
(tests/test_torch_engine.py gives the reason: the plain K1 dequantizes in
f32, the JAX einsum in bf16); hidden states 1e-3 in float32 and, with int8
weights (bf16 activations), within 3% of each row's largest magnitude
(tests/test_torch_response.py).
"""

import dataclasses
import os

import jax
import numpy as np
import pytest
import torch

from freeze_omni_tpu import config as jcfg_mod
from freeze_omni_tpu import pipeline as jpipe
from freeze_omni_tpu.models import audio_llm as jal
from freeze_omni_tpu.ops.quant import quantize_llm_params as jax_quantize
from freeze_omni_tpu.utils.checkpoint import load_native
from freeze_omni_tpu_torch import config as tcfg_mod
from freeze_omni_tpu_torch import pipeline as tpipe
from freeze_omni_tpu_torch import weights
from freeze_omni_tpu_torch.frontend.chunker import GatingChunker, gate_stream
from freeze_omni_tpu_torch.frontend.wav import read_wav
from freeze_omni_tpu_torch.models import audio_llm as tal
from freeze_omni_tpu_torch.models import qwen2 as tq

ASSET = os.path.abspath(os.path.join(os.path.dirname(__file__), "..",
                                     "freeze_omni_tpu", "assets", "tiny_s2s"))
PROB_TOL = {"f32": 1e-4, "int8": 2e-3}
HID_TOL = 1e-3
BF16_ROW_TOL = 0.03


def greedy(cfg):
    return dataclasses.replace(
        cfg, sampling=dataclasses.replace(cfg.sampling, top_k=1),
        tts=dataclasses.replace(cfg.tts, top_k=1))


def system_configs():
    path = os.path.join(ASSET, "config.json")
    return (greedy(jcfg_mod.load_system_config(path)),
            greedy(tcfg_mod.load_system_config(path)))


@pytest.fixture(scope="module")
def tree():
    return load_native(os.path.join(ASSET, "params"))


def audiollm_params(tree, quant: bool):
    """(JAX params, the port's params on the CPU) of the checkpoint's
    audio LLM, the LLM int8 weight-only when `quant`."""
    jp = dict(tree["audiollm"])
    if quant:
        jp["llm"] = jax_quantize(jp["llm"])
    return jp, weights.from_jax(jax.tree.map(np.asarray, jp), device="cpu")


def user_windows(cfg, n=4):
    """Gated fbank windows ([1, T, 80]) of one IPU of a committed dev wav."""
    audio = read_wav(os.path.join(ASSET, "dev_wavs", "asr_000.wav"))[0][8000:]
    items = gate_stream(GatingChunker(cfg.duplex.gating), audio,
                        [None, "ipu_sl"] + ["ipu_cl"] * (n - 1))
    return [feat for feat, _ in items][:n]


def hiddens_close(th, jh, quant):
    th, jh = np.asarray(th, np.float32), np.asarray(jh, np.float32)
    assert th.shape == jh.shape
    if quant:
        rows_t, rows_j = th.reshape(-1, th.shape[-1]), jh.reshape(-1, jh.shape[-1])
        err = np.abs(rows_t - rows_j).max(1) / np.abs(rows_j).max(1)
        assert err.max() <= BF16_ROW_TOL, err
    else:
        np.testing.assert_allclose(th, jh, rtol=HID_TOL, atol=HID_TOL)


@pytest.mark.parametrize("weights_kind", ["f32", "int8"])
def test_stage_machine_matches_jax(tree, weights_kind):
    quant = weights_kind == "int8"
    jcfg, tcfg = system_configs()
    jp, tp = audiollm_params(tree, quant)
    jpl = jpipe.InferencePipeline(jcfg, params=jp)
    tpl = tpipe.InferencePipeline(tcfg, params=tp, device="cpu")
    wins = user_windows(tcfg)
    role_before = tq.copy_cache(tpl.core.role_kv("You are a test."))

    def same(jo, to, what):
        assert to["stat"] == jo["stat"], what
        assert int(to["caches"].kv.length[0]) == int(np.asarray(jo["caches"].kv.length)[0]), what
        assert to.get("past_tokens") == jo.get("past_tokens"), what
        if "state_probs" in jo:
            np.testing.assert_allclose(to["state_probs"], jo["state_probs"],
                                       atol=PROB_TOL[weights_kind], err_msg=what)
        if "hidden_state" in jo:
            hiddens_close(to["hidden_state"], jo["hidden_state"], quant)

    jo = jpl.speech_dialogue(None, stat="pre", role="You are a test.")
    to = tpl.speech_dialogue(None, stat="pre", role="You are a test.")
    same(jo, to, "pre")
    for i, w in enumerate(wins[:2]):
        jo, to = jpl.speech_dialogue(w, **jo), tpl.speech_dialogue(w, **to)
        same(jo, to, f"chunk {i}")
        assert to["state_probs"].shape == (3,)
    # the caller nulls the audio-cache keys: fresh encoder/adapter caches,
    # the KV kept, and the next chunk starts an IPU again
    for o in (jo, to):
        o["adapter_cache"] = o["encoder_cache"] = None
    jo, to = jpl.speech_dialogue(wins[2], **jo), tpl.speech_dialogue(wins[2], **to)
    same(jo, to, "chunk after the audio-cache reset")
    assert int(to["caches"].enc_user.pe_index[0]) == int(
        np.asarray(jo["caches"].enc_user.pe_index)[0])
    for o in (jo, to):
        o["stat"] = "dialog_ss"
    jo, to = jpl.speech_dialogue(None, **jo), tpl.speech_dialogue(None, **to)
    same(jo, to, "dialog_ss")
    assert to["hidden_state"].shape == (1, 1, tcfg.audio_llm.llm.hidden)
    for k in range(2):
        if jo["stat"] != "dialog_cs":
            break
        jo, to = jpl.speech_dialogue(None, **jo), tpl.speech_dialogue(None, **to)
        same(jo, to, f"dialog_cs {k}")
    for o in (jo, to):
        o["stat"] = "dialog_cs"
    jo = jpl.speech_dialogue_segment(jo, n_steps=6)
    to = tpl.speech_dialogue_segment(to, n_steps=6)
    same(jo, to, "segment")
    assert to["segment_tokens"] == [int(t) for t in jo["segment_tokens"]]
    assert to["text"] == jo["text"]
    hiddens_close(to["segment_hiddens"], jo["segment_hiddens"], quant)
    # 'pre' handed out a copy: the shared role prefill was never written
    role = tpl.core.role_kv("You are a test.")
    assert torch.equal(role.length, role_before.length)
    assert torch.equal(role.k, role_before.k) and torch.equal(role.v, role_before.v)


@pytest.mark.parametrize("weights_kind", ["f32", "int8"])
def test_fork_tuple_api_matches_jax(tree, weights_kind):
    quant = weights_kind == "int8"
    jcfg, tcfg = system_configs()
    jp, tp = audiollm_params(tree, quant)
    jpl = jpipe.DuplexPipeline(jcfg, params=jp)
    tpl = tpipe.DuplexPipeline(tcfg, params=tp, device="cpu")
    jr = jpl.speech_dialogue(None, identity="", status="pre", role="Test prompt.")
    tr = tpl.speech_dialogue(None, identity="", status="pre", role="Test prompt.")
    assert tr[0] is None and tr[2:] == (None, None, None)
    role = tr[1]
    role_before = tq.copy_cache(role)
    base = int(role.length[0])
    assert base == int(np.asarray(jr[1].length)[0]) > 0
    # the role prefill is shared: the caller copies it before the first chunk
    kv = tq.copy_cache(role)
    jkv = jr[1]
    wins = user_windows(tcfg)
    jc = {"user": (None, None, 0), "system": (None, None, 0)}
    tc = dict(jc)
    calls = [("user", "ipu_sl", wins[0]), ("user", "ipu_cl", wins[1]),
             ("system", "ipu_sl", wins[2]), ("user", "ipu_cl", wins[3]),
             ("system", "ipu_cl", wins[1])]
    grew = []
    for identity, status, w in calls:
        jpred, jkv, jadp, jenc, jpe = jpl.speech_dialogue(
            w, identity, status, past_key_values=jkv, adapter_cache=jc[identity][0],
            encoder_cache=jc[identity][1], pe_index=jc[identity][2])
        before = int(kv.length[0])
        tpred, tkv, tadp, tenc, tpe = tpl.speech_dialogue(
            w, identity, status, past_key_values=kv, adapter_cache=tc[identity][0],
            encoder_cache=tc[identity][1], pe_index=tc[identity][2])
        assert tkv is kv   # advanced in place and handed back
        grew.append(int(kv.length[0]) - before)
        assert int(kv.length[0]) == int(np.asarray(jkv.length)[0]), (identity, status)
        jc[identity], tc[identity] = (jadp, jenc, jpe), (tadp, tenc, tpe)
        if identity == "user":
            assert set(tpred) == {"state_1", "state_2"} and isinstance(tpe, int)
            assert tpe == int(jpe)
            for key in tpred:
                assert abs(tpred[key] - jpred[key]) <= PROB_TOL[weights_kind], key
        else:
            assert tpred is None and jpred is None
            assert int(tpe[0]) == int(np.asarray(jpe)[0])
    # chat prefix + 4 LLM tokens on ipu_sl, 4 on ipu_cl
    assert grew[0] == 4 + len(tpl.core.chat.user_prefix_ids) and grew[1] == 4
    assert tc["user"][2] == 12   # three user windows x encoder chunk_size 4
    assert torch.equal(role.length, role_before.length)
    assert torch.equal(role.k, role_before.k) and torch.equal(role.v, role_before.v)
    with pytest.raises(ValueError, match="system role"):
        tpl.speech_dialogue(wins[0], "user", "ipu_sl")


def test_reset_audio_caches_matches_jax():
    jcfg, tcfg = system_configs()
    jc = jal.init_session(jcfg.audio_llm, 2)
    tc = tal.init_session(tcfg.audio_llm, 2, device="cpu")
    for state in (tc.enc_user, tc.enc_system):
        state.k_cache.fill_(1.0)
        state.pe_index.fill_(7)
    for state in (tc.adp_user, tc.adp_system):
        state.c2.fill_(1.0)
    tc.kv.length.fill_(5)
    jr = jal.reset_audio_caches(jcfg.audio_llm, jc)
    tr = tal.reset_audio_caches(tcfg.audio_llm, tc)
    assert tr.kv is tc.kv and int(tr.kv.length[0]) == 5   # the KV is kept
    for name in ("enc_user", "adp_user", "enc_system", "adp_system"):
        tstate, jstate = getattr(tr, name), getattr(jr, name)
        for t, j in zip(tstate, jstate):
            if j is None:
                assert t is None
                continue
            assert tuple(t.shape) == tuple(j.shape), name
            assert str(t.dtype).split(".")[-1] == str(j.dtype), name
            assert not t.any(), name
    bf = tal.init_session(tcfg.audio_llm, 1, kv_dtype=torch.bfloat16, device="cpu")
    assert tal.reset_audio_caches(tcfg.audio_llm, bf).enc_user.k_cache.dtype \
        == torch.bfloat16   # the session's dtype is kept
