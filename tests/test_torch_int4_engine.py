"""Slice parity for the int4 serving configuration: the port's ServingEngine
against the JAX engine on the committed tiny checkpoint with every layer
projection and the lm_head in grouped int4 (the JAX `quantize_llm_params(
bits=4)`, converted leaf for leaf) and an int8 KV cache.

- 16 fused dual ticks of two sessions across a KV roll: state probabilities
  within 2e-3 (as for int8, test_torch_engine.py: one int8 KV rounding flips
  on a 1-ulp activation difference, and the role prefill runs in bf16 where
  the JAX einsum dequantizes in bf16 and the port's plain K5 in f32),
  decisions at the threshold and KV lengths identical;
- then greedy respond_fast_many and a continue_segments round: text and codec
  tokens identical, PCM within 1e-4, text hiddens (bf16) within 3% of each
  row's largest magnitude.
"""

import dataclasses
import os

import jax
import numpy as np
import pytest

from freeze_omni_tpu import config as jcfg_mod
from freeze_omni_tpu.ops.quant import quantize_llm_params as jax_quantize
from freeze_omni_tpu.runtime.engine import ServingEngine as JaxEngine
from freeze_omni_tpu.utils.checkpoint import load_native
from freeze_omni_tpu_torch import config as tcfg_mod
from freeze_omni_tpu_torch import weights
from freeze_omni_tpu_torch.frontend.chunker import GatingChunker, gate_stream
from freeze_omni_tpu_torch.frontend.wav import read_wav
from freeze_omni_tpu_torch.runtime.engine import ServingEngine

ASSET = os.path.abspath(os.path.join(os.path.dirname(__file__), "..",
                                     "freeze_omni_tpu", "assets", "tiny_s2s"))
PROB_ATOL = 2e-3
BF16_ROW_TOL = 0.03
PCM_TOL = 1e-4

# session -> identity -> (wav name, statuses); 16 ticks of dual work
SCHEDULE = {
    "a": {"user": ("asr_000.wav", [None, None, "ipu_sl"] + ["ipu_cl"] * 13),
          "system": ("qa_000.wav", ["ipu_sl"] + ["ipu_cl"] * 15)},
    "b": {"user": ("asr_001.wav", [None] * 4 + ["ipu_sl"] + ["ipu_cl"] * 11),
          "system": ("qa_001.wav", [None, "ipu_sl"] + ["ipu_cl"] * 14)},
}


def _serving(cfg_mod):
    cfg = cfg_mod.load_system_config(os.path.join(ASSET, "config.json"))
    llm = dataclasses.replace(cfg.audio_llm.llm, max_kv_len=224)
    return dataclasses.replace(
        cfg, audio_llm=dataclasses.replace(cfg.audio_llm, llm=llm),
        serving=dataclasses.replace(cfg.serving, kv_quant_bits=8, kv_margin=64),
        sampling=dataclasses.replace(cfg.sampling, top_k=1),
        tts=dataclasses.replace(cfg.tts, top_k=1))


def _windows(gating_cfg):
    """Gated fbank windows from the committed dev wavs (tiled to cover the
    schedule), through the port's GatingChunker; both engines get them."""
    out = {}
    n = gating_cfg.samples_per_chunk
    for sid, per in SCHEDULE.items():
        out[sid] = {}
        for ident, (name, statuses) in per.items():
            audio = read_wav(os.path.join(ASSET, "dev_wavs", name))[0]
            audio = np.tile(audio, len(statuses) * n // len(audio) + 1)
            out[sid][ident] = gate_stream(GatingChunker(gating_cfg), audio,
                                          statuses)
    return out


@pytest.fixture(scope="module")
def engines():
    tree = load_native(os.path.join(ASSET, "params"))
    jparams = dict(tree["audiollm"])
    jparams["llm"] = jax_quantize(jparams["llm"], bits=4)
    np_params = jax.tree.map(np.asarray, jparams)
    np_tts = jax.tree.map(np.asarray, tree["tts"])
    jcfg, tcfg = _serving(jcfg_mod), _serving(tcfg_mod)
    je = JaxEngine(jcfg, params=jparams)
    te = ServingEngine(tcfg, params=weights.from_jax(np_params, device="cpu"),
                       device="cpu")
    return je, te, np_tts, weights.from_jax(np_tts, device="cpu")


def _lengths(engine):
    return [engine.store.kv_length(s) for s in range(2)]


def test_int4_dual_ticks_then_response_match_jax(engines):
    je, te, jt, tt = engines
    layers = te.core.params["llm"]["layers"]
    assert all("w_q4" in layers[p] for p in ("q", "k", "v", "o", "gate", "up", "down"))
    assert "w_q4" in te.core.params["llm"]["lm_head"]
    windows = _windows(te.cfg.duplex.gating)
    for sid in SCHEDULE:
        assert je.open_session(sid) == te.open_session(sid)
    thr = te.cfg.duplex.resp_threshold
    rolls, prev, compared = 0, None, 0
    for tick in range(16):
        for sid in SCHEDULE:
            for ident in ("user", "system"):
                items = windows[sid][ident]
                if tick < len(items):
                    feat, sl = items[tick]
                    je.submit_chunk(sid, ident, feat, sl)
                    te.submit_chunk(sid, ident, feat, sl)
        jo, to = je.tick().get("user", {}), te.tick().get("user", {})
        assert sorted(jo) == sorted(to)
        for slot in jo:
            for key in ("state_1", "state_2"):
                pj, pt = jo[slot][key], to[slot][key]
                assert abs(pj - pt) <= PROB_ATOL, (tick, slot, key, pj, pt)
                assert (pj > thr) == (pt > thr), (tick, slot, key, pj, pt)
                compared += 1
        assert _lengths(je) == _lengths(te), tick
        if prev is not None:
            rolls += sum(b < a for a, b in zip(prev, _lengths(te)))
        prev = _lengths(te)
    assert rolls >= 1 and compared >= 40

    jo = je.respond_fast_many(["a", "b"], jt, n_text=8)
    to = te.respond_fast_many(["a", "b"], tt, n_text=8)
    for sid in ("a", "b"):
        (jpcm, jtoks), (tpcm, ttoks) = jo[sid], to[sid]
        assert ttoks == jtoks, sid
        assert tpcm.shape == jpcm.shape and tpcm.shape[-1] > 0, sid
        np.testing.assert_allclose(tpcm, jpcm, rtol=PCM_TOL, atol=PCM_TOL)
    assert _lengths(je) == _lengths(te)
    last = {sid: to[sid][1][-1] for sid in to}
    jseg, tseg = je.continue_segments(last, n_steps=6), \
        te.continue_segments(last, n_steps=6)
    for sid in jseg:
        (jt_, jh, jd), (tt_, th, td) = jseg[sid], tseg[sid]
        assert tt_ == jt_ and td == jd, sid
        err = np.abs(th - jh).max(axis=1) / np.abs(jh).max(axis=1)
        assert err.max() <= BF16_ROW_TOL, err
    assert _lengths(je) == _lengths(te)
