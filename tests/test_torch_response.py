"""Slice parity for the spoken-response path: the PyTorch port against the
JAX package, on the CPU.

- `fastpath.first_response` on `tiny_system()` random weights (whose speech
  decoder uses prefix KV), two rows with different contexts;
- the engine's `respond_fast_many` for two sessions, then `continue_segments`
  rounds, on the committed tiny checkpoint, in two configurations: float32
  weights with a float32 KV cache, and int8 weights with an int8 KV cache.

Sampling is greedy (text top_k = 1, codec top_k = 1), so text and codec
tokens must be identical, and the KV lengths equal after every call. PCM
agrees to 1e-4 (the vocoder tolerance of tests/test_tts_batch.py). Text
hidden states agree to 1e-3 in float32 (two LLM layers, sums in another
order). With int8 weights they are bfloat16: the int8 embedding table yields
bf16, and the JAX einsum dequantizes the weights in bf16 where the port's
plain K1 dequantizes in f32 (the kernel's arithmetic), so each row is held
within 3% of its largest magnitude (measured: 1.6%, a few bf16 ulps).
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from freeze_omni_tpu import config as jcfg_mod
from freeze_omni_tpu.duplex.responder import split_sentences as jax_split
from freeze_omni_tpu.models import audio_llm as jal
from freeze_omni_tpu.models import codec as jcodec
from freeze_omni_tpu.models import qwen2 as jq
from freeze_omni_tpu.models import speech_decoder as jsd
from freeze_omni_tpu.ops.quant import quantize_llm_params as jax_quantize
from freeze_omni_tpu.pipeline import post_process as jax_post_process
from freeze_omni_tpu.runtime import fastpath as jfast
from freeze_omni_tpu.runtime.engine import ServingEngine as JaxEngine
from freeze_omni_tpu.utils.checkpoint import load_native
from freeze_omni_tpu_torch import config as tcfg_mod
from freeze_omni_tpu_torch import weights
from freeze_omni_tpu_torch.duplex.responder import SENTENCE_SUFFIXES, split_sentences
from freeze_omni_tpu_torch.frontend.chunker import GatingChunker, gate_stream
from freeze_omni_tpu_torch.frontend.wav import read_wav
from freeze_omni_tpu_torch.models import audio_llm as tal
from freeze_omni_tpu_torch.models import qwen2 as tq
from freeze_omni_tpu_torch.pipeline import post_process
from freeze_omni_tpu_torch.runtime import fastpath as tfast
from freeze_omni_tpu_torch.runtime.engine import ServingEngine
from freeze_omni_tpu_torch.runtime.session import SessionStore
from freeze_omni_tpu_torch.utils.tokenizer import ByteTokenizer

ASSET = os.path.abspath(os.path.join(os.path.dirname(__file__), "..",
                                     "freeze_omni_tpu", "assets", "tiny_s2s"))
HID_TOL = 1e-3
BF16_ROW_TOL = 0.03
PCM_TOL = 1e-4


def _greedy(cfg):
    return dataclasses.replace(
        cfg, sampling=dataclasses.replace(cfg.sampling, top_k=1),
        tts=dataclasses.replace(cfg.tts, top_k=1))


def test_first_response_matches_jax():
    jsys, tsys = _greedy(jcfg_mod.tiny_system()), _greedy(tcfg_mod.tiny_system())
    acfg = jsys.audio_llm
    assert jsys.tts.decoder.use_prefix_kv
    k1, k2 = jax.random.split(jax.random.PRNGKey(7))
    jp = jax.tree.map(np.asarray, jal.init_params(jax.random.PRNGKey(0), acfg))
    jt = jax.tree.map(np.asarray, {"decoder": jsd.init_params(k1, jsys.tts.decoder),
                                   "codec": jcodec.init_params(k2, jsys.tts.codec)})
    tp, tt = weights.from_jax(jp, device="cpu"), weights.from_jax(jt, device="cpu")
    ctx = np.array([[5, 6, 7, 8, 9, 10, 11, 12], [40, 41, 42, 43, 44, 45, 46, 47]])
    ids = np.array([[1, 2, 3], [1, 2, 3]])
    gt = np.zeros((2, 1, len(jsys.tts.codec.global_tokens)), np.int32)
    n_codec = jsys.tts.codec_chunk_size + jsys.tts.codec_padding_size
    kw = dict(n_text=7, n_codec=n_codec, top_k=1, eod_id=-1, penalty_window=10,
              penalty=jsys.tts.penalty)

    jkv = jq.init_cache(acfg.llm, 2, dtype=jnp.float32)
    jkv = jal.prefill_tokens(jp, acfg, jnp.asarray(ctx), jkv)
    j = jfast.first_response(jp, jt, acfg, jsys.tts.decoder, jsys.tts.codec,
                             jnp.asarray(ids), jkv, jax.random.PRNGKey(0),
                             jsys.sampling, global_tokens=jnp.asarray(gt), **kw)
    tkv = tq.init_cache(tsys.audio_llm.llm, 2, dtype=torch.float32, device="cpu")
    with torch.no_grad():
        tkv = tal.prefill_tokens(tp, tsys.audio_llm, torch.from_numpy(ctx), tkv)
        t = tfast.first_response(tp, tt, tsys.audio_llm, tsys.tts.decoder,
                                 tsys.tts.codec, torch.from_numpy(ids), tkv,
                                 torch.Generator().manual_seed(0), tsys.sampling,
                                 global_tokens=torch.from_numpy(gt).long(), **kw)
    j_pcm, j_toks, j_done, j_ctoks, j_nv, j_kv = j
    t_pcm, t_toks, t_done, t_ctoks, t_nv, t_kv = t
    for name, a, b in (("text tokens", t_toks, j_toks), ("done", t_done, j_done),
                       ("codec tokens", t_ctoks, j_ctoks), ("n_valid", t_nv, j_nv),
                       ("kv length", t_kv.length, j_kv.length)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=name)
    assert t_toks.shape == (2, 8) and int(t_kv.length[0]) == 8 + 3 + 7
    assert tuple(t_pcm.shape) == j_pcm.shape
    np.testing.assert_allclose(t_pcm.numpy(), np.asarray(j_pcm), rtol=PCM_TOL,
                               atol=PCM_TOL)


# ---------------------------------------------------------------------------
# the engine on the tiny checkpoint
# ---------------------------------------------------------------------------


def _serving(cfg_mod, quant):
    cfg = _greedy(cfg_mod.load_system_config(os.path.join(ASSET, "config.json")))
    return dataclasses.replace(cfg, serving=dataclasses.replace(
        cfg.serving, kv_quant_bits=8 if quant else None))


def _windows(gating_cfg):
    """User windows of one IPU per session from committed dev wavs, cut past their
    leading silence, through the port's GatingChunker (the engine parity test
    holds the two chunkers together; here both engines get the same
    windows)."""
    out = {}
    for sid, wav, start in (("a", "asr_000.wav", 8000), ("b", "asr_001.wav", 16000)):
        audio = read_wav(os.path.join(ASSET, "dev_wavs", wav))[0][start:]
        out[sid] = gate_stream(GatingChunker(gating_cfg), audio,
                               [None, "ipu_sl", "ipu_cl"])
    return out


@pytest.fixture(scope="module", params=["f32", "int8"])
def engines(request):
    quant = request.param == "int8"
    tree = load_native(os.path.join(ASSET, "params"))
    jparams = dict(tree["audiollm"])
    if quant:
        jparams["llm"] = jax_quantize(jparams["llm"])
    np_llm = jax.tree.map(np.asarray, jparams)
    np_tts = jax.tree.map(np.asarray, tree["tts"])
    jcfg, tcfg = _serving(jcfg_mod, quant), _serving(tcfg_mod, quant)
    je = JaxEngine(jcfg, params=jparams)
    te = ServingEngine(tcfg, params=weights.from_jax(np_llm, device="cpu"),
                       device="cpu")
    windows = _windows(tcfg.duplex.gating)
    for sid in windows:
        assert je.open_session(sid) == te.open_session(sid)
    assert len(windows["a"]) == len(windows["b"]) >= 3
    for tick in range(len(windows["a"])):
        for sid, items in windows.items():
            feat, sl = items[tick]
            je.submit_chunk(sid, "user", feat, sl)
            te.submit_chunk(sid, "user", feat, sl)
        je.tick()
        te.tick()
    return je, te, np_tts, weights.from_jax(np_tts, device="cpu")


def _hiddens_close(th, jh, bf16):
    if bf16:
        err = np.abs(th - jh).max(axis=1) / np.abs(jh).max(axis=1)
        assert err.max() <= BF16_ROW_TOL, err
    else:
        np.testing.assert_allclose(th, jh, rtol=HID_TOL, atol=HID_TOL)


def _lengths(engine):
    return [engine.store.kv_length(s) for s in range(2)]


def test_respond_fast_many_and_continue_segments_match_jax(engines):
    je, te, jt, tt = engines
    assert _lengths(je) == _lengths(te)
    jo = je.respond_fast_many(["a", "b"], jt, n_text=8)
    to = te.respond_fast_many(["a", "b"], tt, n_text=8)
    assert sorted(jo) == sorted(to) == ["a", "b"]
    for sid in jo:
        (jpcm, jtoks), (tpcm, ttoks) = jo[sid], to[sid]
        assert ttoks == jtoks and len(ttoks) == 9, sid
        assert tpcm.shape == jpcm.shape and tpcm.shape[-1] > 0, sid
        np.testing.assert_allclose(tpcm, jpcm, rtol=PCM_TOL, atol=PCM_TOL)
        assert np.abs(tpcm).max() <= 1.0
    assert _lengths(je) == _lengths(te)
    assert list(te._len_host) == _lengths(te)

    last = {sid: to[sid][1][-1] for sid in to}
    for _ in range(2):
        jseg = je.continue_segments(last, n_steps=6)
        tseg = te.continue_segments(last, n_steps=6)
        assert sorted(jseg) == sorted(tseg)
        for sid in jseg:
            (jt_, jh, jd), (tt_, th, td) = jseg[sid], tseg[sid]
            assert tt_ == jt_ and td == jd, sid
            assert th.shape == jh.shape == (len(tt_), te.cfg.audio_llm.llm.hidden)
            _hiddens_close(th, jh, te.store.kv_quant_bits is not None)
        assert _lengths(je) == _lengths(te)
        last = {sid: tseg[sid][0][-1] for sid in tseg}
    # a closed session drops out of the batch and its row is not written back
    for e in (je, te):
        e.close_session("b")
    jseg = je.continue_segments(last, n_steps=2)
    tseg = te.continue_segments(last, n_steps=2)
    assert list(tseg) == list(jseg) == ["a"] and tseg["a"][0] == jseg["a"][0]
    assert _lengths(je) == _lengths(te)


def test_embed_tokens_matches_jax(engines):
    je, te, _, _ = engines
    ids = [1, 2, 3, 250, 7]
    np.testing.assert_array_equal(te.embed_tokens(ids), je.embed_tokens(ids))


def test_session_store_row_subsets():
    """gather_kv_many copies rows in order; scatter_kv_many writes the rows
    named by `rows` into `slots` and ignores padded rows."""
    cfg = tcfg_mod.tiny_system().audio_llm
    store = SessionStore(cfg, 3, device="cpu")
    for i, sid in enumerate("xyz"):
        store.alloc(sid)
        store.caches.kv.k[:, i].fill_(i + 1)
        store.caches.kv.length[i] = 10 * (i + 1)
    kv = store.gather_kv_many([2, 0, 2, 2])          # padded to 4 rows
    assert kv.length.tolist() == [30, 10, 30, 30]
    kv.k.fill_(9)
    kv.length.copy_(torch.tensor([7, 8, 9, 9], dtype=torch.int32))
    store.scatter_kv_many([1, 0], kv, rows=[1, 0])
    assert store.caches.kv.length.tolist() == [7, 8, 30]
    assert int(store.caches.kv.k[:, 2].max()) == 3   # untouched row
    one = store.gather_kv(2)
    one.length.fill_(5)
    store.scatter_kv(2, one)
    assert store.kv_length(2) == 5


def test_split_sentences_and_post_process_match_jax():
    tok = ByteTokenizer(512)
    ids = tok.encode("Hi there. How are you?") + [tok.eod_id]
    hids = [np.full((1, 1, 2), i, np.float32) for i in range(len(ids))]
    jb, tb = ([], []), ([], [])
    j = jax_split(tok, tok.eod_id, *jb, ids[:5], hids[:5]) + \
        jax_split(tok, tok.eod_id, *jb, ids[5:], hids[5:])
    t = split_sentences(tok, tok.eod_id, *tb, ids[:5], hids[:5]) + \
        split_sentences(tok, tok.eod_id, *tb, ids[5:], hids[5:])
    assert [s for s, _ in t] == [s for s, _ in j] and len(t) == 2
    assert [[float(h[0, 0, 0]) for h in hs] for _, hs in t] == \
        [[float(h[0, 0, 0]) for h in hs] for _, hs in j]
    assert tb == ([], []) and "." in SENTENCE_SUFFIXES
    for text in ("1. first (a)  2. second", "你好、世界", "done,", "**bold** text\n",
                 "ok!", ""):
        assert post_process(text) == jax_post_process(text), text
