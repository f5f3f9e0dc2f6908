"""Slice parity: the PyTorch port's duplex serving tick against the JAX engine.

Both engines are built from the committed tiny checkpoint with int8 LLM
weights (the JAX `quantize_llm_params`, converted leaf for leaf) and an int8
KV cache, with a lowered `max_kv_len` so the sliding-window roll fires. Two
sessions with the same role get the same user and system fbank windows, cut
from committed dev wavs by each package's own GatingChunker (with onset
replay on `ipu_sl`), and run fused dual ticks across the roll. The windows
of the two chunkers agree within the fbank tolerance (see
test_torch_frontend.py); both engines are then fed the port's windows, so the
comparison isolates the model.
"""

import dataclasses
import os

import jax
import numpy as np
import pytest
import torch

from freeze_omni_tpu import config as jcfg
from freeze_omni_tpu.frontend.chunker import GatingChunker as JaxChunker
from freeze_omni_tpu.ops.quant import quantize_llm_params as jax_quantize
from freeze_omni_tpu.runtime.engine import ServingEngine as JaxEngine
from freeze_omni_tpu.utils.checkpoint import load_native
from freeze_omni_tpu_torch import config as tcfg
from freeze_omni_tpu_torch import weights
from freeze_omni_tpu_torch.frontend.chunker import GatingChunker, gate_stream
from freeze_omni_tpu_torch.frontend.wav import read_wav
from freeze_omni_tpu_torch.models import adapter, audio_llm, encoder, qwen2
from freeze_omni_tpu_torch.runtime.engine import CapacityError, ServingEngine
from freeze_omni_tpu_torch.runtime.session import SessionStore

ASSET = os.path.abspath(os.path.join(os.path.dirname(__file__), "..",
                                     "freeze_omni_tpu", "assets", "tiny_s2s"))
WAVS = os.path.join(ASSET, "dev_wavs")

# A 1-ulp difference in an activation can flip one int8 KV rounding (the
# cache is re-quantized on every append, and the role prefill runs in bf16
# because the int8 embedding table yields bf16), so the state probabilities
# agree to about 1e-3 (1.5e-3 at most on this schedule), not to float32 rounding.
PROB_ATOL = 2e-3


def _serving(cfg_mod):
    cfg = cfg_mod.load_system_config(os.path.join(ASSET, "config.json"))
    llm = dataclasses.replace(cfg.audio_llm.llm, max_kv_len=224)
    return dataclasses.replace(
        cfg, audio_llm=dataclasses.replace(cfg.audio_llm, llm=llm),
        serving=dataclasses.replace(cfg.serving, kv_quant_bits=8, kv_margin=64))


def _audio(names):
    return np.concatenate([read_wav(os.path.join(WAVS, n))[0] for n in names])


# session -> identity -> (wav names, statuses)
SCHEDULE = {
    "a": {"user": (["asr_000.wav", "asr_001.wav"],
                   [None, None, "ipu_sl"] + ["ipu_cl"] * 5),
          "system": (["qa_000.wav", "qa_001.wav", "qa_002.wav"],
                     ["ipu_sl"] + ["ipu_cl"] * 9)},
    "b": {"user": (["asr_002.wav", "asr_003.wav"],
                   [None] * 4 + ["ipu_sl"] + ["ipu_cl"] * 6),
          "system": (["qa_003.wav", "qa_004.wav"],
                     [None, "ipu_sl"] + ["ipu_cl"] * 7)},
}


def jax_chunker(gating_cfg):
    """The JAX package's GatingChunker on its JAX fbank (its optional native
    C++ path is not what the port mirrors)."""
    c = JaxChunker(gating_cfg)
    c._native = None
    c.reset()
    return c


def _streams(chunker_cls, gating_cfg):
    return {sid: {ident: gate_stream(chunker_cls(gating_cfg), _audio(names), st)
                  for ident, (names, st) in per.items()}
            for sid, per in SCHEDULE.items()}


@pytest.fixture(scope="module")
def engines():
    tree = load_native(os.path.join(ASSET, "params"))["audiollm"]
    jparams = dict(tree)
    jparams["llm"] = jax_quantize(tree["llm"])
    np_params = jax.tree.map(np.asarray, jparams)
    jcfg_ = _serving(jcfg)
    tcfg_ = _serving(tcfg)
    je = JaxEngine(jcfg_, params=jparams)
    te = ServingEngine(tcfg_, params=weights.from_jax(np_params, device="cpu"),
                       device="cpu")
    return je, te, jcfg_, tcfg_


def test_dual_ticks_match_jax_across_kv_roll(engines):
    je, te, jcfg_, tcfg_ = engines
    j_items = _streams(jax_chunker, jcfg_.duplex.gating)
    t_items = _streams(GatingChunker, tcfg_.duplex.gating)
    for sid in SCHEDULE:
        for ident in ("user", "system"):
            assert len(j_items[sid][ident]) == len(t_items[sid][ident])
            for (fj, slj), (ft, slt) in zip(j_items[sid][ident],
                                            t_items[sid][ident]):
                assert slj == slt
                # log-mel bins within 40 dB of the frame peak: 1e-4; quieter
                # bins sit below float32 FFT rounding in both packages
                loud = fj > fj.max(axis=-1, keepdims=True) - np.log(1e4)
                assert np.abs(ft - fj)[loud].max() <= 1e-4
        assert je.open_session(sid) == te.open_session(sid)

    thr = jcfg_.duplex.resp_threshold
    rolls = 0
    prev = None
    n_ticks = max(len(v) for per in t_items.values() for v in per.values())
    assert n_ticks >= 12
    for tick in range(n_ticks):
        for sid in SCHEDULE:
            for ident in ("user", "system"):
                if tick < len(t_items[sid][ident]):
                    feat, sl = t_items[sid][ident][tick]
                    je.submit_chunk(sid, ident, feat, sl)
                    te.submit_chunk(sid, ident, feat, sl)
        jo = je.tick().get("user", {})
        to = te.tick().get("user", {})
        assert sorted(jo) == sorted(to)
        for slot in jo:
            for key in ("state_1", "state_2"):
                pj, pt = jo[slot][key], to[slot][key]
                assert abs(pj - pt) <= PROB_ATOL, (tick, slot, key, pj, pt)
                if abs(pj - thr) > PROB_ATOL:
                    assert (pj > thr) == (pt > thr), (tick, slot, key)
        j_len = [je.store.kv_length(s) for s in range(2)]
        t_len = [te.store.kv_length(s) for s in range(2)]
        assert j_len == t_len, (tick, j_len, t_len)
        assert list(te._len_host) == t_len
        if prev is not None:
            rolls += sum(b < a for a, b in zip(prev, t_len))
        prev = t_len
    assert rolls >= 1


def test_engine_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; the no-card path is not reachable")
    with pytest.raises(RuntimeError, match="CUDA"):
        ServingEngine(tcfg.tiny_system())


_NO_DEVICE_ENTRY_POINTS = {
    "audio_llm.init_params": lambda c: audio_llm.init_params(c),
    "audio_llm.init_session": lambda c: audio_llm.init_session(c),
    "SessionStore": lambda c: SessionStore(c, 1),
    "qwen2.init_cache": lambda c: qwen2.init_cache(c.llm),
    "encoder.init_state": lambda c: encoder.init_state(c.encoder),
    "adapter.init_state": lambda c: adapter.init_state(c.adapter),
}


@pytest.mark.parametrize("name", sorted(_NO_DEVICE_ENTRY_POINTS))
def test_entry_points_default_to_card_and_raise_without_one(name):
    """device=None means the CUDA card: without one, every allocating entry
    point raises instead of building its tensors on the host."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; the no-card path is not reachable")
    with pytest.raises(RuntimeError, match="CUDA"):
        _NO_DEVICE_ENTRY_POINTS[name](tcfg.tiny_system().audio_llm)


def test_engine_session_lifecycle_and_deferred_delivery(monkeypatch):
    """close/reopen reuses the slot and re-seeds it from the role prefill;
    tick_submit defers the user predictions and the callbacks to deliver(),
    which delivers once; a system-only tick delivers nothing; the host KV
    mirror tracks the device lengths; device OOM surfaces as CapacityError."""
    cfg = tcfg.tiny_system()
    te = ServingEngine(cfg, device="cpu")
    assert te.open_session("a") == 0 and te.open_session("b") == 1
    for sid in ("a", "a", "never-opened"):
        te.close_session(sid)
    assert te.num_active == 1
    seen = []
    assert te.open_session("c", on_prediction=lambda k, p: seen.append((k, p))) == 0
    prefix = int(te.store.prefix_len[0])
    assert prefix > 0 and te.store.kv_length(0) == prefix
    assert float(te.store.caches.enc_user.k_cache[:, 0].abs().max()) == 0

    rng = np.random.RandomState(0)
    window = lambda: rng.randn(1, cfg.duplex.gating.frames_per_step, 80)  # noqa: E731
    te.submit_chunk("c", "user", window(), True)
    te.submit_chunk("b", "user", window(), False)
    pending = te.tick_submit()
    assert seen == []
    out = pending.deliver()
    assert sorted(out["user"]) == [0, 1]
    assert seen == [("user", out["user"][0])]
    assert pending.deliver() == {}
    te.submit_chunk("b", "system", window(), True)
    assert te.tick() == {}
    assert list(te._len_host) == te.store.caches.kv.length.tolist()

    def oom(*args, **kwargs):
        raise torch.cuda.OutOfMemoryError("out of memory")

    monkeypatch.setattr("freeze_omni_tpu_torch.models.audio_llm.recognize_step", oom)
    te.submit_chunk("c", "user", window(), False)
    with pytest.raises(CapacityError) as err:
        te.tick()
    assert err.value.active_sessions == 2


def test_session_store_rows_roundtrip():
    cfg = tcfg.tiny_system().audio_llm
    store = SessionStore(cfg, 2, kv_quant_bits=8, device="cpu")
    a = store.alloc("a")
    b = store.alloc("b")
    row = store.gather_slot(a)
    for leaf in (row.kv.k, row.kv.k_scale, row.enc_user.k_cache):
        leaf.fill_(3)
    row.kv.length.fill_(7)
    store.scatter_slot(b, row)
    assert store.kv_length(b) == 7 and store.kv_length(a) == 0
    assert int(store.caches.kv.k[:, b].min()) == 3
    assert float(store.caches.enc_user.k_cache[:, a].abs().max()) == 0
    store.free("b")
    assert store.alloc("c") == b and store.kv_length(b) == 0
    assert store.kv_capacity == cfg.llm.max_kv_len
