"""Two faults of the port's synthesis pool under the duplex service, on the
CPU, with the tiny preset and seeded random weights (the port alone: no JAX
service runs here).

- A sentence too long for the pool's rows is refused on its own: the service
  drops it from its session's queue with an `error` event, and the sentences
  beside it (the same session's next one, another session's) still start
  and speak, and the pool keeps stepping. Before, `BatchedTTS.start` raised
  for the whole batch, and the service retried the same sentence on every
  step, so no pool step ever ran again.
- The service sizes the pool's rows for the longest sentence a response can
  hand it (`duplex.resp_max_tokens` tokens as prefix and again as text, each
  LLM hidden / decoder idim frames), so a sentence at that cap gets its whole
  `max_tokens` of codec tokens. Before, rows were sized for 128 frames of
  each and a long sentence was refused or cut short.
"""

import dataclasses

import numpy as np
import pytest
import torch

from freeze_omni_tpu_torch.config import flagship_system, tiny_system
from freeze_omni_tpu_torch.models import audio_llm, codec
from freeze_omni_tpu_torch.models import speech_decoder as sd
from freeze_omni_tpu_torch.runtime.service import DuplexService
from freeze_omni_tpu_torch.runtime.tts_batch import BatchedTTS, row_slots


def _service(cfg):
    g = torch.Generator().manual_seed(0)
    tts = {"decoder": sd.init_params(cfg.tts.decoder, g, device="cpu"),
           "codec": codec.init_params(cfg.tts.codec, g, device="cpu")}
    params = audio_llm.init_params(cfg.audio_llm, seed=0, device="cpu")
    return DuplexService(cfg, params=params, tts_params=tts, device="cpu")


def _cfg(dec_max_kv_len=None):
    cfg = tiny_system()
    tts = dataclasses.replace(cfg.tts, top_k=1)
    if dec_max_kv_len is not None:
        tts = dataclasses.replace(tts, decoder=dataclasses.replace(
            tts.decoder, max_kv_len=dec_max_kv_len))
    return dataclasses.replace(cfg, tts=tts)


def _sentence(svc, n_tokens, text, seed):
    """A queued sentence as the service's continuation leaves it: its text,
    one [1, 1, hidden] float32 hidden per LLM token, its generation."""
    rng = np.random.RandomState(seed)
    hidden = svc.cfg.audio_llm.llm.hidden
    hids = [rng.randn(1, 1, hidden).astype(np.float32) for _ in range(n_tokens)]
    return text, hids


@pytest.fixture(scope="module")
def tiny_service():
    svc = _service(_cfg())
    sinks = {sid: svc.open_session(sid) for sid in ("a", "b")}
    return svc, sinks


def test_a_sentence_the_pool_refuses_is_dropped_and_the_rest_speak(tiny_service):
    svc, sinks = tiny_service
    pool = svc._tts
    # 40 tokens: 160 prefix frames and 164 text frames, past the 256 slots
    # of the tiny decoder's rows
    long = _sentence(svc, 40, "x" * 40, seed=1)
    short = _sentence(svc, 3, "Hi there.", seed=2)
    fa, fb = svc.sessions["a"], svc.sessions["b"]
    fa.tts_queue += [(*long, fa.resp_gen), (*short, fa.resp_gen)]
    fb.tts_queue.append((*_sentence(svc, 4, "Hello.", seed=3), fb.resp_gen))

    steps = 0
    while (fa.tts_queue or fb.tts_queue or pool.n_active) and steps < 100:
        svc._advance_tts()
        steps += 1
    assert not fa.tts_queue and not fb.tts_queue and pool.n_active == 0
    assert pool.n_free == pool.capacity

    errors = sinks["a"].events_of("error")
    assert len(errors) == 1 and errors[0]["where"] == "synthesis"
    assert "KV slots" in errors[0]["message"]
    assert not sinks["b"].events_of("error")
    for sid in ("a", "b"):
        audio = sinks[sid].events_of("response_audio")
        assert audio and all(np.isfinite(e["pcm"]).all() for e in audio)


def test_the_service_sizes_rows_for_its_longest_sentence():
    """A sentence of resp_max_tokens tokens gets the pool's whole token
    budget (the tiny decoder's context is raised so that the bound, not the
    decoder, sets the row)."""
    cfg = _cfg(dec_max_kv_len=2048)
    svc = _service(cfg)
    pool = svc._tts
    frames = cfg.duplex.resp_max_tokens * (cfg.audio_llm.llm.hidden
                                           // cfg.tts.decoder.idim)
    assert pool.max_kv_len == row_slots(cfg.tts, frames) == 1 + 2 * frames + 64 + 8
    svc.open_session("a")
    fe = svc.sessions["a"]
    n = cfg.duplex.resp_max_tokens
    text, hids = _sentence(svc, n, "a" * (n - 1) + ".", seed=4)
    assert len(svc._prepare_sentence(text, hids)[0]) == n   # 4n text frames
    fe.tts_queue.append((text, hids, fe.resp_gen))
    svc._tts_starts(dict(svc.sessions))
    (job,) = pool.jobs.values()
    assert job.room >= cfg.tts.max_tokens


def test_row_slots_at_flagship():
    """Flagship: 64 tokens x 3584 / 896 = 256 frames of prefix and of text,
    bos, 1000 codec tokens (25 whole chunks of 40) and the margin: 1521
    slots a row (1265 before), under the decoder's 2048."""
    cfg = flagship_system()
    frames = cfg.duplex.resp_max_tokens * (cfg.audio_llm.llm.hidden
                                           // cfg.tts.decoder.idim)
    assert frames == 256
    assert row_slots(cfg.tts, frames) == 1521
    assert row_slots(cfg.tts, 128) == 1265   # BatchedTTS's own default
    # a budget that is not whole chunks rounds up to them; the decoder caps
    ragged = dataclasses.replace(cfg.tts, max_tokens=990)
    assert row_slots(ragged, frames) == 1521
    assert row_slots(cfg.tts, 1024) == cfg.tts.decoder.max_kv_len


def test_start_refuses_one_sentence_and_starts_the_others():
    cfg = _cfg()
    g = torch.Generator().manual_seed(0)
    tts = {"decoder": sd.init_params(cfg.tts.decoder, g, device="cpu"),
           "codec": codec.init_params(cfg.tts.codec, g, device="cpu")}
    pool = BatchedTTS(tts, cfg.tts, capacity=2, seed=0, device="cpu")
    rng = np.random.RandomState(5)
    idim = cfg.tts.decoder.idim
    small, big = (rng.randn(1, t, idim).astype(np.float32) for t in (6, 300))
    assert pool.start([("x", big, None), ("y", small, None),
                       ("z", small, None), ("w", small, None)]) == 2
    assert sorted(j.key for j in pool.jobs.values()) == ["y", "z"]
    (refused,) = pool.take_refused()
    assert refused[0] == "x" and "KV slots" in refused[1]
    assert pool.take_refused() == []
