"""Streaming synthesis of the PyTorch port (tts.py, runtime/tts_batch.py)
against the JAX package, on the CPU.

`find_min_seam` is the same numpy code in both packages, so its splices are
identical. Synthesis runs greedily (top_k = 1), where the AR token stream
does not depend on how it is cut into segments: the port's StreamingTTS must
then yield the JAX StreamingTTS's segments, and the port's BatchedTTS pool
the port's StreamingTTS PCM, solo and beside other jobs, as
tests/test_tts_batch.py holds the JAX pool. PCM is float32 through the same
vocoder windows; the two packages differ only in the order of f32 sums, so
samples agree to 1e-4 (the tolerance of tests/test_tts_batch.py).
"""

import dataclasses

import jax
import numpy as np
import pytest

from freeze_omni_tpu.config import tiny_system as jax_tiny
from freeze_omni_tpu.models import codec as jcodec
from freeze_omni_tpu.models import speech_decoder as jsd
from freeze_omni_tpu.tts import StreamingTTS as JaxStreamingTTS
from freeze_omni_tpu.tts import find_min_seam as jax_seam
from freeze_omni_tpu_torch import weights
from freeze_omni_tpu_torch.config import tiny_system
from freeze_omni_tpu_torch.runtime.tts_batch import BatchedTTS
from freeze_omni_tpu_torch.tts import StreamingTTS, bucket_pad, find_min_seam

TOL = 1e-4


@pytest.fixture(scope="module")
def tts():
    """(jax cfg, port cfg, jax params, port params): the tiny system's
    decoder and codec, greedy, with a 48-token budget."""
    jcfg = dataclasses.replace(jax_tiny().tts, top_k=1, max_tokens=48)
    tcfg = dataclasses.replace(tiny_system().tts, top_k=1, max_tokens=48)
    k1, k2 = jax.random.split(jax.random.PRNGKey(3))
    jp = jax.tree.map(np.asarray, {"decoder": jsd.init_params(k1, jcfg.decoder),
                                   "codec": jcodec.init_params(k2, jcfg.codec)})
    return jcfg, tcfg, jp, weights.from_jax(jp, device="cpu")


@pytest.mark.parametrize("scale", [0.001, 1.0])
def test_find_min_seam_is_exact(scale):
    rng = np.random.RandomState(int(scale * 10))
    buf = rng.randn(1, 1, 50).astype(np.float32)
    syn = (rng.randn(1, 1, 900) * scale).astype(np.float32)
    j_buf, j_emit = jax_seam(buf, syn, 241, 0.01)
    t_buf, t_emit = find_min_seam(buf, syn, 241, 0.01)
    np.testing.assert_array_equal(t_buf, j_buf)
    assert (t_emit is None) == (j_emit is None) == (scale == 1.0)
    if j_emit is not None:
        np.testing.assert_array_equal(t_emit, j_emit)


def test_bucket_pad_masks_the_padding():
    x = np.ones((2, 5, 3), np.float32)
    xb, m = bucket_pad(x, 4, "cpu")
    assert tuple(xb.shape) == (2, 8, 3) and m.numpy().sum(1).tolist() == [5, 5]
    assert float(xb[:, 5:].abs().max()) == 0


def _run(tts, hidden, prefix):
    return [np.asarray(s) for s in tts.run(hidden, prefix=prefix)]


@pytest.mark.parametrize("seam_threshold", [0.01, 10.0])
def test_streaming_tts_matches_jax(tts, seam_threshold):
    """At the default threshold the loud random vocoder finds no quiet seam
    and everything leaves in the final flush; a high threshold splices at
    every window."""
    jcfg, tcfg, jp, tp = tts
    jcfg = dataclasses.replace(jcfg, seam_threshold=seam_threshold)
    tcfg = dataclasses.replace(tcfg, seam_threshold=seam_threshold)
    rng = np.random.RandomState(0)
    hidden = rng.randn(1, 7, tcfg.decoder.idim).astype(np.float32)
    prefix = rng.randn(1, 3, tcfg.decoder.idim).astype(np.float32)
    j = _run(JaxStreamingTTS(jp, jcfg, seed=0), hidden, prefix)
    t = _run(StreamingTTS(tp, tcfg, seed=0, device="cpu"), hidden, prefix)
    assert [s.shape for s in t] == [s.shape for s in j]
    assert len(j) >= (4 if seam_threshold > 1 else 1)
    for a, b in zip(t, j):
        np.testing.assert_allclose(a, b, rtol=TOL, atol=TOL)


def _run_pool(pool, jobs):
    """Drive the pool until it drains; returns {key: concatenated pcm} and
    checks that every job ends with exactly one final entry."""
    assert pool.start(jobs) == len(jobs)
    chunks, finals = {}, {}
    for _ in range(200):
        for key, lst in pool.step().items():
            for pcm, final in lst:
                chunks.setdefault(key, []).append(pcm)
                finals[key] = finals.get(key, 0) + int(final)
        if pool.n_active == 0:
            break
    assert pool.n_active == 0 and pool.n_free == pool.capacity
    assert finals == {key: 1 for key, _, _ in jobs}
    return {k: np.concatenate(v, axis=-1) for k, v in chunks.items()}


def test_batched_tts_holds_to_streaming_tts_solo_and_batched(tts):
    _, tcfg, _, tp = tts
    rng = np.random.RandomState(1)
    mk = lambda t: (rng.randn(1, t, tcfg.decoder.idim).astype(np.float32),  # noqa: E731
                    rng.randn(1, 2, tcfg.decoder.idim).astype(np.float32))
    (h0, p0), (h1, p1), (h2, p2) = mk(6), mk(9), mk(4)
    ref = np.concatenate(_run(StreamingTTS(tp, tcfg, seed=0, device="cpu"),
                              h0, p0), axis=-1)
    solo = _run_pool(BatchedTTS(tp, tcfg, capacity=1, seed=0, device="cpu"),
                     [("x", h0, p0)])["x"]
    batch = _run_pool(BatchedTTS(tp, tcfg, capacity=4, seed=0, device="cpu"),
                      [("x", h0, p0), ("y", h1, p1), ("z", h2, None)])
    assert solo.shape == ref.shape == batch["x"].shape
    np.testing.assert_allclose(solo, ref, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(batch["x"], solo, rtol=TOL, atol=TOL)
    ref_z = np.concatenate(_run(StreamingTTS(tp, tcfg, seed=0, device="cpu"),
                                h2, None), axis=-1)
    np.testing.assert_allclose(batch["z"], ref_z, rtol=TOL, atol=TOL)


def test_batched_tts_staggered_start_and_cancel(tts):
    _, tcfg, _, tp = tts
    # inputs whose sentences run to the token budget (with seed 2, "a" draws
    # a special id at its third token and ends in the first step)
    rng = np.random.RandomState(3)
    h0, h1 = (rng.randn(1, 6, tcfg.decoder.idim).astype(np.float32) for _ in range(2))
    pool = BatchedTTS(tp, tcfg, capacity=2, seed=0, device="cpu")
    assert pool.start([("a", h0, None)]) == 1 and pool.n_free == 1
    pool.step()
    assert pool.start([("b", h1, None), ("c", h1, None)]) == 1   # pool full
    pool.cancel("a")
    assert all(j.key != "a" for j in pool.jobs.values()) and pool.n_free == 1
    got = {}
    for _ in range(200):
        for key, lst in pool.step().items():
            got.setdefault(key, []).extend(lst)
        if pool.n_active == 0:
            break
    assert set(got) == {"b"} and got["b"][-1][1]
    ref = np.concatenate(_run(StreamingTTS(tp, tcfg, seed=0, device="cpu"),
                              h1, None), axis=-1)
    np.testing.assert_allclose(np.concatenate([p for p, _ in got["b"]], axis=-1),
                               ref, rtol=TOL, atol=TOL)


def test_batched_tts_ends_a_sentence_when_its_kv_row_is_full(tts):
    """A pooled sentence stops when its next segment would not fit its
    decoder KV row (before any write past the row) and ends with one final
    entry, shorter than the same sentence in a roomy pool; a sentence whose
    preamble leaves no room for one segment is refused on the host: it takes
    no row, and take_refused names it."""
    _, tcfg, _, tp = tts
    chunk = tcfg.codec_chunk_size
    rng = np.random.RandomState(4)
    h, p = (rng.randn(1, t, tcfg.decoder.idim).astype(np.float32) for t in (6, 2))
    used = 1 + 6 + 2   # bos + hidden block + prefix
    tight = BatchedTTS(tp, tcfg, capacity=1, seed=0, device="cpu",
                       max_kv_len=used + 1 + chunk + chunk // 2)
    out = _run_pool(tight, [("x", h, p)])
    ref = _run_pool(BatchedTTS(tp, tcfg, capacity=1, seed=0, device="cpu"),
                    [("x", h, p)])
    assert 0 < out["x"].shape[-1] < ref["x"].shape[-1]
    short = BatchedTTS(tp, tcfg, capacity=1, seed=0, device="cpu",
                       max_kv_len=used + chunk)
    assert short.start([("y", h, p)]) == 0 and short.n_free == 1
    (refused,) = short.take_refused()
    assert refused[0] == "y" and "KV slots" in refused[1]


def test_a_special_codec_id_ends_the_sentence(tts):
    """The decoder's head covers the four specials; a sampled bos/sos (not
    only eos/pad) ends the sentence before it reaches the codec, which has
    no embedding for it (as fastpath.first_response counts valid tokens)."""
    _, tcfg, _, tp = tts
    rng = np.random.RandomState(2)   # draws sos (codec_vocab + 1) third
    h = rng.randn(1, 6, tcfg.decoder.idim).astype(np.float32)
    out = _run_pool(BatchedTTS(tp, tcfg, capacity=1, seed=0, device="cpu"),
                    [("a", h, None)])["a"]
    ref = np.concatenate(_run(StreamingTTS(tp, tcfg, seed=0, device="cpu"),
                              h, None), axis=-1)
    assert out.shape == ref.shape and np.isfinite(out).all()
    up = tcfg.codec.upsample_rate
    assert 0 < out.shape[-1] <= 3 * up
    np.testing.assert_allclose(out, ref, rtol=TOL, atol=TOL)


def test_streaming_tts_ends_a_sentence_at_its_decoder_cache(tts):
    """A sentence whose codec tokens would outgrow the decoder cache ends
    when the cache is full, as at a token budget of the slots left: the
    same PCM as a roomy cache with that budget, shorter than the sentence
    unbounded. (Writing past the cache faults: an index error on the CPU, a
    device-side assert on the card.)"""
    _, tcfg, _, tp = tts
    rng = np.random.RandomState(3)   # runs to the 48-token budget unbounded
    h, p = (rng.randn(1, t, tcfg.decoder.idim).astype(np.float32) for t in (6, 2))
    used = 1 + 6 + 2   # bos + hidden frames + prefix
    room = 20
    tight = dataclasses.replace(tcfg, decoder=dataclasses.replace(
        tcfg.decoder, max_kv_len=used + 1 + room))
    out = np.concatenate(_run(StreamingTTS(tp, tight, seed=0, device="cpu"), h, p),
                         axis=-1)
    budget = dataclasses.replace(tcfg, max_tokens=room)
    ref = np.concatenate(_run(StreamingTTS(tp, budget, seed=0, device="cpu"), h, p),
                         axis=-1)
    full = np.concatenate(_run(StreamingTTS(tp, tcfg, seed=0, device="cpu"), h, p),
                          axis=-1)
    assert np.isfinite(out).all() and out.shape == ref.shape
    assert out.shape[-1] < full.shape[-1]
    np.testing.assert_allclose(out, ref, rtol=TOL, atol=TOL)


def test_streaming_tts_refuses_a_sentence_its_cache_cannot_start(tts):
    """A preamble that leaves the cache no slot for a codec token is
    refused on the host, before the preamble writes anything."""
    _, tcfg, _, tp = tts
    rng = np.random.RandomState(4)
    h, p = (rng.randn(1, t, tcfg.decoder.idim).astype(np.float32) for t in (6, 2))
    tight = dataclasses.replace(tcfg, decoder=dataclasses.replace(
        tcfg.decoder, max_kv_len=1 + 6 + 2 + 1))
    with pytest.raises(ValueError, match="decoder KV slots"):
        next(StreamingTTS(tp, tight, seed=0, device="cpu").run(h, p))
