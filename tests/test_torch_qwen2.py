"""Qwen2 backbone of the PyTorch port against the JAX package: chunk prefill
with rank/cumsum compaction into float and int8 caches, the sliding-window
roll, embeddings and KV quantization.

Weights come from the JAX initializer (and its int8 quantizer), converted
leaf for leaf. Tolerances: float32 hidden states and float caches 1e-4
(sums in another order); an int8 cache entry may round to the neighbouring
level when its float input differs by an ulp, so int8 caches compare within
one quantization step and hidden states over them at 2e-3. Slot S-1, the
scratch slot of invalid tokens, is excluded: duplicate writes there land in
no defined order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from freeze_omni_tpu.config import tiny_system as jax_tiny
from freeze_omni_tpu.models import qwen2 as jq
from freeze_omni_tpu.ops import quant as jquant
from freeze_omni_tpu_torch import weights
from freeze_omni_tpu_torch.config import tiny_system
from freeze_omni_tpu_torch.models import qwen2 as tq

S = 32


def _cfgs():
    return jax_tiny().audio_llm.llm, tiny_system().audio_llm.llm


def _params(int8_weights):
    jcfg, _ = _cfgs()
    p = jq.init_params(jax.random.PRNGKey(0), jcfg, dtype=jnp.float32)
    if int8_weights:
        p = jquant.quantize_llm_params(p)
    p = jax.tree.map(np.asarray, p)
    return p, weights.from_jax(p, device="cpu")


def _kv_np(kv):
    return {k: (None if v is None else np.asarray(v)) for k, v in kv._asdict().items()}


def _deq(kv, name):
    return kv[name].astype(np.float32) * kv[name[0] + "_scale"][..., None]


@pytest.mark.parametrize("int8_weights", [False, True])
@pytest.mark.parametrize("quant_bits", [None, 8])
def test_forward_three_ragged_chunks(int8_weights, quant_bits):
    jcfg, tcfg = _cfgs()
    jp, tp = _params(int8_weights)
    B, T = 2, 5
    jkv = jq.init_cache(jcfg, B, S, jnp.float32, quant_bits)
    tkv = tq.init_cache(tcfg, B, S, torch.float32, quant_bits, device="cpu")
    rng = np.random.RandomState(4)
    fwd = jax.jit(jq.forward, static_argnames=("cfg",))
    h_tol = 1e-4 if quant_bits is None else 2e-3
    for step in range(3):
        emb = rng.randn(B, T, tcfg.hidden).astype(np.float32)
        mask = np.ones((B, T), bool) if step == 0 else rng.rand(B, T) > 0.35
        mask[1, 0] = step != 1          # a row that skips its first token
        jh, jkv = fwd(jp, jcfg, jnp.asarray(emb), jnp.asarray(mask), jkv)
        th, _ = tq.forward(tp, tcfg, torch.from_numpy(emb), torch.from_numpy(mask), tkv)
        np.testing.assert_allclose(th.numpy()[mask], np.asarray(jh)[mask],
                                   rtol=h_tol, atol=h_tol, err_msg=f"chunk {step}")
    jn, tn = _kv_np(jkv), _kv_np(tkv)
    np.testing.assert_array_equal(tn["length"], jn["length"])
    L = int(tn["length"].max())
    assert L < S - 1
    if quant_bits is None:
        for name in ("k", "v"):
            np.testing.assert_allclose(tn[name][:, :, :L], jn[name][:, :, :L],
                                       rtol=1e-4, atol=1e-4)
    else:
        for name in ("k", "v"):
            dt, dj = _deq(tn, name)[:, :, :L], _deq(jn, name)[:, :, :L]
            step_ = np.maximum(tn[name[0] + "_scale"], jn[name[0] + "_scale"])[:, :, :L]
            assert (np.abs(dt - dj) <= 1.01 * step_[..., None] + 1e-6).all()
            assert (tn[name][:, :, :L] == jn[name][:, :, :L]).mean() > 0.99


def _random_cache(quant_bits, lengths):
    _, tcfg = _cfgs()
    rng = np.random.RandomState(5)
    shape = (tcfg.num_layers, len(lengths), S, tcfg.num_kv_heads, tcfg.head_dim)
    k = rng.randn(*shape).astype(np.float32)
    v = rng.randn(*shape).astype(np.float32)
    length = np.asarray(lengths, np.int32)
    jkv = jq.KVCache(k=jnp.asarray(k), v=jnp.asarray(v), length=jnp.asarray(length))
    tkv = tq.KVCache(k=torch.from_numpy(k), v=torch.from_numpy(v),
                     length=torch.from_numpy(length))
    if quant_bits:
        jkv = jq.quantize_cache(jkv)
        tkv = tq.quantize_cache(tkv)
    return jkv, tkv


@pytest.mark.parametrize("quant_bits", [None, 8])
def test_roll_kv_matches_jax(quant_bits):
    jcfg, tcfg = _cfgs()
    jkv, tkv = _random_cache(quant_bits, [24, 13])
    prefix = np.array([3, 5], np.int32)
    keep = np.array([8, 8], np.int32)
    do = np.array([True, False])
    jr = _kv_np(jq.roll_kv(jcfg, jkv, jnp.asarray(prefix), jnp.asarray(keep),
                           jnp.asarray(do)))
    tr = _kv_np(tq.roll_kv(tcfg, tkv, torch.from_numpy(prefix),
                           torch.from_numpy(keep), torch.from_numpy(do)))
    np.testing.assert_array_equal(tr["length"], jr["length"])
    assert list(tr["length"]) == [11, 13]
    if quant_bits is None:
        for name in ("k", "v"):
            np.testing.assert_allclose(tr[name], jr[name], rtol=1e-5, atol=1e-5)
        return
    # V and all scales move losslessly; K is dequantized, rotated, requantized
    for name in ("v", "v_scale"):
        np.testing.assert_array_equal(tr[name], jr[name])
    np.testing.assert_allclose(tr["k_scale"], jr["k_scale"], rtol=1e-5, atol=1e-7)
    step_ = np.maximum(tr["k_scale"], jr["k_scale"])[..., None]
    assert (np.abs(_deq(tr, "k") - _deq(jr, "k")) <= 1.01 * step_ + 1e-6).all()
    assert (tr["k"][:, 0, 11:] == 0).all() and (tr["k_scale"][:, 0, 11:] == 0).all()


def test_quantize_kv_vectors_and_cache_roundtrip():
    x = np.random.RandomState(6).randn(3, 7, 2, 16).astype(np.float32)
    jqv, js = jq.quantize_kv_vectors(jnp.asarray(x))
    tqv, ts = tq.quantize_kv_vectors(torch.from_numpy(x))
    np.testing.assert_array_equal(tqv.numpy(), np.asarray(jqv))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    _, tkv = _random_cache(8, [4, 9])
    back = tq.dequantize_cache(tkv, torch.float32)
    assert back.k_scale is None and back.k.dtype == torch.float32
    assert torch.equal(back.length, tkv.length)


@pytest.mark.parametrize("int8_weights", [False, True])
def test_embed_tokens_and_last_valid_index(int8_weights):
    jp, tp = _params(int8_weights)
    ids = np.array([[0, 7, 511], [3, 3, 100]], np.int64)
    je = jq.embed_tokens(jax.tree.map(jnp.asarray, jp), jnp.asarray(ids))
    te = tq.embed_tokens(tp, torch.from_numpy(ids))
    assert te.dtype == (torch.bfloat16 if int8_weights else torch.float32)
    np.testing.assert_array_equal(te.float().numpy(), np.asarray(je, np.float32))
    mask = np.array([[True, False, True, False], [False] * 4, [True] * 4])
    np.testing.assert_array_equal(tq.last_valid_index(torch.from_numpy(mask)).numpy(),
                                  np.asarray(jq.last_valid_index(jnp.asarray(mask))))
