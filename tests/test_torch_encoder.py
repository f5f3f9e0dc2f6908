"""Streaming encoder and adapter of the PyTorch port against the JAX package.

Weights come from the JAX initializers and are converted leaf for leaf.
Tolerance: 1e-4 in float32 (sums in another order through several blocks,
as tests/test_encoder.py allows 2e-4 for its oracles)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from freeze_omni_tpu.config import AdapterConfig as JAdapterCfg
from freeze_omni_tpu.config import EncoderConfig as JEncoderCfg
from freeze_omni_tpu.models import adapter as jadp
from freeze_omni_tpu.models import encoder as jenc
from freeze_omni_tpu_torch import weights
from freeze_omni_tpu_torch.config import AdapterConfig, EncoderConfig
from freeze_omni_tpu_torch.models import adapter as tadp
from freeze_omni_tpu_torch.models import encoder as tenc

TOL = dict(rtol=1e-4, atol=1e-4)

ENC_KW = {
    "rel": dict(pos_enc="rel-enc"),
    "abs": dict(pos_enc="abs-enc"),
    "conv1d-linear": dict(pos_enc="rel-enc", positionwise="conv1d-linear",
                          positionwise_conv_kernel=3),
    "conv1d": dict(pos_enc="rel-enc", positionwise="conv1d",
                   positionwise_conv_kernel=3),
}


def _enc_cfgs(kind):
    kw = dict(input_dim=80, output_dim=32, attention_dim=32, attention_heads=4,
              linear_units=64, num_blocks=2, chunk_size=4, left_chunks=2,
              pe_max_len=64, **ENC_KW[kind])
    return JEncoderCfg(**kw), EncoderConfig(**kw)


def _enc_params(jcfg, seed):
    p = jenc.init_params(jax.random.PRNGKey(seed), jcfg)
    p["cmvn"]["mean"] = jnp.full((80,), 1.5)
    p["cmvn"]["istd"] = jnp.full((80,), 0.6)
    return p, weights.from_jax(jax.tree.map(np.asarray, p), device="cpu")


def _state_np(st):
    return [np.asarray(x) for x in st]


@pytest.mark.parametrize("kind", list(ENC_KW))
def test_stream_step_matches_jax_stream(kind):
    """16 chunks cross the streaming PE wraparound (pe_wrap = 64 - 12)."""
    jcfg, tcfg = _enc_cfgs(kind)
    jp, tp = _enc_params(jcfg, seed=1)
    rng = np.random.RandomState(1)
    js = jenc.init_state(jcfg, batch=2)
    ts = tenc.init_state(tcfg, batch=2, device="cpu")
    step = jax.jit(jenc.stream_step, static_argnames=("cfg",))
    for i in range(16):
        x = rng.randn(2, 19, 80).astype(np.float32)
        jo, js = step(jp, jcfg, jnp.asarray(x), js)
        to, ts = tenc.stream_step(tp, tcfg, torch.from_numpy(x), ts)
        np.testing.assert_allclose(to.numpy(), np.asarray(jo), err_msg=f"step {i}",
                                   **TOL)
    for a, b in zip(ts, _state_np(js)):
        np.testing.assert_allclose(a.numpy(), b, **TOL)


@pytest.mark.parametrize("kind", ["rel", "conv1d-linear", "conv1d"])
def test_forward_matches_jax(kind):
    jcfg, tcfg = _enc_cfgs(kind)
    jp, tp = _enc_params(jcfg, seed=2)
    x = np.random.RandomState(2).randn(2, 67, 80).astype(np.float32)
    np.testing.assert_allclose(tenc.forward(tp, tcfg, torch.from_numpy(x)).numpy(),
                               np.asarray(jenc.forward(jp, jcfg, jnp.asarray(x))),
                               **TOL)


def test_abs_stream_equals_chunk_masked_forward():
    """With absolute PE, streaming 19-frame windows (3 frames of overlap) is the
    chunk-masked full forward: the same subsampled frames, window and mask."""
    _, tcfg = _enc_cfgs("abs")
    _, tp = _enc_params(_enc_cfgs("abs")[0], seed=3)
    rng = np.random.RandomState(3)
    n = 6
    full = rng.randn(1, 3 + 16 * n, 80).astype(np.float32)
    st = tenc.init_state(tcfg, device="cpu")
    outs = []
    for i in range(n):
        o, st = tenc.stream_step(tp, tcfg, torch.from_numpy(full[:, 16 * i:16 * i + 19]), st)
        outs.append(o)
    ref = tenc.forward(tp, tcfg, torch.from_numpy(full))
    assert ref.shape[1] == 4 * n == tenc.subsampled_len(full.shape[1])
    np.testing.assert_allclose(torch.cat(outs, 1).numpy(), ref.numpy(), **TOL)


def test_chunk_causal_mask_matches_jax():
    np.testing.assert_array_equal(tenc.chunk_causal_mask(23, 4, 2, "cpu").numpy(),
                                  np.asarray(jenc.chunk_causal_mask(23, 4, 2)))


ADP_KW = [dict(enc_out_dim=16, llm_dim=128, kernel_size=5),      # two-stage
          dict(enc_out_dim=16, llm_dim=48, kernel_size=5),       # one-stage
          dict(enc_out_dim=16, llm_dim=48, kernel_size=5, norm="layer",
               activation="gelu")]


@pytest.mark.parametrize("kw", ADP_KW)
def test_adapter_streaming_equals_full_and_jax(kw):
    jcfg, tcfg = JAdapterCfg(**kw), AdapterConfig(**kw)
    jp = jadp.init_params(jax.random.PRNGKey(0), jcfg)
    tp = weights.from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    x = np.random.RandomState(0).randn(2, 14, 16).astype(np.float32)
    full = tadp.forward(tp, tcfg, torch.from_numpy(x))
    assert full.shape == (2, 7, tcfg.llm_dim)
    np.testing.assert_allclose(full.numpy(),
                               np.asarray(jadp.forward(jp, jcfg, jnp.asarray(x))),
                               **TOL)
    st = tadp.init_state(tcfg, batch=2, device="cpu")
    jst = jadp.init_state(jcfg, batch=2)
    outs = []
    for a, b in ((0, 4), (4, 8), (8, 14)):
        o, st = tadp.step(tp, tcfg, torch.from_numpy(x[:, a:b]), st)
        jo, jst = jadp.step(jp, jcfg, jnp.asarray(x[:, a:b]), jst)
        np.testing.assert_allclose(o.numpy(), np.asarray(jo), **TOL)
        outs.append(o)
    np.testing.assert_allclose(torch.cat(outs, 1).numpy(), full.numpy(),
                               rtol=1e-5, atol=1e-5)
    assert tadp.out_len(7) == jadp.out_len(7) == 4
