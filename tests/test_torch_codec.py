"""Codec decode half of the PyTorch port against the JAX package
(models/codec.py and layers.conv_transpose1d), on the CPU.

The JAX conv_transpose1d is an lhs-dilated convolution with a flipped kernel;
the port calls F.conv_transpose1d on the same [in, out, k] weight. Both are
float32 and differ only in the order of the sums, so they agree to 1e-5.
The vocoder stacks ~30 convolutions and ends in tanh; its PCM agrees to
1e-5 on the committed tiny checkpoint. The codebook lookups are exact.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from freeze_omni_tpu import config as jcfg_mod
from freeze_omni_tpu.models import codec as jcodec
from freeze_omni_tpu.models import layers as jlayers
from freeze_omni_tpu.utils.checkpoint import load_native
from freeze_omni_tpu_torch import config as tcfg_mod
from freeze_omni_tpu_torch import weights
from freeze_omni_tpu_torch.models import codec as tcodec
from freeze_omni_tpu_torch.models import layers as tlayers

ASSET = os.path.abspath(os.path.join(os.path.dirname(__file__), "..",
                                     "freeze_omni_tpu", "assets", "tiny_s2s"))
TOL = 1e-5


@pytest.mark.parametrize("cin,cout,k,stride,T", [
    (16, 8, 16, 8, 5), (8, 4, 10, 5, 7), (4, 2, 6, 3, 9), (3, 5, 4, 1, 6)])
def test_conv_transpose1d_matches_jax(cin, cout, k, stride, T):
    rng = np.random.RandomState(cin + k)
    p = {"w": rng.randn(cin, cout, k).astype(np.float32),
         "b": rng.randn(cout).astype(np.float32)}
    x = rng.randn(2, cin, T).astype(np.float32)
    pad = (k - stride) // 2
    j = jlayers.conv_transpose1d(jax.tree.map(jnp.asarray, p), jnp.asarray(x),
                                 stride=stride, padding=pad)
    t = tlayers.conv_transpose1d(weights.from_jax(p, device="cpu"),
                                 torch.from_numpy(x), stride=stride, padding=pad)
    assert tuple(t.shape) == j.shape == (2, cout, (T - 1) * stride - 2 * pad + k)
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=TOL, atol=TOL)


@pytest.fixture(scope="module")
def tiny_codec():
    path = os.path.join(ASSET, "config.json")
    jp = jax.tree.map(np.asarray, load_native(os.path.join(ASSET, "params"))
                      ["tts"]["codec"])
    return (jp, weights.from_jax(jp, device="cpu"),
            jcfg_mod.load_system_config(path).tts.codec,
            tcfg_mod.load_system_config(path).tts.codec)


def test_decode_matches_jax_on_the_tiny_checkpoint(tiny_codec):
    jp, tp, jcfg, tcfg = tiny_codec
    rng = np.random.RandomState(0)
    codes = rng.randint(0, tcfg.n_codes, (2, 12, 1)).astype(np.int32)
    gst = rng.randint(0, tcfg.n_codes, (2, 1, tcfg.global_code_num)).astype(np.int32)
    j_quant = jcodec.quantizer_embed(jp["quantizer"], jcfg, jnp.asarray(codes))
    j_gemb = jcodec.quantizer_embed_gst(jp["quantizer"], jcfg, jnp.asarray(gst))
    j_pcm = jax.jit(jcodec.decode, static_argnames="cfg")(
        jp, jcfg, jnp.asarray(codes), jnp.asarray(gst))
    with torch.no_grad():
        t_quant = tcodec.quantizer_embed(tp["quantizer"], tcfg, torch.from_numpy(codes))
        t_gemb = tcodec.quantizer_embed_gst(tp["quantizer"], tcfg, torch.from_numpy(gst))
        t_pcm = tcodec.decode(tp, tcfg, torch.from_numpy(codes), torch.from_numpy(gst))
    np.testing.assert_array_equal(t_quant.numpy(), np.asarray(j_quant))
    np.testing.assert_array_equal(t_gemb.numpy(), np.asarray(j_gemb))
    # (k - u) odd in the later stages adds a sample each: not exactly 12 * 600
    assert tuple(t_pcm.shape) == j_pcm.shape
    assert j_pcm.shape[:2] == (2, 1) and j_pcm.shape[2] >= 12 * tcfg.upsample_rate
    np.testing.assert_allclose(t_pcm.numpy(), np.asarray(j_pcm), rtol=TOL, atol=TOL)
    assert np.abs(np.asarray(j_pcm)).max() > 1e-3      # not a silent output


def test_init_params_mirror_the_jax_decode_tree():
    jcfg = jcfg_mod.tiny_system().tts.codec
    tcfg = tcfg_mod.tiny_system().tts.codec
    jshapes = jax.tree.map(lambda a: (a.shape, str(a.dtype)),
                           jcodec.init_params(jax.random.PRNGKey(0), jcfg))
    tp = tcodec.init_params(tcfg, torch.Generator().manual_seed(0), device="cpu")
    tshapes = jax.tree.map(lambda t: (tuple(t.shape), str(t.dtype).split(".")[-1]),
                           tp)
    assert tshapes == jshapes


@pytest.fixture(scope="module")
def encoder_codec():
    """The tiny codec with its encoder branch, drawn by the JAX initializer
    (the trained checkpoint has none), in both packages."""
    jcfg = jcfg_mod.tiny_system().tts.codec
    jp = jax.tree.map(np.asarray, jcodec.init_params(jax.random.PRNGKey(3), jcfg,
                                                     with_encoder=True))
    return jp, weights.from_jax(jp, device="cpu"), jcfg, tcfg_mod.tiny_system().tts.codec


def test_encode_matches_jax(encoder_codec):
    """encode_features within 1e-4 (f32 convolutions, GroupNorm, the global
    branch); the residual codes and global-style-token ids identical."""
    jp, tp, jcfg, tcfg = encoder_codec
    wav = (0.3 * np.random.RandomState(1).randn(2, 1, 20 * tcfg.upsample_rate)
           ).astype(np.float32)
    jf, jg = jax.jit(jcodec.encode_features, static_argnames="cfg")(
        jp, jcfg, jnp.asarray(wav))
    j_codes, j_gst = jcodec.quantize(jp["quantizer"], jcfg, jf, jg)
    with torch.no_grad():
        tf, tg = tcodec.encode_features(tp, tcfg, torch.from_numpy(wav))
        t_codes, t_gst = tcodec.encode(tp, tcfg, torch.from_numpy(wav))
    assert tuple(tf.shape) == jf.shape and jf.shape[:2] == (2, 512)
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), rtol=0, atol=1e-4)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=0, atol=1e-4)
    assert tuple(t_codes.shape) == j_codes.shape and tuple(t_gst.shape) == j_gst.shape
    np.testing.assert_array_equal(t_codes.numpy(), np.asarray(j_codes))
    np.testing.assert_array_equal(t_gst.numpy(), np.asarray(j_gst))


def test_extract_global_tokens_matches_jax(encoder_codec, monkeypatch):
    """A 16 kHz dev wav, resampled to the codec's rate and padded to whole
    frames by each package: the same voice tokens; a codec without the
    encoder branch is refused."""
    from freeze_omni_tpu import tts as jtts
    from freeze_omni_tpu.frontend import native as jnative
    from freeze_omni_tpu_torch import tts as ttts
    from freeze_omni_tpu_torch.frontend.wav import read_wav

    monkeypatch.setattr(jnative, "available", lambda: False)   # numpy resampler
    jp, tp, jcfg, tcfg = encoder_codec
    wav, sr = read_wav(os.path.join(ASSET, "dev_wavs", "qa_001.wav"))
    assert sr == 16000 != tcfg.sample_rate
    got = ttts.extract_global_tokens(tp, tcfg, wav, sr)
    assert got == jtts.extract_global_tokens(jp, jcfg, wav, sr)
    assert len(got) == tcfg.global_code_num
    with pytest.raises(ValueError, match="encoder branch"):
        ttts.extract_global_tokens({k: tp[k] for k in ("generator", "quantizer")},
                                   tcfg, wav, sr)


def test_init_params_with_encoder_keeps_the_decode_draw():
    """The encoder leaves are drawn after every decode leaf: a seed's decode
    weights are the same with and without the encoder, and the encoder tree
    has the JAX layout."""
    jcfg = jcfg_mod.tiny_system().tts.codec
    tcfg = tcfg_mod.tiny_system().tts.codec
    plain = tcodec.init_params(tcfg, torch.Generator().manual_seed(0), device="cpu")
    full = tcodec.init_params(tcfg, torch.Generator().manual_seed(0), device="cpu",
                              with_encoder=True)
    for a, b in zip(jax.tree.leaves(plain), jax.tree.leaves(
            {k: full[k] for k in plain})):
        assert torch.equal(a, b)
    jshapes = jax.tree.map(lambda a: (a.shape, str(a.dtype)), jcodec.init_params(
        jax.random.PRNGKey(0), jcfg, with_encoder=True)["encoder"])
    tshapes = jax.tree.map(lambda t: (tuple(t.shape), str(t.dtype).split(".")[-1]),
                           full["encoder"])
    assert tshapes == jshapes
