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
