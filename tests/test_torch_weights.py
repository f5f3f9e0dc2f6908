"""Weight bridge and int8 quantization of the PyTorch port against the JAX package."""

import os

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from freeze_omni_tpu.config import tiny_system as jax_tiny
from freeze_omni_tpu.ops import quant as jquant
from freeze_omni_tpu.utils.checkpoint import load_native
from freeze_omni_tpu_torch import weights
from freeze_omni_tpu_torch.config import tiny_system
from freeze_omni_tpu_torch.ops import quant as tquant

CKPT = os.path.abspath(os.path.join(os.path.dirname(__file__), "..",
                                    "freeze_omni_tpu", "assets", "tiny_s2s",
                                    "params"))


@pytest.fixture(scope="module")
def tree():
    return load_native(CKPT)


def _paths(tree):
    return {jax.tree_util.keystr(p): leaf
            for p, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def test_tiny_checkpoint_roundtrips_every_leaf(tree):
    port = weights.from_jax(tree, device="cpu")
    back = weights.to_numpy(port)
    src, out = _paths(tree), _paths(back)
    assert src.keys() == out.keys() and len(src) > 150
    for k, a in src.items():
        b = out[k]
        assert b.shape == a.shape and b.dtype == a.dtype, k
        np.testing.assert_array_equal(b, a, err_msg=k)
    # the port's leaves are tensors with the same layout
    w = port["audiollm"]["llm"]["layers"]["q"]["w"]
    assert isinstance(w, torch.Tensor) and tuple(w.shape) == (2, 512, 512)


def test_tts_subtree_keeps_its_nested_lists(tree):
    """The speech decoder and codec cross leaf for leaf, and the codec's
    lists (upsample convs, resblocks, residual codebooks) stay lists."""
    tts = tree["tts"]
    port = weights.from_jax(tts, device="cpu")
    assert set(port) == {"decoder", "codec"}
    gen, q = port["codec"]["generator"], port["codec"]["quantizer"]
    for node, src in ((gen["ups"], tts["codec"]["generator"]["ups"]),
                      (gen["resblocks"], tts["codec"]["generator"]["resblocks"]),
                      (q["codebooks"], tts["codec"]["quantizer"]["codebooks"])):
        assert isinstance(node, list) and len(node) == len(src) > 0
    assert isinstance(gen["resblocks"][0]["convs1"], list)
    back = weights.to_numpy(port)
    src, out = _paths(tts), _paths(back)
    assert src.keys() == out.keys()
    for k, a in src.items():
        assert out[k].dtype == a.dtype, k
        np.testing.assert_array_equal(out[k], a, err_msg=k)


def test_bf16_and_int8_leaves_roundtrip():
    rng = np.random.RandomState(0)
    src = {"a": rng.randn(3, 4).astype(ml_dtypes.bfloat16),
           "b": [rng.randint(-127, 128, (5,)).astype(np.int8),
                 {"c": rng.rand(2).astype(np.float32)}]}
    port = weights.from_jax(src, device="cpu")
    assert port["a"].dtype == torch.bfloat16 and port["b"][0].dtype == torch.int8
    np.testing.assert_array_equal(port["a"].float().numpy(),
                                  src["a"].astype(np.float32))
    back = weights.to_numpy(port)
    assert back["a"].dtype == src["a"].dtype
    np.testing.assert_array_equal(back["a"], src["a"])
    np.testing.assert_array_equal(back["b"][0], src["b"][0])
    np.testing.assert_array_equal(back["b"][1]["c"], src["b"][1]["c"])


def test_from_jax_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; the no-card path is not reachable")
    with pytest.raises(RuntimeError, match="CUDA"):
        weights.from_jax({"w": np.zeros(2, np.float32)})


def test_quantize_llm_params_matches_jax_bytes(tree):
    """Both packages round half to even: the same float weights quantize to
    the same int8 bytes. Scales agree to one float32 ulp: under jit, XLA
    rewrites amax / 127 as amax * (1/127), which can round the other way."""
    llm = tree["audiollm"]["llm"]
    jq = jax.tree.map(np.asarray, jquant.quantize_llm_params(llm))
    tq = weights.to_numpy(tquant.quantize_llm_params(
        weights.from_jax(llm, device="cpu")))
    jp, tp = _paths(jq), _paths(tq)
    assert jp.keys() == tp.keys()
    for k in jp:
        assert tp[k].dtype == jp[k].dtype, k
        if k.endswith("['scale']"):
            np.testing.assert_allclose(tp[k], jp[k], rtol=2e-7, atol=0, err_msg=k)
        else:
            np.testing.assert_array_equal(tp[k], jp[k], err_msg=k)


def test_quantize_ties_round_half_to_even():
    # w / scale lands exactly on .5 for these columns
    w = np.array([[127.0, 0.5, 2.5], [-1.5, 127.0, -127.0]], np.float32)
    jq = jquant.quantize_linear({"w": jnp.asarray(w)})
    tq = tquant.quantize_linear({"w": torch.from_numpy(w)})
    np.testing.assert_array_equal(tq["w_q"].numpy(), np.asarray(jq["w_q"]))
    np.testing.assert_array_equal(tq["scale"].numpy(), np.asarray(jq["scale"]))
    deq_j = np.asarray(jquant.dequantize_weight(jq, jnp.float32))
    deq_t = tquant.dequantize_weight(tq, torch.float32).numpy()
    np.testing.assert_array_equal(deq_t, deq_j)


@pytest.mark.parametrize("quantize_llm", [False, True])
def test_audio_llm_init_params_mirrors_jax_tree(quantize_llm):
    """The port's random init builds the JAX tree's structure, shapes and
    dtypes (encoders, adapters, LLM, predictor, task table)."""
    from freeze_omni_tpu.models import audio_llm as jal
    from freeze_omni_tpu_torch.models import audio_llm as tal

    jtree = jal.init_params(jax.random.PRNGKey(0), jax_tiny().audio_llm,
                            quantize_llm=quantize_llm)
    ttree = tal.init_params(tiny_system().audio_llm, seed=0, device="cpu",
                            quantize_llm=quantize_llm)
    jp = _paths(jax.tree.map(np.asarray, jtree))
    tp = _paths(weights.to_numpy(ttree))
    assert jp.keys() == tp.keys()
    for k in jp:
        assert tp[k].shape == jp[k].shape and tp[k].dtype == jp[k].dtype, k


def test_init_quantized_llm_mirrors_jax_tree():
    """Same structure, shapes and dtypes as the JAX init (values come from
    another generator); int8 values in range, positive scales."""
    cfg = tiny_system().audio_llm.llm
    jtree = jquant.init_quantized_llm(jax.random.PRNGKey(0), jax_tiny().audio_llm.llm)
    ttree = tquant.init_quantized_llm(cfg, torch.Generator().manual_seed(0), "cpu")
    jp = _paths(jax.tree.map(np.asarray, jtree))
    tp = _paths(weights.to_numpy(ttree))
    assert jp.keys() == tp.keys()
    for k in jp:
        assert tp[k].shape == jp[k].shape and tp[k].dtype == jp[k].dtype, k
    wq = ttree["layers"]["gate"]["w_q"]
    assert int(wq.abs().max()) == 127 and bool((ttree["layers"]["gate"]["scale"] > 0).all())
