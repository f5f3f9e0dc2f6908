"""Grouped int4 weight-only quantization of the PyTorch port against the JAX
package: the quantizer's bytes and scales, the unpacking, the trees the two
entry points build, the matmul's plain version (against the JAX Pallas kernel
in interpret mode and the dequant einsum) and `layers.linear`'s int4 branch.

Tolerances: packed bytes identical; scales within one f32 ulp (XLA may
rewrite amax / 7 as amax * (1 / 7) under jit); f32 products within
rtol = atol = 1e-5 (the same f32 weights, sums in another order); bf16
`linear` within 2e-2 of the output's largest magnitude (the JAX CPU path
rounds q * scale and the product to bf16, the port's plain version
dequantizes in f32 and rounds the output once).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from freeze_omni_tpu.config import tiny_system as jax_tiny
from freeze_omni_tpu.models import layers as jlayers
from freeze_omni_tpu.models import qwen2 as jqwen2
from freeze_omni_tpu.ops import quant as jquant
from freeze_omni_tpu.ops.quant_matmul import quant_matmul4 as jax_quant_matmul4
from freeze_omni_tpu_torch import weights
from freeze_omni_tpu_torch.config import tiny_system
from freeze_omni_tpu_torch.models import layers as tlayers
from freeze_omni_tpu_torch.ops import quant as tquant
from freeze_omni_tpu_torch.ops import quant_matmul as tqm

F32_TOL = 1e-5


def _ulps(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return int(np.abs(a.view(np.int32).astype(np.int64)
                      - b.view(np.int32).astype(np.int64)).max())


def _quantize_both(w, group):
    jp = jax.tree.map(np.asarray, jquant.quantize_linear_int4(
        {"w": jnp.asarray(w)}, group=group))
    tp = weights.to_numpy(tquant.quantize_linear_int4(
        {"w": torch.from_numpy(w)}, group=group))
    return jp, tp


@pytest.mark.parametrize("group", [64, 128])
@pytest.mark.parametrize("shape", [(256, 192), (3, 512, 96)])
def test_quantize_linear_int4_matches_jax_bytes(shape, group):
    w = np.random.RandomState(sum(shape) + group).randn(*shape).astype(np.float32)
    jp, tp = _quantize_both(w, group)
    K, O = shape[-2:]
    assert tp["w_q4"].dtype == np.uint8 and tp["scale4"].dtype == np.float32
    assert tp["w_q4"].shape == (*shape[:-2], K // 2, O)
    assert tp["scale4"].shape == (*shape[:-2], K // group, O)
    np.testing.assert_array_equal(tp["w_q4"], jp["w_q4"])
    assert _ulps(tp["scale4"], jp["scale4"]) <= 1
    # the quantizer writes nibbles 1..15 only (values -7..7)
    assert (tp["w_q4"] & 0xF).min() >= 1 and (tp["w_q4"] >> 4).min() >= 1


def test_quantize_linear_int4_rejects_a_ragged_group():
    with pytest.raises(ValueError, match="group"):
        tquant.quantize_linear_int4({"w": torch.zeros(96, 8)}, group=64)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dequantize_weight_int4_matches_jax(dtype):
    """Packed bytes over all of 0..255 (nibble 0, weight -8, included)."""
    rng = np.random.RandomState(3)
    p = {"w_q4": rng.randint(0, 256, (2, 64, 40)).astype(np.uint8),
         "scale4": rng.rand(2, 2, 40).astype(np.float32)}
    jw = np.asarray(jquant.dequantize_weight_int4(
        jax.tree.map(jnp.asarray, p), dtype=getattr(jnp, dtype)).astype(jnp.float32))
    tw = tquant.dequantize_weight_int4(weights.from_jax(p, device="cpu"),
                                       dtype=getattr(torch, dtype)).float().numpy()
    np.testing.assert_array_equal(tw, jw)


def _llm_params():
    cfg = jax_tiny().audio_llm.llm
    return cfg, jax.tree.map(np.asarray, jqwen2.init_params(
        jax.random.PRNGKey(0), cfg, dtype=jnp.float32))


def _tree_spec(tree):
    return {jax.tree_util.keystr(p): (np.asarray(leaf).dtype.name,
                                      np.asarray(leaf).shape)
            for p, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def test_quantize_llm_params_bits4_matches_jax():
    """Every layer projection and the lm_head int4, the embedding per-row
    int8: the same tree, bytes and scales as the JAX function."""
    _, src = _llm_params()
    jq = jax.tree.map(np.asarray, jquant.quantize_llm_params(
        jax.tree.map(jnp.asarray, src), bits=4))
    tq = weights.to_numpy(tquant.quantize_llm_params(
        weights.from_jax(src, device="cpu"), bits=4))
    assert _tree_spec(tq) == _tree_spec(jq)
    for name in ("q", "k", "v", "o", "gate", "up", "down"):
        assert set(tq["layers"][name]) >= {"w_q4", "scale4"}
        np.testing.assert_array_equal(tq["layers"][name]["w_q4"],
                                      jq["layers"][name]["w_q4"])
        assert _ulps(tq["layers"][name]["scale4"], jq["layers"][name]["scale4"]) <= 1
    assert set(tq["lm_head"]) == {"w_q4", "scale4"}
    np.testing.assert_array_equal(tq["lm_head"]["w_q4"], jq["lm_head"]["w_q4"])
    assert set(tq["embed"]) == {"w_q", "scale"}
    np.testing.assert_array_equal(tq["embed"]["w_q"], jq["embed"]["w_q"])
    with pytest.raises(ValueError, match="4 or 8"):
        tquant.quantize_llm_params(weights.from_jax(src, device="cpu"), bits=2)


def test_init_quantized_llm_bits4_tree_matches_jax():
    """Layers int4, lm_head int8 and the embedding per-row int8, as the JAX
    function builds them (values differ: another generator)."""
    jcfg = jax_tiny().audio_llm.llm
    tcfg = tiny_system().audio_llm.llm
    jt = jax.tree.map(np.asarray, jquant.init_quantized_llm(
        jax.random.PRNGKey(0), jcfg, bits=4))
    tt = weights.to_numpy(tquant.init_quantized_llm(
        tcfg, torch.Generator().manual_seed(0), "cpu", bits=4))
    assert _tree_spec(tt) == _tree_spec(jt)
    assert set(tt["layers"]["down"]) == {"w_q4", "scale4"}
    assert set(tt["lm_head"]) == {"w_q", "scale"}
    assert set(tt["embed"]) == {"w_q", "scale"}


@pytest.mark.parametrize("group", [64, 128])
@pytest.mark.parametrize("N", [1, 3, 8, 29])
def test_quant_matmul4_reference_matches_jax(N, group):
    rng = np.random.RandomState(N * group)
    K, O = 256, 256
    w = rng.randn(K, O).astype(np.float32) / np.sqrt(K)
    x = rng.randn(N, K).astype(np.float32)
    jp, _ = _quantize_both(w, group)
    ours = tqm.quant_matmul4(torch.from_numpy(x), torch.from_numpy(jp["w_q4"]),
                             torch.from_numpy(jp["scale4"]), group).numpy()
    pallas = np.asarray(jax_quant_matmul4(
        jnp.asarray(x), jnp.asarray(jp["w_q4"]), jnp.asarray(jp["scale4"]),
        group=group, block_o=128, interpret=True))
    einsum = np.asarray(jnp.einsum("ni,io->no", x, jquant.dequantize_weight_int4(
        jax.tree.map(jnp.asarray, jp), dtype=jnp.float32)))
    assert ours.shape == (N, O) and ours.dtype == np.float32
    np.testing.assert_allclose(ours, pallas, rtol=F32_TOL, atol=F32_TOL)
    np.testing.assert_allclose(ours, einsum, rtol=F32_TOL, atol=F32_TOL)


def test_quant_matmul4_reference_rejects_a_group_that_does_not_fit():
    with pytest.raises(ValueError, match="group"):
        tqm.quant_matmul4(torch.zeros(2, 128), torch.zeros(64, 8, dtype=torch.uint8),
                          torch.ones(2, 8), 32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_linear_int4_branch_matches_jax(dtype):
    rng = np.random.RandomState(11)
    w = rng.randn(192, 48).astype(np.float32) / np.sqrt(192)
    jp, _ = _quantize_both(w, 64)
    jp["b"] = rng.randn(48).astype(np.float32)
    x = rng.randn(2, 5, 192).astype(np.float32)
    jx = jnp.asarray(x).astype(getattr(jnp, dtype))
    jy = np.asarray(jlayers.linear(jax.tree.map(jnp.asarray, jp), jx)
                    .astype(jnp.float32))
    tx = torch.from_numpy(np.asarray(jx.astype(jnp.float32))).to(getattr(torch, dtype))
    ty = tlayers.linear(weights.from_jax(jp, device="cpu"), tx)
    assert ty.dtype == getattr(torch, dtype) and tuple(ty.shape) == (2, 5, 48)
    ty = ty.float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(ty, jy, rtol=F32_TOL, atol=F32_TOL)
    else:
        assert np.abs(ty - jy).max() <= 2e-2 * np.abs(jy).max()


def test_int4_leaves_roundtrip_through_the_weight_bridge():
    w = np.random.RandomState(5).randn(2, 128, 64).astype(np.float32)
    jp, _ = _quantize_both(w, 64)
    port = weights.from_jax(jp, device="cpu")
    assert port["w_q4"].dtype == torch.uint8
    assert port["scale4"].dtype == torch.float32
    back = weights.to_numpy(port)
    for k in ("w_q4", "scale4"):
        assert back[k].dtype == jp[k].dtype and back[k].shape == jp[k].shape
        np.testing.assert_array_equal(back[k], jp[k])
