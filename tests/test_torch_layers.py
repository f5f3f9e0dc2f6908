"""models/layers of the PyTorch port against the JAX functions, on numpy inputs.

Tolerance: float32 inputs agree to 1e-5 (the two libraries only order sums
differently); the bf16 rms_norm to one bf16 rounding (1e-2 relative)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from freeze_omni_tpu.models import layers as jl
from freeze_omni_tpu_torch.models import layers as tl

RNG = np.random.RandomState(0)
TOL = dict(rtol=1e-5, atol=1e-5)


def f32(*shape):
    return RNG.randn(*shape).astype(np.float32)


def both(tree):
    """numpy tree -> (jax tree, torch tree)."""
    if isinstance(tree, dict):
        pairs = {k: both(v) for k, v in tree.items()}
        return ({k: v[0] for k, v in pairs.items()},
                {k: v[1] for k, v in pairs.items()})
    return jnp.asarray(tree), torch.from_numpy(tree)


def check(t_out, j_out, **tol):
    np.testing.assert_allclose(t_out.detach().float().numpy(),
                               np.asarray(j_out, np.float32), **(tol or TOL))


@pytest.mark.parametrize("bias", [False, True])
def test_linear_float(bias):
    p = {"w": f32(16, 24)}
    if bias:
        p["b"] = f32(24)
    jp, tp = both(p)
    x = f32(2, 3, 16)
    check(tl.linear(tp, torch.from_numpy(x)), jl.linear(jp, jnp.asarray(x)))


def test_linear_int8_matches_jax_einsum_branch():
    w_q = RNG.randint(-127, 128, (32, 24)).astype(np.int8)
    p = {"w_q": w_q, "scale": (RNG.rand(24) * 0.01 + 1e-3).astype(np.float32),
         "b": f32(24)}
    jp, tp = both(p)
    x = f32(2, 5, 32)
    check(tl.linear(tp, torch.from_numpy(x)), jl.linear(jp, jnp.asarray(x)))


def test_linear_bias_keeps_bf16_activation():
    p = {"w": f32(8, 4).astype(np.float32), "b": f32(4)}
    _, tp = both(p)
    tp["w"] = tp["w"].to(torch.bfloat16)
    y = tl.linear(tp, torch.from_numpy(f32(3, 8)).to(torch.bfloat16))
    assert y.dtype == torch.bfloat16


@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
def test_rms_norm(dtype):
    x = f32(2, 5, 64)
    scale = (1 + 0.1 * f32(64)).astype(np.float32)
    jp, tp = both({"scale": scale})
    if dtype == "bfloat16":
        jy = jl.rms_norm(jp, jnp.asarray(x).astype(jnp.bfloat16))
        ty = tl.rms_norm(tp, torch.from_numpy(x).to(torch.bfloat16))
        assert ty.dtype == torch.bfloat16
        check(ty, jy.astype(jnp.float32), rtol=1e-2, atol=1e-2)
    else:
        check(tl.rms_norm(tp, torch.from_numpy(x)), jl.rms_norm(jp, jnp.asarray(x)))


def test_layer_norm():
    p = {"scale": f32(32), "bias": f32(32)}
    jp, tp = both(p)
    x = 3 + 2 * f32(4, 32)
    check(tl.layer_norm(tp, torch.from_numpy(x), eps=1e-3),
          jl.layer_norm(jp, jnp.asarray(x), eps=1e-3))


@pytest.mark.parametrize("stride,padding,groups,dilation", [
    (1, (0, 0), 1, 1), (2, (2, 2), 1, 1), (1, (4, 0), 8, 1), (1, (1, 1), 1, 2)])
def test_conv1d(stride, padding, groups, dilation):
    p = {"w": f32(16, 8 // groups, 5), "b": f32(16)}
    jp, tp = both(p)
    x = f32(2, 8, 21)
    check(tl.conv1d(tp, torch.from_numpy(x), stride, padding, groups, dilation),
          jl.conv1d(jp, jnp.asarray(x), stride, padding, groups, dilation))


def test_conv2d():
    p = {"w": f32(6, 3, 3, 3), "b": f32(6)}
    jp, tp = both(p)
    x = f32(2, 3, 19, 80)
    check(tl.conv2d(tp, torch.from_numpy(x), 2), jl.conv2d(jp, jnp.asarray(x), 2))


def test_batch_norm_eval():
    p = {"scale": f32(12), "bias": f32(12), "mean": f32(12),
         "var": (RNG.rand(12) + 0.5).astype(np.float32)}
    jp, tp = both(p)
    x = f32(2, 12, 7)
    check(tl.batch_norm_eval(tp, torch.from_numpy(x), 1e-3, 1),
          jl.batch_norm_eval(jp, jnp.asarray(x), 1e-3, 1))


def test_sinusoidal_pe():
    pos = np.array([-3, 0, 1, 17, 511, 4999], np.int32)
    check(tl.sinusoidal_pe(torch.from_numpy(pos), 64),
          jl.sinusoidal_pe(jnp.asarray(pos), 64), rtol=1e-5, atol=2e-5)


def test_rotary_embed():
    pos = np.array([0, 5, 88, 1023], np.int32)
    tc, ts = tl.rotary_embed(torch.from_numpy(pos), 64, 1e6)
    jc, js = jl.rotary_embed(jnp.asarray(pos), 64, 1e6)
    check(tc, jc)
    check(ts, js)


def test_layer_params_indexes_stacked_tree():
    tree = {"a": {"w": torch.arange(6).reshape(3, 2)}, "b": torch.arange(3)}
    out = tl.layer_params(tree, 1)
    assert out["a"]["w"].tolist() == [2, 3] and int(out["b"]) == 1


def test_masked_softmax():
    s = f32(2, 3, 5, 9)
    m = RNG.rand(2, 1, 5, 9) > 0.4
    m[0, 0, 0] = False  # a fully masked row
    check(tl.masked_softmax(torch.from_numpy(s), torch.from_numpy(m)),
          jl.masked_softmax(jnp.asarray(s), jnp.asarray(m)))
    check(tl.masked_softmax(torch.from_numpy(s), None),
          jl.masked_softmax(jnp.asarray(s), None))


def test_embedding():
    p = {"w": f32(10, 6)}
    jp, tp = both(p)
    ids = np.array([[0, 9, 3]], np.int64)
    check(tl.embedding(tp, torch.from_numpy(ids)), jl.embedding(jp, jnp.asarray(ids)))
