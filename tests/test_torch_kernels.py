"""Plain PyTorch versions of the port's kernels (K1 int8 weight-only matmul,
K2 int8-KV prefill attention) against the JAX Pallas kernels, run in
interpret mode as tests/test_kv_quant.py runs them, and against their XLA
references. On CPU tensors the wrappers run these plain versions and launch
nothing.

Tolerance: 1e-4 on float32 data (the same arithmetic, summed in another
order; the plain K1 applies the scale before the dot and the Pallas kernel
inside it)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from freeze_omni_tpu.models import layers as jlayers
from freeze_omni_tpu.ops import attention as jatt
from freeze_omni_tpu.ops import quant_matmul as jqm
from freeze_omni_tpu_torch.ops import attention as tatt
from freeze_omni_tpu_torch.ops import quant_matmul as tqm

TOL = dict(rtol=1e-4, atol=1e-4)


def _k1(N, K, O, seed):
    rng = np.random.RandomState(seed)
    x = rng.randn(N, K).astype(np.float32)
    w_q = rng.randint(-127, 128, (K, O)).astype(np.int8)
    scale = ((rng.rand(O) + 0.5) / (127.0 * np.sqrt(K))).astype(np.float32)
    return x, w_q, scale


@pytest.mark.parametrize("N", [1, 5, 13])
def test_quant_matmul_plain_matches_pallas_interpret(N):
    x, w_q, scale = _k1(N, 256, 384, seed=N)
    ref = jqm.quant_matmul(jnp.asarray(x), jnp.asarray(w_q), jnp.asarray(scale),
                           block_k=128, block_o=128, interpret=True)
    out = tqm.quant_matmul_reference(torch.from_numpy(x), torch.from_numpy(w_q),
                                     torch.from_numpy(scale))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def test_quant_matmul_plain_matches_linear_int8_branch():
    x, w_q, scale = _k1(7, 96, 40, seed=1)
    ref = jlayers.linear({"w_q": jnp.asarray(w_q), "scale": jnp.asarray(scale)},
                         jnp.asarray(x))
    out = tqm.quant_matmul_reference(torch.from_numpy(x), torch.from_numpy(w_q),
                                     torch.from_numpy(scale))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def test_quant_matmul_wrapper_runs_plain_on_cpu_without_launching():
    x, w_q, scale = _k1(3, 64, 20, seed=2)
    before = tqm.quant_matmul.launches
    args = (torch.from_numpy(x).to(torch.bfloat16), torch.from_numpy(w_q),
            torch.from_numpy(scale))
    y = tqm.quant_matmul(*args)
    assert tqm.quant_matmul.launches == before
    assert y.dtype == torch.bfloat16 and y.shape == (3, 20)
    torch.testing.assert_close(y, tqm.quant_matmul_reference(*args), rtol=0, atol=0)


def _k2(B, T, H, Hkv, dk, S, seed):
    rng = np.random.RandomState(seed)
    q = rng.randn(B, T, H, dk).astype(np.float32)
    k_q = rng.randint(-127, 128, (B, S, Hkv, dk)).astype(np.int8)
    v_q = rng.randint(-127, 128, (B, S, Hkv, dk)).astype(np.int8)
    k_s = (0.01 + rng.rand(B, S, Hkv) * 0.05).astype(np.float32)
    v_s = (0.01 + rng.rand(B, S, Hkv) * 0.05).astype(np.float32)
    qend = rng.randint(0, S, (B, T)).astype(np.int32)   # ragged, with zeros
    qend[0, 0] = 0
    return q, k_q, k_s, v_q, v_s, qend


@pytest.mark.parametrize("B,T,H,Hkv,dk,S", [(3, 6, 8, 2, 16, 64),
                                            (2, 29, 8, 2, 64, 96)])
def test_prefill_quant_plain_matches_pallas_and_reference(B, T, H, Hkv, dk, S):
    args = _k2(B, T, H, Hkv, dk, S, seed=S)
    j = [jnp.asarray(a) for a in args]
    pallas = np.asarray(jatt.prefill_quant_pallas(*j, interpret=True))
    ref = np.asarray(jatt.prefill_quant_reference(*j))
    out = tatt.prefill_quant_reference(*[torch.from_numpy(a) for a in args]).numpy()
    valid = args[-1] > 0   # qend = 0 rows are unspecified in the JAX versions
    np.testing.assert_allclose(out[valid], pallas[valid], **TOL)
    np.testing.assert_allclose(out[valid], ref[valid], **TOL)
    assert np.isfinite(out).all() and (out[~valid] == 0).all()


def test_prefill_quant_masked_scratch_slot_never_reaches_the_result():
    q, k_q, k_s, v_q, v_s, qend = _k2(2, 5, 4, 2, 16, 32, seed=3)
    qend = np.minimum(qend, 31)
    k_s[:, 31] = np.nan
    v_s[:, 31] = np.inf
    t = [torch.from_numpy(a) for a in (q, k_q, k_s, v_q, v_s, qend)]
    before = tatt.prefill_quant.launches
    out = tatt.prefill_quant(*t).numpy()
    assert tatt.prefill_quant.launches == before
    assert np.isfinite(out).all()
    k_s[:, 31] = 1.0
    v_s[:, 31] = 1.0
    clean = tatt.prefill_quant_reference(
        *[torch.from_numpy(a) for a in (q, k_q, k_s, v_q, v_s, qend)]).numpy()
    np.testing.assert_array_equal(out, clean)
