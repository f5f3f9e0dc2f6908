"""Decode attention (kernels K3/K4) of the PyTorch port against the JAX
package, on the CPU, where the wrappers run their plain version.

The JAX Pallas kernels run in interpret mode, as tests/test_ops.py runs
them. Everything is float32; the plain version and the JAX kernels differ
only in the order of f32 sums (and a division by sqrt(dk) against a
multiplication by its inverse), so outputs agree to 1e-5, the tolerance of
tests/test_ops.py. Rows with length 0 are masked rows: the JAX kernels leave
them unspecified and the port writes zeros, so they are compared to zero, not
to JAX. The T = 1 float-cache branch of qwen2.forward, which calls
gqa_decode, is held to the JAX forward at 1e-4 (its hidden-state tolerance in
test_torch_qwen2.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from freeze_omni_tpu.config import tiny_system as jax_tiny
from freeze_omni_tpu.models import qwen2 as jq
from freeze_omni_tpu.ops import attention as jatt
from freeze_omni_tpu_torch import weights
from freeze_omni_tpu_torch.config import tiny_system
from freeze_omni_tpu_torch.models import qwen2 as tq
from freeze_omni_tpu_torch.ops import attention as tatt

TOL = 1e-5


def _inputs(B, H, Hkv, dk, S, seed):
    rng = np.random.RandomState(seed)
    return (rng.randn(B, H, dk).astype(np.float32),
            rng.randn(B, S, Hkv, dk).astype(np.float32),
            rng.randn(B, S, Hkv, dk).astype(np.float32))


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


@pytest.mark.parametrize("B,H,Hkv,dk,S", [
    (4, 8, 2, 128, 256),
    (2, 28, 4, 128, 512),    # the LLM's GQA (rep 7)
    (1, 4, 4, 128, 128),     # no grouping
    (3, 14, 14, 64, 96),     # the speech decoder's heads
])
def test_plain_version_matches_pallas_decode_attention(B, H, Hkv, dk, S):
    q, k, v = _inputs(B, H, Hkv, dk, S, seed=B + S)
    length = np.random.RandomState(S).randint(1, S + 1, (B,)).astype(np.int32)
    j = jatt.decode_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              jnp.asarray(length), interpret=True)
    for fn in (tatt.decode_attention, tatt.decode_attention_blocked,
               tatt.gqa_decode, tatt.decode_attention_reference):
        t = fn(*_t(q, k, v, length))
        assert t.dtype == torch.float32 and t.shape == (B, H, dk)
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=TOL, atol=TOL)


def test_plain_version_matches_pallas_blocked_at_ragged_lengths():
    B, H, Hkv, dk, S = 3, 8, 2, 128, 1024
    q, k, v = _inputs(B, H, Hkv, dk, S, seed=3)
    length = np.array([5, 300, 1024], np.int32)
    j = jatt.decode_attention_blocked(jnp.asarray(q), jnp.asarray(k),
                                      jnp.asarray(v), jnp.asarray(length),
                                      block=256, interpret=True)
    t = tatt.decode_attention_blocked(*_t(q, k, v, length), block=256)
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("fill", [1e6, np.nan])
def test_masked_slots_have_no_influence(fill):
    """Slots at or past length (the scratch slot S-1 among them) may hold
    anything: huge values or NaN there leave every output bit unchanged, and
    a length-0 row comes out as zeros."""
    B, H, Hkv, dk, S = 3, 4, 2, 64, 64
    q, k, v = _inputs(B, H, Hkv, dk, S, seed=1)
    length = np.array([10, 0, 63], np.int32)
    base = tatt.decode_attention_reference(*_t(q, k, v, length)).numpy()
    k2, v2 = k.copy(), v.copy()
    for b, n in enumerate(length):
        k2[b, n:] = fill
        v2[b, n:] = -fill
    k2[:, S - 1] = fill
    for fn in (tatt.decode_attention, tatt.decode_attention_blocked):
        out = fn(*_t(q, k2, v2, length)).numpy()
        np.testing.assert_array_equal(out, base)
    assert (base[1] == 0).all()
    j = jatt.decode_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              jnp.asarray(length), interpret=True)
    valid = length > 0
    np.testing.assert_allclose(base[valid], np.asarray(j)[valid], rtol=TOL,
                               atol=TOL)


def test_wrappers_raise_off_cpu_and_cuda_and_count_no_cpu_launches():
    q, k, v = _inputs(1, 4, 2, 64, 16, seed=0)
    length = np.array([3], np.int32)
    before = (tatt.decode_attention.launches,
              tatt.decode_attention_blocked.launches)
    tatt.gqa_decode(*_t(q, k, v, length))
    assert (tatt.decode_attention.launches,
            tatt.decode_attention_blocked.launches) == before
    meta = [x.to("meta") for x in _t(q, k, v, length)]
    for fn in (tatt.decode_attention, tatt.decode_attention_blocked):
        with pytest.raises(ValueError, match="unsupported device"):
            fn(*meta)


@pytest.mark.parametrize("pos_offset", [0, "rows"])
def test_qwen2_single_token_decode_matches_jax(pos_offset):
    """Decode steps (T = 1) on a float cache, the branch that calls
    gqa_decode, after a ragged prefill; one row masked on some steps (its
    cache must not grow) and, in the second case, a per-row RoPE offset as
    the speech decoder uses."""
    jcfg, tcfg = jax_tiny().audio_llm.llm, tiny_system().audio_llm.llm
    jp = jax.tree.map(np.asarray, jq.init_params(jax.random.PRNGKey(0), jcfg,
                                                 dtype=jnp.float32))
    tp = weights.from_jax(jp, device="cpu")
    B, S = 3, 40
    jkv = jq.init_cache(jcfg, B, S, jnp.float32)
    tkv = tq.init_cache(tcfg, B, S, torch.float32, device="cpu")
    rng = np.random.RandomState(2)
    off = np.array([0, 2, 5], np.int32) if pos_offset == "rows" else 0
    fwd = jax.jit(jq.forward, static_argnames=("cfg",))
    for step in range(6):
        T = 7 if step == 0 else 1
        emb = rng.randn(B, T, tcfg.hidden).astype(np.float32)
        mask = np.ones((B, T), bool)
        if step == 0:
            mask[2, 4:] = False
        elif step % 2:
            mask[1] = False
        jh, jkv = fwd(jp, jcfg, jnp.asarray(emb), jnp.asarray(mask), jkv,
                      pos_offset=jnp.asarray(off))
        th, _ = tq.forward(tp, tcfg, torch.from_numpy(emb),
                           torch.from_numpy(mask), tkv,
                           pos_offset=torch.as_tensor(off))
        np.testing.assert_allclose(th.numpy()[mask], np.asarray(jh)[mask],
                                   rtol=1e-4, atol=1e-4, err_msg=f"step {step}")
        np.testing.assert_array_equal(tkv.length.numpy(), np.asarray(jkv.length))
    L = int(tkv.length.max())
    np.testing.assert_allclose(tkv.k.numpy()[:, :, :L], np.asarray(jkv.k)[:, :, :L],
                               rtol=1e-4, atol=1e-4)
