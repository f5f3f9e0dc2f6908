"""Samplers of the PyTorch port against the JAX package (ops/sampling.py).

JAX keys and torch Generators give different random numbers, so greedy
draws (top_k = 1) must agree exactly, and sampled draws are held to the
distribution: every draw of either package falls inside the top-k/top-p
support, and over 4000 draws each token's frequency lies within five
standard errors (plus 1e-3) of its renormalised probability, computed here
in numpy from the reference's definition. The repetition penalty is a
deterministic select and divide, so it matches exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from freeze_omni_tpu.ops import sampling as js
from freeze_omni_tpu_torch.ops import sampling as ts

N_DRAWS = 4000


def _logits(B=4, V=50, seed=0):
    return np.random.RandomState(seed).randn(B, V).astype(np.float32) * 2.0


def _expected(row, temperature, top_k, top_p):
    """Renormalised probabilities of the reference's order: temperature ->
    softmax -> top-k -> renormalise -> top-p keeping the argmax ->
    renormalise."""
    x = row.astype(np.float64) / temperature
    p = np.exp(x - x.max())
    p /= p.sum()
    order = np.argsort(-p, kind="stable")
    k = top_k if top_k > 0 else len(p)
    vals = p[order[:k]] / p[order[:k]].sum()
    if top_p > 0:
        remove = np.concatenate([[False], np.cumsum(vals)[:-1] > top_p])
        vals = np.where(remove, 0.0, vals)
        vals /= vals.sum()
    out = np.zeros_like(p)
    out[order[:k]] = vals
    return out


@pytest.mark.parametrize("temperature,top_k,top_p", [
    (1.0, 1, 0.0), (0.7, 1, 0.8), (0.7, 0, 1e-6), (0.3, 5, 0.0)])
def test_greedy_draws_are_identical(temperature, top_k, top_p):
    lg = _logits()
    gen = torch.Generator().manual_seed(0)
    for seed in range(3):
        j = js.sample_top_k_top_p(jax.random.PRNGKey(seed), jnp.asarray(lg),
                                  temperature=temperature, top_k=top_k,
                                  top_p=top_p)
        t = ts.sample_top_k_top_p(gen, torch.from_numpy(lg), temperature,
                                  top_k, top_p)
        if top_k == 1 or top_p == 1e-6:
            np.testing.assert_array_equal(t.numpy(), np.asarray(j))
        assert t.dtype == torch.int32
    j1 = js.sample_top_k(jax.random.PRNGKey(0), jnp.asarray(lg), top_k=1)
    t1 = ts.sample_top_k(gen, torch.from_numpy(lg), 1)
    np.testing.assert_array_equal(t1.numpy(), np.asarray(j1))
    np.testing.assert_array_equal(t1.numpy(), lg.argmax(-1))


def _check_frequencies(draws, probs, what):
    counts = np.bincount(draws, minlength=probs.shape[0]) / draws.shape[0]
    assert (counts[probs == 0] == 0).all(), f"{what}: draw outside the support"
    se = np.sqrt(probs * (1 - probs) / draws.shape[0])
    assert (np.abs(counts - probs) <= 5 * se + 1e-3).all(), (what, counts, probs)


@pytest.mark.parametrize("temperature,top_k,top_p", [
    (0.7, 5, 0.8),     # the default SamplingConfig
    (1.0, 4, 0.0),     # the speech decoder's top-k only
    (1.3, 0, 0.9)])    # top-p over the whole vocabulary
def test_sampled_draws_follow_the_renormalised_distribution(temperature, top_k,
                                                            top_p):
    row = _logits(B=1, V=12, seed=3)[0] * 0.25
    probs = _expected(row, temperature, top_k, top_p)
    assert (probs > 0).sum() >= 3
    rep = np.repeat(row[None], N_DRAWS, axis=0)
    t = ts.sample_top_k_top_p(torch.Generator().manual_seed(1),
                              torch.from_numpy(rep), temperature, top_k, top_p)
    j = js.sample_top_k_top_p(jax.random.PRNGKey(1), jnp.asarray(rep),
                              temperature=temperature, top_k=top_k, top_p=top_p)
    _check_frequencies(t.numpy().astype(np.int64), probs, "port")
    _check_frequencies(np.asarray(j).astype(np.int64), probs, "jax")
    if top_p == 0.0:   # sample_top_k is the same sampler without temperature
        t2 = ts.sample_top_k(torch.Generator().manual_seed(2),
                             torch.from_numpy(rep * (1.0 / temperature)), top_k)
        _check_frequencies(t2.numpy().astype(np.int64), probs, "port top-k")


def test_repetition_penalty_matches_exactly():
    lg = _logits(B=3, V=20, seed=5)
    window = np.array([[1, 2, 99], [0, 0, 19], [-1, 5, 20]], np.int32)
    for penalty in (1.1, 2.0):
        j = js.apply_repetition_penalty(jnp.asarray(lg), jnp.asarray(window),
                                        penalty)
        t = ts.apply_repetition_penalty(torch.from_numpy(lg),
                                        torch.from_numpy(window), penalty)
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
