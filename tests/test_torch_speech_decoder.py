"""AR speech-token decoder of the PyTorch port against the JAX package
(models/speech_decoder.py), on the CPU.

Two weight sets: `tiny_system()` random weights drawn by JAX (the tiny
config has use_prefix_kv=True, so the prefix stack runs) and the committed
tiny checkpoint (use_prefix_kv=False). The same numpy inputs go through both
packages. Hidden states and caches are float32 in both and differ only in
the order of f32 sums, so they agree to 1e-4 (the hidden-state tolerance of
test_torch_qwen2.py). Decoding is greedy (top_k = 1) with a repetition
penalty window of 10, so the codec tokens must be identical.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from freeze_omni_tpu import config as jcfg_mod
from freeze_omni_tpu.models import speech_decoder as jsd
from freeze_omni_tpu.utils.checkpoint import load_native
from freeze_omni_tpu_torch import config as tcfg_mod
from freeze_omni_tpu_torch import weights
from freeze_omni_tpu_torch.models import speech_decoder as tsd

ASSET = os.path.abspath(os.path.join(os.path.dirname(__file__), "..",
                                     "freeze_omni_tpu", "assets", "tiny_s2s"))
TOL = 1e-4
PENALTY_WINDOW, PENALTY = 10, 1.1


@pytest.fixture(scope="module", params=["random", "checkpoint"])
def decoder(request):
    """(jax params, port params, jax cfg, port cfg) of one weight set, with
    max_kv_len cut to 64 slots."""
    if request.param == "random":
        jcfg = jcfg_mod.tiny_system().tts.decoder
        tcfg = tcfg_mod.tiny_system().tts.decoder
        jp = jsd.init_params(jax.random.PRNGKey(5), jcfg)
    else:
        path = os.path.join(ASSET, "config.json")
        jcfg = jcfg_mod.load_system_config(path).tts.decoder
        tcfg = tcfg_mod.load_system_config(path).tts.decoder
        jp = load_native(os.path.join(ASSET, "params"))["tts"]["decoder"]
    jcfg = dataclasses.replace(jcfg, max_kv_len=64)
    tcfg = dataclasses.replace(tcfg, max_kv_len=64)
    np_params = jax.tree.map(np.asarray, jp)
    return np_params, weights.from_jax(np_params, device="cpu"), jcfg, tcfg


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _preamble_jax(p, cfg, hidden, h_mask, prefix, p_mask):
    cache = jsd.init_cache(cfg, hidden.shape[0])
    if cfg.use_prefix_kv:
        cache = jsd.prefix_prefill(p, cfg, prefix, p_mask, cache)
    pre = jsd.pre_nn(p, cfg, hidden, h_mask)
    bos = jsd.embedding(p["embedding"], jnp.full((hidden.shape[0], 1), cfg.bos_id))
    block = jnp.concatenate([bos, pre], axis=1)
    b_mask = jnp.concatenate([jnp.ones((hidden.shape[0], 1), bool), h_mask], 1)
    out, cache = jsd.prefill(p, cfg, block, b_mask, cache)
    return pre, out, cache


_decode_jax = jax.jit(jsd.decode_segment, static_argnames=(
    "cfg", "n_steps", "top_k", "penalty_window", "penalty"))


def test_preamble_and_greedy_decode_match_jax(decoder):
    jp, tp, jcfg, tcfg = decoder
    rng = np.random.RandomState(0)
    B, T, P, D = 2, 7, 5, tcfg.idim
    hidden = rng.randn(B, T, D).astype(np.float32)
    prefix = rng.randn(B, P, D).astype(np.float32)
    h_mask = np.ones((B, T), bool)
    h_mask[1, 5:] = False                       # ragged text block
    p_mask = np.ones((B, P), bool)
    p_mask[0, 3:] = False                       # ragged prefix

    j_pre, j_out, j_cache = jax.jit(_preamble_jax, static_argnames="cfg")(
        jp, jcfg, jnp.asarray(hidden), jnp.asarray(h_mask), jnp.asarray(prefix),
        jnp.asarray(p_mask))
    with torch.no_grad():
        t_pre = tsd.pre_nn(tp, tcfg, _t(hidden), _t(h_mask))
        cache = tsd.init_cache(tcfg, B, device="cpu")
        if tcfg.use_prefix_kv:
            cache = tsd.prefix_prefill(tp, tcfg, _t(prefix), _t(p_mask), cache)
        bos = tsd.embedding(tp["embedding"],
                            torch.full((B, 1), tcfg.bos_id, dtype=torch.long))
        block = torch.cat([bos, t_pre], 1)
        b_mask = torch.cat([torch.ones((B, 1), dtype=torch.bool), _t(h_mask)], 1)
        t_out, cache = tsd.prefill(tp, tcfg, block, b_mask, cache)
    np.testing.assert_allclose(t_pre.numpy()[h_mask], np.asarray(j_pre)[h_mask],
                               rtol=TOL, atol=TOL)
    bm = np.concatenate([np.ones((B, 1), bool), h_mask], 1)
    np.testing.assert_allclose(t_out.numpy()[bm], np.asarray(j_out)[bm],
                               rtol=TOL, atol=TOL)
    np.testing.assert_array_equal(cache.kv.length.numpy(),
                                  np.asarray(j_cache.kv.length))
    np.testing.assert_array_equal(cache.prefix_len.numpy(),
                                  np.asarray(j_cache.prefix_len))
    L = int(cache.kv.length.max())
    np.testing.assert_allclose(cache.kv.k.numpy()[:, :, :L],
                               np.asarray(j_cache.kv.k)[:, :, :L], rtol=TOL, atol=TOL)

    # greedy decode with the penalty ring, then a segment with row 1 frozen
    j_state = jsd.init_decode_state(jcfg, j_cache, PENALTY_WINDOW)
    t_state = tsd.init_decode_state(tcfg, cache, PENALTY_WINDOW)
    gen = torch.Generator().manual_seed(0)
    for seg, active in enumerate((None, np.array([True, False]))):
        j_toks, j_state = _decode_jax(
            jp, jcfg, j_state, jax.random.PRNGKey(seg), n_steps=12, top_k=1,
            penalty_window=PENALTY_WINDOW, penalty=PENALTY,
            active=None if active is None else jnp.asarray(active))
        with torch.no_grad():
            t_toks, t_state = tsd.decode_segment(
                tp, tcfg, t_state, gen, n_steps=12, top_k=1,
                penalty_window=PENALTY_WINDOW, penalty=PENALTY,
                active=None if active is None else _t(active))
        np.testing.assert_array_equal(t_toks.numpy(), np.asarray(j_toks),
                                      err_msg=f"segment {seg}")
        for name in ("cur_token", "recent", "done"):
            np.testing.assert_array_equal(
                getattr(t_state, name).numpy(), np.asarray(getattr(j_state, name)),
                err_msg=f"segment {seg} {name}")
        np.testing.assert_array_equal(t_state.cache.kv.length.numpy(),
                                      np.asarray(j_state.cache.kv.length))
    # the frozen row neither grew nor emitted anything but pad
    assert (t_toks.numpy()[1] == tcfg.pad_id).all()


def test_init_params_mirror_the_jax_tree():
    jcfg = jcfg_mod.tiny_system().tts.decoder
    tcfg = tcfg_mod.tiny_system().tts.decoder
    jshapes = jax.tree.map(lambda a: (a.shape, str(a.dtype)),
                           jsd.init_params(jax.random.PRNGKey(0), jcfg))
    tp = tsd.init_params(tcfg, torch.Generator().manual_seed(0), device="cpu")
    tshapes = jax.tree.map(lambda t: (tuple(t.shape), str(t.dtype).split(".")[-1]),
                           tp)
    assert tshapes == jshapes
