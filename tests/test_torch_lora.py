"""The port's LoRA merge (models/lora.py) against the JAX package's, on the
CPU: dense, int8 and int4 trees with every target and B drawn non-zero, one
dual tick on a merged int8 tree, the adapter file format both ways.

Merged dense leaves agree to 1e-6. A quantized merge requantizes w + delta.
Both packages sum the delta in f32, and XLA at the suite's optimization
level sums it in PyTorch's order, so the merged weights are the same; the
JAX merge runs compiled, where XLA turns amax / 127 (and / 7) into a
multiply by the reciprocal. So scales agree to 1 f32 ulp (also given the
same merged weights, test_requantization_is_within_one_ulp_of_jax), codes
are equal where the scales are and within one elsewhere.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from freeze_omni_tpu import config as jcfg_mod
from freeze_omni_tpu.models import lora as jlora
from freeze_omni_tpu.models import qwen2 as jqwen2
from freeze_omni_tpu.ops.quant import quantize_llm_params as jax_quantize
from freeze_omni_tpu.runtime.engine import ServingEngine as JaxEngine
from freeze_omni_tpu.utils.checkpoint import load_native
from freeze_omni_tpu_torch import config as tcfg_mod
from freeze_omni_tpu_torch import weights
from freeze_omni_tpu_torch.models import lora as tlora
from freeze_omni_tpu_torch.runtime.engine import ServingEngine
from tests.test_torch_engine import PROB_ATOL

ASSET = os.path.abspath(os.path.join(os.path.dirname(__file__), "..",
                                     "freeze_omni_tpu", "assets", "tiny_s2s"))
SCALE = 0.7


def _adapter(cfg, rank=4, seed=1):
    """A rank-`rank` adapter on all 7 targets from the JAX init, with B
    drawn non-zero (an untrained adapter's B is zero)."""
    tree = jlora.init(jax.random.PRNGKey(seed), cfg, rank=rank,
                      targets=jlora.TARGETS)
    rng = np.random.RandomState(seed)
    return {k: {"a": np.asarray(v["a"]),
                "b": (0.05 * rng.randn(*v["b"].shape)).astype(np.float32)}
            for k, v in tree.items()}


def _ulps(a, b):
    return np.abs(a.view(np.int32).astype(np.int64)
                  - b.view(np.int32).astype(np.int64))


def assert_merged_close(got, want):
    """The merge rule of the module docstring, leaf by leaf over the 7
    targets; every other leaf equal."""
    for name, leaves in want["layers"].items():
        if name not in jlora.TARGETS:
            continue
        scale_key = "scale" if "w_q" in leaves else "scale4"
        for key, w in leaves.items():
            g = got["layers"][name][key]
            assert g.dtype == w.dtype and g.shape == w.shape, (name, key)
            if key == "w":
                np.testing.assert_allclose(g, w, rtol=0, atol=1e-6)
            elif key in ("scale", "scale4"):
                assert _ulps(g, w).max() <= 1, (name, key)
            elif key in ("w_q", "w_q4"):
                same = got["layers"][name][scale_key] == leaves[scale_key]
                if key == "w_q4":   # two codes a byte, one scale a group
                    rows = same.repeat(g.shape[-2] // same.shape[-2], axis=-2)
                    parts = [(g & 0xF, w & 0xF), (g >> 4, w >> 4)]
                else:               # [L, K, O] codes, [L, O] scales
                    rows = np.broadcast_to(same[..., None, :], g.shape)
                    parts = [(g, w)]
                for a, b in parts:
                    d = np.abs(a.astype(np.int16) - b.astype(np.int16))
                    assert d.max() <= 1 and not d[rows].any(), (name, key)
            else:
                np.testing.assert_array_equal(g, w)


@pytest.fixture(scope="module")
def llm_tree():
    cfg = jcfg_mod.tiny_system().audio_llm.llm
    tree = jqwen2.init_params(jax.random.PRNGKey(0), cfg, dtype=jnp.float32)
    return cfg, tree, _adapter(cfg)


@pytest.mark.parametrize("bits", [None, 8, 4])
def test_merge_matches_jax(llm_tree, bits):
    cfg, tree, adapter = llm_tree
    src = tree if bits is None else jax_quantize(tree, bits=bits)
    want = jax.tree.map(np.asarray, jlora.merge(
        src, jax.tree.map(jnp.asarray, adapter), SCALE))
    got = weights.to_numpy(tlora.merge(
        weights.from_jax(jax.tree.map(np.asarray, src), device="cpu"),
        adapter, SCALE))
    assert_merged_close(got, want)


def _worst_scale_ulps(got, want, bits):
    key = "scale" if bits == 8 else "scale4"
    return max(int(_ulps(got["layers"][n][key], want["layers"][n][key]).max())
               for n in jlora.TARGETS)


@pytest.mark.parametrize("bits", [8, 4])
def test_requantization_is_within_one_ulp_of_jax(llm_tree, bits):
    """Given the same merged f32 weights (the JAX dense merge), the port's
    requantization and the JAX one compiled, as the JAX merge runs it:
    scales within 1 f32 ulp, codes equal where the scales are and within
    one elsewhere."""
    from freeze_omni_tpu.ops import quant as jquant
    from freeze_omni_tpu_torch.ops import quant as tquant

    _, tree, adapter = llm_tree
    dense = jlora.merge(tree, jax.tree.map(jnp.asarray, adapter), SCALE)
    if bits == 8:
        jq, tq = jax.jit(jquant.quantize_linear), tquant.quantize_linear
    else:
        jq, tq = jax.jit(jquant.quantize_linear_int4), tquant.quantize_linear_int4
    want = {"layers": {}}
    got = {"layers": {}}
    for name in jlora.TARGETS:
        w = dense["layers"][name]["w"]
        want["layers"][name] = jax.tree.map(np.asarray, jq({"w": w}))
        got["layers"][name] = weights.to_numpy(
            tq({"w": torch.from_numpy(np.array(w))}))
    assert _worst_scale_ulps(got, want, bits) <= 1
    assert_merged_close(got, want)


def test_merge_leaves_its_input_unmodified(llm_tree):
    _, tree, adapter = llm_tree
    src = weights.from_jax(jax.tree.map(np.asarray, jax_quantize(tree, bits=4)),
                           device="cpu")
    before = jax.tree.map(np.copy, weights.to_numpy(src))
    merged = tlora.merge(src, adapter, SCALE)
    assert merged is not src and merged["layers"] is not src["layers"]
    after = weights.to_numpy(src)
    for got, want in zip(jax.tree.leaves(after), jax.tree.leaves(before)):
        np.testing.assert_array_equal(got, want)
    assert not np.array_equal(weights.to_numpy(merged["layers"]["q"]["w_q4"]),
                              before["layers"]["q"]["w_q4"])


def test_untrained_adapter_changes_nothing():
    cfg = tcfg_mod.tiny_system().audio_llm.llm
    from freeze_omni_tpu_torch.models import qwen2

    g = torch.Generator().manual_seed(0)
    llm = qwen2.init_params(cfg, g, dtype=torch.float32, device="cpu")
    adapter = tlora.init(cfg, g, rank=4, targets=tlora.TARGETS, device="cpu")
    assert set(adapter) == set(tlora.TARGETS)
    for name, pair in adapter.items():
        assert tuple(pair["a"].shape) == (cfg.num_layers, tlora._dims(cfg, name)[0], 4)
        assert not pair["b"].any()
    merged = tlora.merge(llm, adapter)
    for name in tlora.TARGETS:
        assert torch.equal(merged["layers"][name]["w"], llm["layers"][name]["w"])


def test_unknown_targets_are_refused():
    cfg = tcfg_mod.tiny_system().audio_llm.llm
    with pytest.raises(ValueError, match="unknown LoRA targets"):
        tlora.init(cfg, torch.Generator(), targets=("q", "qkv"), device="cpu")
    with pytest.raises(ValueError, match="unknown LoRA targets"):
        tlora.merge({"layers": {}}, {"lm_head": {"a": np.zeros((1, 2, 1)),
                                                 "b": np.zeros((1, 1, 2))}})


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_adapter_files_load_in_the_other_package(llm_tree, tmp_path, writer):
    """The .npz of either package loads in the other, bit for bit, scale
    included."""
    _, _, adapter = llm_tree
    path = str(tmp_path / "adapter.npz")
    if writer == "jax":
        jlora.save(path, jax.tree.map(jnp.asarray, adapter), scale=0.25)
        tree, scale = tlora.load(path)
    else:
        tlora.save(path, {k: {leaf: torch.tensor(v) for leaf, v in p.items()}
                          for k, p in adapter.items()}, scale=0.25)
        tree, scale = jlora.load(path)
    assert scale == 0.25 and set(tree) == set(adapter)
    for name, pair in adapter.items():
        for leaf in ("a", "b"):
            np.testing.assert_array_equal(np.asarray(tree[name][leaf]), pair[leaf])


def test_dual_tick_on_a_merged_int8_tree_matches_jax():
    """The committed tiny system with int8 weights and the adapter merged by
    each package: one fused dual tick (user and system chunks) of two
    sessions through each engine, probabilities within PROB_ATOL."""
    cfgs = {m: m.load_system_config(os.path.join(ASSET, "config.json"))
            for m in (jcfg_mod, tcfg_mod)}
    tree = load_native(os.path.join(ASSET, "params"))["audiollm"]
    adapter = _adapter(cfgs[jcfg_mod].audio_llm.llm, rank=8, seed=3)
    jparams = dict(tree)
    jparams["llm"] = jlora.merge(jax_quantize(tree["llm"]),
                                 jax.tree.map(jnp.asarray, adapter), SCALE)
    tparams = weights.from_jax(jax.tree.map(np.asarray, dict(tree)), device="cpu")
    tparams["llm"] = tlora.merge(
        weights.from_jax(jax.tree.map(np.asarray, jax_quantize(tree["llm"])),
                         device="cpu"), adapter, SCALE)
    je = JaxEngine(cfgs[jcfg_mod], params=jparams)
    te = ServingEngine(cfgs[tcfg_mod], params=tparams, device="cpu")
    rng = np.random.RandomState(4)
    chunks = {(sid, ident): rng.randn(1, 32, 80).astype(np.float32)
              for sid in "ab" for ident in ("user", "system")}
    out = {}
    for name, e in (("jax", je), ("port", te)):
        for sid in "ab":
            e.open_session(sid)
            for ident in ("user", "system"):
                e.submit_chunk(sid, ident, chunks[sid, ident], is_sl=True)
        res = e.tick()["user"]
        out[name] = np.array([[res[e.store.slot_of(s)][k]
                               for k in ("state_1", "state_2")] for s in "ab"])
    np.testing.assert_allclose(out["port"], out["jax"], rtol=0, atol=PROB_ATOL)
