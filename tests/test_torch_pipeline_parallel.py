"""The port's GPipe forward (parallel/pipeline_parallel.py) against the JAX
`pp_forward`, on the CPU.

The JAX tests' model (hidden 64, 4 layers, 4 / 2 heads with q/k/v biases),
its f32 tree drawn by the JAX `qwen2.init_params` and converted leaf for
leaf, and seed-made numpy embeds [4, 6, 64]. The port's stages are gloo CPU
processes (tests/_torch_parallel_child.py, one torch thread each), started
once for the module: a world of 2 ((P, M) = (2, 2), and the same pipeline
on the int8 tree of the JAX `quantize_llm_params`, which the port runs
through K1's plain version) and a world of 4 ((4, 4), (4, 2), and
(data 2, stage 2) with M = 2 and each data index on its own half of the
batch). Every rank's output must equal the JAX pp_forward on the suite's
virtual CPU mesh of the same shape within the JAX tests' 2e-4 (rtol and
atol). Each rank is handed the full tree and keeps its stage's layers
(stage_tree); stage_tree's cut is checked against the layer stack here.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from freeze_omni_tpu.config import LLMConfig as JLLMConfig
from freeze_omni_tpu.models import qwen2 as jqwen2
from freeze_omni_tpu.ops.quant import quantize_llm_params as jquantize
from freeze_omni_tpu.parallel.mesh import make_mesh as jmake_mesh
from freeze_omni_tpu.parallel.pipeline_parallel import pp_forward as jpp_forward
from freeze_omni_tpu_torch import weights
from freeze_omni_tpu_torch.config import LLMConfig
from freeze_omni_tpu_torch.parallel import mesh as tmesh
from freeze_omni_tpu_torch.parallel.pipeline_parallel import (pp_forward,
                                                               stage_tree)
from freeze_omni_tpu_torch.utils.checkpoint import save_native
from tests.test_torch_parallel import collect_ranks, start_ranks, stop_ranks

TOL = 2e-4
CFG = dict(hidden=64, num_layers=4, num_heads=4, num_kv_heads=2, ffn=128,
           vocab_size=64, max_kv_len=32)
B, T = 4, 6
# (name, world, mesh, axes, microbatches, tree)
CASES = (("P2_M2", 2, (2,), ("stage",), 2, "f32"),
         ("P2_M2_int8", 2, (2,), ("stage",), 2, "int8"),
         ("P4_M4", 4, (4,), ("stage",), 4, "f32"),
         ("P4_M2", 4, (4,), ("stage",), 2, "f32"),
         ("data2_stage2", 4, (2, 2), ("data", "stage"), 2, "f32"))


def jax_trees():
    params = jqwen2.init_params(jax.random.PRNGKey(0), JLLMConfig(**CFG),
                                dtype=jnp.float32)
    return {"f32": jax.tree.map(np.asarray, params),
            "int8": jax.tree.map(np.asarray, jquantize(params, bits=8))}


def embeds():
    return np.random.RandomState(0).randn(B, T, CFG["hidden"]).astype(np.float32)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{case: (the JAX pp_forward's [B, T, D], [each rank's output])}."""
    tmp = tmp_path_factory.mktemp("pipeline")
    trees = jax_trees()
    job = {"mode": "pipeline", "hosts": 1, "cfg": CFG, "params": {},
           "embeds": str(tmp / "embeds.npy")}
    np.save(job["embeds"], embeds())
    for name, tree in trees.items():
        job["params"][name] = str(tmp / f"{name}.npz")
        save_native(job["params"][name], tree)
    procs = {}
    for world in (2, 4):
        out = tmp / f"world{world}"
        out.mkdir()
        cases = [{"name": n, "mesh": list(m), "axes": list(a), "tree": t,
                  "microbatches": mb} for n, w, m, a, mb, t in CASES if w == world]
        procs[world] = start_ranks(dict(job, cases=cases, out=str(out)), tmp,
                                   world=world)
    try:
        want = {}
        for name, _, mesh, axes, mb, tree in CASES:   # while the ranks run
            want[name] = np.asarray(jpp_forward(
                jax.tree.map(jnp.asarray, trees[tree]), JLLMConfig(**CFG),
                jnp.asarray(embeds()), jmake_mesh(mesh, axes),
                num_microbatches=mb))
        for world in procs:
            collect_ranks(procs[world])
    finally:
        for p in procs.values():
            stop_ranks(p)
    got = {}
    for name, world, *_ in CASES:
        got[name] = [np.load(tmp / f"world{world}" / f"rank{r}.npz")[name]
                     for r in range(world)]
    return {name: (want[name], got[name]) for name in want}


@pytest.mark.parametrize("case", [c[0] for c in CASES])
def test_pipeline_matches_jax_pp_forward(runs, case):
    want, ranks = runs[case]
    data = dict((c[0], c[2][0] if c[3][0] == "data" else 1) for c in CASES)[case]
    rows = B // data
    for r, got in enumerate(ranks):
        di = r // (len(ranks) // data)
        # the JAX mesh replicates the batch over 'data'; a port data index
        # runs its own rows
        np.testing.assert_allclose(got, want[di * rows:(di + 1) * rows],
                                   rtol=TOL, atol=TOL, err_msg=f"rank {r}")


def test_stage_tree_cuts_contiguous_layer_blocks():
    tree = weights.from_jax(jax_trees()["int8"], device="cpu")
    parts = [stage_tree(tree, s, 2) for s in range(2)]
    for name in ("q", "down"):
        for leaf, full in tree["layers"][name].items():
            got = torch.cat([p["layers"][name][leaf] for p in parts])
            assert torch.equal(got, full) and all(
                p["layers"][name][leaf].is_contiguous() for p in parts)
            assert parts[1]["layers"][name][leaf].untyped_storage().data_ptr() \
                != full.untyped_storage().data_ptr()
    assert set(parts[0]) == {"layers", "final_norm"}


@pytest.mark.parametrize("batch,microbatches,stages,match", [
    (3, 2, 2, r"\(3, 2\)"),       # B % M
    (4, 2, 3, r"\(4, 3\)"),       # num_layers % P
])
def test_pp_forward_asserts_the_jax_preconditions(batch, microbatches, stages,
                                                  match):
    cfg = LLMConfig(**CFG)
    mesh = tmesh.Mesh((1, stages), 0, 0, 0, inner_axis="stage")
    tree = weights.from_jax(jax_trees()["f32"], device="cpu")
    with pytest.raises(AssertionError, match=match):
        pp_forward(tree, cfg, torch.zeros(batch, T, CFG["hidden"]), mesh,
                   microbatches)


def test_pp_forward_refuses_a_tree_of_another_depth():
    cfg = dataclasses.replace(LLMConfig(**CFG), num_layers=8)
    mesh = tmesh.Mesh((1, 2), 0, 0, 0, inner_axis="stage")
    tree = weights.from_jax(jax_trees()["f32"], device="cpu")   # 4 layers
    with pytest.raises(ValueError, match="neither the model's 8 nor one stage's 4"):
        pp_forward(stage_tree(tree, 0, 4), cfg, torch.zeros(2, T, 64), mesh, 2)
