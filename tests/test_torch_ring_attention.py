"""The port's ring attention (parallel/ring_attention.py) against the JAX
`sp_forward`, on the CPU.

The JAX tests' model (hidden 64, 2 layers, 4 / 2 heads with q/k/v biases),
its f32 tree drawn by the JAX `qwen2.init_params` and converted leaf for
leaf, and seed-made numpy embeds [2, 16, 64]. The port's rings are gloo CPU
processes (tests/_torch_parallel_child.py, one torch thread each), started
once for the module: a world of 2 (R = 2 on ('seq',), and the same ring on
the int8 tree of the JAX `quantize_llm_params`, which the port runs through
K1's plain version) and a world of 4 (R = 4, and (data 2, seq 2) with each
data index on its own row of the batch). Each rank gathers the hidden
states of its ring and must equal the JAX sp_forward on the suite's virtual
CPU mesh of the same shape within the JAX tests' 3e-4 (rtol and atol).
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from freeze_omni_tpu.config import LLMConfig as JLLMConfig
from freeze_omni_tpu.models import qwen2 as jqwen2
from freeze_omni_tpu.ops.quant import quantize_llm_params as jquantize
from freeze_omni_tpu.parallel.mesh import make_mesh as jmake_mesh
from freeze_omni_tpu.parallel.ring_attention import sp_forward as jsp_forward
from freeze_omni_tpu_torch.config import LLMConfig
from freeze_omni_tpu_torch.parallel import mesh as tmesh
from freeze_omni_tpu_torch.parallel.ring_attention import seq_slice
from freeze_omni_tpu_torch.utils.checkpoint import save_native
from tests.test_torch_parallel import collect_ranks, start_ranks, stop_ranks

TOL = 3e-4
CFG = dict(hidden=64, num_layers=2, num_heads=4, num_kv_heads=2, ffn=128,
           vocab_size=64, max_kv_len=64)
B, T = 2, 16
# (name, world, mesh, axes, tree)
CASES = (("seq2", 2, (2,), ("seq",), "f32"),
         ("seq2_int8", 2, (2,), ("seq",), "int8"),
         ("seq4", 4, (4,), ("seq",), "f32"),
         ("data2_seq2", 4, (2, 2), ("data", "seq"), "f32"))


def jax_trees():
    params = jqwen2.init_params(jax.random.PRNGKey(0), JLLMConfig(**CFG),
                                dtype=jnp.float32)
    return {"f32": jax.tree.map(np.asarray, params),
            "int8": jax.tree.map(np.asarray, jquantize(params, bits=8))}


def embeds():
    return np.random.RandomState(0).randn(B, T, CFG["hidden"]).astype(np.float32)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{case: (the JAX sp_forward's [B, T, D], [each rank's gathered
    output])}."""
    tmp = tmp_path_factory.mktemp("ring")
    trees = jax_trees()
    job = {"mode": "ring", "hosts": 1, "cfg": CFG, "params": {},
           "embeds": str(tmp / "embeds.npy")}
    np.save(job["embeds"], embeds())
    for name, tree in trees.items():
        job["params"][name] = str(tmp / f"{name}.npz")
        save_native(job["params"][name], tree)
    procs = {}
    for world in (2, 4):
        out = tmp / f"world{world}"
        out.mkdir()
        cases = [{"name": n, "mesh": list(m), "axes": list(a), "tree": t}
                 for n, w, m, a, t in CASES if w == world]
        procs[world] = start_ranks(dict(job, cases=cases, out=str(out)), tmp,
                                   world=world)
    try:
        want = {}
        for name, _, mesh, axes, tree in CASES:   # while the ranks run
            want[name] = np.asarray(jsp_forward(
                jax.tree.map(jnp.asarray, trees[tree]), JLLMConfig(**CFG),
                jnp.asarray(embeds()), jmake_mesh(mesh, axes)))
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
def test_ring_matches_jax_sp_forward(runs, case):
    want, ranks = runs[case]
    data = dict((c[0], c[2][0] if c[3][0] == "data" else 1) for c in CASES)[case]
    rows = B // data
    for r, got in enumerate(ranks):
        di = r // (len(ranks) // data)
        np.testing.assert_allclose(got, want[di * rows:(di + 1) * rows],
                                   rtol=TOL, atol=TOL, err_msg=f"rank {r}")


def test_seq_slice_asserts_the_jax_precondition():
    mesh = tmesh.Mesh((1, 3), 0, 0, 0, inner_axis="seq")
    with pytest.raises(AssertionError, match=r"\(16, 3\)"):
        seq_slice(torch.zeros(2, 16, 4), mesh)
    x = torch.arange(2 * 18).reshape(2, 18).float()[..., None]
    mesh = dataclasses.replace(mesh, inner_index=2)
    assert torch.equal(seq_slice(x, mesh), x[:, 12:18])


@pytest.mark.parametrize("shape,axes,grid,inner", [
    ((1,), ("seq",), (1, 1), "seq"),
    ((1,), ("stage",), (1, 1), "stage"),
    ((1,), ("model",), (1, 1), "model"),
    ((1,), ("data",), (1, 1), "model"),
    ((1, 1), ("data", "seq"), (1, 1), "seq"),
    ((1, 1), ("data", "stage"), (1, 1), "stage"),
])
def test_make_mesh_takes_the_named_axes(shape, axes, grid, inner):
    mesh = tmesh.make_mesh(shape, axes)
    assert mesh.shape == grid and mesh.inner_axis == inner
    assert mesh.axis_size(axes[-1]) == 1 and mesh.axis_index(axes[-1]) == 0
    assert mesh.model == 1 and mesh.model_group is None


@pytest.mark.parametrize("shape,axes,match", [
    ((2,), ("seq",), r"needs 2 devices, have 1"),
    ((2, 2), ("data", "stage"), r"needs 4 devices, have 1"),
    ((1, 1), ("seq", "data"), "axes must be"),
    ((1, 1, 1), ("data", "seq", "model"), "axes must be"),
    ((1,), ("expert",), "axes must be"),
    ((1, 1), ("data",), "does not match"),
])
def test_make_mesh_refuses(shape, axes, match):
    with pytest.raises(ValueError, match=match):
        tmesh.make_mesh(shape, axes)


def test_a_mesh_reads_only_its_own_axes():
    mesh = tmesh.Mesh((2, 4), 5, 1, 1, inner_axis="seq")
    assert (mesh.axis_size("data"), mesh.axis_size("seq")) == (2, 4)
    assert (mesh.axis_index("data"), mesh.axis_index("seq")) == (1, 1)
    assert mesh.rank_of(1, 3) == 7
    # the tensor-parallel callers see one model rank on a 'seq' mesh
    assert (mesh.model, mesh.model_index, mesh.model_group) == (1, 0, None)
    with pytest.raises(ValueError, match="no axis 'model'"):
        mesh.axis_size("model")
    tp = tmesh.Mesh((1, 2), 1, 0, 1, inner_group="g")
    assert (tp.model, tp.model_index, tp.model_group) == (2, 1, "g")
