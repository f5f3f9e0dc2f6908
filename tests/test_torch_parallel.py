"""The port's tensor-parallel serving against the JAX mesh engine, on the CPU.

The weights are the committed tiny checkpoint's (2 kv heads, q/k/v
biases), float32 or quantized by the JAX package's `quantize_llm_params`
(int8 with an int8 embedding table, grouped int4), converted leaf for leaf:
the trees the single-process parity tests (test_torch_engine.py,
test_torch_service.py) hold to PROB_ATOL. (With seed-0 random weights the
int8 single-process port is already 2.4e-3 from the JAX engine, bf16
rounding of a less peaked state head: not a property of the sharding.)

- Shards: rank r's slice of every LLM leaf equals, bit for bit, device r's
  addressable shard of the JAX `shard_llm_params` tree on make_mesh((1, 2))
  (the conftest's 8 virtual CPU devices).
- Ticks: two port ranks (gloo CPU processes, tests/_torch_parallel_child.py)
  serve a tp = 2 engine through dual-identity ticks across a KV roll, and
  the JAX ServingEngine on make_mesh((1, 2)) runs the same schedule.
  Limits: PROB_ATOL (tests/test_torch_engine.py's reason) for every tree,
  decisions and KV lengths equal. The port's tp = 2 against its own
  single-process engine: TP_ATOL (where the all_reduce's sums round).

Each child has a hard timeout (CHILD_TIMEOUT): a hang fails its test.
"""

import dataclasses
import functools
import json
import os
import socket
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from freeze_omni_tpu import config as jcfg
from freeze_omni_tpu.ops.quant import quantize_llm_params as jax_quantize
from freeze_omni_tpu.parallel.mesh import make_mesh as jax_make_mesh
from freeze_omni_tpu.parallel.mesh import shard_llm_params as jax_shard
from freeze_omni_tpu.runtime.engine import ServingEngine as JaxEngine
from freeze_omni_tpu.utils.checkpoint import load_native
from freeze_omni_tpu_torch import config as tcfg
from freeze_omni_tpu_torch import weights
from freeze_omni_tpu_torch.parallel import mesh as tmesh
from freeze_omni_tpu_torch.runtime.engine import ServingEngine
from freeze_omni_tpu_torch.utils.checkpoint import save_native
from tests import _torch_parallel_child as child

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ASSET = os.path.join(REPO, "freeze_omni_tpu", "assets", "tiny_s2s")
CHILD_TIMEOUT = 240
PROB_ATOL = 2e-3
# tp = 2 against tp = 1: in float32 the all_reduce only reorders a sum
# (measured 1.2e-7); the quantized trees run bf16 activations, whose o and
# down partial sums each round to bf16 before the all_reduce where one card
# rounds the whole sum once (measured 5.7e-4 int8, 3.2e-4 int4)
TP_ATOL = {"f32": 1e-6, "int8": 1e-3, "int4": 1e-3}
N_TICKS = 14
TREES = ("f32", "int8", "int4")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def start_ranks(job: dict, tmp_path, world: int = 2) -> list:
    """Start the child on `world` gloo ranks; collect_ranks waits for them
    (the caller works meanwhile: the ranks need one core each)."""
    shape = job.get("mesh", [world])
    path = tmp_path / f"job-{job['mode']}-{'x'.join(map(str, shape))}.json"
    path.write_text(json.dumps(job))
    coord = f"127.0.0.1:{_free_port()}"
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep +
               os.environ.get("PYTHONPATH", ""), OMP_NUM_THREADS="1")
    return [subprocess.Popen(
        [sys.executable, os.path.join(REPO, "tests", "_torch_parallel_child.py"),
         coord, str(r), str(world), str(path)], cwd=REPO, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(world)]


def collect_ranks(procs: list) -> dict:
    """{rank: RESULT dict} of started ranks, each within CHILD_TIMEOUT."""
    out = {}
    try:
        for r, p in enumerate(procs):
            so, se = p.communicate(timeout=CHILD_TIMEOUT)
            assert p.returncode == 0, f"rank {r} failed:\n{se[-4000:]}"
            line = [x for x in so.splitlines() if x.startswith("RESULT ")][-1]
            out[r] = json.loads(line[len("RESULT "):])
    finally:
        stop_ranks(procs)
    return out


def stop_ranks(procs: list) -> None:
    for p in procs:   # a hung rank dies with its test
        if p.poll() is None:
            p.kill()
            p.communicate()


def write_config(cfg, path) -> str:
    path.write_text(json.dumps(dataclasses.asdict(cfg)))
    return str(path)


def tick_cfg(mod, tree: str):
    """The checkpoint's config with a 192-slot KV, so the schedule rolls;
    the quantized trees serve an int8 KV (K2's path)."""
    cfg = mod.load_system_config(os.path.join(ASSET, "config.json"))
    llm = dataclasses.replace(cfg.audio_llm.llm, max_kv_len=192)
    return dataclasses.replace(
        cfg, audio_llm=dataclasses.replace(cfg.audio_llm, llm=llm),
        serving=dataclasses.replace(
            cfg.serving, max_sessions=2, kv_margin=64,
            kv_quant_bits=None if tree == "f32" else 8))


@functools.lru_cache(maxsize=None)
def jax_tree(tree: str) -> dict:
    """The checkpoint's audio-LLM tree, the LLM quantized for int8/int4."""
    params = dict(load_native(os.path.join(ASSET, "params"))["audiollm"])
    if tree != "f32":
        params["llm"] = jax_quantize(params["llm"], bits=int(tree[3:]))
    return jax.tree.map(np.asarray, params)


# -- shards -------------------------------------------------------------------


@pytest.mark.parametrize("tree", TREES)
def test_shards_equal_jax_addressable_shards(tree):
    cfg = tick_cfg(jcfg, tree)
    llm = jax_tree(tree)["llm"]
    assert ("w_q" in llm["embed"]) == (tree != "f32")   # the int8 table
    sharded = jax_shard(llm, jax_make_mesh((1, 2)), cfg.audio_llm.llm)
    full = weights.from_jax(llm, device="cpu")
    ours = [tmesh.shard_llm_tree(full, r, 2) for r in range(2)]
    flat_j = jax.tree_util.tree_flatten_with_path(sharded)[0]
    assert len(flat_j) == len(jax.tree.leaves(llm))
    for path, leaf in flat_j:
        keys = [p.key for p in path]
        by_device = {s.device.id: np.asarray(s.data)
                     for s in leaf.addressable_shards}
        for r in range(2):
            mine = ours[r]
            for k in keys:
                mine = mine[k]
            want = by_device[jax_make_mesh((1, 2)).devices[0, r].id]
            got = weights.to_numpy(mine)
            assert got.shape == want.shape, (keys, r)
            assert got.dtype == want.dtype, (keys, r)
            np.testing.assert_array_equal(got, want, err_msg=str((keys, r)))
            assert mine.is_contiguous()


def test_shard_rules_refuse_what_does_not_split():
    cfg = tcfg.tiny_system().audio_llm.llm
    with pytest.raises(ValueError, match="num_kv_heads = 2 does not split"):
        tmesh.check_divisible(cfg, 4)
    with pytest.raises(ValueError, match="row-parallel bias"):
        tmesh._linear_axes("row", 1, {"w": None, "b": None})
    with pytest.raises(ValueError, match=r"needs 2 devices, have 1"):
        tmesh.make_mesh((1, 2))


def test_multihost_job_layout(monkeypatch):
    """The JAX multihost helpers' rules: the env triple wins over the flags,
    one host is no multi-host job, a TP group may not straddle hosts, and
    each host keeps its contiguous rows of a global batch."""
    from freeze_omni_tpu_torch.parallel import multihost as mh

    assert mh.resolve_job(None, 2, 0) is None
    monkeypatch.setenv("FO_COORDINATOR", "h:1")
    monkeypatch.setenv("FO_NUM_HOSTS", "4")
    monkeypatch.setenv("FO_HOST_ID", "3")
    assert mh.resolve_job(None, 2, 0) == ("h:1", 4, 3)
    monkeypatch.setenv("FO_NUM_HOSTS", "1")
    with pytest.raises(ValueError, match="--num_hosts < 2"):
        mh.resolve_job("h:2", 2, 0)
    with pytest.raises(ValueError, match="straddle"):
        mh.make_global_mesh(("data", "model"), model_par=2)
    assert mh.choose_backend("cpu", 4) == "gloo"
    batch = {"x": np.arange(12).reshape(6, 2)}
    np.testing.assert_array_equal(mh.local_batch_slice(batch, 3, 1)["x"],
                                  batch["x"][2:4])
    with pytest.raises(ValueError, match="not divisible"):
        mh.local_batch_slice(batch, 4, 0)


# -- ticks --------------------------------------------------------------------


@pytest.fixture(scope="module")
def tick_runs(tmp_path_factory):
    """{tree: (JAX mesh run, port tp=1 run, port tp=2 rank runs)}."""
    tmp = tmp_path_factory.mktemp("ticks")
    job = {"mode": "ticks", "mesh": [1, 2], "hosts": 1, "n_ticks": N_TICKS,
           "params": {}, "configs": {}}
    for tree in TREES:
        job["params"][tree] = str(tmp / f"{tree}.npz")
        save_native(job["params"][tree], jax_tree(tree))
        job["configs"][tree] = write_config(tick_cfg(tcfg, tree), tmp / f"{tree}.json")
    procs = start_ranks(job, tmp)
    runs, threads = {}, torch.get_num_threads()
    # one torch thread: beside the ranks and the other test workers, the
    # default thread pool makes the tiny reference engine ~40x slower
    torch.set_num_threads(1)
    try:
        for tree in TREES:   # the references, while the ranks run
            params = jax_tree(tree)
            je = JaxEngine(tick_cfg(jcfg, tree), mesh=jax_make_mesh((1, 2)),
                           params=jax.tree.map(np.asarray, params))
            te = ServingEngine(tick_cfg(tcfg, tree), device="cpu",
                               params=weights.from_jax(params, device="cpu"))
            runs[tree] = [child.tick_schedule(je, N_TICKS),
                          child.tick_schedule(te, N_TICKS)]
        ranks = collect_ranks(procs)
    finally:
        torch.set_num_threads(threads)
        stop_ranks(procs)
    for tree in TREES:
        runs[tree].append([ranks[r][tree] for r in (0, 1)])
    return runs


def _max_dprob(a, b) -> float:
    return max(abs(x[s][k] - y[s][k]) for x, y in zip(a, b) for s in x
               for k in ("state_1", "state_2"))


@pytest.mark.parametrize("tree", TREES)
def test_tp2_ticks_match_jax_mesh_engine(tick_runs, tree):
    (j_ticks, j_len), _, ranks = tick_runs[tree]
    thr = tick_cfg(tcfg, tree).duplex.resp_threshold
    assert min(l for ls in j_len for l in ls) >= 0
    rolled = any(b < a for x, y in zip(j_len, j_len[1:]) for a, b in zip(x, y))
    assert rolled, "the schedule never rolled the KV"
    for r in ranks:
        assert _max_dprob(r["ticks"], j_ticks) <= PROB_ATOL
        assert r["lengths"] == j_len
        assert r["device_lengths"] == j_len[-1]
        assert r["decisions"] == [{s: child.decision(p, thr) for s, p in t.items()}
                                  for t in j_ticks]


@pytest.mark.parametrize("tree", TREES)
def test_tp2_ticks_match_the_ports_single_process_engine(tick_runs, tree):
    _, (t_ticks, t_len), ranks = tick_runs[tree]
    for r in ranks:
        assert _max_dprob(r["ticks"], t_ticks) <= TP_ATOL[tree]
        assert r["lengths"] == t_len
    # every rank of the model group returned the same predictions
    assert ranks[0]["ticks"] == ranks[1]["ticks"]


@pytest.mark.parametrize("tree", TREES)
def test_tp2_ranks_draw_the_same_tokens(tick_runs, tree):
    """Top-k / top-p sampling at temperature 0.7 on both model ranks: each
    draws from a generator seeded alike over the all-gathered logits, so a
    diverging draw (which would desynchronise the ranks' KV) cannot occur."""
    ranks = tick_runs[tree][2]
    sampled = ranks[0]["sampled"]
    assert sorted(sampled) == ["a", "b"] and all(sampled.values())
    assert ranks[1]["sampled"] == sampled
    assert ranks[0]["sampled_lengths"] == ranks[1]["sampled_lengths"]
