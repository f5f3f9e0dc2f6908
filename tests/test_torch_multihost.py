"""Lockstep multi-process serving of the port (runtime/multihost_serving.py)
on the CPU, against the JAX package's single-process engine.

Two gloo CPU ranks (tests/_torch_parallel_child.py) serve one ServingEngine
on a (data 2, model 1) mesh, joined as two "hosts" (the --coordinator
layout: session rows split over the ranks), and on a (data 1, model 2) mesh
on one host (the --tp layout: the LLM split over the ranks). Rank 0 drives a
PrimaryDriver through the schedule of tests/_multihost_serving_child.drive
(opens, an sl tick, a dual-identity tick, a continuation, a batched fast
response and the sentence re-embed, a store overflow that every rank
survives, export/import migration); rank 1 replays it with run_follower.
The weights are the JAX engine's seed-0 float32 tree (and its seed-7 speech
decoder and codec), sampling greedy, so the port's ranks must agree with
each other and with JAX's single-process engine on the same schedule, at
the JAX lockstep test's own limits.

Then the sessions go through a snapshot and back (save_sessions /
restore_sessions ride bundles), and the same PrimaryDriver serves a
DuplexService: a user onset at threshold 0 speaks, a response continues by
batched segments (PrimaryDriver.continue_segments_submit, which the JAX
PrimaryDriver lacks), and a pipelined service ticks
(PrimaryDriver.tick_submit), with no error event.

Each rank has a hard timeout (test_torch_parallel.CHILD_TIMEOUT).
"""

import dataclasses
import os
import sys

import jax
import numpy as np
import pytest

from freeze_omni_tpu.runtime.engine import ServingEngine as JaxEngine
from freeze_omni_tpu.training.vad import synth_speech
from freeze_omni_tpu_torch.utils.checkpoint import save_native
from freeze_omni_tpu_torch.runtime.session import row_from_leaves, row_leaves
from tests.test_torch_parallel import (collect_ranks, start_ranks, stop_ranks,
                                      write_config)

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import _multihost_serving_child as jax_child  # noqa: E402

MESHES = {"data2": [2, 1], "model2": [1, 2]}


def greedy(cfg):
    return dataclasses.replace(
        cfg, sampling=dataclasses.replace(cfg.sampling, top_k=1),
        tts=dataclasses.replace(cfg.tts, top_k=1))


@pytest.fixture(scope="module")
def lockstep(tmp_path_factory):
    """(JAX single-process drive, {mesh: {rank: port result}})."""
    from freeze_omni_tpu_torch import config as tcfg

    tmp = tmp_path_factory.mktemp("lockstep")
    jcfg = greedy(jax_child.tiny_serving_cfg())
    engine = JaxEngine(jcfg, seed=0)
    params = jax.tree.map(np.asarray, engine.core.params)
    tts = jax.tree.map(np.asarray, jax_child.tiny_tts_params(jcfg))

    tc = tcfg.tiny_system()
    tc = greedy(dataclasses.replace(
        tc, audio_llm=dataclasses.replace(
            tc.audio_llm, llm=dataclasses.replace(tc.audio_llm.llm,
                                                  num_kv_heads=2)),
        serving=dataclasses.replace(tc.serving, max_sessions=4)))
    n = tc.duplex.gating.samples_per_chunk
    job = {"mode": "lockstep", "params": {"lockstep": str(tmp / "p.npz")},
           "configs": {"lockstep": write_config(tc, tmp / "cfg.json")},
           "tts": str(tmp / "tts.npz"), "speech": str(tmp / "speech.npy")}
    save_native(job["params"]["lockstep"], params)
    save_native(job["tts"], tts)
    np.save(job["speech"], (0.5 * synth_speech(np.random.RandomState(3), 2 * n)
                            ).astype(np.float32))
    # both meshes' ranks at once, and the JAX drive while they run
    procs = {name: start_ranks(dict(job, mesh=shape, hosts=shape[0],
                                    snapshot=str(tmp / f"snap-{name}"),
                                    blob=str(tmp / f"blob-{name}.npz")), tmp)
             for name, shape in MESHES.items()}
    try:
        single = jax_child.drive(engine, tts)
        runs = {name: collect_ranks(ranks) for name, ranks in procs.items()}
    finally:
        for ranks in procs.values():
            stop_ranks(ranks)
    for name, run in runs.items():
        with np.load(tmp / f"blob-{name}.npz") as z:
            run["blob"] = [z[f"arr_{i}"] for i in range(len(z.files))]
    single["blob"] = [np.asarray(x, np.float32) if x.dtype.kind == "V" else
                      np.asarray(x) for x in jax.tree.leaves(
                          engine.export_session("s1")["caches"])]
    return single, runs, (tc, params)


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_lockstep_serving_matches_jax_single_process(lockstep, mesh):
    single, runs, _ = lockstep
    got = runs[mesh][0]
    # lockstep: every rank's KV-length mirror evolved identically
    assert runs[mesh][0]["len_host"] == runs[mesh][1]["len_host"]
    if mesh == "data2":   # replicated LLM: identical weights on both ranks
        assert runs[mesh][0]["checksum"] == runs[mesh][1]["checksum"]
    # the overflow raised on the primary and the follower served on
    assert got["overflow"] == "raised" == single["overflow"]
    for tick in ("tick1", "tick2", "tick3"):
        assert set(got[tick]) == {str(k) for k in single[tick]}
        for slot, pred in single[tick].items():
            for k in ("state_1", "state_2"):
                np.testing.assert_allclose(got[tick][str(slot)][k], pred[k],
                                           atol=2e-4)
    assert got["cont_tokens"] == single["cont_tokens"]
    for k in ("state_1", "state_2"):
        np.testing.assert_allclose(got["migrated"][k], single["migrated"][k],
                                   atol=2e-4)
    assert got["resp_tokens"] == single["resp_tokens"]
    for s, v in single["resp_pcm_sum"].items():
        np.testing.assert_allclose(got["resp_pcm_sum"][s], v, rtol=1e-4)
    np.testing.assert_allclose(got["embed_sum"], single["embed_sum"], rtol=1e-5)


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_session_blob_moves_to_a_single_card_engine_and_matches_jax(lockstep,
                                                                   mesh):
    """A sharded engine's export is the single-card layout: its leaves match
    the JAX single-process engine's export of the same session (every kv
    head, f32; measured within 3.4e-6, float32 sums in another order after
    the same greedy schedule), and a one-process port engine imports it and
    exports it back unchanged."""
    from freeze_omni_tpu_torch import weights
    from freeze_omni_tpu_torch.runtime.engine import ServingEngine

    single, runs, (tc, params) = lockstep
    blob = runs[mesh]["blob"]
    assert [b.shape for b in blob] == [b.shape for b in single["blob"]]
    for got, want in zip(blob, single["blob"]):
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    one = ServingEngine(tc, params=weights.from_jax(params, device="cpu"),
                        device="cpu")
    one.import_session("s1", {"version": 1, "sid": "s1", "role": None,
                              "prefix_len": 0, "caches": row_from_leaves(
                                  one.store.row_template_canonical, blob)})
    back = row_leaves(one.export_session("s1")["caches"])
    for got, want in zip(back, blob):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_snapshot_round_trip_through_the_primary(lockstep, mesh):
    """save_sessions / restore_sessions ride bundles: rank 0 writes the
    snapshot (the rows gathered to it), every rank restores its part, and
    each session exports the same row as before."""
    snap = lockstep[1][mesh][0]["snapshot"]
    assert snap["saved"] == snap["restored"] == ["s0", "s1", "s2", "s6"]
    assert snap["same"]


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_service_continues_and_pipelines_through_the_primary(lockstep, mesh):
    svc = lockstep[1][mesh][0]["service"]
    assert svc["errors"] == []
    assert svc["spoke"] >= 1
    assert svc["continue_rounds"] >= 1
    assert svc["calls"]["continue_segments_submit"] >= 1
    assert svc["calls"]["tick_submit"] >= 1
    assert svc["pipelined_updates"] >= 1
