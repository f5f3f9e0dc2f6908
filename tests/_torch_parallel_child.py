"""One rank of the port's multi-process CPU tests (tests/test_torch_parallel.py,
test_torch_ring_attention.py, test_torch_pipeline_parallel.py,
test_torch_train_dp.py).

    python tests/_torch_parallel_child.py <host:port> <rank> <world> <job.json>

Joins a gloo job of `world` CPU processes, runs the job's mode on the
weights the job names (written by the parent test from the JAX package's
trees) and prints one line `RESULT <json>`. Imports no JAX: the parent
compares. The serving modes build the port's ServingEngine on a
('data', 'model') mesh.

Modes:
- "ticks": per weight tree, two sessions through dual-identity ticks across
  a KV roll (`tick_schedule`) and one sampled text segment, on every rank;
- "lockstep": rank 0 drives a PrimaryDriver through `drive` (the schedule of
  tests/_multihost_serving_child.py) while the others run `run_follower`,
  snapshots and restores the sessions (`snapshot_roundtrip`), then a
  DuplexService on the same PrimaryDriver speaks, continues a response and ticks
  under pipeline_ticks (`serve_through_primary`);
- "ring" / "pipeline": every case of the job on its own mesh (('seq',),
  ('data', 'seq'), ('stage',), ('data', 'stage')), in order on every rank:
  parallel/ring_attention.sp_forward on this rank's time slice, gathered,
  or parallel/pipeline_parallel.pp_forward; a data index takes its
  contiguous rows of the embeds. Each rank saves its outputs to
  <out>/rank<r>.npz;
- "train": bin/train.main with the job's argv and this rank as host
  --host_id of a --coordinator job (the CLI joins the job itself); the
  result holds the printed summary keys and every step's loss.
"""

import dataclasses
import json
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def chunk(seed, t=32):
    return np.random.RandomState(seed).randn(1, t, 80).astype(np.float32)


def decision(pred, thr):
    if pred["state_1"] > thr:
        return "ss"
    return "el" if pred["state_2"] > thr else "cl"


def tick_schedule(engine, n_ticks):
    """Two sessions, one dual-identity tick after another (is_sl now and
    then); works on the JAX and the port engines alike. Returns the user
    predictions per tick and the KV-length mirror after each."""
    sids = ("a", "b")
    for sid in sids:
        engine.open_session(sid)
    ticks, lengths = [], []
    for i in range(n_ticks):
        for j, sid in enumerate(sids):
            engine.submit_chunk(sid, "user", chunk(100 * j + i), i % 5 == 0)
            engine.submit_chunk(sid, "system", chunk(100 * j + 50 + i),
                                i % 5 == 1)
        res = engine.tick()["user"]
        ticks.append({sid: res[engine.store.slot_of(sid)] for sid in sids})
        lengths.append([int(x) for x in engine._len_host])
    return ticks, lengths


def drive(drv, tts):
    """The chunk schedule of tests/_multihost_serving_child.drive: 4
    sessions, an sl tick, a dual-identity tick, a continuation, a batched
    fast response + sentence re-embed, overflow, migration."""
    for i in range(4):
        drv.open_session(f"s{i}")
    for i in range(4):
        drv.submit_chunk(f"s{i}", "user", chunk(i), True)
    out1 = drv.tick()
    for i in range(4):
        drv.submit_chunk(f"s{i}", "user", chunk(10 + i), False)
        drv.submit_chunk(f"s{i}", "system", chunk(20 + i), i == 0)
    out2 = drv.tick()
    cont = drv.continue_segments({f"s{i}": 5 for i in range(4)}, n_steps=4)
    resp = drv.respond_fast_many(["s0", "s1"], tts, n_text=4)
    emb = drv.embed_tokens([3, 1, 4, 1, 5])
    drv.close_session("s3")
    drv.open_session("s4")
    try:
        drv.open_session("s5")
        overflow = "no-error"
    except RuntimeError:
        overflow = "raised"
    drv.close_session("s4")
    drv.open_session("s6")
    drv.submit_chunk("s6", "user", chunk(30), True)
    out3 = drv.tick()
    blob = drv.export_session("s0")
    drv.close_session("s0")
    slot = drv.import_session("s0", blob)
    drv.submit_chunk("s0", "user", chunk(31), False)
    out4 = drv.tick()
    return {
        "tick1": {str(k): v for k, v in out1["user"].items()},
        "tick2": {str(k): v for k, v in out2["user"].items()},
        "cont_tokens": {s: t for s, (t, _, _) in cont.items()},
        "overflow": overflow,
        "tick3": {str(k): v for k, v in out3["user"].items()},
        "migrated": out4["user"][slot],
        "resp_tokens": {s: list(map(int, t)) for s, (_, t) in resp.items()},
        "resp_pcm_sum": {s: float(np.abs(p).sum()) for s, (p, _) in
                         resp.items()},
        "embed_sum": float(np.abs(emb).sum()),
    }


def snapshot_roundtrip(drv, dirpath):
    """save_sessions / restore_sessions through the PrimaryDriver (rank 0 writes,
    every rank reads): the sessions come back with the rows they had."""
    before = {sid: drv.export_session(sid) for sid in drv.store.active_sids}
    saved = drv.save_sessions(dirpath)
    for sid in saved:
        drv.close_session(sid)
    restored = drv.restore_sessions(dirpath)
    same = all(
        all(np.array_equal(np.asarray(a), np.asarray(b)) for a, b in zip(
            row_leaves(before[sid]["caches"]),
            row_leaves(drv.export_session(sid)["caches"])))
        for sid in restored)
    return {"saved": sorted(saved), "restored": sorted(restored), "same": same}


def serve_through_primary(drv, cfg, tts, speech):
    """DuplexService(engine=PrimaryDriver): at threshold 0 a user onset
    speaks (respond bundle), a response continues by batched segments
    (continue_segments_submit), then a pipelined service ticks
    (tick_submit). Returns the calls seen and the error events."""
    from freeze_omni_tpu_torch.runtime.service import DuplexService

    for sid in drv.store.active_sids:   # the store is full after `drive`
        drv.close_session(sid)
    calls = {"continue_segments_submit": 0, "tick_submit": 0}
    for name in calls:
        def counted(*a, _f=getattr(drv, name), _n=name, **k):
            calls[_n] += 1
            return _f(*a, **k)
        setattr(drv, name, counted)
    n = cfg.duplex.gating.samples_per_chunk
    rcfg = dataclasses.replace(cfg, duplex=dataclasses.replace(
        cfg.duplex, resp_threshold=0.0, resp_segment=6, resp_max_tokens=18))
    svc = DuplexService(rcfg, engine=drv, seed=0, tts_params=tts)
    sink = svc.open_session("r")
    svc.enqueue_audio_data("r", "user", {"audio": np.zeros(n, np.float32)})
    svc.enqueue_audio_data("r", "system", {
        "audio": 5e-4 * np.random.RandomState(0).randn(n).astype(np.float32)})
    svc.step()
    svc.enqueue_audio_data("r", "user", {"audio": speech})
    for _ in range(10):
        svc.step()
        if sink.events_of("response_text"):
            break
    spoke = len(sink.events_of("response_text"))
    svc.resp_threshold = 2.0
    fe = svc.sessions["r"]
    fe.resp = {"last": 3, "n": 0, "toks": [], "hids": []}
    rounds = 0
    for _ in range(4):
        if fe.resp is None:
            break
        svc.step()
        rounds += 1
    svc.flush_tts()
    errors = [e for e in sink.events_of("error")]
    svc.close_session("r")

    pcfg = dataclasses.replace(cfg, serving=dataclasses.replace(
        cfg.serving, pipeline_ticks=True))
    psvc = DuplexService(pcfg, engine=drv, seed=0)
    psink = psvc.open_session("p")
    psvc.enqueue_audio_data("p", "user", {"audio": np.zeros(n, np.float32)})
    psvc.enqueue_audio_data("p", "user", {"audio": speech})
    for _ in range(8):
        psvc.step()
    psvc.drain_ticks()
    updates = len(psink.events_of("dialog_state_update"))
    errors += psink.events_of("error")
    psvc.close_session("p")
    return {"calls": calls, "spoke": spoke, "continue_rounds": rounds,
            "pipelined_updates": updates,
            "errors": [str(e) for e in errors]}


def row_leaves(row):
    from freeze_omni_tpu_torch.runtime.session import row_leaves as leaves

    return leaves(row)


def _engine(job, name, mesh, cfg=None):
    import torch

    from freeze_omni_tpu_torch import weights
    from freeze_omni_tpu_torch.config import load_system_config
    from freeze_omni_tpu_torch.runtime.engine import ServingEngine
    from freeze_omni_tpu_torch.utils.checkpoint import load_native

    cfg = cfg or load_system_config(job["configs"][name])
    params = weights.from_jax(load_native(job["params"][name]), device="cpu")
    kv_dtype = getattr(torch, job.get("kv_dtype", "float32"))
    return cfg, ServingEngine(cfg, params=params, seed=0, kv_dtype=kv_dtype,
                              device="cpu", mesh=mesh)


def run_ticks(job, mesh):
    out = {}
    for name in job["params"]:
        cfg, engine = _engine(job, name, mesh)
        ticks, lengths = tick_schedule(engine, job["n_ticks"])
        thr = cfg.duplex.resp_threshold
        device_lengths = [int(x) for x in engine.store.lengths()]
        # a sampled segment (the config's top-k / top-p / temperature): each
        # model rank draws from its own generator over the gathered logits
        segs = engine.continue_segments({"a": 3, "b": 7}, n_steps=8)
        out[name] = {"ticks": ticks, "lengths": lengths,
                     "sampled": {s: toks for s, (toks, _, _) in segs.items()},
                     "device_lengths": device_lengths,
                     "sampled_lengths": [int(x) for x in engine.store.lengths()],
                     "decisions": [{s: decision(p, thr) for s, p in t.items()}
                                   for t in ticks]}
    return out


def run_lockstep(job, mesh):
    from freeze_omni_tpu_torch import weights
    from freeze_omni_tpu_torch.parallel import multihost as mh
    from freeze_omni_tpu_torch.runtime import multihost_serving as ms
    from freeze_omni_tpu_torch.utils.checkpoint import load_native

    cfg, engine = _engine(job, "lockstep", mesh)
    tts = weights.from_jax(load_native(job["tts"]), device="cpu")
    if mh.is_primary():
        drv = ms.PrimaryDriver(engine, tts)
        try:
            result = drive(drv, tts)
            # a session in the canonical blob layout, for the parent to move
            # into a single-process engine and hold to the JAX engine's export
            np.savez(job["blob"], *[np.asarray(x) for x in row_leaves(
                drv.export_session("s1")["caches"])])
            result["snapshot"] = snapshot_roundtrip(drv, job["snapshot"])
            result["service"] = serve_through_primary(
                drv, cfg, tts, np.load(job["speech"]))
        finally:
            drv.stop()   # releases the followers, whatever happened here
    else:
        ms.run_follower(engine, tts)
        result = {}
    result["len_host"] = [int(x) for x in engine._len_host]
    result["checksum"] = mh.tree_checksum(engine.core.params["llm"])
    return result


def run_forwards(job):
    """The "ring" / "pipeline" cases of `job` on this rank."""
    import torch

    from freeze_omni_tpu_torch import weights
    from freeze_omni_tpu_torch.config import LLMConfig
    from freeze_omni_tpu_torch.parallel import mesh as pmesh
    from freeze_omni_tpu_torch.parallel.pipeline_parallel import pp_forward
    from freeze_omni_tpu_torch.parallel.ring_attention import (gather_seq,
                                                                seq_slice,
                                                                sp_forward)
    from freeze_omni_tpu_torch.utils.checkpoint import load_native

    cfg = LLMConfig(**job["cfg"])
    trees = {name: weights.from_jax(load_native(path), device="cpu")
             for name, path in job["params"].items()}
    embeds = torch.from_numpy(np.load(job["embeds"]))
    out = {}
    for case in job["cases"]:
        mesh = pmesh.make_mesh(case["mesh"], case["axes"])
        rows = embeds.shape[0] // mesh.data
        x = embeds[mesh.data_index * rows:(mesh.data_index + 1) * rows]
        params = trees[case["tree"]]
        if job["mode"] == "ring":
            y = gather_seq(sp_forward(params, cfg, seq_slice(x, mesh), mesh), mesh)
        else:
            y = pp_forward(params, cfg, x, mesh, case["microbatches"])
        out[case["name"]] = y.numpy()
    np.savez(os.path.join(job["out"], f"rank{mesh.rank}.npz"), **out)
    return {"cases": sorted(out)}


def run_train(job, coordinator, rank, world):
    from freeze_omni_tpu_torch.bin import train

    out = train.main(job["argv"] + ["--coordinator", coordinator, "--num_hosts",
                                    str(world), "--host_id", str(rank)])
    return {"summary": {k: out[k] for k in train.SUMMARY_KEYS if k in out},
            "losses": out["losses"]}


def main():
    coordinator, rank, world, job_path = sys.argv[1], int(sys.argv[2]), \
        int(sys.argv[3]), sys.argv[4]
    with open(job_path) as f:
        job = json.load(f)
    import torch

    torch.set_num_threads(1)   # the test workers share the host's cores
    from freeze_omni_tpu_torch.parallel import multihost as mh

    if job["mode"] == "train":   # the CLI joins (and leaves) the job
        result = run_train(job, coordinator, rank, world)
        print("RESULT " + json.dumps(dict(result, rank=rank)), flush=True)
        return

    if job["hosts"] > 1:   # one rank a host: the --coordinator layout
        mh.initialize(coordinator, world, rank, device="cpu")
    else:                  # one host, `world` local ranks: the --tp layout
        mh.initialize(coordinator, 1, 0, local_ranks=world, local_rank=rank,
                      device="cpu")
    if job["mode"] in ("ring", "pipeline"):
        result = run_forwards(job)
    else:
        mesh = mh.make_global_mesh(("data", "model"), model_par=job["mesh"][1])
        assert tuple(mesh.shape) == tuple(job["mesh"]), mesh.shape
        result = {"ticks": run_ticks, "lockstep": run_lockstep}[job["mode"]](
            job, mesh)
    result["rank"] = rank
    print("RESULT " + json.dumps(result), flush=True)
    mh.sync("done")
    mh.shutdown()


if __name__ == "__main__":
    sys.path.insert(0, REPO)
    main()
