"""The port's `bin/serve`: the per-session server and the engine-mode server
over a real websocket on the CPU, the flagship preset's int4 branch at tiny
widths, the checkpoint and config flags, and the flags that wait for later
work."""

import asyncio
import base64
import json
import os
import socket
import threading
import time

import jax
import numpy as np
import pytest
import torch

from freeze_omni_tpu.training.vad import synth_speech
from freeze_omni_tpu_torch import weights
from freeze_omni_tpu_torch.bin import serve
from freeze_omni_tpu_torch.config import tiny_system
from tests.test_torch_checkpoint import APP_YAML


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _b64(x):
    return base64.b64encode(
        (np.clip(x, -1, 1) * 32767).astype("<i2").tobytes()).decode()


def test_server_session_over_websocket():
    websockets = pytest.importorskip("websockets")
    port = _free_port()
    server = serve.Server(serve.get_args(
        ["--preset", "tiny", "--engine", "--device", "cpu", "--port", str(port)]))
    n = server.cfg.duplex.gating.samples_per_chunk

    async def client():
        deadline = time.time() + 30
        while True:
            try:
                ws = await websockets.connect(f"ws://127.0.0.1:{port}",
                                              open_timeout=10)
                break
            except OSError:
                if time.time() > deadline:
                    raise
                await asyncio.sleep(0.1)
        events = []
        async with ws:
            await ws.send(json.dumps({"type": "start_session", "sid": "t1"}))
            while json.loads(await asyncio.wait_for(ws.recv(), 30))["event"] \
                    != "session_ready":
                pass
            speech = 0.5 * synth_speech(np.random.RandomState(7), 3 * n)
            for chunk in (np.zeros(2 * n), speech, np.zeros(6 * n)):
                # 48 kHz client: the service resamples at ingest
                await ws.send(json.dumps({"type": "audio", "identity": "user",
                                          "pcm_b64": _b64(np.repeat(chunk, 3)),
                                          "sr": 48000}))
            await ws.send(json.dumps({"type": "bogus"}))
            deadline = time.time() + 60
            while time.time() < deadline:
                try:
                    msg = json.loads(await asyncio.wait_for(ws.recv(), 5))
                except asyncio.TimeoutError:
                    continue
                events.append(msg)
                if any(e.get("status") == "ipu_el" for e in events) and \
                        any(e["event"] == "dialog_state_update" for e in events) \
                        and any(e["event"] == "error" for e in events):
                    break
            await ws.send(json.dumps({"type": "stop"}))
        return events

    async def main():
        task = asyncio.create_task(server.run())
        try:
            return await client()
        finally:
            task.cancel()
            with pytest.raises(asyncio.CancelledError):
                await task

    events = asyncio.run(main())
    assert not server._ticker_thread.is_alive()
    names = [e["event"] for e in events]
    statuses = [e.get("status") for e in events if e["event"] == "vad_event"]
    assert "ipu_sl" in statuses and "ipu_el" in statuses, statuses
    upd = [e for e in events if e["event"] == "dialog_state_update"]
    assert upd and all(0.0 <= u["probs"]["state_1"] <= 1.0 for u in upd)
    err = [e for e in events if e["event"] == "error"]
    assert err and "bogus" in err[0]["message"]
    assert "vad_state_update" in names
    assert server.service.engine.num_active == 0   # the handler closed it


def test_flagship_int4_branch(monkeypatch):
    """`--preset flagship --quant 4` draws the LLM in int4 (every layer
    projection) with the int8 lm_head and embedding of init_quantized_llm,
    serves the KV and frontend in bf16, and builds the synthesis pool with
    --respond. At tiny widths, with the flagship config swapped out."""
    monkeypatch.setattr(serve, "flagship_system", tiny_system)
    server = serve.Server(serve.get_args(
        ["--preset", "flagship", "--engine", "--quant", "4", "--kv_quant", "8",
         "--max_sessions", "2", "--respond", "--device", "cpu"]))
    try:
        engine = server.service.engine
        llm = engine.core.params["llm"]
        for name in ("q", "k", "v", "o", "gate", "up", "down"):
            assert set(llm["layers"][name]) - {"b"} == {"w_q4", "scale4"}, name
            assert llm["layers"][name]["w_q4"].dtype == torch.uint8
        assert set(llm["lm_head"]) == {"w_q", "scale"}
        assert set(llm["embed"]) == {"w_q", "scale"}
        assert engine.store.kv_quant_bits == 8
        assert engine.store.max_sessions == 2
        enc = weights.to_numpy(engine.core.params["encoder_user"])
        floats = [a.dtype.name for a in jax.tree.leaves(enc) if a.dtype.kind in "fV"]
        assert floats and set(floats) == {"bfloat16"}
        assert server.service._tts is not None
    finally:
        server.stop_ticker()
    assert not server._ticker_thread.is_alive()


def test_tiny_preset_ignores_quant():
    server = serve.Server(serve.get_args(
        ["--preset", "tiny", "--engine", "--quant", "4", "--device", "cpu"]))
    try:
        assert "w" in server.service.engine.core.params["llm"]["layers"]["q"]
    finally:
        server.stop_ticker()


COPY = os.path.join(os.path.dirname(__file__), "..", "freeze_omni_tpu_torch",
                    "assets", "tiny_s2s")


@pytest.mark.parametrize("kind", ["native", "reference", "app_yaml"])
def test_checkpoint_flags_load(kind, tmp_path):
    """--model_path, --llm_path and --config load instead of exiting:
    - native: `--preset tiny --model_path freeze_omni_tpu_torch/assets/
      tiny_s2s` serves the trained tiny system's params (per-session
      server);
    - reference: a reference checkpoint dir with --llm_path, its LLM int8 by
      default, through the engine with --respond (the converted TTS);
    - app_yaml: `--config` with the reference app YAML takes its VAD
      threshold and sampling over the checkpoint its model_path names."""
    from freeze_omni_tpu_torch.utils.checkpoint import _load_chunk_index

    want = _load_chunk_index(os.path.join(COPY, "chunks.json"))
    base = ["--preset", "tiny", "--device", "cpu"]
    if kind == "native":
        server = serve.Server(serve.get_args([*base, "--model_path", COPY]))
        params = server.pipeline.core.params
        got = weights.to_numpy(params["llm"])
        np.testing.assert_array_equal(got["embed"]["w"],
                                      want["audiollm"]["llm"]["embed"]["w"])
        np.testing.assert_array_equal(
            weights.to_numpy(params["encoder_user"])["blocks"]["q"]["w"],
            want["audiollm"]["encoder_user"]["blocks"]["q"]["w"])
        assert server.cfg.audio_llm.llm.vocab_size == 512
        return
    if kind == "reference":
        import chip_smoke  # its phase-11c writer, at tiny widths here

        model_path, llm_path = chip_smoke.write_reference_checkpoint(
            str(tmp_path), tiny_system(), seed=5, device="cpu")
        server = serve.Server(serve.get_args(
            [*base, "--engine", "--respond", "--model_path", model_path,
             "--llm_path", llm_path]))
        try:
            llm = server.service.engine.core.params["llm"]
            assert llm["layers"]["q"]["w_q"].dtype == torch.int8
            assert llm["layers"]["ln1"]["scale"].dtype == torch.bfloat16
            assert server.service.engine.store.caches.kv.k.dtype == torch.bfloat16
            assert server.cfg.audio_llm.llm.num_layers == 2   # the HF config's
            assert server.service.tts_params["codec"]["generator"] is not None
        finally:
            server.stop_ticker()
        return
    yaml_doc = APP_YAML.replace('"/ckpt"', json.dumps(os.path.abspath(COPY)))
    (tmp_path / "app.yaml").write_text(yaml_doc)
    server = serve.Server(serve.get_args(
        [*base, "--config", str(tmp_path / "app.yaml")]))
    assert server.args.model_path == os.path.abspath(COPY)
    assert server.cfg.duplex.vad.threshold == 0.6
    assert server.cfg.sampling.top_k == 7 and server.cfg.duplex.resp_threshold == 0.55
    got = weights.to_numpy(server.pipeline.core.params["llm"])
    np.testing.assert_array_equal(got["lm_head"]["w"],
                                  want["audiollm"]["llm"]["lm_head"]["w"])


@pytest.mark.parametrize("argv,error,message", [
    (["--tp", "2"], SystemExit, "^--tp requires --engine"),
    (["--coordinator", "h:1"], SystemExit, "^--coordinator requires --engine"),
    (["--engine", "--coordinator", "h:1", "--num_hosts", "1"], ValueError,
     "^--coordinator given but --num_hosts < 2$"),
    (["--engine", "--coordinator", "h:1", "--num_hosts", "2", "--state_dir",
      "s"], SystemExit, "^--state_dir requires --engine and is single-host"),
])
def test_waiting_flags_exit_naming_their_roadmap_item(argv, error, message):
    """The multi-GPU flags are served now (ROADMAP D9); what the JAX server
    refuses, the port refuses with the JAX server's words."""
    with pytest.raises(error, match=message):
        serve.Server(serve.get_args(["--preset", "tiny", "--device", "cpu", *argv]))


@pytest.mark.parametrize("argv,reason", [
    (["--engine", "--tp", "2"], "^--tp 2 needs 2 devices, have 1$"),
    (["--engine", "--tp", "4"], "^--tp 4 needs 4 devices, have 1$"),
    (["--state_dir", "s"], "^--state_dir requires --engine and is single-host"),
])
def test_engine_only_flags_exit_without_engine(argv, reason, monkeypatch):
    """--state_dir needs --engine, with the JAX reason; --tp k on the card
    needs k cards (one rank a card: NCCL refuses two ranks on one device)."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(SystemExit, match=reason):
        serve.Server(serve.get_args(["--preset", "tiny", *argv]))


def test_tp2_server_ticks_through_its_follower(monkeypatch):
    """serve --engine --tp 2 --device cpu: this process is rank 0 and starts
    one follower process; a tick of the service runs on both ranks (the
    tiny LLM's two kv heads split one a rank) and gives predictions."""
    from freeze_omni_tpu_torch.runtime.multihost_serving import PrimaryDriver

    monkeypatch.setenv("OMP_NUM_THREADS", "1")   # the follower shares the cores

    server = serve.Server(serve.get_args(
        ["--preset", "tiny", "--engine", "--device", "cpu", "--tp", "2"]))
    try:
        server.stop_ticker()
        drv = server.service.engine
        assert isinstance(drv, PrimaryDriver)
        assert drv.engine.mesh.shape == (1, 2)
        assert drv.store.caches.kv.k.shape[3] == 1
        drv.open_session("t")
        drv.submit_chunk("t", "user", np.random.RandomState(0).randn(
            1, 32, 80).astype(np.float32), True)
        pred = drv.tick()["user"][drv.store.slot_of("t")]
        assert 0.0 <= pred["state_1"] <= 1.0 and 0.0 <= pred["state_2"] <= 1.0
        follower = server._local_ranks[0]
        assert follower.poll() is None   # still replaying
    finally:
        server.close()
    assert follower.wait(timeout=60) == 0


def test_two_host_server_ticks_through_its_follower_host():
    """serve --engine --coordinator --num_hosts 2: host 1 is a second
    command (here a subprocess), host 0 this process; the session rows
    split over the hosts (data 2) and a tick runs on both."""
    import subprocess
    import sys

    from freeze_omni_tpu_torch.runtime.multihost_serving import PrimaryDriver

    flags = ["--preset", "tiny", "--engine", "--device", "cpu", "--coordinator",
             f"127.0.0.1:{_free_port()}", "--num_hosts", "2"]
    host1 = subprocess.Popen(
        [sys.executable, "-m", "freeze_omni_tpu_torch.bin.serve", *flags,
         "--host_id", "1"], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, env=dict(os.environ, OMP_NUM_THREADS="1"))
    try:
        server = serve.Server(serve.get_args([*flags, "--host_id", "0"]))
        try:
            server.stop_ticker()
            drv = server.service.engine
            assert isinstance(drv, PrimaryDriver)
            assert drv.engine.mesh.shape == (2, 1) and drv.store.local_rows == 4
            slots = [drv.open_session(f"h{i}") for i in range(5)]   # both hosts' rows
            for i in range(5):
                drv.submit_chunk(f"h{i}", "user", np.random.RandomState(i).randn(
                    1, 32, 80).astype(np.float32), True)
            preds = drv.tick()["user"]
            assert sorted(preds) == sorted(slots) and max(slots) >= 4
        finally:
            server.close()
        out, _ = host1.communicate(timeout=60)
    finally:
        if host1.poll() is None:
            host1.kill()
            host1.communicate()
    assert host1.returncode == 0, out[-3000:]
    assert "follower host joined (host_id=1)" in out


def test_per_session_server_over_websocket():
    """Without --engine each connection gets its own DuplexSession on the
    shared pipeline: start_session, audio (VAD events and predictions
    stream back), reset -> reset_done, stop (the session's worker ends)."""
    websockets = pytest.importorskip("websockets")
    port = _free_port()
    server = serve.Server(serve.get_args(
        ["--preset", "tiny", "--device", "cpu", "--port", str(port)]))
    assert server.service is None and server.pipeline is not None
    n = server.cfg.duplex.gating.samples_per_chunk
    opened = []
    open_session = server._open_session
    server._open_session = lambda *a: opened.append(open_session(*a)) or opened[-1]

    async def client():
        deadline = time.time() + 30
        while True:
            try:
                ws = await websockets.connect(f"ws://127.0.0.1:{port}",
                                              open_timeout=10)
                break
            except OSError:
                if time.time() > deadline:
                    raise
                await asyncio.sleep(0.1)
        events = []

        async def until(pred, seconds=60):
            end = time.time() + seconds
            while time.time() < end:
                try:
                    msg = json.loads(await asyncio.wait_for(ws.recv(), 5))
                except asyncio.TimeoutError:
                    continue
                events.append(msg)
                if pred(events):
                    return
            raise AssertionError(f"timed out; got {[e['event'] for e in events]}")

        async with ws:
            await ws.send(json.dumps({"type": "start_session", "sid": "p1"}))
            await until(lambda ev: ev[-1]["event"] == "session_ready")
            speech = 0.5 * synth_speech(np.random.RandomState(7), 3 * n)
            for chunk in (np.zeros(2 * n), speech, np.zeros(6 * n)):
                await ws.send(json.dumps({"type": "audio", "identity": "user",
                                          "pcm_b64": _b64(chunk), "sr": 16000}))
            # the VAD stage runs ahead of the predictions
            await until(lambda ev: any(e.get("status") == "ipu_el" for e in ev)
                        and any(e["event"] == "dialog_state_update" for e in ev))
            await ws.send(json.dumps({"type": "reset"}))
            await until(lambda ev: ev[-1]["event"] == "reset_done")
            await ws.send(json.dumps({"type": "stop"}))
        return events

    async def main():
        task = asyncio.create_task(server.run())
        try:
            return await client()
        finally:
            task.cancel()
            with pytest.raises(asyncio.CancelledError):
                await task

    events = asyncio.run(main())
    names = [e["event"] for e in events]
    statuses = [e.get("status") for e in events if e["event"] == "vad_event"]
    assert "ipu_sl" in statuses and "ipu_el" in statuses, statuses
    upd = [e for e in events if e["event"] == "dialog_state_update"]
    assert upd and all(0.0 <= u["probs"]["state_1"] <= 1.0 for u in upd)
    assert names.index("reset_done") > names.index("dialog_state_update")
    (session,) = opened
    deadline = time.time() + 10
    while session._worker is not None and time.time() < deadline:
        time.sleep(0.05)   # the handler releases the session on stop
    assert session._worker is None
    assert int(session.past_key_values.length[0]) == session._role_len


VOICE = os.path.join(os.path.dirname(__file__), "..", "freeze_omni_tpu", "assets",
                     "tiny_s2s", "dev_wavs", "asr_000.wav")


def _adapter_file(path, cfg, scale):
    """A rank-4 adapter on every target with B drawn non-zero, saved."""
    from freeze_omni_tpu_torch.models import lora

    g = torch.Generator().manual_seed(3)
    tree = lora.init(cfg.audio_llm.llm, g, rank=4, targets=lora.TARGETS,
                     device="cpu")
    for pair in tree.values():
        pair["b"] = 0.05 * torch.randn(pair["b"].shape, generator=g)
    lora.save(path, tree, scale=scale)
    return lora.load(path)[0]


@pytest.mark.parametrize("mode", ["tiny-engine", "flagship-int4", "per-session"])
def test_lora_flag_merges_at_boot(mode, tmp_path, monkeypatch):
    """--lora merges the adapter into the tree the server serves: its LLM
    leaves equal lora.merge of the same seeded weights at --lora_scale
    (which overrides the file's scale). The tiny preset merges into its f32
    draw; flagship (tiny widths here) into its int4 draw."""
    from freeze_omni_tpu_torch.models import audio_llm, lora

    cfg = tiny_system()
    path = str(tmp_path / "adapter.npz")
    adapter = _adapter_file(path, cfg, scale=0.5)
    argv = ["--device", "cpu", "--lora", path, "--lora_scale", "0.25"]
    if mode == "flagship-int4":
        monkeypatch.setattr(serve, "flagship_system", tiny_system)
        argv += ["--preset", "flagship", "--engine", "--quant", "4",
                 "--max_sessions", "2"]
        base = audio_llm.init_params(cfg.audio_llm, seed=0, device="cpu",
                                     llm_dtype=torch.bfloat16, quantize_llm=True,
                                     quant_bits=4)["llm"]
    else:
        argv += ["--preset", "tiny"] + (["--engine"] if mode == "tiny-engine" else [])
        base = audio_llm.init_params(cfg.audio_llm, seed=0, device="cpu",
                                     llm_dtype=torch.float32)["llm"]
    server = serve.Server(serve.get_args(argv))
    try:
        core = (server.service.engine if server.service else server.pipeline).core
        got = weights.to_numpy(core.params["llm"])
        want = weights.to_numpy(lora.merge(base, adapter, 0.25))
        for (path_, g), w in zip(jax.tree_util.tree_leaves_with_path(got),
                                 jax.tree.leaves(want)):
            np.testing.assert_array_equal(g, w, err_msg=str(path_))
        key = "w_q4" if mode == "flagship-int4" else "w"
        assert not np.array_equal(got["layers"]["q"][key],
                                  weights.to_numpy(base["layers"]["q"][key]))
    finally:
        server.stop_ticker()


@pytest.mark.parametrize("engine", [True, False])
def test_voice_wav_sets_the_global_tokens_jax_derives(engine, monkeypatch):
    """--voice_wav draws the codec with its encoder branch and puts the
    voice's global style tokens in cfg.tts.codec: the tokens JAX's
    extract_global_tokens gives on the same codec weights and wav, and the
    ones the synthesizer (the service's pool, or the responder's
    StreamingTTS) speaks with."""
    from freeze_omni_tpu import config as jcfg
    from freeze_omni_tpu import tts as jtts
    from freeze_omni_tpu.frontend import native as jnative
    from freeze_omni_tpu.frontend.wav import read_wav as jread_wav

    monkeypatch.setattr(jnative, "available", lambda: False)   # numpy resampler
    server = serve.Server(serve.get_args(
        ["--preset", "tiny", "--device", "cpu", "--respond", "--voice_wav", VOICE]
        + (["--engine"] if engine else [])))
    try:
        tts = server.service._tts if engine else server.responder.tts
        codec = (server.service.tts_params if engine else tts.params)["codec"]
        assert "encoder" in codec
        wav, sr = jread_wav(VOICE)
        want = jtts.extract_global_tokens(weights.to_numpy(codec),
                                          jcfg.tiny_system().tts.codec, wav, sr)
        assert server.cfg.tts.codec.global_tokens == want
        assert tts._global_tokens.reshape(-1).tolist() == list(want)
    finally:
        server.stop_ticker()


def _open_and_tick(server, sids, seed=0):
    """Open `sids` on the server's service (its ticker stopped) and run one
    user tick each through its engine; their KV lengths."""
    eng = server.service.engine
    rng = np.random.RandomState(seed)
    for sid in sids:
        server.service.open_session(sid)
        eng.submit_chunk(sid, "user", rng.randn(1, 32, 80).astype(np.float32),
                         is_sl=True)
    eng.tick()
    return {sid: eng.store.kv_length(eng.store.slot_of(sid)) for sid in sids}


def test_state_dir_snapshot_and_reboot_resume(tmp_path):
    """A --state_dir server snapshots its live sessions at shutdown; the next
    boot with the same flags restores them in run(), and a client that
    reconnects with its sid resumes with the row's KV length."""
    websockets = pytest.importorskip("websockets")
    port = _free_port()
    argv = ["--preset", "tiny", "--engine", "--device", "cpu", "--port",
            str(port), "--state_dir", str(tmp_path / "state")]
    first = serve.Server(serve.get_args(argv))
    first.stop_ticker()
    lengths = _open_and_tick(first, ["c1", "c2"])
    assert sorted(first.snapshot()) == ["c1", "c2"]
    prefix = int(first.service.engine.store.prefix_len[
        first.service.engine.store.slot_of("c1")])
    assert lengths["c1"] > prefix

    second = serve.Server(serve.get_args(argv))
    store = second.service.engine.store

    async def client():
        deadline = time.time() + 30
        while True:
            try:
                ws = await websockets.connect(f"ws://127.0.0.1:{port}",
                                              open_timeout=10)
                break
            except OSError:
                if time.time() > deadline:
                    raise
                await asyncio.sleep(0.1)
        async with ws:
            assert sorted(store.active_sids) == ["c1", "c2"]   # restored
            await ws.send(json.dumps({"type": "start_session", "sid": "c1"}))
            while json.loads(await asyncio.wait_for(ws.recv(), 30))["event"] \
                    != "session_ready":
                pass
            got = store.kv_length(store.slot_of("c1"))
            await ws.send(json.dumps({"type": "stop"}))
        return got

    async def main():
        task = asyncio.create_task(second.run())
        try:
            return await client()
        finally:
            task.cancel()
            with pytest.raises(asyncio.CancelledError):
                await task

    assert asyncio.run(main()) == lengths["c1"]
    # the reboot's own shutdown snapshotted what was still live: c2
    index = json.loads((tmp_path / "state" / "sessions.json").read_text())
    assert list(index["sessions"]) == ["c2"]


def test_resume_grace_evicts_an_unclaimed_restored_session(tmp_path):
    argv = ["--preset", "tiny", "--engine", "--device", "cpu", "--state_dir",
            str(tmp_path / "state"), "--resume_grace", "0.3"]
    first = serve.Server(serve.get_args(argv))
    first.stop_ticker()
    _open_and_tick(first, ["kept", "gone"])
    first.snapshot()
    second = serve.Server(serve.get_args(argv))
    try:
        assert sorted(second.restore_snapshot()) == ["gone", "kept"]
        second.service.open_session("kept")   # its client reconnected
        assert asyncio.run(second.evict_unclaimed(["gone", "kept"])) == ["gone"]
        store = second.service.engine.store
        assert store.has("kept") and not store.has("gone")
    finally:
        second.stop_ticker()


def test_a_reattach_at_the_resume_deadline_keeps_a_live_row(tmp_path):
    """A client that reconnects just as --resume_grace runs out ends with a
    live row, whichever of the two comes first: the eviction runs on the
    serving loop, on the thread where the handler opens sessions, so it
    cannot free a row between a reattach's open and its check."""
    websockets = pytest.importorskip("websockets")
    port, grace = _free_port(), 0.6
    argv = ["--preset", "tiny", "--engine", "--device", "cpu", "--port",
            str(port), "--state_dir", str(tmp_path / "state"),
            "--resume_grace", str(grace)]
    first = serve.Server(serve.get_args(argv))
    first.stop_ticker()
    _open_and_tick(first, ["late", "gone"])
    first.snapshot()
    second = serve.Server(serve.get_args(argv))
    eng, svc = second.service.engine, second.service
    threads = {}

    def recorded(name, fn):
        def call(*a, **kw):
            threads.setdefault(name, set()).add(threading.get_ident())
            return fn(*a, **kw)
        return call

    eng.close_session = recorded("close", eng.close_session)
    svc.open_session = recorded("open", svc.open_session)

    async def client(deadline):
        while True:
            try:
                ws = await websockets.connect(f"ws://127.0.0.1:{port}",
                                              open_timeout=10)
                break
            except OSError:
                await asyncio.sleep(0.05)
        async with ws:
            await asyncio.sleep(max(0.0, deadline - time.monotonic()))
            await ws.send(json.dumps({"type": "start_session", "sid": "late"}))
            while json.loads(await asyncio.wait_for(ws.recv(), 30))["event"] \
                    != "session_ready":
                pass
            await asyncio.sleep(grace)   # past the eviction, whenever it ran
            live = (eng.store.has("late"), "late" in svc.sessions,
                    eng.store.has("gone"))
            await ws.send(json.dumps({"type": "stop"}))
        return live

    async def main():
        deadline = time.monotonic() + grace
        task = asyncio.create_task(second.run())
        try:
            return await client(deadline), threading.get_ident()
        finally:
            task.cancel()
            with pytest.raises(asyncio.CancelledError):
                await task

    live, loop_thread = asyncio.run(main())
    assert live == (True, True, False)
    # "gone" was evicted and the reattach opened: both on the loop's thread
    assert threads["close"] == threads["open"] == {loop_thread}


def test_snapshot_delivers_the_pipelined_tick_in_flight(tmp_path):
    """--pipeline_ticks: Server.snapshot delivers the tick still in flight
    before it exports. On the committed tiny system with an int8 KV store,
    the pipelined server's predictions and saved rows equal those of the
    same run made synchronously, and so does one more tick after each
    server restores its own snapshot."""
    from tests.test_torch_service import SIDS, _audio, _predictions

    runs = {}
    for pipelined in (True, False):
        state = tmp_path / f"state-{pipelined}"
        server = serve.Server(serve.get_args(
            ["--preset", "tiny", "--model_path", COPY, "--engine", "--device",
             "cpu", "--kv_quant", "8", "--state_dir", str(state),
             *(["--pipeline_ticks"] if pipelined else [])]))
        server.stop_ticker()
        svc, eng = server.service, server.service.engine
        audio = _audio(server.cfg.duplex.gating.samples_per_chunk)
        sinks = {sid: svc.open_session(sid) for sid in SIDS}
        for k in range(3):
            for sid in SIDS:
                for ident in ("user", "system"):
                    svc.enqueue_audio_data(sid, ident,
                                           {"audio": audio[sid][ident][k]})
            svc.step()
        if pipelined:
            # step on until a user chunk's tick is in flight, with earlier
            # predictions already delivered
            n_steps = 3
            while not (svc._pending_tick[1] and
                       any(_predictions(s) for s in sinks.values())):
                svc.step()
                n_steps += 1
                assert n_steps < 20
        else:
            for _ in range(n_steps - 3):
                svc.step()
        assert sorted(server.snapshot()) == sorted(SIDS)
        index = json.loads((state / "sessions.json").read_text())["sessions"]
        rows = {}
        for sid in SIDS:
            with np.load(state / index[sid]["file"]) as z:
                rows[sid] = [z[f"leaf_{j}"] for j in range(len(z.files))]
        preds = {sid: _predictions(sinks[sid]) for sid in SIDS}
        for sid in SIDS:
            svc.close_session(sid)
        assert sorted(server.restore_snapshot()) == sorted(SIDS)
        rng = np.random.RandomState(5)
        for sid in SIDS:
            eng.submit_chunk(sid, "user", rng.randn(1, 32, 80).astype(np.float32),
                             is_sl=False)
        res = eng.tick()["user"]
        after = {sid: res[eng.store.slot_of(sid)]["state_1"] for sid in SIDS}
        runs[pipelined] = (preds, rows, after)
    (pp, prow, pafter), (sp, srow, safter) = runs[True], runs[False]
    assert pp == sp and all(pp.values()), (pp, sp)
    for sid in SIDS:
        assert len(prow[sid]) == len(srow[sid])
        n = len(prow[sid])
        for j, (a, b) in enumerate(zip(prow[sid], srow[sid])):
            if j in (n - 3, n - 2):   # kv.k, kv.v [L, 1, S, Hkv, dk]: the
                # scratch slot S-1 takes the masked tokens' writes in any order
                a, b = a[:, :, :-1], b[:, :, :-1]
            np.testing.assert_array_equal(a, b)
    assert pafter == safter


def test_client_against_a_responding_server(tmp_path):
    """The port's bin/client drives the port's tiny server (--engine
    --respond --resp_threshold 0) end to end, as the JAX package's test does
    its own: dialog events, the spoken response and the reply wav."""
    pytest.importorskip("websockets")
    from freeze_omni_tpu_torch.bin.client import main as client_main
    from freeze_omni_tpu_torch.frontend.wav import read_wav, write_wav

    port = _free_port()
    server = serve.Server(serve.get_args(
        ["--preset", "tiny", "--device", "cpu", "--port", str(port), "--engine",
         "--respond", "--resp_threshold", "0.0"]))
    loop = asyncio.new_event_loop()
    task = loop.create_task(server.run())
    thread = threading.Thread(target=lambda: loop.run_until_complete(
        asyncio.gather(task, return_exceptions=True)), daemon=True)
    thread.start()
    try:
        n = server.cfg.duplex.gating.samples_per_chunk
        wav = np.concatenate([np.zeros(2 * n, np.float32),
                              0.5 * synth_speech(np.random.RandomState(7), 4 * n),
                              np.zeros(3 * n, np.float32)])
        inp, out = tmp_path / "in.wav", tmp_path / "out.wav"
        write_wav(str(inp), wav, 16000)
        stats = client_main(["--url", f"ws://127.0.0.1:{port}", "--input_wav",
                             str(inp), "--output_wav", str(out), "--speed", "8",
                             "--listen_s", "6"])
    finally:
        loop.call_soon_threadsafe(task.cancel)
        thread.join(30)
    assert stats["events"].get("dialog_state_update", 0) >= 1
    assert stats["events"].get("vad_event", 0) >= 1
    assert stats["texts"], f"no response_text; events={stats['events']}"
    assert stats["responses"], f"no response_audio; events={stats['events']}"
    reply, sr = read_wav(str(out))
    assert reply.size > 0 and sr in (16000, 24000)
