"""The port's `bin/serve`: the per-session server and the engine-mode server
over a real websocket on the CPU, the flagship preset's int4 branch at tiny
widths, the checkpoint and config flags, and the flags that wait for later
work."""

import asyncio
import base64
import json
import os
import socket
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


@pytest.mark.parametrize("argv,item", [
    (["--engine", "--voice_wav", "v.wav"], "D4"),
    (["--engine", "--lora", "a.npz"], "D4"),
    (["--engine", "--lora_scale", "0.5"], "D4"),
    (["--engine", "--state_dir", "s"], "D5"),
    (["--engine", "--resume_grace", "10"], "D5"),
    (["--engine", "--tp", "2"], "D9"),
    (["--engine", "--coordinator", "h:1"], "D9"),
    (["--engine", "--num_hosts", "2"], "D9"),
    (["--engine", "--host_id", "1"], "D9"),
])
def test_waiting_flags_exit_naming_their_roadmap_item(argv, item):
    with pytest.raises(SystemExit, match=f"ROADMAP.md {item}"):
        serve.Server(serve.get_args(["--preset", "tiny", "--device", "cpu", *argv]))


@pytest.mark.parametrize("argv,item", [
    (["--tp", "2"], "D9"),
    (["--coordinator", "h:1"], "D9"),
    (["--state_dir", "s"], "D5"),
])
def test_engine_only_flags_exit_without_engine(argv, item):
    """As in the JAX server, these need --engine; they also wait for their
    ROADMAP item."""
    with pytest.raises(SystemExit, match=f"ROADMAP.md {item} .*, and it needs --engine"):
        serve.Server(serve.get_args(["--preset", "tiny", "--device", "cpu", *argv]))


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
