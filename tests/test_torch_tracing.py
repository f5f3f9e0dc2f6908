"""The port's tracer (utils/logging) on the batched service's tick, on the
CPU with the tiny preset and seeded random weights (the port alone):

- off, a DuplexService records nothing;
- on, every step has one `service.step` record whose interval spans nest
  inside their parents on the time.time_ns clock, tiled by the service's
  four top-level spans;
- `engine.tokens_valid` / `engine.tokens_computed` are the mask the
  forward gets, summed and counted;
- `frontend.windows` counts the VAD's calls, `frontend.replays` the onset
  features the gating chunker replays, `frontend.ipu_open` the onsets;
- the ring keeps the last `steps` records;
- the offline CLI's `span_report` still prints, and `bin/serve --trace`
  serves the per-step means at /stats.
"""

import argparse
import dataclasses
import json
import socket
import time
import urllib.request

import numpy as np
import pytest

from freeze_omni_tpu_torch.config import tiny_system
from freeze_omni_tpu_torch.duplex.serializer import ContextSerializer
from freeze_omni_tpu_torch.frontend.chunker import GatingChunker
from freeze_omni_tpu_torch.models import audio_llm, qwen2
from freeze_omni_tpu_torch.runtime.engine import ServingEngine
from freeze_omni_tpu_torch.runtime.service import DuplexService
from freeze_omni_tpu_torch.utils import logging as trace

TOP = ("service.frontend", "engine.submit", "engine.deliver", "service.decide")


def _speech(rng, n, sr=16000):
    """A voiced-speech surrogate the learned VAD hears: a harmonic stack
    with a drifting pitch, one formant and syllabic modulation."""
    t = np.arange(n) / sr
    f0 = rng.uniform(100, 220)
    phase = 2 * np.pi * np.cumsum(
        f0 + 0.15 * f0 * np.sin(2 * np.pi * rng.uniform(0.3, 1.2) * t)) / sr
    fc = rng.uniform(500, 1500)
    sig = sum((0.05 / k + np.exp(-((k * f0 - fc) ** 2) / (2 * 150.0 ** 2)))
              * np.sin(k * phase) for k in range(1, 13))
    sig = sig * (0.55 + 0.45 * np.sin(2 * np.pi * rng.uniform(3, 7) * t))
    return (0.5 * sig / np.abs(sig).max()).astype(np.float32)


@pytest.fixture(autouse=True)
def tracer_off():
    trace.enable(False, steps=trace.DEFAULT_STEPS)
    trace.reset()
    yield
    trace.enable(False, steps=trace.DEFAULT_STEPS)
    trace.reset()


@pytest.fixture(scope="module")
def params():
    return audio_llm.init_params(tiny_system().audio_llm, seed=0, device="cpu")


def _cfg(pipeline=True, sessions=4):
    cfg = tiny_system()
    return dataclasses.replace(cfg, serving=dataclasses.replace(
        cfg.serving, max_sessions=sessions, pipeline_ticks=pipeline))


def _served(params, pipeline=True, sids="abc"):
    """A service whose sessions each have quiet, speech and quiet queued
    (the system line low noise); its sinks."""
    cfg = _cfg(pipeline)
    svc = DuplexService(cfg, params=params, device="cpu")
    n = cfg.duplex.gating.samples_per_chunk
    rng = np.random.default_rng(3)
    sinks = {}
    for i, sid in enumerate(sids):
        sinks[sid] = svc.open_session(sid)
        user = np.concatenate([np.zeros((2 + i) * n, np.float32),
                               _speech(rng, 6 * n), np.zeros(4 * n, np.float32)])
        svc.enqueue_audio_data(sid, "user", {"audio": user})
        svc.enqueue_audio_data(sid, "system", {
            "audio": 5e-4 * rng.standard_normal(len(user)).astype(np.float32)})
    return svc, sinks


def _step(svc, steps):
    for _ in range(steps):
        svc.step()
    svc.drain_ticks()


def test_tracer_off_records_nothing(params):
    svc, sinks = _served(params)
    _step(svc, 12)
    assert not trace.ON
    assert trace.snapshot() == []
    assert any(s.events_of("dialog_state_update") for s in sinks.values())


@pytest.mark.parametrize("pipeline", [True, False])
def test_spans_nest_on_one_clock(params, pipeline):
    svc, _ = _served(params, pipeline)
    trace.enable(True)
    t_before = time.time_ns()
    _step(svc, 12)
    t_after = time.time_ns()
    recs = trace.snapshot()
    assert [r["step"] for r in recs] == list(range(1, 13))
    for r in recs:
        assert r["attrs"]["sessions"] == 3
        roots = [s for s in r["spans"] if s[0] == "service.step"]
        assert len(roots) == 1 and roots[0][1] is None
        root = roots[0]
        assert t_before <= root[2] <= root[3] <= t_after
        for i, (name, parent, t0, t1) in enumerate(r["spans"]):
            assert t0 <= t1, name
            if name == "service.step":
                continue
            # the parent is the innermost span opened before it that holds it
            encl = [s for s in r["spans"][:i] if s[0] == parent]
            assert encl and encl[-1][2] <= t0 and t1 <= encl[-1][3], (name, parent)
        top = sorted((s for s in r["spans"] if s[1] == "service.step"),
                     key=lambda s: s[2])
        assert {s[0] for s in top} <= set(TOP)
        assert top[0][0] == "service.frontend" and top[0][2] >= root[2]
        assert top[-1][0] == "service.decide" and top[-1][3] == root[3]
        # the tiles do not overlap
        assert all(a[3] <= b[2] for a, b in zip(top, top[1:]))
        names = [s[0] for s in r["spans"]]
        for child in ("engine.roll", "engine.gather"):
            assert names.count(child) == 1
        for name, parent, total, calls in r["stages"]:
            assert parent == "service.frontend" and total >= 0 and calls >= 1
    # ticking steps copy and launch; pipelined, a step delivers the last tick
    ticked = [r for r in recs if r["counters"].get("engine.rows_active.user")]
    assert ticked
    for r in ticked:
        names = [s[0] for s in r["spans"]]
        assert "engine.h2d" in names and "engine.launch" in names
        assert r["counters"]["engine.h2d_bytes"] > 0
    assert sum("engine.deliver" in [s[0] for s in r["spans"]] for r in recs) >= len(ticked) - 1


def test_tokens_match_the_forward_mask(params, monkeypatch):
    svc, _ = _served(params)
    masks = []
    real = qwen2.forward

    def forward(p, cfg, embeds, mask, cache, *a, **k):
        masks.append((int(mask.sum()), mask.numel()))
        return real(p, cfg, embeds, mask, cache, *a, **k)

    monkeypatch.setattr(qwen2, "forward", forward)
    trace.enable(True)
    _step(svc, 14)
    total = trace.summary(trace.snapshot())["counters"]
    assert masks and total["engine.tokens_valid"] == sum(m[0] for m in masks)
    assert total["engine.tokens_computed"] == sum(m[1] for m in masks)
    assert 0 < total["engine.tokens_valid"] < total["engine.tokens_computed"]


def test_frontend_counters_count_windows_replays_and_onsets(params, monkeypatch):
    from freeze_omni_tpu_torch.runtime import service as service_mod

    adds, gated, inside = [0], [0], [False]
    real_add = ContextSerializer.add_feature_chunk
    real_gate = GatingChunker.process_and_gate
    real_stage = service_mod.vad_stage

    def add(self, chunk):
        adds[0] += inside[0]     # the service's put-backs are not counted
        return real_add(self, chunk)

    def gate(self, ann):
        out = real_gate(self, ann)
        gated[0] += out is not None
        return out

    def stage(*a, **k):
        inside[0] = True
        try:
            return real_stage(*a, **k)
        finally:
            inside[0] = False

    monkeypatch.setattr(ContextSerializer, "add_feature_chunk", add)
    monkeypatch.setattr(GatingChunker, "process_and_gate", gate)
    monkeypatch.setattr(service_mod, "vad_stage", stage)
    svc, sinks = _served(params)
    calls = {"user": 0, "system": 0}
    for fe in svc.sessions.values():
        for ident, vad in fe.vad.items():
            def predict(x, vad=vad, ident=ident, real=vad.predict):
                calls[ident] += 1
                return real(x)
            vad.predict = predict
    trace.enable(True)
    _step(svc, 16)
    c = trace.summary(trace.snapshot())["counters"]
    assert c["frontend.windows.user"] == calls["user"] > 0
    assert c["frontend.windows.system"] == calls["system"] > 0
    onsets = sum(1 for s in sinks.values() for e in s.events_of("vad_event")
                 if e["identity"] == "user" and e["status"] == "ipu_sl")
    assert onsets > 0 and c["frontend.ipu_open.user"] == onsets
    assert c.get("frontend.ipu_open.system", 0) == 0
    # each gated window enters the serializer once, an onset's replayed
    # features before it
    assert c["frontend.replays"] == adds[0] - gated[0] > 0


def test_ring_keeps_the_last_steps(params):
    svc, _ = _served(params)
    trace.enable(True, steps=3)
    _step(svc, 7)
    recs = trace.snapshot()
    assert [r["step"] for r in recs] == [5, 6, 7]
    assert len(trace.snapshot(last=2)) == 2
    trace.enable(True, steps=5)   # a longer ring keeps what it had
    assert [r["step"] for r in trace.snapshot()] == [5, 6, 7]


def test_engine_counts_overwrites_and_rolls():
    cfg = tiny_system()
    cfg = dataclasses.replace(cfg, serving=dataclasses.replace(
        cfg.serving, max_sessions=2))
    eng = ServingEngine(cfg, device="cpu")
    rng = np.random.RandomState(0)
    eng.open_session("a")
    trace.enable(True)
    trace.step_begin(1)
    for _ in range(2):   # a second chunk before the tick replaces the first
        eng.submit_chunk("a", "user", rng.randn(1, 32, 80).astype(np.float32), True)
    eng.tick()
    trace.step_end()
    (rec,) = trace.snapshot()
    assert rec["counters"]["engine.submit_overwrites"] == 1
    assert rec["counters"]["engine.rows_active.user"] == 1
    assert "engine.kv_rolled_rows" not in rec["counters"]
    # a session at capacity is rolled before the next tick
    eng._len_host[eng.store.slot_of("a")] = eng.store.kv_capacity - 1
    trace.step_begin(2)
    eng.submit_chunk("a", "user", rng.randn(1, 32, 80).astype(np.float32), False)
    eng.tick()
    trace.step_end()
    assert trace.snapshot()[-1]["counters"]["engine.kv_rolled_rows"] == 1


def test_sites_outside_a_step_record_nothing():
    trace.enable(True)
    trace.begin("engine.submit")
    trace.count("engine.tokens_valid", 3)
    trace.stage("frontend.vad", trace.now())
    trace.end()
    assert trace.snapshot() == []


def test_offline_span_report_prints(tmp_path, capsys):
    from freeze_omni_tpu_torch.bin import offline_infer

    trace.reset_spans()
    args = argparse.Namespace(
        input_wav="freeze_omni_tpu/assets/tiny_s2s/dev_wavs/qa_000.wav",
        output_wav=str(tmp_path / "out.wav"), max_tokens=4, seed=0,
        model_path=None, voice_wav=None, device="cpu")
    offline_infer.run_inference(tiny_system(), args)
    out = capsys.readouterr().out
    lines = out[out.index("-- latency spans --"):].splitlines()
    assert [ln.split(":")[0].strip() for ln in lines[1:]] == [
        "init", "read_audio", "pre", "listen", "synthesize", "generate",
        "write_audio"]
    stats = trace.span_stats()
    assert stats["listen"]["count"] == 1 and stats["generate"]["avg_ms"] > 0
    assert stats["generate"]["total_ms"] >= stats["synthesize"]["total_ms"]
    parents = {s[0]: s[1] for r in trace.snapshot() for s in r["spans"]}
    assert parents["synthesize"] == "generate" and parents["listen"] is None
    trace.reset_spans()
    assert trace.span_stats() == {} and trace.span_report() == "-- latency spans --"


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_serve_trace_answers_stats():
    from freeze_omni_tpu_torch.bin import serve

    assert serve.trace_stats("")["tracing"] is False
    with pytest.raises(SystemExit, match="--trace requires --engine"):
        serve.Server(serve.get_args(["--preset", "tiny", "--device", "cpu",
                                     "--trace"]))
    port = _free_port()
    server = serve.Server(serve.get_args(
        ["--preset", "tiny", "--engine", "--device", "cpu", "--trace",
         "--http_port", str(port)]))
    server.stop_ticker()
    http = server._start_http()
    try:
        assert trace.ON
        svc = server.service
        n = server.cfg.duplex.gating.samples_per_chunk
        svc.open_session("s")
        svc.enqueue_audio_data("s", "user", {
            "audio": np.concatenate([np.zeros(2 * n, np.float32),
                                     _speech(np.random.default_rng(1), 4 * n)])})
        for _ in range(8):
            svc.step()
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/stats?last=8",
                                    timeout=10) as r:
            assert r.headers["Content-Type"] == "application/json"
            body = json.loads(r.read())
        assert body["tracing"] is True and body["steps"] == 8
        assert body["last_step"] == svc.steps
        assert body["spans_ms"]["service.step"] > 0
        assert body["stages_ms"]["frontend.vad"] > 0
        assert body["counters"]["frontend.windows.user"] > 0
        # the monitor page is still served
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/", timeout=10) as r:
            assert b"<html" in r.read().lower()
    finally:
        http.shutdown()
        trace.enable(False)
