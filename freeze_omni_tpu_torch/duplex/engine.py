"""Duplex dialog-state engine: per-session orchestration (counterpart of
freeze_omni_tpu/duplex/engine.py; DialogStateParams of the reference,
bin/dialog_state_pred.py:65-888).

Each session is an event-driven engine: `enqueue_audio_data` buffers raw PCM
and `pump()` (from the session's worker thread, `start()`, or directly)
drives

    PCM -> VAD (IPU lifecycle + events) -> fbank gating -> timestamp
    serializer -> dialog-state prediction (DuplexPipeline, one LLM chunk
    prefill per 224 ms window) -> threshold decision + events

The session owns one preallocated LLM KV cache, which the pipeline advances
in place; `reset_context` copies the shared role prefill into it, so the
session never writes into the prefill and no two sessions share a cache.
`vad_stage` is the frontend the batched DuplexService runs per session too.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from ..config import SystemConfig
from ..frontend.chunker import GatingChunker
from ..frontend.wav import StreamingResampler
from ..models import qwen2
from ..models.audio_llm import chunk_tokens
from ..pipeline import DuplexPipeline
from ..utils import logging as trace
from ..utils.queues import PCMQueue
from .events import EventSink
from .ipu import IPUHandle
from .serializer import ContextSerializer
from .vad import make_vad

IDENTITIES = ("user", "system")
# the tracer's counters of vad_stage, by identity
_WINDOWS = {i: f"frontend.windows.{i}" for i in IDENTITIES}
_IPU_OPEN = {i: f"frontend.ipu_open.{i}" for i in IDENTITIES}


class Frontend:
    """Host-side state of one session's two audio lines: PCM queues with
    per-rate resamplers, VADs, gating chunkers, the IPU in progress per
    identity and the timestamp serializer."""

    def __init__(self, cfg: SystemConfig, sink: EventSink,
                 user_ipu_outlets: Optional[List] = None):
        self.cfg = cfg
        self.sink = sink
        self.user_ipu_outlets = user_ipu_outlets or []
        gating_cfg = cfg.duplex.gating
        # VAD decisions at the 224 ms prediction cadence
        vad_cfg = dataclasses.replace(cfg.duplex.vad,
                                      chunk_size=gating_cfg.samples_per_chunk)
        self.pcm = {i: PCMQueue() for i in IDENTITIES}
        self.resamplers: Dict[str, StreamingResampler] = {}  # per client rate
        self.vad = {i: make_vad(vad_cfg, identity=i) for i in IDENTITIES}
        self.gating = {i: GatingChunker(gating_cfg) for i in IDENTITIES}
        self.serializer = ContextSerializer()
        self.current_ipu: Dict[str, Optional[IPUHandle]] = {
            i: None for i in IDENTITIES}

    def push_pcm(self, identity: str, data: dict) -> None:
        """data: {'audio': bytes (s16le) | float array, 'sr': int, ...} (the
        contract of DialogStateParams.enqueue_audio_data,
        dialog_state_pred.py:330-400). Any client rate is accepted: chunks
        stream through a per-identity resampler to the VAD rate with no
        per-message boundary artifacts."""
        if identity not in IDENTITIES:
            raise ValueError(f"unknown identity {identity!r}")
        want = self.cfg.duplex.vad.sample_rate
        sr = data.get("sr", want)
        audio = data["audio"]
        if isinstance(audio, (bytes, bytearray)):
            audio = np.frombuffer(bytes(audio), "<i2").astype(np.float32) \
                / 32768.0
        else:
            audio = np.asarray(audio, np.float32)
        if sr != want:
            rs = self.resamplers.get(identity)
            if rs is None or rs.orig_sr != sr:
                rs = self.resamplers[identity] = StreamingResampler(sr, want)
            audio = rs.push(audio)
        self.pcm[identity].push(audio)

    def reset(self) -> None:
        for i in IDENTITIES:
            self.vad[i].reset()
            self.gating[i].reset()
        self.serializer.reset()


def vad_stage(fe: Frontend, identity: str, chunk: np.ndarray,
              on_user_onset: Optional[Callable[[float], None]] = None) -> None:
    """One VAD window of one identity: VAD events and the IPU lifecycle
    (dialog_state_pred.py:484-563), then fbank gating, whose gated windows
    enter the serializer; on ipu_sl the pre-onset history enters first as
    ipu_sl + ipu_cl..., then the current window as ipu_cl (onset replay,
    dialog_state_pred.py:639-670). `on_user_onset(ts)` runs at a user
    ipu_sl (the service's barge-in).

    With the tracer on, its time goes to the summed stages `frontend.vad`
    (the VAD), `frontend.events` (the listeners of its two events),
    `frontend.gate` (fbank and gating) and `frontend.serialize` (the
    serializer's adds), and it counts `frontend.windows.<identity>`,
    `frontend.ipu_open.<identity>` and `frontend.replays` (the onset's
    replayed features)."""
    on = trace.ON
    if on:
        trace.count(_WINDOWS[identity])
        t = trace.now()
    ts = time.time()
    ann = fe.vad[identity].predict({"audio": chunk, "time_stamp": ts})
    if on:
        t = trace.stage("frontend.vad", t)
    fe.sink.emit("vad_state_update", {"identity": identity,
                                      "prob": ann["prob"], "time_stamp": ts})
    if on:
        t = trace.stage("frontend.events", t)
    status = ann["status"]
    if status == "ipu_sl":
        if on:
            trace.count(_IPU_OPEN[identity])
        handle = IPUHandle(identity, ts)
        fe.current_ipu[identity] = handle
        if identity == "user":
            for outlet in fe.user_ipu_outlets:
                outlet(handle)
            if on_user_onset is not None:
                on_user_onset(ts)
        handle.add_chunk(ann["audio"], ts)
    elif status in ("ipu_cl", "ipu_el"):
        handle = fe.current_ipu[identity]
        if handle is not None:
            handle.add_chunk(ann["audio"], ts)
            if status == "ipu_el":
                handle.set_end_timestamp(ts)
    if status is not None:
        if on:
            t = trace.now()
        fe.sink.emit("vad_event", {
            "identity": identity, "status": status,
            "ipu_id": getattr(fe.current_ipu[identity], "id", None),
            "time_stamp": ts})
        if on:
            trace.stage("frontend.events", t)

    if on:
        t = trace.now()
    gated = fe.gating[identity].process_and_gate(
        {"audio": ann["audio"], "status": status})
    if on:
        t = trace.stage("frontend.gate", t)
    if gated is None:
        return
    replay = gated.get("feature_last_chunk", [])
    if replay and gated["status"] == "ipu_sl":
        if on:
            trace.count("frontend.replays", len(replay))
        seq = [(f, "ipu_sl" if i == 0 else "ipu_cl")
               for i, f in enumerate(replay)]
        seq.append((gated["feature"], "ipu_cl"))
    else:
        seq = [(gated["feature"], gated["status"])]
    for k, (f, st) in enumerate(seq):
        fe.serializer.add_feature_chunk({
            "time_stamp": ts + 1e-6 * k, "identity": identity,
            "status": st, "feature": np.asarray(f, np.float32),
            "ipu_id": getattr(fe.current_ipu[identity], "id", None)})
    if on:
        trace.stage("frontend.serialize", t)


class DuplexSession:
    EXPECTED_ENCODING = "s16le"

    def __init__(self, pipeline: DuplexPipeline, cfg: SystemConfig,
                 sink: Optional[EventSink] = None, sid: str = "",
                 user_ipu_outlets: Optional[List] = None, responder=None):
        """responder: an optional DuplexResponder; with one, a dialog_ss
        decision speaks and the speech re-enters as system audio."""
        self.pipeline = pipeline
        self.cfg = cfg
        self.sid = sid
        self.frontend = Frontend(cfg, sink or EventSink(), user_ipu_outlets)
        self.responder = responder
        self.resp_threshold = cfg.duplex.resp_threshold
        # the worker thread and reset_context (a handler thread) both touch
        # the frontend and the cache: one unit of work at a time
        self._lock = threading.RLock()

        # the role prefill, shared by every session of this role: the reset
        # point, copied into the session's own cache and never written
        _, self.system_role_kv, _, _, _ = pipeline.speech_dialogue(
            None, identity="", status="pre", role=cfg.duplex.default_prompt)
        self.past_key_values = qwen2.copy_cache(self.system_role_kv)
        # host mirror of the KV length, so per-chunk handling never waits on
        # the device: one read here, advanced exactly per chunk, read again
        # once after a response (the generated length is data-dependent)
        self._role_len = int(self.system_role_kv.length[0])
        core = pipeline.core
        self._prefix_len = {"user": int(core.user_prefix_embeds.shape[0]),
                            "system": int(core.system_prefix_embeds.shape[0])}
        self.reset_context()

        self._stop = threading.Event()
        self._worker: Optional[threading.Thread] = None

    @property
    def sink(self) -> EventSink:
        return self.frontend.sink

    # ------------------------------------------------------------------
    # lifecycle
    # ------------------------------------------------------------------

    def reset_context(self) -> None:
        """Fresh session context: the KV restarts from the role prefill
        (dialog_state_pred.py:170-232), copied into the session's cache in
        place; encoder/adapter caches, VADs, gating and serializer restart."""
        with self._lock:
            qwen2.copy_cache(self.system_role_kv, out=self.past_key_values)
            self._kv_len: Optional[int] = self._role_len
            self.caches = {i: {"encoder_cache": None, "adapter_cache": None,
                               "pe_index": 0} for i in IDENTITIES}
            self.frontend.reset()
            self.dialog_state = "dialog_sl"

    def start(self, interval: float = 0.005) -> None:
        """Pump on a worker thread until `release()`."""
        if self._worker is not None:
            return

        def loop():
            while not self._stop.is_set():
                try:
                    worked = self.pump()
                except Exception as e:
                    # failure containment (the reference's try/except ->
                    # release() teardown, dialog_state_pred.py:595-598): emit,
                    # drop the poisoned queues, keep the session alive
                    self.sink.emit("error", {"where": "pump", "message": str(e)})
                    for q in self.frontend.pcm.values():
                        q.clear()
                    worked = False
                if not worked:
                    time.sleep(interval)

        self._worker = threading.Thread(target=loop, daemon=True)
        self._worker.start()

    def release(self) -> None:
        self._stop.set()
        if self._worker is not None:
            self._worker.join(timeout=30.0)
            self._worker = None

    # ------------------------------------------------------------------
    # input
    # ------------------------------------------------------------------

    def enqueue_audio_data(self, identity: str, data: dict) -> None:
        """data: {'audio': bytes (s16le) | float array, 'sr': int,
        'enc': 's16le'|'f32', 'time_stamp': float}; any client rate."""
        self.frontend.push_pcm(identity, data)
        if identity == "user":
            self.sink.emit("audio_rebroadcast",
                           {"identity": identity,
                            "time_stamp": data.get("time_stamp")})

    # ------------------------------------------------------------------
    # engine step
    # ------------------------------------------------------------------

    def pump(self) -> bool:
        """Process all complete chunks; returns True if any work was done."""
        fe = self.frontend
        worked = False
        for identity in IDENTITIES:
            while True:
                with self._lock:
                    chunk = fe.pcm[identity].pull(fe.vad[identity].get_chunk_size())
                    if chunk is None:
                        break
                    vad_stage(fe, identity, chunk)
                worked = True
        while True:
            with self._lock:
                feat = fe.serializer.get_next_feature()
                if feat is None:
                    if len(fe.serializer) == 0:
                        break
                    continue  # gated out; keep draining
                self._predict_stage(feat)
            worked = True
        return worked

    def _predict_stage(self, feat: dict) -> None:
        identity = feat["identity"]
        # the cache has a fixed capacity: a session nearing it ROLLS
        # (qwen2.roll_kv), keeping the role prefill pinned and the most
        # recent window of dialog in place, off the host length mirror
        if self._kv_len is None:
            self._kv_len = int(self.past_key_values.length[0].item())
        cap = self.past_key_values.k.shape[2]
        margin = max(self.cfg.serving.kv_margin, 64)
        if self._kv_len > cap - margin:
            prefix = self.system_role_kv.length
            # post-roll length targets half the usable window
            target = (cap - margin) // 2
            keep = int(min(max(target - self._role_len, 16),
                           self.cfg.serving.kv_keep_recent))
            with torch.no_grad():
                qwen2.roll_kv(self.cfg.audio_llm.llm, self.past_key_values,
                              prefix, torch.full_like(prefix, keep),
                              torch.ones_like(prefix, dtype=torch.bool))
            self._kv_len = self._role_len + keep
            self.sink.emit("kv_roll", {
                "identity": identity, "kept_recent": keep,
                "time_stamp": feat["time_stamp"]})
        c = self.caches[identity]
        pred, _, adp, enc, pe = self.pipeline.speech_dialogue(
            feat["feature"], identity, feat["status"],
            past_key_values=self.past_key_values,
            adapter_cache=c["adapter_cache"], encoder_cache=c["encoder_cache"],
            pe_index=c["pe_index"])
        c.update(adapter_cache=adp, encoder_cache=enc, pe_index=pe)
        # exact host-side append accounting: the chat prefix on ipu_sl and
        # the window's adapter tokens
        self._kv_len += chunk_tokens(np.asarray(feat["feature"]).shape[-2]) \
            + (self._prefix_len[identity] if feat["status"] == "ipu_sl" else 0)

        if pred is None:
            return
        ts = feat["time_stamp"]
        decision = "dialog_cl"
        if pred["state_1"] > self.resp_threshold:
            decision = "dialog_ss"
            self.sink.emit("dialog_ss_callback", {
                "ipu_id": feat.get("ipu_id"), "state_1": pred["state_1"],
                "time_stamp": ts})
            if self.responder is not None:
                self._respond()
        elif pred["state_2"] > self.resp_threshold:
            # end without response (collapsed to cl in the fork,
            # dialog_state_pred.py:828-830)
            decision = "dialog_el"
        self.dialog_state = decision
        self.sink.emit("dialog_state_update", {
            "state": decision, "probs": pred, "time_stamp": ts})
        handle = self.frontend.current_ipu["user"]
        if handle is not None:
            handle.register_response_state(
                {"time_stamp": ts, "decision": decision, **pred})

    def _respond(self) -> None:
        """Speak on the session's context; the speech re-enters as system
        audio so the predictor hears the system speaking (the upstream
        duplex loop). The responder leaves the cache at the last sentence
        it yielded."""
        try:
            self._kv_len = None  # the generated length is data-dependent
            for text, pcm16, _ in self.responder.respond(self.past_key_values):
                self.sink.emit("response_text", {"text": text})
                if pcm16 is not None and pcm16.size:
                    self.sink.emit("response_audio", {"pcm": pcm16, "sr": 16000})
                    self.enqueue_audio_data("system", {"audio": pcm16,
                                                       "enc": "f32"})
        except Exception as e:  # a responder failure must not kill the session
            self.sink.emit("error", {"where": "responder", "message": str(e)})

    # ------------------------------------------------------------------

    def warmup(self) -> None:
        """Push synthetic sl/cl..el sequences through both identities, every
        (identity, status) step shape once (warmup_compiled_methods,
        dialog_state_pred.py:846-888), then reset the context."""
        n = self.cfg.duplex.gating.samples_per_chunk
        loud = (0.5 * np.sin(2 * np.pi * 220 * np.arange(3 * n) / 16000)
                ).astype(np.float32)
        quiet = np.zeros(4 * n, np.float32)
        # warmup traffic must not reach subscribers or IPU consumers
        fe = self.frontend
        real_sink, real_outlets = fe.sink, fe.user_ipu_outlets
        fe.sink, fe.user_ipu_outlets = EventSink(), []
        try:
            for identity in IDENTITIES:
                self.enqueue_audio_data(identity, {"audio": quiet[:n], "enc": "f32"})
                self.enqueue_audio_data(identity, {"audio": loud, "enc": "f32"})
                self.enqueue_audio_data(identity, {"audio": quiet, "enc": "f32"})
            while self.pump():
                pass
        finally:
            fe.sink, fe.user_ipu_outlets = real_sink, real_outlets
        self.reset_context()
