"""DuplexService: many duplex sessions on one batched device step
(counterpart of freeze_omni_tpu/runtime/service.py).

Each session keeps its host-side frontend (VAD, fbank gating, timestamp
serializer, IPU lifecycle, events), but dialog-state prediction goes through
the continuous-batching ServingEngine: one batched step per service tick
serves every session's 224 ms chunk together, instead of one device call per
session (the reference's replica pools, bin/pool.py, scaled by copying the
model). With `tts_params` the service also speaks: sessions that decide to
respond share one `respond_fast_many`, continuing responses advance by
batched text segments, and their sentences are synthesized by one pooled
BatchedTTS step per tick; the 24 kHz speech is resampled to 16 kHz and fed
back as system-identity audio.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional

import numpy as np

from ..config import SystemConfig
from ..duplex.engine import IDENTITIES, Frontend, vad_stage
from ..duplex.events import EventSink
from ..utils import logging as trace
from .engine import ServingEngine


class _SessionFrontend(Frontend):
    """Host-side per-session state (device caches live in the engine)."""

    def __init__(self, sid: str, cfg: SystemConfig, sink: EventSink,
                 user_ipu_outlets: Optional[List] = None):
        super().__init__(cfg, sink, user_ipu_outlets)
        self.sid = sid
        # in-flight multi-sentence response: {'last': int (token to continue
        # from), 'n': tokens generated so far, 'toks': sentence buffer,
        # 'hids': [[1,1,D] float32]} — None when not speaking
        self.resp: Optional[dict] = None
        # barge-in generation counter: queued sentence-synthesis jobs carry
        # the generation they belong to and are dropped if it moved on
        self.resp_gen = 0
        # per-session sentence-synthesis FIFO for the batched TTS pool:
        # sentences queue here and start in order, one in flight per session
        self.tts_queue: List[tuple] = []
        self.tts_key: Optional[tuple] = None  # in-flight pool job key


class DuplexService:
    def __init__(self, cfg: SystemConfig, engine: Optional[ServingEngine] = None,
                 seed: int = 0, tts_params: Optional[dict] = None, **engine_kw):
        """tts_params: when given ({'decoder', 'codec'} on the engine's
        device), a dialog_ss decision triggers the batched fast response
        (engine.respond_fast_many); the synthesized speech is emitted as
        response_audio and fed back as system input."""
        self.cfg = cfg
        # engine_kw (params, tokenizer, kv_dtype, device) builds the engine
        # when none is given; device=None means the CUDA card
        self.engine = engine or ServingEngine(cfg, seed=seed, **engine_kw)
        self.sessions: Dict[str, _SessionFrontend] = {}
        self._lock = threading.Lock()
        # double-buffered ticks (cfg.serving.pipeline_ticks): the previous
        # tick's (PendingTick, submitted-features) pair, delivered AFTER the
        # next tick is enqueued so the device works while the host fetches;
        # decisions run one tick late in exchange for capacity
        self._pipeline = cfg.serving.pipeline_ticks
        self._pending_tick = None
        self.steps = 0   # service steps taken: the tracer's step index
        self.resp_threshold = cfg.duplex.resp_threshold
        self.tts_params = tts_params
        self._tts = None
        if tts_params is not None:
            # sentence-level synthesis for response continuation runs on a
            # batched job pool: every in-flight sentence is a row of ONE
            # pooled decode state, advanced by one batched step per service
            # tick (runtime/tts_batch.BatchedTTS). Sentence order per session
            # is kept by the per-session FIFO (one job in flight).
            from .tts_batch import BatchedTTS, row_slots

            pool = cfg.serving.tts_pool or max(4, cfg.serving.max_sessions // 4)
            # rows sized for the longest sentence a response can hand the
            # pool: resp_max_tokens LLM tokens, each hidden / idim decoder
            # frames, as prefix and again as re-embedded text
            frames = cfg.duplex.resp_max_tokens * (
                cfg.audio_llm.llm.hidden // cfg.tts.decoder.idim)
            self._tts = BatchedTTS(tts_params, cfg.tts, capacity=pool,
                                   seed=seed, max_kv_len=row_slots(cfg.tts, frames),
                                   device=self.engine.device)

    # ------------------------------------------------------------------

    def warmup_synthesis(self) -> int:
        """The JAX service pre-compiles its synthesis pool's shapes here. The
        port's pool runs eagerly and compiles nothing, so there is nothing to
        warm: returns the number of programs compiled, 0."""
        return 0

    def open_session(self, sid: str, role: Optional[str] = None,
                     sink: Optional[EventSink] = None,
                     user_ipu_outlets: Optional[List] = None) -> EventSink:
        sink = sink or EventSink()
        self.engine.open_session(sid, role=role)
        with self._lock:
            self.sessions[sid] = _SessionFrontend(sid, self.cfg, sink,
                                                  user_ipu_outlets)
        return sink

    def close_session(self, sid: str) -> None:
        with self._lock:
            fe = self.sessions.pop(sid, None)
        if fe is not None and self._tts is not None and fe.tts_key is not None:
            self._tts.cancel(fe.tts_key)
        self.engine.close_session(sid)

    def enqueue_audio_data(self, sid: str, identity: str, data: dict) -> None:
        self.sessions[sid].push_pcm(identity, data)

    # ------------------------------------------------------------------

    def step(self) -> bool:
        """One service tick: advance every session's frontend, submit at most
        one feature per (session, identity), run the batched step, deliver
        predictions. Returns True if any work was done.

        With the tracer on (utils/logging) the step's record holds the
        spans `service.step` > `service.frontend` (the session loop),
        `engine.submit`, `engine.deliver` and `service.decide` (from the
        end of the delivery to the end of the step), which tile it."""
        self.steps += 1
        if not trace.ON:
            return self._step(False)
        trace.step_begin(self.steps)
        try:
            return self._step(True)
        finally:
            trace.step_end(sessions=len(self.sessions))

    def _step(self, on: bool) -> bool:
        worked = False
        submitted: Dict[str, dict] = {}  # sid -> feature meta for user chunks
        if on:
            trace.begin("service.frontend")
        with self._lock:
            sessions = dict(self.sessions)

        for sid, fe in sessions.items():
            # frontend stages (identical semantics to DuplexSession). DRAIN
            # the ring buffer rather than pulling one VAD window per tick:
            # clients may stream faster than realtime (reconnect catch-up,
            # accelerated replay), and at one window per tick the VAD falls
            # behind arrival and IPU onsets surface seconds late — or never,
            # within a bounded listen window. The VAD is host-side and cheap;
            # the expensive engine step still consumes at most one serialized
            # feature per identity per tick below.
            for identity in IDENTITIES:
                while True:
                    chunk = fe.pcm[identity].pull(
                        fe.vad[identity].get_chunk_size())
                    if chunk is None:
                        break
                    worked = True
                    self._vad_stage(fe, identity, chunk)
            # one serialized feature per identity per tick
            if on:
                t = trace.now()
            taken = set()
            while len(taken) < len(IDENTITIES):
                feat = fe.serializer.get_next_feature()
                if feat is None:
                    if len(fe.serializer) == 0:
                        break
                    continue
                ident = feat["identity"]
                if ident in taken:
                    # keep strict ordering: push back is not possible with the
                    # heap API, so process next tick by re-adding
                    fe.serializer.add_feature_chunk(feat)
                    break
                taken.add(ident)
                worked = True
                try:  # the session may close concurrently (websocket thread)
                    self.engine.submit_chunk(
                        sid, ident, feat["feature"],
                        is_sl=(feat["status"] == "ipu_sl"))
                except KeyError:
                    break
                if ident == "user":
                    submitted[sid] = feat
            if on:
                trace.stage("frontend.serialize", t)
                waiting = len(fe.serializer)
                trace.count("serializer.waiting.sum", waiting)
                trace.peak("serializer.waiting.max", waiting)

        if on:
            trace.end()   # service.frontend
        if self._pipeline:
            handle = self.engine.tick_submit()
            prev, self._pending_tick = self._pending_tick, (handle, submitted)
            if prev is None:
                results, submitted = {}, {}
            else:
                results = prev[0].deliver()
                submitted = prev[1]
            worked = worked or bool(results) or bool(submitted)
        else:
            results = self.engine.tick()
        if on:
            trace.begin("service.decide")   # closed by the step's end
        self._decide_all(results, submitted, sessions)
        if self._pipeline:
            # capacity mode: the text continuation and the synthesis-pool
            # advance are enqueued back to back, then both deliver: the host
            # pays one fetch wave per tick. New sentences discovered by this
            # tick's continuation start pooled jobs now and produce their
            # first chunk next tick (a one-tick start deferral; the
            # latency-oriented sync path below keeps same-tick starts).
            cont_sub = self._continue_responses_submit()
            tts_deliver = self._tts.step_submit() if self._tts is not None \
                else None
            if cont_sub is not None:
                worked = self._continue_responses_deliver(cont_sub) or worked
            if self._tts is not None:
                with self._lock:
                    sessions = dict(self.sessions)
                starters = self._tts_starts(sessions)
                emitted = tts_deliver()
                self._tts_emit(sessions, emitted)
                worked = worked or bool(emitted) or bool(starters)
            return worked
        if self._continue_responses():
            worked = True
        if self._advance_tts():
            worked = True
        return worked

    def _decide_all(self, results, submitted: Dict[str, dict], sessions) -> None:
        """Run the decisions of a delivered tick; every session that decided
        to speak shares ONE batched engine.respond_fast_many instead of
        serial per-session generations on the tick thread."""
        respondents: List[str] = []
        for sid, feat in submitted.items():
            try:  # the session may close concurrently (websocket thread)
                slot = self.engine.store.slot_of(sid)
            except KeyError:
                continue
            pred = results.get("user", {}).get(slot)
            if pred is None:
                continue
            fe = sessions.get(sid)  # pipelined: submitted is one tick old
            if fe is not None and self._decide(fe, feat, pred):
                respondents.append(sid)
        if respondents:
            self._respond_fast_many(respondents)

    # ------------------------------------------------------------------

    def _vad_stage(self, fe: _SessionFrontend, identity: str,
                   chunk: np.ndarray) -> None:
        vad_stage(fe, identity, chunk,
                  on_user_onset=lambda ts: self._barge_in(fe, ts))

    def _barge_in(self, fe: _SessionFrontend, ts: float) -> None:
        """A user speech onset cancels the session's response in flight (the
        reference interrupts the LLM on user input, "LLM interrupted" in
        BASELINE.md): bumping the generation drops queued sentences, and the
        pooled synthesis job is cancelled outright."""
        if fe.resp is None and fe.tts_key is None and not fe.tts_queue:
            return
        fe.resp = None
        if self._tts is not None and fe.tts_key is not None:
            self._tts.cancel(fe.tts_key)
        fe.tts_key = None
        fe.tts_queue.clear()
        fe.resp_gen += 1
        fe.sink.emit("response_interrupted", {"time_stamp": ts})

    def _decide(self, fe: _SessionFrontend, feat: dict, pred: dict) -> bool:
        """Returns True when the session should speak (the caller batches all
        respondents of this tick into one batched response)."""
        ts = feat["time_stamp"]
        decision = "dialog_cl"
        respond = False
        if pred["state_1"] > self.resp_threshold:
            decision = "dialog_ss"
            fe.sink.emit("dialog_ss_callback", {
                "ipu_id": feat.get("ipu_id"), "state_1": pred["state_1"],
                "time_stamp": ts})
            respond = self.tts_params is not None
        elif pred["state_2"] > self.resp_threshold:
            decision = "dialog_el"
        fe.sink.emit("dialog_state_update", {
            "state": decision, "probs": pred, "time_stamp": ts})
        handle = fe.current_ipu["user"]
        if handle is not None:
            handle.register_response_state(
                {"time_stamp": ts, "decision": decision, **pred})
        return respond

    def _respond_fast_many(self, sids: List[str]) -> None:
        from ..frontend.wav import resample

        with self._lock:  # drop sessions that closed since the decision
            frontends = {sid: self.sessions[sid] for sid in sids
                         if sid in self.sessions}
        if not frontends:
            return
        try:
            out = self.engine.respond_fast_many(list(frontends),
                                                self.tts_params)
        except Exception as e:
            for fe in frontends.values():
                fe.sink.emit(
                    "error", {"where": "respond_fast", "message": str(e)})
            return
        eod = self.engine.core.tokenizer.eod_id
        for sid, (pcm24, toks) in out.items():
            fe = frontends[sid]
            fe.sink.emit("response_text",
                         {"text": self.engine.core.tokenizer.decode(
                             [t for t in toks if t != eod])})
            fe.sink.emit("response_audio",
                         {"pcm": pcm24[0, 0],
                          "sr": self.cfg.tts.codec.sample_rate})
            pcm16 = resample(pcm24[0, 0], self.cfg.tts.codec.sample_rate, 16000)
            self._feedback_system_audio(fe, pcm16)
            # register continuation: the fast path spoke the first segment;
            # later sentences advance batched across ticks until eod/cap
            if toks and toks[-1] != eod and \
                    len(toks) < self.cfg.duplex.resp_max_tokens:
                fe.resp = {"last": toks[-1], "n": len(toks),
                           "toks": [], "hids": []}
            else:
                fe.resp = None

    def _continue_responses(self) -> bool:
        """One batched text segment for every session mid-response; completed
        sentences are synthesized and emitted, eod/cap ends the response.
        Returns True when any session advanced."""
        sub = self._continue_responses_submit()
        if sub is None:
            return False
        return self._continue_responses_deliver(sub)

    def _continue_responses_submit(self):
        """Enqueue the batched continuation; the deliver half fetches and
        routes sentences. Split so the pipelined tick can overlap this with
        the synthesis-pool advance (one fetch wave per tick instead of
        serialized enqueue + fetch round trips)."""
        with self._lock:
            sessions = dict(self.sessions)
        cont = {sid: fe.resp["last"] for sid, fe in sessions.items()
                if fe.resp is not None and self.engine.store.has(sid)}
        if not cont:
            return None
        try:
            handle = self.engine.continue_segments_submit(
                cont, n_steps=self.cfg.duplex.resp_segment)
        except Exception as e:
            self._continue_error(sessions, cont, e)
            return ()  # advanced (errored) — caller reports work done
        return (handle, sessions, cont)

    def _continue_error(self, sessions, cont, e) -> None:
        for sid in cont:
            sessions[sid].sink.emit(
                "error", {"where": "continue_response", "message": str(e)})
            sessions[sid].resp = None

    def _continue_responses_deliver(self, sub) -> bool:
        if sub == ():  # submit already errored and reported
            return True
        handle, sessions, cont = sub
        try:
            out = handle.deliver()
        except Exception as e:
            self._continue_error(sessions, cont, e)
            return True
        eod = self.engine.core.tokenizer.eod_id
        from ..duplex.responder import split_sentences

        for sid, (toks, hids, done) in out.items():
            fe = sessions[sid]
            r = fe.resp
            if r is None:  # barge-in cleared it mid-flight
                continue
            per_tok = [hids[j][None, None, :] for j in range(len(toks))]
            r["n"] += len(toks)
            for st, sh in split_sentences(self.engine.core.tokenizer, eod,
                                          r["toks"], r["hids"], toks,
                                          per_tok):
                self._emit_sentence(fe, st, sh)
            r["last"] = toks[-1] if toks else eod
            if done or r["n"] >= self.cfg.duplex.resp_max_tokens:
                if r["toks"]:  # flush any unterminated tail
                    self._emit_sentence(fe, r["toks"], r["hids"])
                fe.resp = None
        return True

    def _emit_sentence(self, fe: _SessionFrontend, toks: list,
                       hids: list) -> None:
        """Queue one completed sentence for the batched synthesis pool. Text
        is emitted immediately; audio follows as the pooled job streams
        chunks. A barge-in bumps resp_gen so stale queue entries drop."""
        if not toks:
            return
        eod = self.engine.core.tokenizer.eod_id
        text = self.engine.core.tokenizer.decode(
            [t for t in toks if t != eod])
        fe.sink.emit("response_text", {"text": text})
        if self._tts is None:  # text-only service: no audio stage
            return
        fe.tts_queue.append((text, list(hids), fe.resp_gen))

    def _prepare_sentence(self, text: str, hids: list):
        """Sentence text + per-token hiddens -> (ids, prefix [1,P,D]) for the
        speech decoder (the responder's re-embed stage, split out so the
        embedding lookups of all starting sentences batch into one call)."""
        from ..pipeline import post_process

        ids = self.engine.core.tokenizer.encode(post_process(text))
        dec_idim = self.cfg.tts.decoder.idim
        prefix = np.concatenate(hids, axis=1).astype(np.float32) \
            .reshape(-1, dec_idim)[None] if hids else None
        return ids, prefix

    def _advance_tts(self) -> bool:
        """Start queued sentences (one per idle session, batched preamble +
        ONE embedding lookup across sessions) and advance every in-flight
        sentence by one codec chunk (one batched decode). Emits
        response_audio chunks as they splice out."""
        if self._tts is None:
            return False
        with self._lock:
            sessions = dict(self.sessions)
        starters = self._tts_starts(sessions)
        # one batched chunk for every in-flight sentence
        emitted = self._tts.step()
        self._tts_emit(sessions, emitted)
        return bool(emitted) or bool(starters)

    def _tts_starts(self, sessions) -> list:
        """Start queued sentences, at most one in flight per session."""
        starters = []  # (fe, text, hids, gen)
        for sid, fe in sessions.items():
            if fe.tts_key is None and fe.tts_queue:
                text, hids, gen = fe.tts_queue[0]
                if gen != fe.resp_gen:  # stale (barge-in): drop
                    fe.tts_queue.pop(0)
                    continue
                starters.append((sid, fe, text, hids, gen))
        starters = starters[: self._tts.n_free]
        if starters:
            prepared = []
            flat_ids: List[int] = []
            spans = []
            for sid, fe, text, hids, gen in starters:
                ids, prefix = self._prepare_sentence(text, hids)
                spans.append((len(flat_ids), len(flat_ids) + len(ids)))
                flat_ids.extend(ids)
                prepared.append((sid, fe, gen, prefix))
            emb = self.engine.embed_tokens(flat_ids) if flat_ids else None
            dec_idim = self.cfg.tts.decoder.idim
            jobs = []
            for (sid, fe, gen, prefix), (a, b) in zip(prepared, spans):
                if b == a:  # empty after post_process: nothing to speak
                    fe.tts_queue.pop(0)
                    continue
                hidden = emb[a:b].reshape(-1, dec_idim)[None]
                jobs.append(((sid, gen), hidden, prefix))
            if jobs:
                n = self._tts.start(jobs)
                # a sentence the pool refuses (too long for its rows) is
                # dropped from its session's queue with an error event; the
                # others started (there were rows for all of them)
                refused = dict(self._tts.take_refused())
                started = [key for key, _h, _p in jobs if key not in refused][:n]
                for key, reason in refused.items():
                    fe = sessions[key[0]]
                    fe.tts_queue.pop(0)
                    fe.sink.emit("error", {"where": "synthesis", "message": reason})
                # assign tts_key under the lock and re-check membership:
                # close_session (websocket thread) pops the session and
                # cancels fe.tts_key — if it ran between start() and the
                # assignment it would cancel None and the pool row would leak
                # for the sentence's full duration. A session that closed
                # mid-start gets its fresh job cancelled here instead.
                with self._lock:
                    for key in started:
                        sid = key[0]
                        fe = sessions[sid]
                        if self.sessions.get(sid) is not fe:
                            self._tts.cancel(key)
                            continue
                        fe.tts_queue.pop(0)
                        fe.tts_key = key
        return starters

    def _tts_emit(self, sessions, emitted) -> None:
        from ..frontend.wav import resample

        for key, chunks in emitted.items():
            sid, gen = key
            fe = sessions.get(sid)
            if fe is None:
                continue
            for pcm24, final in chunks:
                if gen == fe.resp_gen and pcm24.size:
                    pcm16 = resample(pcm24[0, 0],
                                     self.cfg.tts.codec.sample_rate, 16000)
                    fe.sink.emit("response_audio", {"pcm": pcm16,
                                                    "sr": 16000})
                    self._feedback_system_audio(fe, pcm16)
                if final and fe.tts_key == key:
                    fe.tts_key = None

    def _feedback_system_audio(self, fe: _SessionFrontend,
                               pcm16: np.ndarray) -> None:
        """Feed synthesized speech back as system-identity input, tolerating
        a session that closed concurrently."""
        with self._lock:
            still_open = self.sessions.get(fe.sid) is fe
        if still_open:
            fe.pcm["system"].push(np.asarray(pcm16, np.float32))

    def drain_ticks(self) -> None:
        """Deliver the in-flight tick (pipelined mode) and run its decisions,
        without taking new audio. Call with the ticker stopped, before a
        snapshot or shutdown, so no prediction is dropped."""
        if self._pipeline and self._pending_tick is not None:
            (handle, submitted), self._pending_tick = self._pending_tick, None
            with self._lock:
                sessions = dict(self.sessions)
            self._decide_all(handle.deliver(), submitted, sessions)

    def flush_tts(self, timeout: float = 30.0) -> None:
        """Drain queued/in-flight sentence synthesis (tests/teardown): keep
        advancing the pool until every queue and job is empty."""
        if self._tts is None:
            return
        deadline = time.time() + timeout
        while time.time() < deadline:
            with self._lock:
                busy = any(fe.tts_queue or fe.tts_key is not None
                           for fe in self.sessions.values())
            if not busy and self._tts.n_active == 0:
                return
            if not self._advance_tts() and self._tts.n_active == 0:
                # queues reference sessions only; if nothing advanced and the
                # pool is idle, remaining queue entries are stale
                return
