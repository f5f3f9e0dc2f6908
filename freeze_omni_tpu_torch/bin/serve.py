"""Duplex dialog-state server of the PyTorch port (counterpart of
freeze_omni_tpu/bin/serve.py).

A websocket server that hosts duplex sessions and streams the
monitoring-GUI event catalog (VAD state updates, VAD events, dialog-state
updates, dialog_ss callbacks, and with --respond the spoken response) as JSON
messages. By default every websocket gets its own DuplexSession (its worker
thread, its KV cache) on one shared DuplexPipeline, and with --respond one
shared DuplexResponder speaks through a StreamingTTS (the reference's
per-session path, bin/dialog_state_pred.py). With --engine every session
runs on one continuous-batching DuplexService instead (one batched step per
tick for every session).

Protocol (JSON messages):
  client -> server:
    {"type": "start_session", "sid": str, "role": str?}
    {"type": "audio", "identity": "user"|"system", "pcm_b64": <s16le b64>,
     "sr": int (any rate; non-16k streams through a per-identity
     resampler), "time_stamp": float?}
    {"type": "reset"} (restarts the session's context from the role
     prefill; a no-op with --engine) | {"type": "stop"}
  server -> client:
    {"event": "session_ready", "sid": ...} | {"event": "reset_done"}
    {"event": "vad_state_update"|"vad_event"|"dialog_state_update"|
     "dialog_ss_callback"|"response_text"|"response_audio"|..., ...payload}

Run (the card by default; --device cpu runs the plain PyTorch versions):
  python -m freeze_omni_tpu_torch.bin.serve --preset flagship --engine \\
      --quant 4 --kv_quant 8 --respond --port 8765
  python -m freeze_omni_tpu_torch.bin.serve --preset flagship --respond
  python -m freeze_omni_tpu_torch.bin.serve --preset tiny --device cpu

`--model_path` serves a checkpoint: a port-native system dir
(`bin/convert_ckpt.py`, or the committed tiny system
`freeze_omni_tpu_torch/assets/tiny_s2s`) or a reference checkpoint dir with
`--llm_path` (the HF Qwen2 dir), whose LLM is quantized on the host to
`--quant` bits (default 8) before it reaches the card. `--config` takes the
reference fork's app YAML (detected by its sections: VAD, gating, sampling
and threshold settings over the preset or checkpoint architecture, and its
model paths where they exist) or a config tree in this package's schema.
Without a checkpoint, `--preset flagship` serves Qwen2-7B widths with
seeded random weights drawn on the device in weight-only int8 (default) or
int4 (`--quant 4`). Per-session KV caches are float, in the activation
dtype; --kv_quant, --max_sessions and --pipeline_ticks apply to --engine
only.

`--voice_wav` derives the codec's global style tokens from a reference wav
(the codec's encode half; seeded random codec weights are drawn with it)
and every synthesizer speaks in that voice. `--lora` merges an adapter .npz
(`models/lora.py`, the JAX package's format) into the LLM weights at boot,
into the quantized tree where the LLM is quantized; `--lora_scale`
overrides its scale. `--state_dir` (with --engine) restores the sessions
saved there at boot and snapshots every live session at shutdown; a client
that reconnects with its sid resumes its dialog, and a restored session
whose client does not return within `--resume_grace` seconds is closed.

Multi-GPU serving (--engine only). `--tp k` runs the frozen LLM
tensor-parallel over k processes, one per card: this process (rank 0) owns
the sockets and drives a lockstep PrimaryDriver, and starts k - 1 follower
processes (`python -m freeze_omni_tpu_torch.bin.serve` with the same
command line, and the rank in FO_SERVE_RANK) that replay its steps
(runtime/multihost_serving.run_follower). `--coordinator host:port
--num_hosts N --host_id h` joins a job of N hosts (run the same command on
each host, with its --host_id; the FO_COORDINATOR / FO_NUM_HOSTS /
FO_HOST_ID env triple works too): session rows shard over the hosts, the
LLM over each host's --tp ranks, and host 0's rank 0 serves the sockets.
The ranks meet over NCCL with one card each; `--device cpu` runs them as
CPU processes over gloo.
  python -m freeze_omni_tpu_torch.bin.serve --preset flagship --engine \
      --quant 4 --kv_quant 8 --respond --tp 2
"""

from __future__ import annotations

import argparse
import asyncio
import base64
import dataclasses
import json
import os
import sys
import threading
from pathlib import Path

import numpy as np
import torch

from ..config import (flagship_system, load_reference_app_yaml,
                      load_system_config, read_yaml, tiny_system)
from ..utils import logging as trace

MONITOR_HTML = Path(__file__).resolve().parents[2] / "freeze_omni_tpu" / "bin" / "monitor.html"

# a follower rank started by rank 0 of its host runs its command line and
# gets its place in the job through this
_RANK_ENV = "FO_SERVE_RANK"


def get_args(argv=None):
    p = argparse.ArgumentParser(description="freeze-omni duplex server (PyTorch)")
    p.add_argument("--preset", default="flagship", choices=["tiny", "flagship"])
    p.add_argument("--device", default=None,
                   help="torch device to serve on (default: the CUDA card; "
                        "'cpu' runs the kernels' plain versions)")
    p.add_argument("--quant", default=None, type=int, choices=[0, 8, 4],
                   help="weight-only quantization bits of the flagship LLM "
                        "(0 = bf16; default 8). Ignored by --preset tiny")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8765)
    p.add_argument("--max_sessions", type=int, default=8)
    p.add_argument("--pipeline_ticks", action="store_true",
                   help="double-buffered serving: enqueue tick N+1 before "
                        "fetching tick N's predictions (decisions run one "
                        "224 ms tick late). A sharded engine (--tp, "
                        "--coordinator) gathers its results at submit, so "
                        "there it overlaps nothing yet")
    p.add_argument("--kv_quant", type=int, default=0, choices=[0, 8],
                   help="int8-quantize the per-session LLM KV cache "
                        "(per-token-per-head scales)")
    p.add_argument("--respond", action="store_true",
                   help="speak back on dialog_ss (response_text / "
                        "response_audio events)")
    p.add_argument("--resp_threshold", type=float, default=None,
                   help="override dialog_state_decision.resp_threshold")
    p.add_argument("--no_tts_warmup", action="store_true",
                   help="skip the synthesis pool warmup at boot (the eager "
                        "pool has nothing to compile)")
    p.add_argument("--http_port", type=int, default=0,
                   help="also serve the monitoring GUI (monitor.html) over "
                        "HTTP on this port")
    p.add_argument("--trace", action="store_true",
                   help="turn on the serving tick's spans and counters "
                        "(utils/logging) and serve their per-step means over "
                        "the last steps as JSON at /stats on --http_port "
                        "(needs --engine)")
    p.add_argument("--engine", action="store_true",
                   help="serve all sessions through the continuous-batching "
                        "DuplexService (default: one DuplexSession per "
                        "connection)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--timeout", type=float, default=None,
                   help="stop serving after N seconds (for smoke tests)")
    p.add_argument("--model_path", default=None,
                   help="port-native system dir, or reference checkpoint dir "
                        "(with --llm_path)")
    p.add_argument("--llm_path", default=None, help="HF Qwen2 dir")
    p.add_argument("--config", default=None,
                   help="reference app YAML or a config tree (YAML/JSON)")
    p.add_argument("--voice_wav", default=None,
                   help="voice prompt: a reference wav whose TiCodec global "
                        "style tokens condition all synthesized speech")
    p.add_argument("--lora", default=None,
                   help="LoRA adapter .npz, merged into the LLM weights at "
                        "boot (dequantize, merge, requantize for a quantized "
                        "LLM)")
    p.add_argument("--lora_scale", type=float, default=None,
                   help="override the merge scale stored in the adapter")
    p.add_argument("--state_dir", default=None,
                   help="serving snapshot dir (needs --engine): restore the "
                        "sessions saved there at boot and snapshot every "
                        "live session's context at shutdown; a client that "
                        "reconnects with its sid resumes")
    p.add_argument("--resume_grace", type=float, default=300.0,
                   help="seconds a restored session waits for its client "
                        "before its slot is reclaimed")
    p.add_argument("--tp", type=int, default=1,
                   help="tensor-parallel ways for the frozen LLM (--engine "
                        "mode): k processes, one card each, the KV heads "
                        "split over them")
    # multi-host serving: one command per host, identical flags except
    # --host_id. Host 0 owns the sockets; the other ranks replay its device
    # steps in lockstep (runtime/multihost_serving.py). Session rows shard
    # over hosts; --tp shards the LLM inside each host.
    p.add_argument("--coordinator", default=None,
                   help="host:port of host 0: enables multi-host "
                        "(env: FO_COORDINATOR/FO_NUM_HOSTS/FO_HOST_ID)")
    p.add_argument("--num_hosts", type=int, default=1)
    p.add_argument("--host_id", type=int, default=0)
    args = p.parse_args(argv)
    args.argv = list(sys.argv[1:] if argv is None else argv)   # the followers' too
    return args


class Server:
    def __init__(self, args):
        from ..models import audio_llm
        from ..utils.device import resolve_device

        from ..parallel import multihost as mh

        # the JAX server's refusals, word for word
        multi = bool(args.coordinator or os.environ.get("FO_COORDINATOR"))
        if args.tp > 1 and not args.engine:
            raise SystemExit("--tp requires --engine (the per-session "
                             "pipeline path is single-device)")
        if multi and not args.engine:
            raise SystemExit("--coordinator requires --engine (multi-host "
                             "serving is the batched engine path)")
        if args.trace and not args.engine:
            raise SystemExit("--trace requires --engine (the spans are the "
                             "batched service's tick)")
        if args.state_dir and (not args.engine or multi):
            raise SystemExit("--state_dir requires --engine and is "
                             "single-host (the snapshot fetch/import are not "
                             "wired through the lockstep bundles at boot)")
        self.args = args
        self.follower = None   # (engine, tts_params) on a follower rank
        self._local_ranks = []
        if multi:   # refuses --num_hosts < 2 before anything starts
            mh.resolve_job(args.coordinator, args.num_hosts, args.host_id)
        if args.tp > 1 and torch.device(args.device or "cuda").type == "cuda":
            n = torch.cuda.device_count()
            if n < args.tp:
                raise SystemExit(f"--tp {args.tp} needs {args.tp} devices, "
                                 f"have {n}")
        self.ranked = args.tp > 1 or multi
        # every rank draws the same seeded weights on its own device, then
        # the engine cuts its shard
        self.device = self._join_ranks() if self.ranked else \
            resolve_device(args.device)
        preset = tiny_system() if args.preset == "tiny" else flagship_system()
        base_cfg = None
        if args.config:
            doc = read_yaml(args.config)
            if ("audio_feature_gating" in doc or "dialog_state_decision" in doc
                    or "inference_control" in doc):
                base_cfg, extras = load_reference_app_yaml(args.config,
                                                           base=preset)
                # the YAML's checkpoint paths apply only where they exist (the
                # reference file pins another machine's absolute paths)
                for key in ("model_path", "llm_path"):
                    if not getattr(args, key) and extras[key] and \
                            os.path.isdir(extras[key]):
                        setattr(args, key, extras[key])
            else:
                base_cfg = load_system_config(args.config)
        params = tts_params = tokenizer = None
        if args.model_path:
            from ..utils.factory import load_system

            # a reference dir's LLM is quantized on the host, int8 unless
            # --quant says otherwise; a native dir restores as converted
            quant = 8 if args.quant is None else args.quant
            self.cfg, params, tts_params, tokenizer = load_system(
                args.model_path, args.llm_path, quantize_llm_bits=quant or None,
                device=self.device)
            print(f"loaded {args.model_path}", flush=True)
            if base_cfg is not None:
                # the checkpoint sets the architecture; the config still
                # governs the runtime (VAD and gating cadence, sampling,
                # thresholds)
                self.cfg = dataclasses.replace(self.cfg, duplex=base_cfg.duplex,
                                               sampling=base_cfg.sampling)
        else:
            self.cfg = base_cfg or preset
            if args.preset == "flagship":
                # weightless full-scale serving (seeded random params): the
                # LLM is drawn directly in weight-only int8 or int4, never as
                # a bf16 tree; --quant 0 draws it in bf16
                quant = 8 if args.quant is None else args.quant
                params = audio_llm.init_params(
                    self.cfg.audio_llm, seed=args.seed, device=self.device,
                    llm_dtype=torch.bfloat16, quantize_llm=bool(quant),
                    quant_bits=quant or 8)
                params = audio_llm.cast_frontend(params, torch.bfloat16)
                print(f"weightless flagship: random params, "
                      f"{'int%d weight-only' % quant if quant else 'bf16'} LLM",
                      flush=True)

        if args.resp_threshold is not None:
            self.cfg = dataclasses.replace(
                self.cfg, duplex=dataclasses.replace(
                    self.cfg.duplex, resp_threshold=args.resp_threshold))
        if args.voice_wav:
            # derive the voice's global style tokens once and put them in the
            # config, so every synthesizer (responder, pool) speaks with them
            tts_params = tts_params or self._init_tts_params(with_encoder=True)
            self.cfg = _with_voice(self.cfg, tts_params["codec"], args.voice_wav)
            print(f"voice prompt: global tokens "
                  f"{self.cfg.tts.codec.global_tokens}", flush=True)
        if args.lora:
            if params is None:
                # the tiny weightless preset: draw the f32 tree the serving
                # core would draw, so there is one to merge into
                params = audio_llm.init_params(
                    self.cfg.audio_llm, seed=args.seed, device=self.device,
                    llm_dtype=torch.float32)
            params = dict(params)
            params["llm"], scale = _merge_lora(params["llm"], args.lora,
                                               args.lora_scale)
            print(f"merged LoRA adapter {args.lora} (scale {scale})", flush=True)
        if args.respond:
            tts_params = tts_params or self._init_tts_params()
        else:
            tts_params = None
        self.service = self.pipeline = self.responder = None
        self._ticker_thread = None
        if not args.engine:
            self._init_per_session(params, tts_params, tokenizer)
            return
        from ..runtime.service import DuplexService

        self.cfg = dataclasses.replace(self.cfg, serving=dataclasses.replace(
            self.cfg.serving, max_sessions=args.max_sessions,
            pipeline_ticks=bool(args.pipeline_ticks),
            kv_quant_bits=args.kv_quant or None))
        # full-scale serving runs half precision (bf16 KV and frontend); the
        # tiny weightless preset stays f32
        kv_dtype = (torch.float32 if args.preset == "tiny" and not args.model_path
                    else torch.bfloat16)
        if self.ranked:
            from ..parallel import multihost as mh
            from ..runtime.engine import ServingEngine
            from ..runtime.multihost_serving import PrimaryDriver

            # the data axis spans hosts, the model axis stays inside a host
            mesh = mh.make_global_mesh(("data", "model"), model_par=args.tp)
            engine = ServingEngine(self.cfg, params, tokenizer, seed=args.seed,
                                   kv_dtype=kv_dtype, device=self.device,
                                   mesh=mesh)
            if not mh.is_primary():
                self.follower = (engine, tts_params)
                return
            self.service = DuplexService(
                self.cfg, engine=PrimaryDriver(engine, tts_params),
                seed=args.seed, tts_params=tts_params)
        else:
            self.service = DuplexService(self.cfg, seed=args.seed,
                                         tts_params=tts_params, params=params,
                                         tokenizer=tokenizer, kv_dtype=kv_dtype,
                                         device=self.device)
        if tts_params is not None and not args.no_tts_warmup:
            n = self.service.warmup_synthesis()
            print(f"synthesis pool warmup: {n} programs", flush=True)
        if args.trace:
            trace.enable(True)
        self._svc_stop = threading.Event()
        self._ticker_thread = threading.Thread(target=self._ticker, daemon=True)
        self._ticker_thread.start()

    def _join_ranks(self) -> torch.device:
        """Join the serving job and return this rank's device. Rank 0 of a
        host starts the host's other --tp ranks first
        (multihost.join_local_ranks)."""
        from ..parallel import multihost as mh

        args = self.args
        dev, self._local_ranks = mh.join_local_ranks(
            "freeze_omni_tpu_torch.bin.serve", args.argv, args.tp, _RANK_ENV,
            args.device, args.coordinator, args.num_hosts, args.host_id)
        return dev

    def close(self, timeout: float = 60.0) -> None:
        """Leave the serving job (ranked serving): rank 0 stops its ticker
        (no tick may race the stop broadcast) and broadcasts stop, which
        ends every follower's replay loop; every rank meets the others at a
        barrier and destroys the process group; then the ranks this process
        started are reaped. Idempotent."""
        if not self.ranked:
            return
        from ..parallel import multihost as mh

        self.ranked = False
        if self.follower is None and self.service is not None:
            self.stop_ticker()
            self.service.engine.stop()
        mh.sync("serve-done")
        mh.shutdown()
        mh.reap_ranks(self._local_ranks, timeout)

    def _init_per_session(self, params, tts_params, tokenizer) -> None:
        """One DuplexPipeline for every session (the KV of each is a float
        cache in the activation dtype), and with --respond one
        DuplexResponder over a StreamingTTS."""
        from ..duplex.responder import DuplexResponder
        from ..pipeline import DuplexPipeline
        from ..tts import StreamingTTS

        self.pipeline = DuplexPipeline(self.cfg, params=params,
                                       tokenizer=tokenizer,
                                       seed=self.args.seed, device=self.device)
        if tts_params is not None:
            tts = StreamingTTS(tts_params, self.cfg.tts, seed=self.args.seed,
                               device=self.device)
            self.responder = DuplexResponder(self.pipeline.core, tts, self.cfg)

    def _ticker(self):
        import time

        last_err = 0.0
        while not self._svc_stop.is_set():
            try:
                worked = self.service.step()
            except Exception as e:  # a poisoned tick must not kill the server
                now = time.monotonic()
                if now - last_err > 5.0:  # rate-limited
                    print(f"ticker error: {e!r}", file=sys.stderr)
                    last_err = now
                worked = False
                self._svc_stop.wait(0.25)  # back off while failing
            if not worked:
                self._svc_stop.wait(0.01)

    def stop_ticker(self, timeout: float = 30.0) -> None:
        """Stop the service's tick thread (the caller may then step
        `self.service` itself); per-session serving has none."""
        if self._ticker_thread is not None:
            self._svc_stop.set()
            self._ticker_thread.join(timeout=timeout)

    def _init_tts_params(self, with_encoder: bool = False):
        """Seeded random speech decoder + codec on the device (the codec's
        decode half, and its encoder with `with_encoder`: the decode
        weights are the same either way)."""
        from ..models import codec as codec_mod
        from ..models import speech_decoder as sd

        g = torch.Generator(device=self.device).manual_seed(self.args.seed + 7)
        return {"decoder": sd.init_params(self.cfg.tts.decoder, g,
                                          device=self.device),
                "codec": codec_mod.init_params(self.cfg.tts.codec, g,
                                               device=self.device,
                                               with_encoder=with_encoder)}

    def restore_snapshot(self) -> list:
        """--state_dir at boot: import the sessions saved there, if any.
        Returns the restored sids, which run() hands to evict_unclaimed."""
        if not self.args.state_dir or self.service is None or not \
                os.path.exists(os.path.join(self.args.state_dir, "sessions.json")):
            return []
        sids = self.service.engine.restore_sessions(self.args.state_dir)
        print(f"restored {len(sids)} session(s) from {self.args.state_dir}: "
              f"{sids}", flush=True)
        return sids

    async def evict_unclaimed(self, sids) -> list:
        """After --resume_grace seconds, close the restored sessions among
        `sids` that no client has reattached to, so they do not hold slots
        (and reappear in every later snapshot) for good. Runs on the serving
        loop, where the handler opens sessions too, so a reconnect cannot
        fall between the check and the close. Returns the closed sids."""
        await asyncio.sleep(self.args.resume_grace)
        closed = []
        for sid in sids:
            if sid not in self.service.sessions and \
                    self.service.engine.store.has(sid):
                self.service.engine.close_session(sid)
                closed.append(sid)
                print(f"evicted unclaimed restored session {sid!r} after "
                      f"{self.args.resume_grace:.0f}s", flush=True)
        return closed

    def snapshot(self) -> list:
        """--state_dir at shutdown: stop the ticker (nothing may write the
        rows while they are copied), deliver a tick still in flight under
        --pipeline_ticks, then save every live session. Returns the saved
        sids."""
        if not self.args.state_dir or self.service is None:
            return []
        self.stop_ticker()
        self.service.drain_ticks()
        sids = self.service.engine.save_sessions(self.args.state_dir)
        print(f"snapshotted {len(sids)} session(s) to {self.args.state_dir}",
              flush=True)
        return sids

    async def handler(self, ws):
        from ..duplex.events import EventSink
        from ..runtime.engine import CapacityError

        loop = asyncio.get_running_loop()
        outbox: "asyncio.Queue" = asyncio.Queue()
        sink = EventSink()
        for ev in sink.EVENTS:
            def fwd(payload, ev=ev):
                try:
                    loop.call_soon_threadsafe(
                        outbox.put_nowait, {"event": ev, **_jsonable(payload)})
                except RuntimeError:  # the loop closed with the connection
                    pass
            sink.on(ev, fwd)

        session = None   # per-session path: this connection's DuplexSession
        svc_sid = None   # --engine: this connection's sid in the service
        sender = asyncio.create_task(self._sender(ws, outbox))
        try:
            async for raw in ws:
                msg = json.loads(raw)
                t = msg.get("type")
                if t == "start_session":
                    sid = msg.get("sid", "") or f"anon-{id(ws)}"
                    if self.service is None:
                        if session is not None:
                            await asyncio.to_thread(session.release)
                        # construction and warmup run device steps: off the
                        # event loop
                        session = await asyncio.to_thread(
                            self._open_session, sid, sink)
                    else:
                        if svc_sid is not None:
                            self.service.close_session(svc_sid)
                            svc_sid = None
                        try:
                            self.service.open_session(sid, sink=sink)
                        except RuntimeError as e:  # no free slots / device OOM
                            err = {"event": "error", "message": str(e)}
                            if isinstance(e, CapacityError):
                                # structured capacity refusal: clients can
                                # tell "server full" from a protocol error
                                err["kind"] = "capacity"
                                err["active_sessions"] = e.active_sessions
                            await ws.send(json.dumps(err))
                            continue
                        svc_sid = sid
                    await ws.send(json.dumps(
                        {"event": "session_ready", "sid": sid}))
                elif t == "audio":
                    if session is None and svc_sid is None:
                        await ws.send(json.dumps(
                            {"event": "error", "message": "no session"}))
                        continue
                    data = {"audio": base64.b64decode(msg["pcm_b64"]),
                            "sr": msg.get("sr", 16000), "enc": "s16le",
                            "time_stamp": msg.get("time_stamp")}
                    if session is not None:
                        session.enqueue_audio_data(msg["identity"], data)
                    else:
                        self.service.enqueue_audio_data(svc_sid, msg["identity"],
                                                        data)
                elif t == "reset":
                    if session is not None:  # engine mode has no context
                        await asyncio.to_thread(session.reset_context)
                        await ws.send(json.dumps({"event": "reset_done"}))
                elif t == "stop":
                    break
                else:
                    await ws.send(json.dumps(
                        {"event": "error", "message": f"unknown type {t!r}"}))
        finally:
            sender.cancel()
            if session is not None:
                await asyncio.to_thread(session.release)
            if svc_sid is not None:
                self.service.close_session(svc_sid)

    def _open_session(self, sid: str, sink):
        """A DuplexSession on the shared pipeline, warmed up and pumping on
        its own worker thread."""
        from ..duplex.engine import DuplexSession

        session = DuplexSession(self.pipeline, self.cfg, sink=sink, sid=sid,
                                responder=self.responder)
        session.warmup()
        session.start()
        return session

    async def _sender(self, ws, outbox):
        while True:
            msg = await outbox.get()
            try:
                await ws.send(json.dumps(msg))
            except Exception:  # the connection closed: stop forwarding
                return

    def _start_http(self):
        """Monitoring GUI over plain HTTP: the JAX package's monitor.html,
        served unchanged apart from its websocket port."""
        import http.server
        import os

        page = MONITOR_HTML.read_text().replace("window.WS_PORT || 8765",
                                                str(self.args.port))

        class Handler(http.server.BaseHTTPRequestHandler):
            def do_GET(h):
                path, _, query = h.path.partition("?")
                if path == "/stats":
                    body = json.dumps(trace_stats(query)).encode()
                    h.send_response(200)
                    h.send_header("Content-Type", "application/json")
                    h.end_headers()
                    h.wfile.write(body)
                    return
                # event dumps for the GUI's ?events= replay mode: basename-
                # only .jsonl from the server's cwd (no traversal)
                if path.endswith(".jsonl") and "/" not in path.strip("/"):
                    fp = os.path.join(os.getcwd(), path.strip("/"))
                    if os.path.isfile(fp):
                        h.send_response(200)
                        h.send_header("Content-Type", "application/jsonl")
                        h.end_headers()
                        with open(fp, "rb") as f:
                            h.wfile.write(f.read())
                        return
                    h.send_response(404)
                    h.end_headers()
                    return
                h.send_response(200)
                h.send_header("Content-Type", "text/html; charset=utf-8")
                h.end_headers()
                h.wfile.write(page.encode())

            def log_message(h, *a):
                pass

        srv = http.server.ThreadingHTTPServer(
            (self.args.host, self.args.http_port), Handler)
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        print(f"monitor GUI on http://{self.args.host}:{self.args.http_port}",
              flush=True)
        return srv

    async def run(self):
        import websockets

        if self.follower is not None:
            from ..runtime.multihost_serving import run_follower

            engine, tts = self.follower
            print(f"follower host joined (host_id={self.args.host_id}); "
                  f"replaying primary's steps", flush=True)
            await asyncio.to_thread(run_follower, engine, tts)
            return
        http_srv = self._start_http() if self.args.http_port else None
        restored = self.restore_snapshot()
        evictor = asyncio.get_running_loop().create_task(
            self.evict_unclaimed(restored)) if restored else None
        try:
            async with websockets.serve(self.handler, self.args.host,
                                        self.args.port):
                print(f"serving on ws://{self.args.host}:{self.args.port}",
                      flush=True)
                try:
                    if self.args.timeout:
                        await asyncio.sleep(self.args.timeout)
                    else:
                        await asyncio.Future()
                finally:
                    # inside the serve context: leaving it closes every
                    # connection and its session, so snapshot first
                    self.snapshot()
        finally:
            if evictor is not None:
                evictor.cancel()
            self.stop_ticker()
            if http_srv is not None:
                http_srv.shutdown()
            if self.args.trace:
                trace.enable(False)


def trace_stats(query: str = "") -> dict:
    """The /stats answer: the tracer's per-step means of every span and
    stage (ms) and its counter totals over the last `last` steps of the
    query (default 100), or that tracing is off."""
    if not trace.ON:
        return {"tracing": False,
                "message": "tracing is off: start the server with --trace"}
    last = 100
    for part in query.split("&"):
        k, _, v = part.partition("=")
        if k == "last" and v.isdigit():
            last = int(v)
    steps = [r for r in trace.snapshot() if r["step"] is not None]
    return {"tracing": True, **trace.summary(steps[-last:] if last else [])}


def _with_voice(cfg, codec_params: dict, voice_wav: str):
    """cfg with the global style tokens of `voice_wav` as the codec's."""
    from ..frontend.wav import read_wav
    from ..tts import extract_global_tokens

    wav, sr = read_wav(voice_wav)
    if wav.ndim > 1:
        wav = wav.mean(axis=1)
    gst = extract_global_tokens(codec_params, cfg.tts.codec, wav, sr)
    return dataclasses.replace(cfg, tts=dataclasses.replace(
        cfg.tts, codec=dataclasses.replace(cfg.tts.codec, global_tokens=gst)))


def _merge_lora(llm: dict, path: str, scale=None):
    """(llm with the adapter at `path` merged, the scale used): the
    adapter's own scale unless `scale` overrides it."""
    from ..models import lora

    tree, saved = lora.load(path)
    scale = saved if scale is None else scale
    return lora.merge(llm, tree, scale), scale


def _jsonable(payload: dict) -> dict:
    out = {}
    for k, v in payload.items():
        if isinstance(v, (np.floating, np.integer)):
            out[k] = v.item()
        elif isinstance(v, np.ndarray):
            if k == "pcm":  # responder audio travels as base64 s16le
                out["pcm_b64"] = base64.b64encode(
                    (np.clip(v, -1, 1) * 32767).astype("<i2").tobytes()
                ).decode()
            # other raw arrays are not rebroadcast over the event stream
        elif isinstance(v, dict):
            out[k] = _jsonable(v)
        else:
            out[k] = v
    return out


def main(argv=None):
    server = Server(get_args(argv))
    try:
        asyncio.run(server.run())
    finally:
        server.close()


if __name__ == "__main__":
    main()
