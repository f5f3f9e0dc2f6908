"""Duplex websocket client: stream a wav to the server, save the reply
(counterpart of freeze_omni_tpu/bin/client.py; host only, no model).

The reference drives its demo through a Flask-SocketIO GUI (ENHANCED_DEMO.md);
this is the scriptable endpoint of bin/serve.py's JSON protocol, the same in
both packages: stream a wav file as user audio at real-time (or accelerated)
cadence, print the dialog events as they arrive, and write every
response_audio segment the server speaks into one output wav.

Usage (server: python -m freeze_omni_tpu_torch.bin.serve --preset tiny \
           --engine --respond --resp_threshold 0.0 --port 8765 [--device cpu]):

  python -m freeze_omni_tpu_torch.bin.client --url ws://127.0.0.1:8765 \
      --input_wav question.wav --output_wav answer.wav [--speed 4] [--verbose]
"""

from __future__ import annotations

import argparse
import asyncio
import base64
import json
import time

import numpy as np

CHUNK_S = 0.224  # one gating chunk per message (configs: 224 ms)


def get_args(argv=None):
    p = argparse.ArgumentParser(description="freeze-omni duplex client")
    p.add_argument("--url", default="ws://127.0.0.1:8765")
    p.add_argument("--sid", default=None, help="session id (default: random)")
    p.add_argument("--role", default=None, help="system role prompt")
    p.add_argument("--input_wav", required=True)
    p.add_argument("--output_wav", default=None,
                   help="write concatenated response audio here")
    p.add_argument("--speed", type=float, default=1.0,
                   help="send cadence multiplier (1 = real time)")
    p.add_argument("--listen_s", type=float, default=5.0,
                   help="idle window: stop once no event has arrived for "
                        "this long after the wav ends")
    p.add_argument("--max_listen_s", type=float, default=120.0,
                   help="hard cap on the post-stream listen phase (a reply "
                        "known to be in flight — dialog_ss seen, audio not "
                        "yet received — extends the idle window up to this)")
    p.add_argument("--verbose", action="store_true",
                   help="print every event (default: decisions + responses)")
    return p.parse_args(argv)


def _log(msg: str) -> None:
    print(f"[{time.strftime('%H:%M:%S')}] {msg}", flush=True)


async def run_client(args) -> dict:
    import websockets

    from ..frontend.wav import read_wav, resample

    wav, sr = read_wav(args.input_wav)
    if wav.ndim > 1:
        wav = wav.mean(axis=1)
    wav = np.asarray(wav, np.float32)
    sid = args.sid or f"client-{int(time.time() * 1000) % 1_000_000}"
    chunk = max(1, int(CHUNK_S * sr))

    stats = {"events": {}, "responses": [], "texts": []}
    last_event = [time.monotonic()]
    done = asyncio.Event()

    async with websockets.connect(args.url, max_size=None,
                                  open_timeout=300) as ws:
        start = {"type": "start_session", "sid": sid}
        if args.role:
            start["role"] = args.role
        await ws.send(json.dumps(start))

        async def reader():
            try:
                while not done.is_set():
                    msg = json.loads(await ws.recv())
                    ev = msg.get("event")
                    stats["events"][ev] = stats["events"].get(ev, 0) + 1
                    last_event[0] = time.monotonic()
                    if ev == "response_audio" and "pcm_b64" in msg:
                        pcm = np.frombuffer(
                            base64.b64decode(msg["pcm_b64"]), "<i2"
                        ).astype(np.float32) / 32768.0
                        stats["responses"].append((pcm, int(msg.get("sr",
                                                                    16000))))
                        _log(f"response_audio: {len(pcm)} samples @ "
                             f"{msg.get('sr', 16000)} Hz")
                    elif ev == "response_text":
                        stats["texts"].append(msg.get("text", ""))
                        _log(f"response_text: {msg.get('text', '')!r}")
                    elif ev == "dialog_ss_callback":
                        _log(f"dialog_ss (state_1={msg.get('state_1', 0):.3f})"
                             " -> system will speak")
                    elif ev == "error":
                        _log(f"server error: {msg.get('message')}")
                    elif args.verbose or ev in ("session_ready", "vad_event",
                                                "response_interrupted",
                                                "kv_roll"):
                        _log(f"{ev}: "
                             f"{ {k: v for k, v in msg.items() if k != 'event'} }")
            except Exception:
                pass  # connection closed

        rt = asyncio.create_task(reader())
        for i in range(0, len(wav), chunk):
            seg = wav[i : i + chunk]
            s16 = (np.clip(seg, -1, 1) * 32767).astype("<i2").tobytes()
            await ws.send(json.dumps({
                "type": "audio", "identity": "user", "sr": sr,
                "pcm_b64": base64.b64encode(s16).decode(),
                "time_stamp": time.time()}))
            await asyncio.sleep(len(seg) / sr / max(args.speed, 1e-6))
        _log(f"streamed {len(wav) / sr:.1f}s of audio; listening "
             f"(idle window {args.listen_s:.1f}s, cap {args.max_listen_s:.0f}s)")
        # adaptive listen: a fixed sleep races first-use jit compiles on the
        # server (a reply can land tens of seconds after the last event on a
        # loaded host). Stay while events keep arriving; while a reply is
        # known to be in flight (dialog_ss fired but no response_audio yet),
        # keep waiting up to the hard cap.
        listen_start = time.monotonic()
        last_event[0] = listen_start
        while True:
            now = time.monotonic()
            if now - listen_start > args.max_listen_s:
                break
            in_flight = (stats["events"].get("dialog_ss_callback", 0) > 0
                         and not stats["responses"])
            if not in_flight and now - last_event[0] > args.listen_s:
                break
            await asyncio.sleep(0.25)
        done.set()
        await ws.send(json.dumps({"type": "stop"}))
        rt.cancel()

    if args.output_wav and stats["responses"]:
        from ..frontend.wav import write_wav

        out_sr = stats["responses"][0][1]
        parts = [pcm if s == out_sr else resample(pcm, s, out_sr)
                 for pcm, s in stats["responses"]]
        write_wav(args.output_wav, np.concatenate(parts), out_sr)
        _log(f"wrote {args.output_wav} "
             f"({sum(len(p) for p in parts) / out_sr:.2f}s @ {out_sr} Hz)")
    _log(f"event counts: {stats['events']}")
    return stats


def main(argv=None):
    args = get_args(argv)
    return asyncio.run(run_client(args))


if __name__ == "__main__":
    main()
