"""Event emission surface for duplex sessions (copy of
freeze_omni_tpu/duplex/events.py).

The reference emits Socket.IO events to a monitoring GUI through absent
`FloorState.floor_state_emission` helpers (bin/dialog_state_pred.py:565-590,
826-837; catalog in ENHANCED_DEMO.md): VAD state updates, VAD lifecycle
events, dialog-state updates, the `dialog_ss` callback, and audio rebroadcast
to a task-manager sid. Here the surface is transport-agnostic: an EventSink
fans structured events out to registered callbacks; a Socket.IO (or websocket)
server can subscribe 1:1.
"""

from __future__ import annotations

import threading
import time
from collections import defaultdict
from typing import Callable, Dict, List


class EventSink:
    EVENTS = (
        "vad_state_update",    # {'identity', 'prob', 'time_stamp'}
        "vad_event",           # {'identity', 'status', 'ipu_id', 'time_stamp'}
        "dialog_state_update", # {'state', 'probs', 'time_stamp'}
        "dialog_ss_callback",  # {'ipu_id', 'state_1', 'time_stamp'}
        "audio_rebroadcast",   # {'identity', 'audio', 'time_stamp'}
        "response_text",       # {'text', 'time_stamp'} (responder sentences)
        "response_audio",      # {'pcm', 'sr', 'time_stamp'} (responder speech)
        "response_interrupted",  # {'time_stamp'} user barge-in cancelled TTS
        "kv_roll",             # {'identity', 'kept_recent', 'time_stamp'}
        "error",               # {'where', 'message'}
    )

    def __init__(self):
        self._subs: Dict[str, List[Callable[[dict], None]]] = defaultdict(list)
        self._lock = threading.Lock()
        self.history: List[tuple] = []  # (event, payload) ring for tests/GUI
        self.history_limit = 10000

    def on(self, event: str, fn: Callable[[dict], None]) -> None:
        if event not in self.EVENTS:
            raise ValueError(f"unknown event {event!r}")
        with self._lock:
            self._subs[event].append(fn)

    def emit(self, event: str, payload: dict) -> None:
        payload = dict(payload)
        payload.setdefault("time_stamp", time.time())
        with self._lock:
            self.history.append((event, payload))
            if len(self.history) > self.history_limit:
                self.history = self.history[-self.history_limit :]
            subs = list(self._subs.get(event, ()))
        for fn in subs:
            try:
                fn(payload)
            except Exception:  # subscriber errors must not kill the session
                pass

    def events_of(self, event: str) -> List[dict]:
        with self._lock:
            return [p for e, p in self.history if e == event]
