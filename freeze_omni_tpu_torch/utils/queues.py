"""Thread-safe audio queues (copy of freeze_omni_tpu/utils/queues.py).

The reference imports absent `web.queue` classes (PCMQueue, ThreadSafeQueue;
bin/dialog_state_pred.py:27). Contracts from call sites: a PCM queue
accumulates raw audio and hands out fixed-size chunks; ThreadSafeQueue is a
plain producer/consumer queue with a non-blocking drain.
"""

from __future__ import annotations

import queue
import threading
from typing import List, Optional

import numpy as np


class PCMQueue:
    """Accumulates float32 PCM samples; `pull(n)` returns exactly n or None.

    Bounded: a client pushing faster than real time (network burst, replay
    attack, stalled consumer) cannot grow the buffer without limit — the
    OLDEST samples drop once `max_samples` is exceeded (the live end of a
    conversation matters more than a stale backlog). Default cap = 120 s of
    16 kHz audio per (session, identity)."""

    def __init__(self, max_samples: int = 120 * 16000):
        self._buf: List[np.ndarray] = []
        self._n = 0
        self._lock = threading.Lock()
        self.max_samples = max_samples
        self.dropped = 0  # total samples evicted (observability)

    def push(self, samples: np.ndarray) -> None:
        samples = np.asarray(samples, np.float32).reshape(-1)
        with self._lock:
            self._buf.append(samples)
            self._n += samples.shape[0]
            while self._n > self.max_samples and self._buf:
                head = self._buf[0]
                excess = self._n - self.max_samples
                if head.shape[0] <= excess:
                    self._buf.pop(0)
                    self._n -= head.shape[0]
                    self.dropped += head.shape[0]
                else:
                    self._buf[0] = head[excess:]
                    self._n -= excess
                    self.dropped += excess

    def push_s16le(self, raw: bytes) -> None:
        self.push(np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0)

    def available(self) -> int:
        with self._lock:
            return self._n

    def pull(self, n: int) -> Optional[np.ndarray]:
        with self._lock:
            if self._n < n:
                return None
            out = np.empty(n, np.float32)
            got = 0
            while got < n:
                head = self._buf[0]
                take = min(n - got, head.shape[0])
                out[got : got + take] = head[:take]
                if take == head.shape[0]:
                    self._buf.pop(0)
                else:
                    self._buf[0] = head[take:]
                got += take
            self._n -= n
            return out

    def clear(self) -> None:
        with self._lock:
            self._buf = []
            self._n = 0


class ThreadSafeQueue:
    def __init__(self, maxsize: int = 0):
        self._q: "queue.Queue" = queue.Queue(maxsize)

    def put(self, item) -> None:
        self._q.put(item)

    def get(self, timeout: Optional[float] = None):
        try:
            return self._q.get(timeout=timeout) if timeout else self._q.get_nowait()
        except queue.Empty:
            return None

    def drain(self) -> list:
        out = []
        while True:
            try:
                out.append(self._q.get_nowait())
            except queue.Empty:
                return out

    def __len__(self) -> int:
        return self._q.qsize()
