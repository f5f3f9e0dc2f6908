"""IPU (inter-pausal unit) handles (copy of freeze_omni_tpu/duplex/ipu.py).

The reference imports an absent `AudioLLMInterface.IPUHandle`
(bin/dialog_state_pred.py:35); its contract from call sites: constructed per
detected IPU and fanned out to consumer outlets (502-511), receives audio via
`add_chunk` (538-541), is closed with `set_end_timestamp` (546), and records
the system's response decision via `register_response_state` (767-770), with a
public `id`.
"""

from __future__ import annotations

import itertools
import threading
from typing import List, Optional

_ids = itertools.count(1)


class IPUHandle:
    def __init__(self, identity: str, start_timestamp: float):
        self.id = next(_ids)
        self.identity = identity
        self.start_timestamp = start_timestamp
        self.end_timestamp: Optional[float] = None
        self.chunks: List = []
        self.response_states: List[dict] = []
        self._lock = threading.Lock()

    def add_chunk(self, audio, time_stamp: float) -> None:
        with self._lock:
            self.chunks.append((time_stamp, audio))

    def set_end_timestamp(self, ts: float) -> None:
        with self._lock:
            self.end_timestamp = ts

    def register_response_state(self, state: dict) -> None:
        """state: e.g. {'time_stamp', 'state_1', 'state_2', 'decision'}."""
        with self._lock:
            self.response_states.append(state)

    @property
    def closed(self) -> bool:
        return self.end_timestamp is not None

    def duration(self) -> Optional[float]:
        if self.end_timestamp is None:
            return None
        return self.end_timestamp - self.start_timestamp
