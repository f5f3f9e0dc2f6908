"""Timestamp serializer for overlapping user/system audio (copy of
freeze_omni_tpu/duplex/serializer.py).

Re-implements models/ContextSerializer.py:5-121: feature chunks from both
identities merge through a min-heap on timestamps; gating rules decide what the
dialog-state predictor sees:

- user chunks always pass and reset the system pseudo-IPU;
- system chunks pass only while the user is NOT inside an actual IPU;
- the first system chunk of a pseudo-IPU is forced to 'ipu_sl' so the chat
  template prefix gets inserted (ContextSerializer.py:77-89).
"""

from __future__ import annotations

import heapq
import itertools
from typing import Optional


class ContextSerializer:
    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self.user_in_actual_ipu = False
        self.system_in_pseudo_ipu = False
        self._heap: list = []
        self._seq = itertools.count()  # tie-break for equal timestamps

    def add_feature_chunk(self, chunk: dict) -> None:
        """chunk: {'time_stamp', 'identity', 'status', 'feature', 'ipu_id'}."""
        heapq.heappush(self._heap, (chunk.get("time_stamp"), next(self._seq),
                                    chunk))

    def gate_feature(self, identity: str, status: Optional[str]):
        to_send, force_sl = False, False
        if identity == "user":
            to_send = True
            if status in ("ipu_sl", "ipu_cl"):
                self.user_in_actual_ipu = True
            elif status == "ipu_el":
                self.user_in_actual_ipu = False
            self.system_in_pseudo_ipu = False
        elif identity == "system":
            if not self.user_in_actual_ipu:
                to_send = True
                if not self.system_in_pseudo_ipu:
                    self.system_in_pseudo_ipu = True
                    force_sl = True
        return to_send, force_sl

    def get_next_feature(self) -> Optional[dict]:
        if not self._heap:
            return None
        _, _, chunk = heapq.heappop(self._heap)
        to_send, force_sl = self.gate_feature(chunk["identity"], chunk["status"])
        if not to_send:
            return None
        out = dict(chunk)
        if force_sl:
            out["status"] = "ipu_sl"
        return out

    def __len__(self) -> int:
        return len(self._heap)
