"""Lockstep multi-process serving: one ServingEngine spread over ranks
(counterpart of freeze_omni_tpu/runtime/multihost_serving.py).

Each rank (one process per card, or several sharing a card) holds a
ServingEngine built with the same config, seed and weights on a
parallel/mesh.Mesh: the LLM tensor-parallel over 'model', the session rows
over 'data'. Every engine call runs on every rank, in the same order, since
the model's collectives need every rank of a group. Rank 0, the PRIMARY,
owns the sockets and all decisions: each engine call is serialized into a
bundle, broadcast to the FOLLOWERS, then applied identically everywhere by
`apply_bundle`. All host-side engine state (slot maps, pending chunks,
KV-length mirrors, sampling seeds) is a function of the bundle stream, so
the ranks never diverge; per-row results are gathered to every rank by the
engine.

Usage (one process per rank, same config/seed/params everywhere):

    engine = ServingEngine(cfg, params, mesh=mh.make_global_mesh(
        ("data", "model"), model_par=k), device=dev)
    if mh.is_primary():
        drv = PrimaryDriver(engine, tts_params)   # has the engine's API
        drv.open_session("a"); drv.submit_chunk(...); drv.tick(); ...
        drv.stop()
    else:
        run_follower(engine, tts_params)          # returns on stop()

Beyond the JAX PrimaryDriver, this one also has `tick_submit` and
`continue_segments_submit` (bundles applied in broadcast order; the
primary's handle delivers), which `DuplexService` calls on every
continuation round and under `pipeline_ticks`, and `save_sessions` /
`restore_sessions` for a serving snapshot.
"""

from __future__ import annotations

import pickle
import sys
import threading
from typing import Dict, List, Optional

import numpy as np
import torch

from ..parallel import collectives

# size-tiered broadcast frames: every rank must present the same shape to
# the collective, so the payload rides a frame from a fixed ladder after an
# 8-byte size header round (the JAX package measured a single 4 MiB frame
# costing 26.6 ms a call over localhost TCP even for ~100-byte bundles;
# the ladder sends those in the 64 KiB frame). The top covers a 128-session
# x 32-frame x 80-mel dual-identity tick (~2.6 MiB of f32).
FRAME_BYTES = 1 << 22
FRAME_TIERS = (1 << 16, 1 << 19, FRAME_BYTES)


def _broadcast(obj: Optional[dict]) -> dict:
    """Two-round broadcast from rank 0 over the world group: an 8-byte size
    header picks the frame tier (the same on every rank), then the payload
    frame, both uint8 tensors. Rank 0 pickles `obj`; the others pass None.
    The bytes are the primary's own pickle of its bundle."""
    dev = collectives.comm_device()
    if obj is not None:
        payload = pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
        if len(payload) > FRAME_BYTES:
            raise ValueError(f"bundle {len(payload)}B exceeds the "
                             f"{FRAME_BYTES}B broadcast frame")
        header = torch.frombuffer(bytearray(len(payload).to_bytes(8, "little")),
                                  dtype=torch.uint8).to(dev)
    else:
        payload = b""
        header = torch.zeros(8, dtype=torch.uint8, device=dev)
    collectives.broadcast_(header, src=0)
    n = int.from_bytes(bytes(header.cpu().tolist()), "little")
    tier = next(t for t in FRAME_TIERS if n <= t)
    frame = torch.zeros(tier, dtype=torch.uint8)
    if obj is not None:
        frame[:n] = torch.frombuffer(bytearray(payload), dtype=torch.uint8)
    frame = collectives.broadcast_(frame.to(dev), src=0)
    return pickle.loads(frame[:n].cpu().numpy().tobytes())


def apply_bundle(engine, bundle: dict, tts_params: Optional[dict] = None):
    """Replay one decision bundle on the local engine. Ops run in a fixed
    order; every rank takes the same device steps."""
    op = bundle["op"]
    if op == "open":
        return engine.open_session(bundle["sid"], role=bundle.get("role"))
    if op == "close":
        if engine.store.has(bundle["sid"]):  # idempotent under ws races
            engine.close_session(bundle["sid"])
        return None
    if op in ("tick", "tick_submit"):
        for sid, identity, chunk, is_sl in bundle["submits"]:
            # a buffered submit may outlive its session (closed between
            # submit and tick); the store state is identical on every rank,
            # so skipping here is deterministic
            if engine.store.has(sid):
                engine.submit_chunk(sid, identity, chunk, is_sl)
        return engine.tick() if op == "tick" else engine.tick_submit()
    if op == "respond":
        if tts_params is None:
            raise RuntimeError("respond bundle but this rank has no "
                               "tts_params")
        return engine.respond_fast_many(bundle["sids"], tts_params,
                                        n_text=bundle["n_text"])
    if op in ("continue", "continue_submit"):
        run = (engine.continue_segments if op == "continue"
               else engine.continue_segments_submit)
        return run(bundle["last_tokens"], n_steps=bundle["n_steps"])
    if op == "embed":
        # the sentence re-embed: a collective on the vocab-parallel table;
        # the primary uses the result, the others take part
        return engine.embed_tokens(bundle["ids"])
    if op == "export":
        # a collective where the row is sharded: every rank takes part and
        # gets the same blob
        return engine.export_session(bundle["sid"])
    if op == "import":
        return engine.import_session(bundle["sid"], bundle["blob"])
    if op == "save":
        return engine.save_sessions(bundle["dir"])
    if op == "restore":
        return engine.restore_sessions(bundle["dir"])
    if op == "stop":
        return None
    raise ValueError(f"unknown bundle op {op!r}")


class PrimaryDriver:
    """The engine's serving API, with every call broadcast before it runs.
    Mirrors the surface runtime/service.DuplexService uses, so a
    DuplexService constructed with engine=PrimaryDriver(...) serves across
    ranks unchanged."""

    def __init__(self, engine, tts_params: Optional[dict] = None):
        self.engine = engine
        self.tts_params = tts_params
        self.core = engine.core
        self.store = engine.store
        self.cfg = engine.cfg
        self.device = engine.device
        self._submits: List[tuple] = []
        # broadcast+apply is atomic: callers live on several threads (ticker,
        # websocket loop), but followers replay bundles strictly in broadcast
        # order, so the primary's device-op order must match it exactly
        self._lock = threading.Lock()

    # -- session management -------------------------------------------
    def open_session(self, sid: str, role: Optional[str] = None,
                     on_prediction=None) -> int:
        slot = self._run({"op": "open", "sid": sid, "role": role})
        if on_prediction is not None:
            # callbacks are primary-only (they drive sockets); registered
            # outside the broadcast so followers never see them
            self.engine._callbacks[slot] = on_prediction
        return slot

    def close_session(self, sid: str) -> None:
        self._run({"op": "close", "sid": sid})

    def embed_tokens(self, ids):
        return self._run({"op": "embed", "ids": [int(t) for t in ids]})

    def export_session(self, sid: str) -> dict:
        return self._run({"op": "export", "sid": sid})

    def import_session(self, sid: str, blob: dict,
                       on_prediction=None) -> int:
        """The blob rides the broadcast frame (FRAME_BYTES cap): fine for
        tiny/test configs; flagship KV rows exceed it, so migrate those
        through `save_sessions` / `restore_sessions`, which read files."""
        slot = self._run({"op": "import", "sid": sid, "blob": blob})
        if on_prediction is not None:
            self.engine._callbacks[slot] = on_prediction
        return slot

    def save_sessions(self, dirpath: str) -> List[str]:
        return self._run({"op": "save", "dir": dirpath})

    def restore_sessions(self, dirpath: str) -> List[str]:
        """Every rank reads the snapshot files: a directory every rank can
        see (one host)."""
        return self._run({"op": "restore", "dir": dirpath})

    @property
    def num_active(self) -> int:
        return self.engine.num_active

    # -- serving -------------------------------------------------------
    def submit_chunk(self, sid: str, identity: str, fbank_chunk, is_sl: bool
                     ) -> None:
        """Host-only buffering; chunks ride the next tick's bundle."""
        with self._lock:
            self._submits.append((sid, identity,
                                  np.asarray(fbank_chunk, np.float32),
                                  bool(is_sl)))

    def tick(self):
        return self._tick("tick")

    def tick_submit(self):
        """The engine's PendingTick; its deliver() runs here only."""
        return self._tick("tick_submit")

    def _tick(self, op: str):
        with self._lock:
            submits, self._submits = self._submits, []
            return self._run_locked({"op": op, "submits": submits})

    def respond_fast_many(self, sids: List[str], tts_params=None,
                          n_text: int = 8, gen=None):
        # tts_params and the generator are each rank's own (identical by
        # construction); only the decision is broadcast
        return self._run({"op": "respond", "sids": list(sids),
                          "n_text": n_text})

    def respond_fast(self, sid: str, tts_params=None, n_text: int = 8,
                     gen=None):
        return self.respond_fast_many([sid], n_text=n_text)[sid]

    def continue_segments(self, last_tokens: Dict[str, int],
                          n_steps: int = 16, gen=None):
        return self._run({"op": "continue", "last_tokens": dict(last_tokens),
                          "n_steps": n_steps})

    def continue_segments_submit(self, last_tokens: Dict[str, int],
                                 n_steps: int = 16, gen=None):
        """The engine's PendingSegments; its deliver() runs here only."""
        return self._run({"op": "continue_submit",
                          "last_tokens": dict(last_tokens),
                          "n_steps": n_steps})

    def stop(self) -> None:
        with self._lock:
            _broadcast({"op": "stop"})

    def _run(self, bundle: dict):
        with self._lock:
            return self._run_locked(bundle)

    def _run_locked(self, bundle: dict):
        _broadcast(bundle)
        return apply_bundle(self.engine, bundle, self.tts_params)


# a device or collective failure: host-local, and it may leave this rank's
# state diverged mid-ops (older torch raises CUDA errors as RuntimeError)
_RANK_FAULTS = tuple(t for t in (getattr(torch, "AcceleratorError", None),
                                 torch.cuda.OutOfMemoryError,
                                 torch.distributed.DistError) if t is not None)


def _rank_local_fault(e: BaseException) -> bool:
    return isinstance(e, _RANK_FAULTS) or (isinstance(e, RuntimeError)
                                           and "CUDA" in str(e))


def run_follower(engine, tts_params: Optional[dict] = None) -> None:
    """Take part in every device step the primary decides; returns when the
    primary broadcasts stop.

    A bundle that raises a PYTHON-level engine error does so
    DETERMINISTICALLY on every rank (e.g. open_session on a full store
    raises before any state mutation), so the primary's caller sees the
    error while engine state stays identical everywhere: the follower logs
    and keeps serving. A device or collective failure (CUDA error,
    out-of-memory, a distributed backend error) is RANK-LOCAL and may leave
    this rank's state diverged mid-ops: continuing would silently compute
    on diverged KV, so it re-raises and the rank dies loudly (the operator
    restarts the deployment)."""
    while True:
        bundle = _broadcast(None)
        if bundle["op"] == "stop":
            return
        try:
            apply_bundle(engine, bundle, tts_params)
        except Exception as e:  # noqa: BLE001 — filtered below
            if _rank_local_fault(e):
                raise
            print(f"follower: bundle {bundle.get('op')!r} raised "
                  f"{type(e).__name__}: {e}", file=sys.stderr, flush=True)
