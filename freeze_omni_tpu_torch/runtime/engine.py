"""Continuous-batching serving engine for the duplex dialog-state tick
(counterpart of ServingEngine in freeze_omni_tpu/runtime/engine.py).

One resident model serves every session; per-session caches live batched in a
`SessionStore`. Each tick runs the pending 224 ms chunks of both identities
(user and system, with their own encoder/adapter weights) through ONE fused
LLM prefill (audio_llm.recognize_step_dual) when both have work; sessions
without a chunk pass through untouched. A session nearing KV capacity is
rolled (qwen2.roll_kv) before the tick, keeping its role prefix and recent
window.

The response path runs on the same session rows: `respond_fast_many`
batches every session that decided to speak (dialog_ss) through one
runtime/fastpath.first_response, from the assistant prefix to the first PCM,
and `continue_segments` advances every continuing response by one batched
text segment; both gather the sessions' KV rows, generate on the copy and
scatter the advanced rows back; `respond` speaks for one session through a
DuplexResponder on a copy of its row. Sampling draws from a generator the
shared pipeline._Core hands out per call (or one the caller passes).
`TTSPool` and `PipelinePool` keep the API of the reference's replica pools
(bin/pool.py) over shared weights and one engine.

`export_session` / `import_session` move a live session between engines
(its caches as host arrays, the KV in float layout), and `save_sessions` /
`restore_sessions` write and read every live session to a directory in the
JAX package's snapshot format (serving checkpoint and resume).

With a `mesh` (parallel/mesh.Mesh) the engine is one rank of a lockstep
group of processes: the LLM is tensor-parallel over the mesh's 'model' axis
(models/qwen2), the session rows shard over its 'data' axis
(SessionStore.shard), the rest is replicated. Every rank must make the same
engine calls in the same order (runtime/multihost_serving broadcasts them);
host-side state (slot maps, pending chunks, KV-length mirror, sampling
seeds) then evolves identically everywhere. Per-row results are gathered
over 'data' so that every rank returns the same values (the JAX engine's
replicate-then-fetch), and session blobs keep the single-card layout:
export gathers the kv heads, import keeps this rank's.

Left out of the port for now: buffer donation.
"""

from __future__ import annotations

import json
import os
import sys
import threading
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..config import SystemConfig
from ..models import audio_llm, qwen2
from ..parallel import collectives
from ..pipeline import _Core
from ..utils import logging as trace
from ..utils.device import resolve_device
from .session import (SessionStore, all_heads, own_heads, row_from_leaves,
                      row_leaves)

SNAPSHOT_VERSION = 1

IDENTITIES = ("user", "system")
_ROWS_ACTIVE = {i: f"engine.rows_active.{i}" for i in IDENTITIES}


class CapacityError(RuntimeError):
    """Device memory exhausted by session state; carries the active-session
    count so a server can refuse cleanly instead of crashing."""

    def __init__(self, msg: str, active_sessions: Optional[int] = None):
        super().__init__(msg)
        self.active_sessions = active_sessions


class PendingTick:
    """Handle for a dispatched but undelivered tick. `deliver()` waits for the
    user state predictions, fires per-session callbacks and returns
    {'user': {slot: {'state_1', 'state_2'}}}. Deliver at most once; a second
    call returns {}."""

    __slots__ = ("_engine", "_pending", "_probs")

    def __init__(self, engine: "ServingEngine", pending, probs):
        self._engine = engine
        self._pending = pending
        self._probs = probs

    def deliver(self) -> Dict[str, Dict[int, dict]]:
        on = trace.ON
        if on:
            trace.begin("engine.deliver")
        results: Dict[str, Dict[int, dict]] = {}
        pending, self._pending = self._pending, None
        probs, self._probs = self._probs, None
        if pending:
            self._engine._deliver_user(results, pending, probs)
        if on:
            trace.end()
        return results


class PendingSegments:
    """Handle for an enqueued but unfetched continue_segments batch. The
    generation and the KV scatter-back are already enqueued; deliver() waits
    for the tokens and hiddens, updates the KV-length mirror and builds
    {sid: (tokens, hiddens, done)}. Deliver at most once; a second call
    returns {}."""

    __slots__ = ("_engine", "_sids", "_rows", "_kept", "_arrays", "_ready")

    def __init__(self, engine, sids, rows, kept_slots, arrays, ready=None):
        self._engine = engine
        self._sids = sids
        self._rows = rows
        self._kept = kept_slots
        self._arrays = arrays
        self._ready = ready   # a sharded engine's results, fetched at submit

    def deliver(self) -> Dict[str, Tuple[list, np.ndarray, bool]]:
        ready, self._ready = self._ready, None
        if ready is not None:
            return ready
        arrays, self._arrays = self._arrays, None
        if arrays is None or not self._sids:
            return {}
        return self._engine._deliver_segments(self._sids, self._rows,
                                              self._kept, arrays)


class ServingEngine:
    def __init__(self, cfg: SystemConfig, params: Optional[dict] = None,
                 tokenizer=None, seed: int = 0, kv_dtype=torch.float32,
                 device=None, mesh=None):
        """params: a tree already on `device` (weights.from_jax, or
        audio_llm.init_params); None draws random float weights from `seed`.
        device=None means the CUDA card and raises without one. mesh: this
        process's parallel/mesh.Mesh; the full LLM tree is cut to this
        rank's shard here (after any LoRA merge or voice prompt, which work
        on the full tree), and every rank must pass the same weights."""
        self.cfg = cfg
        self.device = resolve_device(device)
        self.core = _Core(cfg, params, tokenizer, seed, kv_dtype, self.device)
        if kv_dtype == torch.bfloat16:
            # serving in half precision: the frontend follows
            self.core.params = audio_llm.cast_frontend(self.core.params, kv_dtype)
        self.mesh = mesh
        max_sessions = cfg.serving.max_sessions
        if mesh is not None:
            from ..parallel.mesh import shard_llm_params

            self.core.params = dict(self.core.params)   # the caller's tree stays
            self.core.params["llm"] = shard_llm_params(
                self.core.params["llm"], mesh, cfg.audio_llm.llm)
            # session rows shard over 'data': round the capacity up to a
            # multiple of it (the JAX engine's rule and message)
            dp = mesh.data
            if max_sessions % dp:
                rounded = -(-max_sessions // dp) * dp
                print(f"serving: max_sessions {max_sessions} -> {rounded} "
                      f"(rounded up to a multiple of the data axis {dp})",
                      file=sys.stderr)
                max_sessions = rounded
        self.store = SessionStore(cfg.audio_llm, max_sessions,
                                  kv_dtype, cfg.serving.kv_quant_bits,
                                  self.device)
        if mesh is not None:
            self.store.shard(mesh)
        # RLock: the callbacks fired inside a roll may re-enter the engine
        self._lock = threading.RLock()
        # pending chunk per (identity, slot): (fbank [1, T, 80], is_sl)
        self._pending: Dict[str, Dict[int, Tuple[np.ndarray, bool]]] = {
            i: {} for i in IDENTITIES}
        self._callbacks: Dict[int, Callable[[str, dict], None]] = {}
        self._role_kv_cache: Dict[str, qwen2.KVCache] = {}
        self._slot_role: Dict[int, str] = {}
        # host mirror of kv.length, advanced exactly at submit time so the
        # roll check needs no device read per tick
        self._len_host: Optional[np.ndarray] = None
        # worst-case KV growth of one identity's step: chat prefix + the
        # adapter tokens of one gating chunk, from the model's own arithmetic
        self._step_append_bound = int(max(
            self.core.user_prefix_embeds.shape[0],
            self.core.system_prefix_embeds.shape[0])) + \
            audio_llm.chunk_tokens(cfg.duplex.gating.frames_per_step)

    # ------------------------------------------------------------------
    # session management
    # ------------------------------------------------------------------

    def open_session(self, sid: str, role: Optional[str] = None,
                     on_prediction: Optional[Callable] = None) -> int:
        try:
            return self._open_session(sid, role, on_prediction)
        except torch.cuda.OutOfMemoryError as e:
            self.close_session(sid)
            raise CapacityError(
                f"device memory exhausted opening session {sid!r} "
                f"({self.num_active} active)",
                active_sessions=self.num_active) from e

    def _open_session(self, sid: str, role: Optional[str],
                      on_prediction: Optional[Callable]) -> int:
        role = role or self.cfg.duplex.default_prompt
        if role not in self._role_kv_cache:
            kv = self.core.role_kv(role)
            if self.store.kv_quant_bits is not None:
                # the pool rows are int8: quantize the float role prefill
                kv = qwen2.quantize_cache(kv, self.store.kv_quant_bits)
            self._role_kv_cache[role] = kv
        with self._lock:
            existing = self.store.has(sid)  # an open sid keeps its row
            slot = self.store.alloc(sid, self._role_kv_cache[role])
            if existing:
                # a reattach (a client reconnecting to a restored session)
                # keeps the role its row was prefilled with
                role = self._slot_role.get(slot, role)
            self._slot_role[slot] = role
            if on_prediction is not None:
                self._callbacks[slot] = on_prediction
            if self._len_host is not None:
                self._len_host[slot] = self.store.kv_length(slot) if existing \
                    else self.store.prefix_len[slot]
        return slot

    def export_session(self, sid: str) -> dict:
        """A live session as host numpy: its whole cache row (encoder window,
        adapter state, LLM KV, pe_index) with the KV in float layout (an
        int8 row is dequantized to f32) and bf16 leaves widened to f32,
        plus the metadata to resume it on another engine, whatever its KV
        layout. The rows are written in place, so the row is copied under
        the engine lock; in-flight response work is not captured."""
        with self._lock:
            slot = self.store.slot_of(sid)
            role = self._slot_role.get(slot)
            prefix_len = int(self.store.prefix_len[slot])
            row = self.store.gather_slot(slot) if self.store.owns(slot) else None
        leaves = None
        if row is not None:
            if self.store.kv_quant_bits is not None:
                row = row._replace(kv=qwen2.dequantize_cache(row.kv,
                                                             torch.float32))
            if self.mesh is not None:   # the canonical blob has every kv head
                row = row._replace(kv=all_heads(row.kv, self.mesh))
            leaves = [(t.float() if t.dtype == torch.bfloat16 else t).cpu().numpy()
                      for t in row_leaves(row)]
        if self.mesh is not None and self.mesh.data > 1:
            # the holder's model group hands the row to every data index
            src = self.mesh.rank_of(self.store.owner(slot), self.mesh.model_index)
            leaves = collectives.broadcast_object(leaves, src,
                                                  self.mesh.data_group)
        template = self.store.row_template_canonical
        return {"version": SNAPSHOT_VERSION, "sid": sid, "role": role,
                "prefix_len": prefix_len,
                "caches": row_from_leaves(template, leaves)}

    def _import_row(self, caches) -> audio_llm.SessionCaches:
        """An exported row (either package's, NamedTuples of arrays) in this
        store's layout on the device. A quantized store's KV is quantized
        from the exported f32 values with qwen2.quantize_cache, which
        gives a row exported from an int8 store its codes and scales back
        exactly (the JAX engine casts to its float dtype and quantizes
        afresh: at bf16 a code can move by one, and a scale by an ulp)."""
        template = self.store.row_template_canonical
        src = [np.asarray(x) for x in row_leaves(caches)]
        dtypes = [t.dtype for t in row_leaves(template)]
        if len(src) != len(dtypes):
            raise ValueError(f"a session row of {len(src)} leaves; this "
                             f"store's rows have {len(dtypes)}")
        bits = self.store.kv_quant_bits
        if bits is not None:   # the last leaves are kv.k, kv.v, kv.length
            dtypes[-3] = dtypes[-2] = torch.float32
        row = row_from_leaves(template, [
            # ml_dtypes bfloat16 (kind V, from a JAX export) widens losslessly
            torch.from_numpy(np.ascontiguousarray(
                x.astype(np.float32) if x.dtype.kind == "V" else x)
            ).to(self.device, dt) for x, dt in zip(src, dtypes)])
        if bits is not None:
            row = row._replace(kv=qwen2.quantize_cache(row.kv, bits))
        if self.mesh is not None:   # this rank's kv heads of the whole row
            row = row._replace(kv=own_heads(row.kv, self.mesh))
        return row

    def import_session(self, sid: str, blob: dict,
                       on_prediction: Optional[Callable] = None) -> int:
        """Resume an exported session (see export_session) in this engine."""
        if blob.get("version") != SNAPSHOT_VERSION:
            raise ValueError(f"unknown session blob version "
                             f"{blob.get('version')!r}")
        row = self._import_row(blob["caches"])
        with self._lock:
            slot = self.store.alloc(sid, reset=False)   # the scatter follows
            self._slot_role[slot] = blob.get("role") or \
                self.cfg.duplex.default_prompt
            if on_prediction is not None:
                self._callbacks[slot] = on_prediction
            if self.store.owns(slot):
                self.store.scatter_slot(slot, row)
            self.store.prefix_len[slot] = int(blob["prefix_len"])
            if self._len_host is not None:
                self._len_host[slot] = int(row.kv.length[0])
        return slot

    def save_sessions(self, dirpath: str) -> List[str]:
        """Snapshot every live session to `dirpath`: one .npz of cache leaves
        per session (`leaf_j` in jax.tree.leaves order) and a sessions.json
        index, the JAX engine's format. With restore_sessions a restarted
        server keeps every dialog's KV context. Nothing may write the rows
        meanwhile: stop the ticker first. Under a mesh every rank takes part
        in the exports and rank 0 writes the files."""
        write = self.mesh is None or self.mesh.rank == 0
        if write:
            os.makedirs(dirpath, exist_ok=True)
        with self._lock:
            sids = list(self.store.active_sids)
        index = {}
        for i, sid in enumerate(sids):
            try:
                blob = self.export_session(sid)
            except KeyError:   # closed since
                continue
            fn = f"session-{i:04d}.npz"
            if write:
                np.savez(os.path.join(dirpath, fn),
                         **{f"leaf_{j}": leaf for j, leaf in
                            enumerate(row_leaves(blob["caches"]))})
            index[sid] = {"file": fn, "role": blob["role"],
                          "prefix_len": blob["prefix_len"]}
        if write:
            with open(os.path.join(dirpath, "sessions.json"), "w") as f:
                json.dump({"version": SNAPSHOT_VERSION, "sessions": index}, f)
        return list(index)

    def restore_sessions(self, dirpath: str) -> List[str]:
        """Import every session that save_sessions (of either package) wrote
        to `dirpath`. A store too small for the snapshot restores what fits
        and says so instead of failing."""
        with open(os.path.join(dirpath, "sessions.json")) as f:
            index = json.load(f)
        if index.get("version") != SNAPSHOT_VERSION:
            raise ValueError(f"unknown snapshot version {index.get('version')!r}")
        template = self.store.row_template_canonical
        restored = []
        for sid, meta in index["sessions"].items():
            if not self.store.has_free() and not self.store.has(sid):
                print(f"restore_sessions: store full, skipping {sid!r} (and "
                      f"{len(index['sessions']) - len(restored) - 1} more)",
                      file=sys.stderr, flush=True)
                break
            with np.load(os.path.join(dirpath, meta["file"])) as z:
                leaves = [z[f"leaf_{j}"] for j in range(len(z.files))]
            self.import_session(sid, {
                "version": SNAPSHOT_VERSION, "sid": sid, "role": meta["role"],
                "prefix_len": meta["prefix_len"],
                "caches": row_from_leaves(template, leaves)})
            restored.append(sid)
        return restored

    def close_session(self, sid: str) -> None:
        """Idempotent: closing an unknown or closed sid is a no-op."""
        with self._lock:
            if not self.store.has(sid):
                return
            slot = self.store.slot_of(sid)
            self._callbacks.pop(slot, None)
            for i in IDENTITIES:
                self._pending[i].pop(slot, None)
            self.store.free(sid)

    @property
    def num_active(self) -> int:
        return len(self.store.active_sids)

    # ------------------------------------------------------------------
    # serving
    # ------------------------------------------------------------------

    def submit_chunk(self, sid: str, identity: str, fbank_chunk: np.ndarray,
                     is_sl: bool) -> None:
        """fbank_chunk: [1, T_f, 80]. One chunk per (session, identity, tick);
        a second submit before the tick overwrites."""
        chunk = np.asarray(fbank_chunk, np.float32)
        with self._lock:
            slot = self.store.slot_of(sid)
            pending = self._pending[identity]
            if trace.ON and slot in pending:
                trace.count("engine.submit_overwrites")
            if pending:
                prev = next(iter(pending.values()))[0]
                if prev.shape[1:] != chunk.shape[1:]:
                    raise ValueError(
                        f"mixed chunk shapes in one tick: pending {prev.shape} "
                        f"vs submitted {chunk.shape} for sid={sid!r} "
                        f"identity={identity!r}")
            pending[slot] = (chunk, bool(is_sl))

    def _gather_pending(self, identity: str):
        """Drain one identity's pending chunks into padded batch arrays."""
        with self._lock:
            pending = self._pending[identity]
            self._pending[identity] = {}
        if not pending:
            return None
        B = self.store.max_sessions
        first = next(iter(pending.values()))[0]
        chunks = np.zeros((B, first.shape[1], first.shape[2]), np.float32)
        active = np.zeros((B,), bool)
        is_sl = np.zeros((B,), bool)
        for slot, (c, sl) in pending.items():
            chunks[slot] = c[0]
            active[slot] = True
            is_sl[slot] = sl
        return pending, chunks, active, is_sl

    def _local(self, a: np.ndarray) -> np.ndarray:
        """The rows this process holds of a host [max_sessions, ...] array
        (all of them without a mesh)."""
        return a[self.store.row0: self.store.row0 + self.store.local_rows]

    def _dev(self, a: np.ndarray) -> torch.Tensor:
        """The rows this process holds of a host [max_sessions, ...] array,
        on the device."""
        return torch.from_numpy(np.ascontiguousarray(self._local(a))).to(self.device)

    def _devs(self, on: bool, *arrays: np.ndarray) -> List[torch.Tensor]:
        """A tick's host arrays on the device, copied back to back: the
        `engine.h2d` span (a copy from pageable memory waits for the
        stream, so the span holds that wait)."""
        if not on:
            return [self._dev(a) for a in arrays]
        trace.begin("engine.h2d")
        out = [self._dev(a) for a in arrays]
        trace.end()
        trace.count("engine.h2d_bytes", sum(self._local(a).nbytes for a in arrays))
        return out

    def _count_tokens(self, identity: str, active: np.ndarray, is_sl: np.ndarray,
                      prefix_tokens: int, chunk_toks: int) -> None:
        """Count one identity's active rows of a tick, its valid tokens (the
        mask qwen2.forward gets) and the tokens the forward computes for it
        (prefix and chunk of every row this process holds)."""
        act, sl = self._local(active), self._local(is_sl)
        rows = int(act.sum())
        trace.count(_ROWS_ACTIVE[identity], rows)
        trace.count("engine.tokens_valid",
                    rows * chunk_toks + prefix_tokens * int((act & sl).sum()))
        trace.count("engine.tokens_computed", act.shape[0] * (prefix_tokens + chunk_toks))

    def _all_rows(self, t: torch.Tensor) -> torch.Tensor:
        """A per-row result of the rows this process holds, gathered whole
        over the data axis (the JAX engine's _repl_out)."""
        if self.mesh is None or self.mesh.data == 1:
            return t
        return collectives.all_gather(t, self.mesh.data_group, dim=0)

    def tick(self) -> Dict[str, Dict[int, dict]]:
        """Run the pending work of both identities and deliver the user
        predictions: {'user': {slot: {'state_1', 'state_2'}}}."""
        return self.tick_submit().deliver()

    def tick_submit(self) -> PendingTick:
        """Enqueue the pending work of both identities (fused into one LLM
        pass when both have chunks) without waiting for the results. The
        KV-length mirror advances exactly here. With 'data' > 1 the
        probabilities are all-gathered here (through the host under gloo),
        so a sharded engine's pipelined tick overlaps little.

        With the tracer on (utils/logging) this is the span
        `engine.submit` > `engine.roll`, `engine.gather`, `engine.h2d`
        (the tick's host-to-device copies) and `engine.launch` (the host's
        enqueue of encoder, adapter, LLM and head), with the counters
        `engine.rows_active.<identity>`, `engine.tokens_valid`,
        `engine.tokens_computed`, `engine.h2d_bytes` and
        `engine.kv_rolled_rows`."""
        on = trace.ON
        if on:
            trace.begin("engine.submit")
        try:
            return self._tick_submit(on)
        except torch.cuda.OutOfMemoryError as e:
            raise CapacityError(
                f"device memory exhausted in the serving tick "
                f"({self.num_active} active sessions)",
                active_sessions=self.num_active) from e
        finally:
            if on:
                trace.end()

    def _tick_submit(self, on: bool) -> PendingTick:
        if on:
            trace.begin("engine.roll")
        self._maybe_roll_kv()
        if on:
            trace.end()
            trace.begin("engine.gather")
        user = self._gather_pending("user")
        system = self._gather_pending("system")
        if on:
            trace.end()
        acfg = self.cfg.audio_llm
        params = self.core.params
        p_user = int(self.core.user_prefix_embeds.shape[0])
        p_system = int(self.core.system_prefix_embeds.shape[0])

        if user is not None and system is not None and \
                user[1].shape == system[1].shape:
            u_toks = audio_llm.chunk_tokens(user[1].shape[1])
            s_toks = audio_llm.chunk_tokens(system[1].shape[1])
            if on:
                self._count_tokens("user", user[2], user[3], p_user, u_toks)
                self._count_tokens("system", system[2], system[3], p_system, s_toks)
            dev = self._devs(on, user[1], user[3], user[2],
                             system[1], system[3], system[2])
            if on:
                trace.begin("engine.launch")
            with self._lock, torch.no_grad():
                probs, _ = audio_llm.recognize_step_dual(
                    params, acfg, *dev, self.core.user_prefix_embeds,
                    self.core.system_prefix_embeds, self.store.caches)
                probs = self._all_rows(probs)
            if on:
                trace.end()
            self._advance_mirror(user[2], user[3], p_user, u_toks)
            self._advance_mirror(system[2], system[3], p_system, s_toks)
            return PendingTick(self, user[0], probs)

        user_pending, user_probs = None, None
        for identity, batch in (("user", user), ("system", system)):
            if batch is None:
                continue
            pending, chunks, active, is_sl = batch
            prefix = (self.core.user_prefix_embeds if identity == "user"
                      else self.core.system_prefix_embeds)
            p_tokens = p_user if identity == "user" else p_system
            toks = audio_llm.chunk_tokens(chunks.shape[1])
            if on:
                self._count_tokens(identity, active, is_sl, p_tokens, toks)
            d_chunks, d_sl, d_active = self._devs(on, chunks, is_sl, active)
            if on:
                trace.begin("engine.launch")
            with self._lock, torch.no_grad():
                probs, _ = audio_llm.recognize_step(
                    params, acfg, identity, d_chunks, d_sl,
                    prefix, self.store.caches, active=d_active)
                probs = self._all_rows(probs)
            if on:
                trace.end()
            self._advance_mirror(active, is_sl, p_tokens, toks)
            if identity == "user":
                user_pending, user_probs = pending, probs
        return PendingTick(self, user_pending, user_probs)

    def _advance_mirror(self, active, is_sl, prefix_tokens: int,
                        chunk_toks: int) -> None:
        """Advance the host KV-length mirror by the exact appendage of one
        step: active rows gain the chunk's tokens plus the chat prefix when
        the chunk starts an IPU (qwen2.forward's n_new)."""
        with self._lock:
            if self._len_host is None:
                return
            add = np.where(active, chunk_toks + prefix_tokens * np.asarray(is_sl, int), 0)
            self._len_host = np.minimum(self._len_host + add,
                                        self.store.kv_capacity).astype(np.int32)

    def _deliver_user(self, results, pending, probs):
        probs = probs.cpu().numpy()
        out = {}
        for slot in pending:
            pred = {"state_1": float(probs[slot, 1]),
                    "state_2": float(probs[slot, 2])}
            out[slot] = pred
            cb = self._callbacks.get(slot)
            if cb is not None:
                cb("user", pred)
        results["user"] = out

    def _maybe_roll_kv(self) -> None:
        """Sliding-window KV (qwen2.roll_kv): sessions within kv_margin of
        capacity keep their pinned role prefix plus the most recent window.
        The margin is floored at the worst single-tick appendage (both
        identities' prefix + chunk) and at 64: beyond it, forward's
        length + n_new <= S-1 invariant would break."""
        margin = max(self.cfg.serving.kv_margin, 2 * self._step_append_bound, 64)
        cap = self.store.kv_capacity
        with self._lock:
            if self._len_host is None:  # first use: one authoritative read
                self._len_host = self.store.lengths()
            lengths = self._len_host.copy()
        need = lengths > cap - margin
        if not need.any():
            return
        if trace.ON:
            trace.count("engine.kv_rolled_rows", int(need.sum()))
        # post-roll length targets half the usable window
        target = (cap - margin) // 2
        keep = np.minimum(np.maximum(target - self.store.prefix_len, 16),
                          self.cfg.serving.kv_keep_recent).astype(np.int32)
        with self._lock, torch.no_grad():
            qwen2.roll_kv(self.cfg.audio_llm.llm, self.store.caches.kv,
                          self._dev(self.store.prefix_len.astype(np.int64)),
                          self._dev(keep.astype(np.int64)), self._dev(need))
        rolled = self.store.prefix_len + np.minimum(
            keep, lengths - self.store.prefix_len)
        with self._lock:
            self._len_host = np.where(need, rolled, lengths).astype(np.int32)
        for slot in np.nonzero(need)[0]:
            cb = self._callbacks.get(int(slot))
            if cb is not None:
                cb("kv_roll", {"kept_recent": int(keep[slot]),
                               "prefix": int(self.store.prefix_len[slot])})

    # ------------------------------------------------------------------
    # response generation (on the shared batched session caches)
    # ------------------------------------------------------------------

    def embed_tokens(self, ids) -> np.ndarray:
        """Token ids -> LLM embeddings as host f32 numpy (the sentence
        re-embed stage of the synthesis path)."""
        emb = qwen2.embed_tokens(self.core.params["llm"],
                                 self.core._ids(np.asarray(ids, np.int64)))
        return emb.float().cpu().numpy()

    def _resolve_slots(self, sids: List[str]):
        """Resolve sids -> slots atomically, dropping sessions that closed
        (another thread may close or recycle them)."""
        with self._lock:
            return [(sid, self.store.slot_of(sid)) for sid in sids
                    if self.store.has(sid)]

    def _still_current(self, pairs):
        """Rows of a batched result whose (sid, slot) mapping survived the
        generation; only those KV rows are scattered back."""
        with self._lock:
            keep = [(i, slot) for i, (sid, slot) in enumerate(pairs)
                    if self.store.has(sid) and self.store.slot_of(sid) == slot]
        return [i for i, _ in keep], [s for _, s in keep]

    def _gather_bucket(self, slots: List[int]) -> qwen2.KVCache:
        """KV rows of `slots`, padded to the next power of two with copies of
        the first row (the padded rows are discarded)."""
        n = len(slots)
        B = 1 << (n - 1).bit_length()
        with self._lock:
            return self.store.gather_kv_many(slots + [slots[0]] * (B - n))

    def _held(self, pairs):
        """The (sid, slot) pairs whose rows this process holds."""
        return [(sid, slot) for sid, slot in pairs if self.store.owns(slot)]

    def _all_results(self, mine: dict) -> dict:
        """{sid: result} of the rows this process holds, merged over the
        data axis (each data index answers for its own rows)."""
        if self.mesh is None or self.mesh.data == 1:
            return mine
        merged = {}
        for part in collectives.all_gather_object(mine, self.mesh.data_group):
            merged.update(part)
        return merged

    def respond(self, sid: str, responder) -> list:
        """Speak for one session on its slot's KV context: gather a copy of
        the row, run the DuplexResponder on it (text segments + StreamingTTS)
        and scatter back the KV its commit rule left, the context up to the
        last sentence it yielded. Returns [(sentence_text, pcm16 | None)].
        One process's responder: a sharded engine speaks through
        respond_fast_many and continue_segments."""
        if self.mesh is not None:
            raise NotImplementedError(
                "respond() runs one process's DuplexResponder; a sharded "
                "engine speaks through respond_fast_many and continue_segments")
        self._maybe_roll_kv()  # headroom before appending a response
        with self._lock:
            slot = self.store.slot_of(sid)
            kv = self.store.gather_kv(slot)
        out = [(text, pcm16) for text, pcm16, _ in responder.respond(kv)]
        with self._lock:
            self.store.scatter_kv(slot, kv)
            self._len_host = None  # growth unknown: refetched at the next check
        return out

    def respond_fast(self, sid: str, tts_params: dict, n_text: int = 8,
                     gen: Optional[torch.Generator] = None):
        """First response of one session: (pcm24k [1, 1, n], text token ids)."""
        return self.respond_fast_many([sid], tts_params, n_text=n_text,
                                      gen=gen)[sid]

    def respond_fast_many(self, sids: List[str], tts_params: dict,
                          n_text: int = 8,
                          gen: Optional[torch.Generator] = None
                          ) -> Dict[str, tuple]:
        """Batched first responses: every session that decided to speak this
        tick rides ONE runtime/fastpath.first_response, from its KV context
        to the first PCM, with one host sync. The batch is padded to a power
        of two with copies of the first session's row; padded rows and rows
        whose session closed meanwhile are not written back. Returns
        {sid: (pcm24k [1, 1, n], text_token_ids list)}. Under a mesh each
        data index answers for the rows it holds, with the one generator
        every rank draws."""
        if not sids:
            return {}
        self._maybe_roll_kv()  # headroom before appending a response
        pairs = self._resolve_slots(sids)
        if not pairs:
            return {}
        gen = gen if gen is not None else self.core.next_key()
        mine = self._held(pairs)
        res = self._all_results(
            self._first_responses(mine, tts_params, n_text, gen) if mine else {})
        with self._lock:
            if self._len_host is not None:
                for sid, slot in pairs:
                    if res[sid][3]:   # its row was written back
                        self._len_host[slot] = res[sid][2]
        return {sid: res[sid][:2] for sid, _ in pairs}

    def _first_responses(self, pairs, tts_params, n_text: int, gen) -> dict:
        """{sid: (pcm24k [1, 1, n], text ids, kv length, written back)} of
        the fast path over `pairs` (rows this process holds)."""
        from . import fastpath

        sids = [sid for sid, _ in pairs]
        kv = self._gather_bucket([slot for _, slot in pairs])
        B = int(kv.length.shape[0])
        cfg = self.cfg
        gt = torch.as_tensor(np.array(cfg.tts.codec.global_tokens, np.int64),
                             device=self.device)[None, None].expand(B, 1, -1)
        ids = self.core._ids(self.core.chat.system_prefix_ids)[None].expand(B, -1)
        padding = cfg.tts.codec_padding_size
        n_codec = cfg.tts.codec_chunk_size + padding
        with torch.no_grad():
            pcm, toks, _, _, n_valid, kv = fastpath.first_response(
                self.core.params, tts_params, cfg.audio_llm, cfg.tts.decoder,
                cfg.tts.codec, ids, kv, gen, cfg.sampling,
                n_text=n_text, n_codec=n_codec, top_k=cfg.tts.top_k,
                eod_id=self.core.tokenizer.eod_id, global_tokens=gt,
                penalty_window=cfg.tts.penalty_window_size,
                penalty=cfg.tts.penalty)
        with self._lock:
            rows, kept_slots = self._still_current(pairs)
            self.store.scatter_kv_many(kept_slots, kv, rows=rows)
        pcm_np, toks_np = pcm.float().cpu().numpy(), toks.cpu().numpy()
        nv, len_np = n_valid.cpu().numpy(), kv.length.cpu().numpy()
        up = cfg.tts.codec.upsample_rate
        out = {}
        for i, sid in enumerate(sids):
            # the reference's emission (llm2tts.py:140-160): an eos inside the
            # block makes this the final chunk, so every valid token's samples
            # go out; otherwise the right look-ahead padding is trimmed
            nvi = int(nv[i])
            emit_tokens = nvi if nvi < n_codec else n_codec - padding
            out[sid] = (pcm_np[i:i + 1, :, : emit_tokens * up],
                        [int(t) for t in toks_np[i]], int(len_np[i]),
                        i in rows)
        return out

    def continue_segments(self, last_tokens: Dict[str, int], n_steps: int = 16,
                          gen: Optional[torch.Generator] = None
                          ) -> Dict[str, Tuple[list, np.ndarray, bool]]:
        """Advance every continuing response by one batched text segment:
        {sid: last_generated_token} -> {sid: (new_tokens, hiddens [n, D] f32,
        done)}. Each session's KV row advances; `done` means the segment hit
        eod (tokens after it repeat eod and are not written to the cache)."""
        return self.continue_segments_submit(last_tokens, n_steps, gen).deliver()

    def continue_segments_submit(self, last_tokens: Dict[str, int],
                                 n_steps: int = 16,
                                 gen: Optional[torch.Generator] = None
                                 ) -> PendingSegments:
        """Enqueue the batched text continuation (padded to a power of two
        like respond_fast_many) and the KV scatter-back without fetching the
        results; the handle's deliver() waits for them. A sharded engine
        fetches and gathers the results here, and advances its KV-length
        mirror here, so that a rank which never delivers (a lockstep
        follower) keeps the same mirror as the one that does; so under a
        mesh nothing overlaps the continuation."""
        if not last_tokens:
            return PendingSegments(self, [], [], [], None)
        self._maybe_roll_kv()
        pairs = self._resolve_slots(list(last_tokens))
        if not pairs:
            return PendingSegments(self, [], [], [], None)
        gen = gen if gen is not None else self.core.next_key()
        if self.mesh is None:
            sids, rows, kept_slots, arrays = self._segments(pairs, last_tokens,
                                                            n_steps, gen)
            return PendingSegments(self, sids, rows, kept_slots, arrays)
        mine = self._held(pairs)
        got = {}
        if mine:
            sids, rows, kept_slots, arrays = self._segments(mine, last_tokens,
                                                            n_steps, gen)
            toks, hiddens, done, length = [a.cpu() for a in arrays]
            segs = self._segments_out(sids, toks.numpy(),
                                      hiddens.float().numpy(), done.numpy())
            got = {sid: (segs[sid], int(length[i]), i in rows)
                   for i, sid in enumerate(sids)}
        got = self._all_results(got)
        with self._lock:
            if self._len_host is not None:
                for sid, slot in pairs:
                    if got[sid][2]:
                        self._len_host[slot] = got[sid][1]
        return PendingSegments(self, [], [], [], None,
                               ready={sid: got[sid][0] for sid, _ in pairs})

    def _segments(self, pairs, last_tokens, n_steps: int, gen):
        """generate_segment over `pairs` (rows this process holds), the
        advanced rows scattered back: (sids, rows kept, their slots,
        (tokens, hiddens, done, kv length) on the device)."""
        sids = [sid for sid, _ in pairs]
        kv = self._gather_bucket([slot for _, slot in pairs])
        B = int(kv.length.shape[0])
        tok0 = torch.as_tensor([last_tokens[s] for s in sids]
                               + [last_tokens[sids[0]]] * (B - len(sids)),
                               dtype=torch.int32, device=self.device)
        with torch.no_grad():
            toks, hiddens, done, kv = audio_llm.generate_segment(
                self.core.params, self.cfg.audio_llm, tok0, kv, gen,
                self.cfg.sampling, n_steps=n_steps,
                eod_id=self.core.tokenizer.eod_id)
        with self._lock:
            rows, kept_slots = self._still_current(pairs)
            self.store.scatter_kv_many(kept_slots, kv, rows=rows)
        return sids, rows, kept_slots, (toks, hiddens, done, kv.length)

    def _deliver_segments(self, sids, rows, kept_slots, arrays):
        toks, hiddens, done, length = arrays
        toks_np, done_np = toks.cpu().numpy(), done.cpu().numpy()
        hid_np = hiddens.float().cpu().numpy()
        len_np = length.cpu().numpy()
        with self._lock:
            if self._len_host is not None:
                for i, slot in zip(rows, kept_slots):
                    self._len_host[slot] = len_np[i]
        return self._segments_out(sids, toks_np, hid_np, done_np)

    def _segments_out(self, sids, toks_np, hid_np, done_np) -> dict:
        """{sid: (tokens up to and with eod, their hiddens, done)}."""
        eod = self.core.tokenizer.eod_id
        out = {}
        for i, sid in enumerate(sids):
            seg = [int(t) for t in toks_np[i]]
            if bool(done_np[i]) and eod in seg:
                seg = seg[: seg.index(eod) + 1]
            out[sid] = (seg, hid_np[i, : len(seg)], bool(done_np[i]))
        return out


class TTSPool:
    """API of the reference's TTSObjectPool (bin/pool.py:22-53: acquire the
    first free object, an in_use flag) over shared TTS parameters: a pooled
    object holds a StreamingTTS with its own sampling stream, not a model
    copy."""

    class _Handle:
        def __init__(self, tts):
            self.in_use = False
            self.tts_proc = tts

    def __init__(self, size: int, params: dict, cfg, seed: int = 0, device=None):
        from ..tts import StreamingTTS

        self.pool = [self._Handle(StreamingTTS(params, cfg, seed=seed + i,
                                               device=device))
                     for i in range(size)]

    def acquire(self):
        for obj in self.pool:
            if not obj.in_use:
                obj.in_use = True
                return obj
        raise RuntimeError("No available objects in the pool")

    def release(self, obj) -> None:
        obj.in_use = False

    def print_info(self) -> None:
        for i, o in enumerate(self.pool):
            print(f"TTS Object {i} is in use: {o.in_use}")


class PipelinePool:
    """API of the reference's pipelineObjectPool (acquire the handle with the
    fewest users, release decrements) over ONE ServingEngine: the pool's
    semantics without its model copies."""

    class _Handle:
        def __init__(self, engine: ServingEngine, idx: int):
            self.pipeline_proc = engine
            self.user_count = 0
            self.id = f"serving-engine-{idx}"

    def __init__(self, size: int, cfg: SystemConfig, params=None, **kw):
        engine = ServingEngine(cfg, params, **kw)
        self.pool = [self._Handle(engine, i) for i in range(size)]

    def acquire(self):
        h = min(self.pool, key=lambda o: o.user_count)
        h.user_count += 1
        return h

    def release(self, obj) -> None:
        if obj.user_count > 0:
            obj.user_count -= 1

    def print_info(self) -> None:
        for i, o in enumerate(self.pool):
            print(f"Pipeline Object {i} user count: {o.user_count}")
