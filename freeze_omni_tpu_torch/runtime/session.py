"""Session store: batched per-user caches with slot allocation (counterpart of
freeze_omni_tpu/runtime/session.py).

One resident model serves every session; all sessions' caches live batched
along a leading session axis in ONE preallocated `SessionCaches`, and a slot
allocator maps session ids to rows. Where the JAX store rebuilds the pytree
functionally, this one writes rows in place.

Under a ('data', 'model') mesh (`shard`) a process holds only its data
index's session rows, and of the LLM KV only its model index's kv heads.
Slots stay global (every rank allocates the same slots in the same order);
a rank reads and writes the rows it holds (`owns`), and `lengths` gathers
the KV lengths of every row.

`row_leaves` / `row_from_leaves` flatten a `SessionCaches` row in the leaf
order of `jax.tree.leaves` (NamedTuple fields in declaration order, None
fields skipped), the order of a serving snapshot's files, so a snapshot
written by either package restores in the other.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from ..config import AudioLLMConfig
from ..models import adapter as adapter_mod
from ..models import audio_llm, qwen2
from ..models import encoder as encoder_mod
from ..parallel import collectives
from ..parallel.mesh import KV_CACHE_AXES, cut

_ENC_AXES = encoder_mod.EncoderState(k_cache=1, v_cache=1, valid=0,
                                     pe_index=0, ffn_cache=1)
_ADP_AXES = adapter_mod.AdapterState(c1=0, c2=0)
_KV_AXES = qwen2.KVCache(k=1, v=1, length=0, k_scale=1, v_scale=1)
BATCH_AXES = audio_llm.SessionCaches(enc_user=_ENC_AXES, adp_user=_ADP_AXES,
                                     enc_system=_ENC_AXES, adp_system=_ADP_AXES,
                                     kv=_KV_AXES)


def row_leaves(row) -> list:
    """The non-None leaves of a caches tree (NamedTuples of tensors or
    arrays), depth first in field order: `jax.tree.leaves`' order."""
    if isinstance(row, tuple):
        return [leaf for field in row for leaf in row_leaves(field)]
    return [] if row is None else [row]


def row_from_leaves(template, leaves):
    """The inverse of `row_leaves`: `template`'s structure (None fields stay
    None) filled from `leaves` in order. Raises when the counts differ."""
    leaves = list(leaves)
    if len(leaves) != len(row_leaves(template)):
        raise ValueError(f"{len(leaves)} leaves for a row of "
                         f"{len(row_leaves(template))}")
    it = iter(leaves)

    def rec(node):
        if isinstance(node, tuple):
            return type(node)(*[rec(f) for f in node])
        return None if node is None else next(it)

    return rec(template)


def own_heads(kv: qwen2.KVCache, mesh) -> qwen2.KVCache:
    """This model index's kv heads (and their scales) of a cache that holds
    every head (parallel/mesh.KV_CACHE_AXES)."""
    heads = KV_CACHE_AXES["model"]
    return kv._replace(**{
        name: cut(getattr(kv, name), heads, mesh.model_index, mesh.model)
        for name in ("k", "v", "k_scale", "v_scale")
        if getattr(kv, name) is not None})


def all_heads(kv: qwen2.KVCache, mesh) -> qwen2.KVCache:
    """Every kv head of a float cache whose heads the model group splits
    (a collective of that group): the inverse of own_heads."""
    heads = KV_CACHE_AXES["model"]
    return kv._replace(**{
        name: collectives.all_gather(getattr(kv, name), mesh.model_group,
                                     dim=heads) for name in ("k", "v")})


def map_rows(fn, axes, *trees):
    """Apply fn(batch_axis, *leaves) over matching leaves of NamedTuple trees
    (None leaves and None axes stay None) and rebuild the structure."""
    if isinstance(axes, tuple):
        return type(axes)(*[map_rows(fn, a, *[t[i] for t in trees])
                            for i, a in enumerate(axes)])
    if trees[0] is None or axes is None:
        return None
    return fn(axes, *trees)


class SessionStore:
    def __init__(self, cfg: AudioLLMConfig, max_sessions: int,
                 kv_dtype=torch.float32, kv_quant_bits: Optional[int] = None,
                 device=None):
        """All caches are preallocated on `device` (None: the CUDA card;
        raises without one)."""
        self.cfg = cfg
        self.max_sessions = max_sessions
        self.kv_quant_bits = kv_quant_bits
        self.caches = audio_llm.init_session(cfg, max_sessions, kv_dtype,
                                             kv_quant_bits, device)
        self._free: List[int] = list(range(max_sessions))
        self._slots: Dict[str, int] = {}
        # pinned role-prefill length per slot (the sliding-KV "sink" prefix)
        self.prefix_len = np.zeros((max_sessions,), np.int32)
        # the rows this process holds: global slots [row0, row0 + local_rows)
        self.mesh = None
        self.row0 = 0
        self.local_rows = max_sessions

    def shard(self, mesh) -> None:
        """Keep this process's part of the caches on a ('data', 'model')
        mesh (counterpart of the JAX SessionStore.shard): its data index's
        session rows of every leaf and, of the LLM KV, its model index's kv
        heads and their scales (parallel/mesh.KV_CACHE_AXES); kv.length
        keeps its rows, whole over 'model'. max_sessions must split over
        the data axis (the engine rounds it up)."""
        if self.max_sessions % mesh.data:
            raise ValueError(f"max_sessions {self.max_sessions} does not "
                             f"split over the data axis {mesh.data}")
        di, dn = mesh.data_index, mesh.data
        rows = map_rows(lambda ax, t: cut(t, ax, di, dn), BATCH_AXES,
                        self.caches)
        self.caches = rows._replace(kv=own_heads(rows.kv, mesh))
        self.mesh = mesh
        self.local_rows = self.max_sessions // dn
        self.row0 = di * self.local_rows

    def owns(self, slot: int) -> bool:
        """Whether this process holds `slot`'s row."""
        return self.row0 <= slot < self.row0 + self.local_rows

    def owner(self, slot: int) -> int:
        """The data index that holds `slot`'s row."""
        return slot // self.local_rows

    def _local(self, slots) -> torch.Tensor:
        """Local row indices of held slots, on the caches' device."""
        return torch.as_tensor([s - self.row0 for s in slots], dtype=torch.long,
                               device=self.caches.kv.k.device)

    def lengths(self) -> np.ndarray:
        """kv.length of every slot as host int32 [max_sessions]; under a
        mesh with several data indices a collective every rank joins."""
        own = self.caches.kv.length
        if self.mesh is not None:
            own = collectives.all_gather(own, self.mesh.data_group)
        return own.cpu().numpy().astype(np.int32)

    def alloc(self, sid: str, role_kv: Optional[qwen2.KVCache] = None,
              reset: bool = True) -> int:
        """Claim a slot (an open sid keeps its slot and its row), zero its row
        and optionally seed its LLM KV row from a batch-1 role prefill.
        reset=False skips the row writes for a caller that scatters a whole
        row next (an import)."""
        if sid in self._slots:
            return self._slots[sid]
        if not self._free:
            raise RuntimeError("no free session slots")
        slot = self._free.pop(0)
        self._slots[sid] = slot
        if reset:
            self.reset_slot(slot, role_kv)
        else:
            self.prefix_len[slot] = 0
        return slot

    def free(self, sid: str) -> None:
        slot = self._slots.pop(sid, None)
        if slot is not None:
            self._free.append(slot)

    def slot_of(self, sid: str) -> int:
        return self._slots[sid]

    def has(self, sid: str) -> bool:
        return sid in self._slots

    def has_free(self) -> bool:
        return bool(self._free)

    @property
    def active_sids(self):
        return list(self._slots)

    def reset_slot(self, slot: int, role_kv: Optional[qwen2.KVCache] = None) -> None:
        """Zero the slot's row in every cache; seed its KV from role_kv (a
        prefill at this process's kv heads). Only the holder writes the row;
        every process records the prefix length."""
        self.prefix_len[slot] = 0 if role_kv is None else int(role_kv.length[0])
        if not self.owns(slot):
            return
        r = slot - self.row0
        map_rows(lambda ax, t: t.narrow(ax, r, 1).zero_(), BATCH_AXES,
                 self.caches)
        if role_kv is not None:
            map_rows(lambda ax, full, row: full.narrow(ax, r, 1).copy_(row),
                     _KV_AXES, self.caches.kv, role_kv)

    @property
    def row_template_canonical(self) -> audio_llm.SessionCaches:
        """A zeroed batch-1 row with the KV in the float layout, no scales:
        the layout of an exported session, whatever the store's kv_quant
        (an import quantizes to this store's layout). Allocated on the
        host."""
        return audio_llm.init_session(self.cfg, 1,
                                      self.caches.enc_user.k_cache.dtype,
                                      None, "cpu")

    def kv_length(self, slot: int) -> int:
        if self.mesh is not None:
            return int(self.lengths()[slot])
        return int(self.caches.kv.length[slot])

    @property
    def kv_capacity(self) -> int:
        """Max KV slots per session (the S of the [L, B, S, ...] cache)."""
        return int(self.caches.kv.k.shape[2])

    def gather_slot(self, slot: int) -> audio_llm.SessionCaches:
        """A batch-1 copy of one held session's caches."""
        r = slot - self.row0
        return map_rows(lambda ax, t: t.narrow(ax, r, 1).clone(),
                        BATCH_AXES, self.caches)

    def scatter_slot(self, slot: int, row: audio_llm.SessionCaches) -> None:
        """Write a batch-1 caches tree back into a held slot, in place."""
        r = slot - self.row0
        map_rows(lambda ax, full, new: full.narrow(ax, r, 1).copy_(new),
                 BATCH_AXES, self.caches, row)

    def gather_kv(self, slot: int) -> qwen2.KVCache:
        """A batch-1 copy of one session's LLM KV row."""
        return self.gather_kv_many([slot])

    def scatter_kv(self, slot: int, kv: qwen2.KVCache) -> None:
        """Write a batch-1 KV row back into the slot, in place."""
        self.scatter_kv_many([slot], kv)

    def gather_kv_many(self, slots: List[int]) -> qwen2.KVCache:
        """A copy of several held sessions' LLM KV rows as one batch-B
        KVCache (batched response generation over the sessions that speak)."""
        kv = self.caches.kv
        idx = self._local(slots)
        return map_rows(lambda ax, t: t.index_select(ax, idx),
                        qwen2.cache_axes(kv), kv)

    def scatter_kv_many(self, slots: List[int], kv: qwen2.KVCache,
                        rows: Optional[List[int]] = None) -> None:
        """Write KV rows back into their slots, in place. `kv` may carry more
        rows than `slots` (bucket padding); by default row i lands in
        slots[i]. `rows` (parallel to `slots`) picks which rows land, so a
        caller can drop rows whose session closed mid-flight."""
        if not slots:
            return
        dev = self.caches.kv.k.device
        dst = self._local(slots)
        src = torch.as_tensor(list(rows if rows is not None else range(len(slots))),
                              dtype=torch.long, device=dev)
        map_rows(lambda ax, full, new: full.index_copy_(ax, dst,
                                                        new.index_select(ax, src)),
                 qwen2.cache_axes(self.caches.kv), self.caches.kv, kv)
