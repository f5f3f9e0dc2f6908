"""Attention kernels of the serving paths (counterpart of
freeze_omni_tpu/ops/attention.py).

K2, int8-KV chunk-prefill attention (prefill_quant_pallas and its dispatcher
prefill_quant): the serving tick's LLM pass is a chunk prefill of T queries
per session against the session's int8 cache. Query t of row b sees slots
[0, qend[b, t]); qend = 0 marks an invalid query. The per-token, per-kv-head
scales factor out of the dots: k_scale multiplies the scores and v_scale
folds into the softmax weights. `prefill_quant` launches
csrc/prefill_quant.cu: bf16 q takes its tensor-core kernel, which gives
each block the valid query rows of one (row, kv head) and splits the visible
slots over `prefill_plan(...).splits` blocks (a second pass merges them);
f32 q takes its SIMT kernel.

K3 and K4, decode attention over a float cache (decode_attention,
decode_attention_blocked and the dispatcher gqa_decode): one query token per
row, q [B, H, dk] against k/v [B, S, Hkv, dk]; row b sees slots
[0, length[b]) with GQA. Both launch csrc/decode_attention.cu: K4 gives
each (row, kv head) `decode_plan(...).splits` blocks, which cut the row's
visible slots among themselves on the card (flash-decoding; a second pass
merges the splits), K3 the same kernel with one block a (row, kv head).
`gqa_decode`, which the T = 1 float-cache branch of models/qwen2.forward
calls (the text decode of a float-KV LLM and every codec-token step of the
speech decoder), launches K4.

Each wrapper launches its hand-written Hopper kernel for CUDA tensors and
runs the plain PyTorch version of the same f32 arithmetic
(`prefill_quant_reference`, `decode_attention_reference`) for CPU tensors
only. A CUDA tensor the kernel does not take raises. Masked slots are
removed by selection, so whatever a masked slot holds (NaN included) cannot
reach the result, and masked rows (qend = 0, length = 0) come out as zeros
(the JAX versions leave them unspecified or give the uniform average over
all slots; every caller discards them). `<wrapper>.launches` counts kernel
launches.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch

from . import _build

NEG_INF = -1e9
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (64, 128)


def prefill_quant_reference(q, k_q, k_scale, v_q, v_scale, qend):
    """q: [B,T,H,dk]; k_q/v_q: [B,S,Hkv,dk] int8; k_scale/v_scale: [B,S,Hkv]
    f32; qend: [B,T] int. Returns [B,T,H,dk] in q.dtype. Masked slots are
    removed by selection, so a non-finite scale in a masked slot (the scratch
    slot S-1) cannot reach the result."""
    B, T, H, dk = q.shape
    S, Hkv = k_q.shape[1], k_q.shape[2]
    rep = H // Hkv
    qg = q.float().reshape(B, T, Hkv, rep, dk)
    ks = k_scale.float().permute(0, 2, 1)[:, :, None, None, :]  # [B,Hkv,1,1,S]
    vs = v_scale.float().permute(0, 2, 1)[:, :, None, None, :]
    scores = torch.einsum("bthrd,bshd->bhrts", qg, k_q.float())
    scores = scores * ks * (1.0 / math.sqrt(dk))
    slot = torch.arange(S, device=q.device)
    mask = (slot[None, None, :] < qend[:, :, None])[:, None, None]  # [B,1,1,T,S]
    scores = torch.where(mask, scores, torch.full_like(scores, NEG_INF))
    p = torch.softmax(scores, dim=-1)
    pv = torch.where(mask, p * vs, torch.zeros_like(p))
    out = torch.einsum("bhrts,bshd->bthrd", pv, v_q.float())
    return out.reshape(B, T, H, dk).to(q.dtype)


def _lib():
    fn = _build.load("prefill_quant").prefill_quant_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 8 + \
            [ctypes.c_int] * 9 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


# K2's bf16 kernel (csrc/prefill_quant.cu): tiles of PREFILL_TILE cache
# slots; blocks of 1, 2 or 4 warps, 16 compacted query rows a warp; at most
# PREFILL_MAX_SPLITS blocks a (b, kv head)
PREFILL_TILE = 64
PREFILL_MAX_SPLITS = 32
_SMS = 132
# the split partials of one call, at most: a partial of its rows of dk =
# 128 (and m, l) for each of at most 2 x 132 blocks of 64 rows or 4 x 132
# of 32, 8.8 MB
PREFILL_WORKSPACE_BYTES = 2 * _SMS * 64 * (128 + 2) * 4


class PrefillPlan(NamedTuple):
    rows: int              # compacted query rows a row tile: 16, 32 or 64
    splits: int            # blocks a (b, kv head)
    tile_splits: int       # the most splits a row tile takes (1: no merge)
    workspace_floats: int  # the split partials (0 for tile_splits 1)


@functools.lru_cache(maxsize=None)
def prefill_plan(B: int, T: int, H: int, Hkv: int, dk: int, S: int) -> PrefillPlan:
    """Launch plan of K2's bf16 kernel, from the shapes alone (qend stays on
    the card). A row tile holds up to `rows` of the valid query rows of one
    (row b, kv head): 16, 32 or 64 as T * rep needs. Each (b, kv head) gets
    `splits` blocks, one wave of the H100's 132 SMs: two blocks an SM of
    4 warps (222 registers a thread), four of 1 or 2 warps (the 56.8 KB
    ring), within S's 64-slot tiles and PREFILL_MAX_SPLITS. The kernel
    deals the (row tile, split) units out over them once it knows the valid
    rows, each row tile taking min(tile_splits, splits // tiles): a tick's
    or a text step's one row tile takes every split. tile_splits is 1 where
    the T * rep rows, all valid, fill at least half the blocks with row
    tiles (the role prefill: ten row tiles over 8 blocks), so that shape
    never launches the merge nor reserves the workspace; else it is
    `splits`. The workspace holds a partial of `rows` rows for each block,
    within PREFILL_WORKSPACE_BYTES."""
    rep = H // Hkv
    M = T * rep
    rows = 16 if M <= 16 else 32 if M <= 32 else 64
    bh = B * Hkv
    resident = 2 if rows == 64 else 4   # blocks an SM: registers, or the ring
    splits = max(1, min(PREFILL_MAX_SPLITS, -(-S // PREFILL_TILE),
                        resident * _SMS // bh))
    tile_splits = 1 if splits // -(-M // rows) <= 1 else splits
    return PrefillPlan(rows, splits, tile_splits,
                       bh * splits * rows * (dk + 2) if tile_splits > 1 else 0)


def _check_cuda_args(q, k_q, k_scale, v_q, v_scale, qend) -> None:
    dev = q.device
    for name, t in (("k_q", k_q), ("k_scale", k_scale), ("v_q", v_q),
                    ("v_scale", v_scale), ("qend", qend)):
        if t.device != dev:
            raise ValueError(f"prefill_quant: {name} on {t.device}, q on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"prefill_quant: {name} must be contiguous")
    if not q.is_contiguous():
        raise ValueError("prefill_quant: q must be contiguous")
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"prefill_quant: q dtype {q.dtype} not in "
                        f"{list(_DTYPE_CODE)}")
    if k_q.dtype != torch.int8 or v_q.dtype != torch.int8:
        raise TypeError("prefill_quant: k_q and v_q must be int8")
    if k_scale.dtype != torch.float32 or v_scale.dtype != torch.float32:
        raise TypeError("prefill_quant: scales must be float32")
    if qend.dtype != torch.int32:
        raise TypeError(f"prefill_quant: qend must be int32, got {qend.dtype}")
    if q.dim() != 4 or k_q.dim() != 4:
        raise ValueError("prefill_quant: want q [B,T,H,dk] and k_q [B,S,Hkv,dk]")
    B, T, H, dk = q.shape
    S, Hkv = k_q.shape[1], k_q.shape[2]
    if (k_q.shape != (B, S, Hkv, dk) or v_q.shape != k_q.shape
            or k_scale.shape != (B, S, Hkv) or v_scale.shape != (B, S, Hkv)
            or qend.shape != (B, T)):
        raise ValueError(
            f"prefill_quant: inconsistent shapes q {tuple(q.shape)}, k_q "
            f"{tuple(k_q.shape)}, v_q {tuple(v_q.shape)}, k_scale "
            f"{tuple(k_scale.shape)}, v_scale {tuple(v_scale.shape)}, qend "
            f"{tuple(qend.shape)}")
    if dk not in _HEAD_DIMS or H % Hkv:
        raise ValueError(f"prefill_quant: head_dim {dk} not in {_HEAD_DIMS} "
                         f"or H={H} not a multiple of Hkv={Hkv}")
    align = 16 if q.dtype == torch.bfloat16 else 4
    for name, t in (("q", q), ("k_q", k_q), ("v_q", v_q)):
        if t.data_ptr() % align:
            raise ValueError(f"prefill_quant: {name} must be {align}-byte aligned")


def prefill_quant(q, k_q, k_scale, v_q, v_scale, qend):
    """Same contract as prefill_quant_reference."""
    if q.device.type == "cpu":
        return prefill_quant_reference(q, k_q, k_scale, v_q, v_scale, qend)
    if q.device.type != "cuda":
        raise ValueError(f"prefill_quant: unsupported device {q.device}")
    _check_cuda_args(q, k_q, k_scale, v_q, v_scale, qend)
    B, T, H, dk = q.shape
    S, Hkv = k_q.shape[1], k_q.shape[2]
    out = torch.empty_like(q)
    if B == 0 or T == 0:
        return out
    fn = _lib()
    warps, splits, tile_splits, ws = 0, 1, 1, None
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        if q.dtype == torch.bfloat16:
            plan = prefill_plan(B, T, H, Hkv, dk, S)
            warps, splits, tile_splits = plan.rows // 16, plan.splits, plan.tile_splits
            if tile_splits > 1:
                ws = _build.workspace(q.get_device(), stream,
                                      plan.workspace_floats)
        err = fn(_DTYPE_CODE[q.dtype], q.data_ptr(), k_q.data_ptr(),
                 k_scale.data_ptr(), v_q.data_ptr(), v_scale.data_ptr(),
                 qend.data_ptr(), out.data_ptr(), ws, B, T, H, Hkv, S, dk,
                 warps, splits, tile_splits, stream)
    _build.check(err, "prefill_quant")
    prefill_quant.launches += 1
    return out


prefill_quant.launches = 0


# ---------------------------------------------------------------------------
# K3 / K4: decode attention over a float cache
# ---------------------------------------------------------------------------

_MAX_REP_DK = 1024   # rep * dk a kernel block holds (32 accumulators a lane)
_MAX_REP = 16        # query heads a kv head the decode kernel holds
_DECODE_HEAD_DIMS = (32, 64, 128)


def decode_attention_reference(q, k_cache, v_cache, length):
    """q: [B, H, dk]; k/v: [B, S, Hkv, dk]; length: [B] (#visible slots).
    Returns [B, H, dk] in q.dtype, computed in f32. Masked slots are removed
    by selection (scores and values), so a non-finite value there cannot
    reach the result; a row with length 0 comes out as zeros."""
    B, H, dk = q.shape
    S, Hkv = k_cache.shape[1], k_cache.shape[2]
    rep = H // Hkv
    visible = torch.arange(S, device=q.device)[None, :] < length.long()[:, None]
    qg = q.float().reshape(B, Hkv, rep, dk)
    scores = torch.einsum("bhrd,bshd->bhrs", qg, k_cache.float()) / math.sqrt(dk)
    vis = visible[:, None, None, :]                                  # [B,1,1,S]
    scores = torch.where(vis, scores, torch.full_like(scores, NEG_INF))
    p = torch.where(vis, torch.softmax(scores, dim=-1), torch.zeros_like(scores))
    v = torch.where(visible[:, :, None, None], v_cache.float(),
                    torch.zeros((), dtype=torch.float32, device=q.device))
    out = torch.einsum("bhrs,bshd->bhrd", p, v)
    return out.reshape(B, H, dk).to(q.dtype)


# K3/K4's kernel (csrc/decode_attention.cu): blocks of 4 warps, each warp
# taking 8 slots of every DECODE_TILE-slot tile through its own ring of
# copies; at most DECODE_MAX_SPLITS blocks a (row, kv head), a merge lane each
DECODE_TILE = 32
DECODE_MAX_SPLITS = 32


class DecodePlan(NamedTuple):
    tile: int              # slots of the unit the kernel cuts rows into
    splits: int            # blocks a (row, kv head); 1: no merge pass
    workspace_floats: int  # the split partials (0 for one split)


@functools.lru_cache(maxsize=None)
def decode_plan(B: int, H: int, Hkv: int, dk: int, S: int) -> DecodePlan:
    """Launch plan of K4 from the shapes alone (length stays on the card):
    `splits` blocks a (row, kv head), as many as put about one block on
    each of the H100's 132 SMs (B * Hkv * splits nearest 132), within S's
    DECODE_TILE-slot tiles and DECODE_MAX_SPLITS. One block an SM streams
    its share at about the card's rate, since each warp keeps its own ring
    of copies in flight; more splits only add partials and a merge pass,
    which costs more than they gain (bin/k4_profile.py). The kernel cuts
    each row's visible slots into min(splits, visible tiles) runs of whole
    tiles on the card; blocks past them exit at once. With one split (the
    speech decoder's B = 8 rows of 14 kv heads) there is no merge and no
    workspace; otherwise the workspace holds each block's partial: rep rows
    of dk accumulators, a max and a sum."""
    bh = B * Hkv
    splits = max(1, min(DECODE_MAX_SPLITS, -(-S // DECODE_TILE),
                        (_SMS + bh // 2) // bh))
    return DecodePlan(DECODE_TILE, splits,
                      B * H * splits * (dk + 2) if splits > 1 else 0)


def _decode_lib():
    fn = _build.load("decode_attention").decode_attention_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_int] * 2 + [ctypes.c_void_p] * 6 + \
            [ctypes.c_int] * 6 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _check_decode_args(what, q, k_cache, v_cache, length) -> None:
    dev = q.device
    for name, t in (("k_cache", k_cache), ("v_cache", v_cache),
                    ("length", length)):
        if t.device != dev:
            raise ValueError(f"{what}: {name} on {t.device}, q on {dev}")
    for name, t in (("q", q), ("k_cache", k_cache), ("v_cache", v_cache),
                    ("length", length)):
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")
    if q.dtype not in _DTYPE_CODE or k_cache.dtype not in _DTYPE_CODE:
        raise TypeError(f"{what}: q and cache dtypes must be in "
                        f"{list(_DTYPE_CODE)}, got {q.dtype} and {k_cache.dtype}")
    if v_cache.dtype != k_cache.dtype:
        raise TypeError(f"{what}: k_cache {k_cache.dtype} and v_cache "
                        f"{v_cache.dtype} differ")
    if length.dtype != torch.int32:
        raise TypeError(f"{what}: length must be int32, got {length.dtype}")
    if q.dim() != 3 or k_cache.dim() != 4:
        raise ValueError(f"{what}: want q [B,H,dk] and k_cache [B,S,Hkv,dk]")
    B, H, dk = q.shape
    S, Hkv = k_cache.shape[1], k_cache.shape[2]
    if (k_cache.shape != (B, S, Hkv, dk) or v_cache.shape != k_cache.shape
            or length.shape != (B,)):
        raise ValueError(
            f"{what}: inconsistent shapes q {tuple(q.shape)}, k_cache "
            f"{tuple(k_cache.shape)}, v_cache {tuple(v_cache.shape)}, length "
            f"{tuple(length.shape)}")
    if dk not in _DECODE_HEAD_DIMS or H % Hkv or H // Hkv > _MAX_REP \
            or (H // Hkv) * dk > _MAX_REP_DK:
        raise ValueError(f"{what}: head_dim {dk} not in {_DECODE_HEAD_DIMS}, "
                         f"H={H} not a multiple of Hkv={Hkv}, or rep over "
                         f"{_MAX_REP} or rep*dk over {_MAX_REP_DK}")
    for name, t in (("q", q), ("k_cache", k_cache), ("v_cache", v_cache)):
        if t.data_ptr() % 16:
            raise ValueError(f"{what}: {name} must be 16-byte aligned")


def _decode_launch(what, q, k_cache, v_cache, length, single: bool):
    """Launch K3 (`single`: one split, no merge) or K4 (decode_plan's
    splits; the partials in the per-(card, stream) workspace)."""
    _check_decode_args(what, q, k_cache, v_cache, length)
    B, H, dk = q.shape
    S, Hkv = k_cache.shape[1], k_cache.shape[2]
    out = torch.empty_like(q)
    if B == 0 or H == 0:
        return out
    splits, ws_floats = 1, 0
    if not single:
        _, splits, ws_floats = decode_plan(B, H, Hkv, dk, S)
    fn = _decode_lib()
    dev = q.get_device()
    with _build.on_device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        ws = _build.workspace(dev, stream, ws_floats) if splits > 1 else None
        err = fn(_DTYPE_CODE[q.dtype], _DTYPE_CODE[k_cache.dtype],
                 q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
                 length.data_ptr(), out.data_ptr(), ws, B, H, Hkv, S, dk,
                 splits, stream)
    _build.check(err, what)
    return out


def decode_attention(q, k_cache, v_cache, length):
    """K3: same contract as decode_attention_reference; on the card one
    kernel block per (row, kv head) walks all of the row's visible slots
    (the kernel's single-pass schedule: no merge, no workspace)."""
    if q.device.type == "cpu":
        return decode_attention_reference(q, k_cache, v_cache, length)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention: unsupported device {q.device}")
    out = _decode_launch("decode_attention", q, k_cache, v_cache, length,
                         single=True)
    decode_attention.launches += 1
    return out


decode_attention.launches = 0


def decode_attention_blocked(q, k_cache, v_cache, length, block: int = 256):
    """K4: same contract as decode_attention_reference. `block` is the JAX
    kernel's VMEM block of cache slots; it must be > 0 and sets nothing on
    the card, where decode_plan's splits blocks a (row, kv head) each walk
    an even share of the row's visible slots, cut on the card in whole
    tiles, and a second pass merges them (none where the plan gives one
    split)."""
    if block <= 0:
        raise ValueError(f"decode_attention_blocked: block {block} must be > 0")
    if q.device.type == "cpu":
        return decode_attention_reference(q, k_cache, v_cache, length)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention_blocked: unsupported device {q.device}")
    out = _decode_launch("decode_attention_blocked", q, k_cache, v_cache,
                         length, single=False)
    decode_attention_blocked.launches += 1
    return out


decode_attention_blocked.launches = 0


def gqa_decode(q, k_cache, v_cache, length):
    """Decode attention dispatch: K4 (decode_attention_blocked) for CUDA
    tensors, the plain version for CPU tensors."""
    return decode_attention_blocked(q, k_cache, v_cache, length)
