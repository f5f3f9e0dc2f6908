"""Qwen2-class decoder-only LLM backbone (counterpart of freeze_omni_tpu/models/qwen2.py).

- a static-shape KV cache [L, B, S_max, Hkv, dk] + per-row length. Chunks
  arrive padded to a static length with a validity mask; valid tokens are
  compacted into the cache (rank/cumsum) and invalid ones are parked in the
  scratch slot S-1, so one code path serves every chunk and sessions batch
  along B;
- GQA, RoPE, RMSNorm, SwiGLU and q/k/v biases as in Qwen2;
- an int8 cache variant (per-token, per-kv-head scales) quantized on append
  and read by the int8-KV prefill attention kernel (ops/attention.py, K2),
  at every chunk length including single-token decode;
- on a float cache, single-token decode (T = 1: text decode and the speech
  decoder's codec-token steps) goes through the decode attention dispatcher
  (ops/attention.gqa_decode, kernel K4); longer float-cache chunks (prefill,
  the speech decoder's prefix) through plain attention, as the JAX package
  computes them outside any Pallas kernel.

Unlike the JAX version, which threads the cache functionally, `forward` and
`roll_kv` update the cache tensors IN PLACE (and also return the cache, to
keep the JAX signatures): the per-session KV pool is preallocated once.
Training differentiates `train_forward` instead, which keeps no cache.
Parameters keep the JAX layout: layer leaves are stacked [L, ...].

Tensor parallel: a tree that parallel/mesh.shard_llm_params cut holds this
rank's heads, FFN columns and vocabulary rows, and the key "mesh". Its
forward runs num_heads / tp query and num_kv_heads / tp kv heads over a
cache of its own kv heads, sums the row-parallel o and down projections
with one all_reduce each over the mesh's model group, looks tokens up in
its vocabulary rows (an all_reduce assembles the rows) and all-gathers the
lm_head's columns, so every rank of a model group holds the same hidden
states and logits. With no mesh, or one model rank, the code path is the
single-card one and runs no collective.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from ..config import LLMConfig
from ..ops.attention import gqa_decode, prefill_quant
from ..parallel import collectives
from ..utils.device import resolve_device
from . import lora as lora_mod
from .layers import (NEG_INF, _uniform, embedding, layer_params, linear,
                     linear_init, rms_norm, rms_norm_init, rotary_embed)


class KVCache(NamedTuple):
    """Static-shape KV cache; int8 when k_scale/v_scale are present."""

    k: torch.Tensor       # [L, B, S_max, Hkv, dk] (bf16/f32, or int8 if quant)
    v: torch.Tensor       # [L, B, S_max, Hkv, dk]
    length: torch.Tensor  # [B] int32 — valid prefix length per row
    k_scale: Optional[torch.Tensor] = None  # [L, B, S_max, Hkv] f32
    v_scale: Optional[torch.Tensor] = None


def init_cache(cfg: LLMConfig, batch: int = 1, max_len: Optional[int] = None,
               dtype=torch.bfloat16, quant_bits: Optional[int] = None,
               device=None, tp: int = 1) -> KVCache:
    """Zeroed cache on `device` (None: the CUDA card), of one rank's
    num_kv_heads / tp kv heads."""
    device = resolve_device(device)
    s = max_len or cfg.max_kv_len
    shape = (cfg.num_layers, batch, s, cfg.num_kv_heads // tp, cfg.head_dim)
    length = torch.zeros(batch, dtype=torch.int32, device=device)
    if quant_bits is None:
        return KVCache(k=torch.zeros(shape, dtype=dtype, device=device),
                       v=torch.zeros(shape, dtype=dtype, device=device),
                       length=length)
    if quant_bits != 8:
        raise ValueError(f"unsupported kv quant_bits {quant_bits!r} (8 or None)")
    return KVCache(
        k=torch.zeros(shape, dtype=torch.int8, device=device),
        v=torch.zeros(shape, dtype=torch.int8, device=device), length=length,
        k_scale=torch.zeros(shape[:-1], dtype=torch.float32, device=device),
        v_scale=torch.zeros(shape[:-1], dtype=torch.float32, device=device))


def cache_axes(cache: KVCache) -> KVCache:
    """Batch-axis index per leaf (for row gather/scatter over sessions); a
    float cache has no scale leaves."""
    return KVCache(k=1, v=1, length=0,
                   k_scale=None if cache.k_scale is None else 1,
                   v_scale=None if cache.v_scale is None else 1)


def quantize_kv_vectors(x: torch.Tensor):
    """Symmetric int8 over the last (head_dim) axis: x [..., dk] ->
    (q int8 [..., dk], scale f32 [...])."""
    xf = x.float()
    s = torch.clamp(xf.abs().amax(dim=-1), min=1e-8) / 127.0
    q = torch.clamp(torch.round(xf / s[..., None]), -127, 127).to(torch.int8)
    return q, s


def _requantize_vectors(x: torch.Tensor):
    """quantize_kv_vectors for values that may be dequantized int8 vectors
    (codes times a scale): such a vector gets its codes and scale back
    exactly. Its scale is one of the three f32 neighbours of max|x| / 127
    (the quantizer's own rounding, and on the card its multiply by 1/127,
    can move it by an ulp); the first that reproduces every value of the
    vector from integer codes is taken. Any other vector (a zero one
    included) is quantized as quantize_kv_vectors does."""
    xf = x.float()
    q_out, s_out = quantize_kv_vectors(xf)
    amax = xf.abs().amax(dim=-1)
    c0 = amax / torch.full_like(amax, 127.0)   # a true division on the card too
    found = torch.zeros_like(amax, dtype=torch.bool)
    for c in (c0, torch.nextafter(c0, torch.zeros_like(c0)),
              torch.nextafter(c0, torch.full_like(c0, float("inf")))):
        q = torch.clamp(torch.round(xf / c[..., None]), -127, 127)
        exact = (amax > 0) & ((q * c[..., None]) == xf).all(dim=-1) & ~found
        q_out = torch.where(exact[..., None], q.to(torch.int8), q_out)
        s_out = torch.where(exact, c, s_out)
        found |= exact
    return q_out, s_out


def quantize_cache(kv: KVCache, quant_bits: int = 8) -> KVCache:
    """Float cache -> new int8 cache (per-token-per-head scales). Floats
    that came from an int8 cache (dequantize_cache) get their codes and
    scales back exactly, so a session exported in float layout resumes in
    an int8 store as it left (see _requantize_vectors); other floats are
    quantized as quantize_kv_vectors does. Only the scratch slot S-1, where
    masked tokens land together, may hold codes and a scale of different
    tokens; it is requantized and stays out of sight."""
    if kv.k_scale is not None:
        return kv
    if quant_bits != 8:
        raise ValueError(f"unsupported kv quant_bits {quant_bits!r}")
    kq, ks = _requantize_vectors(kv.k)
    vq, vs = _requantize_vectors(kv.v)
    return KVCache(k=kq, v=vq, length=kv.length.clone(), k_scale=ks, v_scale=vs)


def dequantize_cache(kv: KVCache, dtype=torch.bfloat16) -> KVCache:
    """int8 cache -> new float cache."""
    if kv.k_scale is None:
        return kv
    k = (kv.k.float() * kv.k_scale[..., None]).to(dtype)
    v = (kv.v.float() * kv.v_scale[..., None]).to(dtype)
    return KVCache(k=k, v=v, length=kv.length.clone())


def copy_cache(kv: KVCache, out: Optional[KVCache] = None) -> KVCache:
    """A copy of `kv` in new tensors, or written into `out` (same shapes and
    dtypes) in place. `forward` and `roll_kv` advance a cache in place, so a
    cache that must stay as it is (a role prefill that sessions restart
    from) is copied before anything appends to it."""
    if out is None:
        return KVCache(*[None if t is None else t.clone() for t in kv])
    for dst, src in zip(out, kv):
        if dst is not None:
            dst.copy_(src)
    return out


def init_layer_stack(cfg: LLMConfig, gen: torch.Generator, num_layers: int,
                     dtype=torch.bfloat16, device=None):
    """Stacked float decoder-layer params [num_layers, ...]."""
    device = resolve_device(device)
    D, H, Hkv, dk = cfg.hidden, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    L = num_layers

    def lin(i, o, bias):
        bound = 1.0 / math.sqrt(i)
        p = {"w": _uniform(gen, (L, i, o), bound, dtype, device)}
        if bias:
            p["b"] = _uniform(gen, (L, o), bound, dtype, device)
        return p

    ones = lambda: {"scale": torch.ones((L, D), dtype=dtype, device=device)}  # noqa: E731
    return {"ln1": ones(), "q": lin(D, H * dk, cfg.qkv_bias),
            "k": lin(D, Hkv * dk, cfg.qkv_bias), "v": lin(D, Hkv * dk, cfg.qkv_bias),
            "o": lin(H * dk, D, False), "ln2": ones(),
            "gate": lin(D, cfg.ffn, False), "up": lin(D, cfg.ffn, False),
            "down": lin(cfg.ffn, D, False)}


def init_params(cfg: LLMConfig, gen: torch.Generator, dtype=torch.bfloat16,
                device=None) -> dict:
    device = resolve_device(device)
    D = cfg.hidden
    params = {
        "embed": {"w": (torch.randn((cfg.vocab_size, D), generator=gen,
                                    device=device) * 0.02).to(dtype)},
        "layers": init_layer_stack(cfg, gen, cfg.num_layers, dtype, device),
        "final_norm": rms_norm_init(D, dtype, device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = linear_init(gen, D, cfg.vocab_size, bias=False,
                                        dtype=dtype, device=device)
    return params


def _mesh(params):
    """The mesh of a tree that parallel/mesh.shard_llm_params cut, where its
    model axis has more than one rank; else None."""
    mesh = params.get("mesh")
    return mesh if mesh is not None and mesh.model > 1 else None


def model_ranks(params) -> int:
    """The model ranks a tree's heads are split over (1 for a full tree);
    a cache for it is made with init_cache(..., tp=model_ranks(params))."""
    mesh = _mesh(params)
    return 1 if mesh is None else mesh.model


def _sum(mesh, y: torch.Tensor) -> torch.Tensor:
    """A row-parallel projection's partial sums, summed over the model
    group (in place)."""
    return y if mesh is None else collectives.all_reduce_(y, mesh.model_group)


def _lookup(p, ids: torch.Tensor) -> torch.Tensor:
    if "w_q" in p:
        rows = p["w_q"][ids].float()
        return (rows * p["scale"][ids][..., None]).to(torch.bfloat16)
    return embedding(p, ids)


def embed_tokens(params, ids: torch.Tensor) -> torch.Tensor:
    """Token embeddings; the per-row int8 table always yields bf16. A
    sharded table looks up the ids among its own rows, zeros the others and
    sums over the model group: exact, each id has one owner."""
    p = params["embed"]
    mesh = _mesh(params)
    if mesh is None:
        return _lookup(p, ids)
    rows = (p["w_q"] if "w_q" in p else p["w"]).shape[0]
    local = ids - mesh.model_index * rows
    mine = (local >= 0) & (local < rows)
    emb = _lookup(p, torch.where(mine, local, torch.zeros_like(local)))
    emb = torch.where(mine[..., None], emb, torch.zeros_like(emb))
    return collectives.all_reduce_(emb, mesh.model_group)


def logits(params, cfg: LLMConfig, hidden: torch.Tensor) -> torch.Tensor:
    """[..., vocab]; a sharded tree's column slices are gathered whole."""
    if cfg.tie_embeddings:
        y = torch.einsum("...d,vd->...v", hidden, params["embed"]["w"])
    else:
        y = linear(params["lm_head"], hidden)
    mesh = _mesh(params)
    return y if mesh is None else collectives.all_gather(y, mesh.model_group,
                                                         dim=-1)


def _gqa_attention(q, k_all, v_all, mask, rep: int):
    """Float-cache attention. q: [B,T,H,dk]; k_all/v_all: [B,S,Hkv,dk];
    mask: [B,T,S] bool. Returns [B, T, H*dk] in q's dtype."""
    B, T, H, dk = q.shape
    Hkv = k_all.shape[2]
    dt = torch.promote_types(q.dtype, k_all.dtype)
    qg = q.reshape(B, T, Hkv, rep, dk).to(dt)
    scores = torch.einsum("bthrd,bshd->bhrts", qg, k_all.to(dt)) / math.sqrt(dk)
    scores = torch.where(mask[:, None, None], scores,
                         torch.full_like(scores, NEG_INF))
    attn = torch.softmax(scores.float(), dim=-1).to(q.dtype)
    dt2 = torch.promote_types(attn.dtype, v_all.dtype)
    out = torch.einsum("bhrts,bshd->bthrd", attn.to(dt2), v_all.to(dt2))
    return out.reshape(B, T, H * dk).to(q.dtype)


def _apply_rot(x, cos, sin):
    """Rotate-half RoPE in f32; x: [B, T, H, dk], cos/sin: [B, T, dk]."""
    d2 = x.shape[-1] // 2
    rot = torch.cat([-x[..., d2:], x[..., :d2]], dim=-1)
    y = x * cos[:, :, None, :] + rot * sin[:, :, None, :]
    return y.to(x.dtype)


def _proj(lp, lo, name: str, h: torch.Tensor, lora_scale: float) -> torch.Tensor:
    """One projection, plus its LoRA delta where the adapter has one."""
    y = linear(lp[name], h)
    if lo is not None and name in lo:
        y = y + lora_mod.delta(lo[name], h, lora_scale)
    return y


def _layer(lp, lo, cfg: LLMConfig, x, cos, sin, attend, lora_scale: float,
           mesh=None):
    """One decoder layer; `attend(q, k, v)` -> [B, T, H*dk] is the
    attention over this layer's cache (serving) or over the fresh K/V
    (training). Under a mesh it runs this rank's heads and sums the o and
    down partial sums over the model group."""
    B, T, _ = x.shape
    tp = 1 if mesh is None else mesh.model
    H, Hkv, dk = cfg.num_heads // tp, cfg.num_kv_heads // tp, cfg.head_dim
    h = rms_norm(lp["ln1"], x, cfg.rms_eps)
    q = _apply_rot(_proj(lp, lo, "q", h, lora_scale).reshape(B, T, H, dk), cos, sin)
    k = _apply_rot(_proj(lp, lo, "k", h, lora_scale).reshape(B, T, Hkv, dk), cos, sin)
    v = _proj(lp, lo, "v", h, lora_scale).reshape(B, T, Hkv, dk)
    x = x + _sum(mesh, _proj(lp, lo, "o", attend(q, k, v), lora_scale))
    h2 = rms_norm(lp["ln2"], x, cfg.rms_eps)
    ffn = F.silu(_proj(lp, lo, "gate", h2, lora_scale)) * _proj(lp, lo, "up", h2, lora_scale)
    return x + _sum(mesh, _proj(lp, lo, "down", ffn, lora_scale))


def forward(params, cfg: LLMConfig, embeds: torch.Tensor, mask: torch.Tensor,
            cache: KVCache, pos_offset=0, lora: Optional[dict] = None,
            lora_scale: float = 1.0) -> Tuple[torch.Tensor, KVCache]:
    """Prefill/decode step over a static-length chunk of embeddings.

    embeds: [B, T, D]; mask: [B, T] bool validity. Valid tokens are appended
    compactly to `cache`, which is updated in place (k/v, scales, length);
    returns (hidden [B, T, D], cache). Invalid positions produce garbage
    hidden states; callers read the last valid position.

    pos_offset (int or [B]) is subtracted from the RoPE positions only, never
    from the cache slots: the speech decoder restarts positions after its KV
    prefix (models/decoder/decoder.py:337-341). lora: an optional stacked
    adapter tree (models/lora.py) whose deltas lora_scale * (h @ A) @ B are
    added to the projections; the base weights stay frozen. The in-place
    cache writes make this path unfit for autograd: training runs
    `train_forward`. A sharded tree (see the module docstring) runs its own
    heads over a cache of its own kv heads; an adapter is merged before
    sharding, never passed with one."""
    B, T, D = embeds.shape
    mesh = _mesh(params)
    if mesh is not None and lora is not None:
        raise ValueError("a sharded LLM takes no LoRA tree: merge the adapter "
                         "before sharding (models/lora.merge)")
    tp = model_ranks(params)
    H, Hkv, dk = cfg.num_heads // tp, cfg.num_kv_heads // tp, cfg.head_dim
    rep = H // Hkv
    S = cache.k.shape[2]
    dev = embeds.device

    maski = mask.to(torch.int64)
    rank = torch.cumsum(maski, dim=1) - 1                 # [B, T]
    n_new = maski.sum(dim=1)                              # [B]
    length = cache.length.to(torch.int64)
    positions = length[:, None] + torch.clamp(rank, min=0)
    offset = torch.as_tensor(pos_offset, device=dev).to(torch.int64).reshape(-1, 1)
    rope_positions = positions - offset
    # invalid tokens go to scratch slot S-1; the runtime keeps
    # length + n_new <= S-1, so no valid query ever sees it
    dest = torch.where(mask, positions, torch.full_like(positions, S - 1))

    cos, sin = rotary_embed(rope_positions.reshape(-1), dk, cfg.rope_theta)
    cos = cos.reshape(B, T, dk)
    sin = sin.reshape(B, T, dk)

    quant = cache.k_scale is not None
    decode = not quant and T == 1
    if quant:
        # query t sees slots [0, length + rank_t + 1); invalid queries none
        qend = torch.where(mask, length[:, None] + rank + 1,
                           torch.zeros_like(rank)).to(torch.int32)
    elif decode:
        # one query per row: a valid row sees its length + 1 slots (its own
        # token included), a masked row none
        visible = torch.where(mask[:, 0], length + 1,
                              torch.zeros_like(length)).to(torch.int32)
    else:
        slot = torch.arange(S, device=dev)[None, None, :]
        attn_mask = (slot < (length[:, None, None] + rank[:, :, None] + 1)) \
            & mask[:, :, None]
    batch_idx = torch.arange(B, device=dev)[:, None].expand(B, T)

    def attend_cache(i):
        def attend(q, k, v):
            if quant:
                kq, ksc = quantize_kv_vectors(k)
                vq, vsc = quantize_kv_vectors(v)
                cache.k[i][batch_idx, dest] = kq
                cache.v[i][batch_idx, dest] = vq
                cache.k_scale[i][batch_idx, dest] = ksc
                cache.v_scale[i][batch_idx, dest] = vsc
                att = prefill_quant(q, cache.k[i], cache.k_scale[i], cache.v[i],
                                    cache.v_scale[i], qend)
                return att.reshape(B, T, H * dk).to(q.dtype)
            cache.k[i][batch_idx, dest] = k.to(cache.k.dtype)
            cache.v[i][batch_idx, dest] = v.to(cache.v.dtype)
            if decode:
                att = gqa_decode(q[:, 0], cache.k[i], cache.v[i], visible)
                return att.reshape(B, 1, H * dk)
            return _gqa_attention(q, cache.k[i], cache.v[i], attn_mask, rep)
        return attend

    x = embeds
    for i in range(cfg.num_layers):
        lo = None if lora is None else layer_params(lora, i)
        x = _layer(layer_params(params["layers"], i), lo, cfg, x, cos, sin,
                   attend_cache(i), lora_scale, mesh)
    x = rms_norm(params["final_norm"], x, cfg.rms_eps)
    cache.length.add_(n_new.to(cache.length.dtype))
    return x, cache


def train_forward(params, cfg: LLMConfig, embeds: torch.Tensor,
                  lora: Optional[dict] = None,
                  lora_scale: float = 1.0) -> torch.Tensor:
    """Full-sequence causal forward for training, which autograd can
    differentiate: embeds [B, T, D], every position valid -> hidden
    [B, T, D]. The JAX training losses run `forward` over a fresh cache of
    T + 1 slots with an all-valid mask: query t sees slots [0, t + 1), the
    slots past it score NEG_INF. Here each layer attends over its own fresh
    K/V under that causal mask, with no cache and no in-place write (a
    shared cache written by layer i + 1 would invalidate what layer i saved
    for backward)."""
    B, T, D = embeds.shape
    rep = cfg.num_heads // cfg.num_kv_heads
    dev = embeds.device
    cos, sin = rotary_embed(torch.arange(T, device=dev), cfg.head_dim,
                            cfg.rope_theta)
    cos = cos[None].expand(B, T, -1)
    sin = sin[None].expand(B, T, -1)
    idx = torch.arange(T, device=dev)
    causal = (idx[None, :] <= idx[:, None])[None].expand(B, T, T)

    def attend(q, k, v):
        return _gqa_attention(q, k, v, causal, rep)

    x = embeds
    for i in range(cfg.num_layers):
        lo = None if lora is None else layer_params(lora, i)
        x = _layer(layer_params(params["layers"], i), lo, cfg, x, cos, sin,
                   attend, lora_scale)
    return rms_norm(params["final_norm"], x, cfg.rms_eps)


def roll_kv(cfg: LLMConfig, kv: KVCache, prefix_len: torch.Tensor,
            keep_recent, do_roll: torch.Tensor) -> KVCache:
    """Sliding-window KV compaction with a pinned prefix, per row, IN PLACE.

    For rows where do_roll: keep slots [0, prefix_len) (the role prefill, the
    attention sink) and move the most recent `keep_recent` entries down to
    [prefix_len, prefix_len + W), re-rotating K by the uniform shift so the
    kept entries sit at within-cache positions (StreamingLLM eviction); slots
    past the new length are zeroed. An int8 cache dequantizes, rotates and
    requantizes K; V and its scales move losslessly. One layer at a time, so
    the f32 transient is one layer's worth. Other rows are untouched."""
    Lc, B, S, Hkv, dk = kv.k.shape
    dev = kv.k.device
    length = kv.length.to(torch.int64)
    prefix_len = torch.as_tensor(prefix_len, device=dev).to(torch.int64)
    keep = torch.as_tensor(keep_recent, device=dev).to(torch.int64)
    do_roll = torch.as_tensor(do_roll, device=dev).bool()
    W = torch.minimum(torch.clamp(keep, min=0), length - prefix_len)   # [B]
    start = length - W
    s_idx = torch.arange(S, device=dev)[None, :]
    in_prefix = s_idx < prefix_len[:, None]
    src = torch.where(in_prefix, s_idx, s_idx - prefix_len[:, None] + start[:, None])
    src = torch.clamp(src, 0, S - 1)
    delta = torch.where(in_prefix, torch.zeros_like(src),
                        (prefix_len - start)[:, None].expand(B, S))

    cos, sin = rotary_embed(delta.reshape(-1), dk, cfg.rope_theta)
    cos = cos.reshape(B, S, 1, dk)
    sin = sin.reshape(B, S, 1, dk)

    new_len = prefix_len + W
    valid = s_idx < new_len[:, None]
    sel = (do_roll[:, None] & valid)[:, :, None, None]                # [B,S,1,1]
    zero = (do_roll[:, None] & ~valid)[:, :, None, None]
    idx4 = src[:, :, None, None].expand(B, S, Hkv, dk)
    idx3 = src[:, :, None].expand(B, S, Hkv)

    def rot(x):
        d2 = dk // 2
        r = torch.cat([-x[..., d2:], x[..., :d2]], dim=-1)
        return (x * cos + r * sin).to(x.dtype)

    def put(dst, new, sel_, zero_):
        dst.copy_(torch.where(sel_, new, torch.where(zero_, torch.zeros_like(dst), dst)))

    for i in range(Lc):
        if kv.k_scale is None:
            put(kv.k[i], rot(torch.gather(kv.k[i], 1, idx4)), sel, zero)
            put(kv.v[i], torch.gather(kv.v[i], 1, idx4), sel, zero)
        else:
            kf = torch.gather(kv.k[i], 1, idx4).float() * \
                torch.gather(kv.k_scale[i], 1, idx3)[..., None]
            kq2, ks2 = quantize_kv_vectors(rot(kf))
            vq2 = torch.gather(kv.v[i], 1, idx4)
            vs2 = torch.gather(kv.v_scale[i], 1, idx3)
            put(kv.k[i], kq2, sel, zero)
            put(kv.v[i], vq2, sel, zero)
            put(kv.k_scale[i], ks2, sel[..., 0], zero[..., 0])
            put(kv.v_scale[i], vs2, sel[..., 0], zero[..., 0])
    kv.length.copy_(torch.where(do_roll, new_len, length).to(kv.length.dtype))
    return kv


def last_valid_index(mask: torch.Tensor) -> torch.Tensor:
    """Index of the last valid token per row of a [B, T] mask (-1 if none)."""
    T = mask.shape[1]
    idx = torch.arange(T, device=mask.device)[None, :].expand_as(mask)
    return torch.where(mask, idx, torch.full_like(idx, -1)).amax(dim=1)
