"""Sequence (context) parallelism: ring attention over a 'seq' mesh axis
(counterpart of freeze_omni_tpu/parallel/ring_attention.py).

Long-sequence forward with the activations cut along TIME: each rank of a
'seq' group holds a contiguous T/R slice of the sequence; the KV blocks
rotate around the ring (collectives.ring_shift, the JAX `ppermute`) while
every rank accumulates its queries' attention with an online softmax, so a
rank's activation memory drops by the ring size. The JAX version runs one
SPMD program under `shard_map` and returns the global [B, T, D]; here each
rank passes its own slice and gets its slice back (`seq_slice` cuts one,
`gather_seq` assembles the global array where a caller wants it).

Forward only, as in the JAX package: no gradient flows through the ring.
"""

from __future__ import annotations

import math

import torch

from ..config import LLMConfig
from ..models.layers import NEG_INF, layer_params, rms_norm, rotary_embed
from ..models.qwen2 import _layer
from . import collectives


def ring_attention(q, k, v, q_pos: torch.Tensor, kv_pos0: int, rep: int,
                   group, R: int) -> torch.Tensor:
    """Causal online-softmax attention of this rank's queries over the whole
    ring's keys, in R rounds. q: [B, Tl, H, dk]; k, v: [B, Tl, Hkv, dk],
    this rank's own block, which starts at position kv_pos0; q_pos: [Tl]
    the queries' positions (those of the own block). Returns
    [B, Tl, H, dk] in f32.

    Round 0 scores the own (diagonal) block, so the running max is finite
    before a block from the future scores NEG_INF everywhere (finite:
    -inf would give NaN in exp(m - m2)). Each round the block and its start
    position move one rank on; the block a rank receives comes from the rank
    before it, whose start is Tl lower (mod T). A block wholly in the future
    adds exp(NEG_INF - m) = 0 to every sum, so it is not scored."""
    B, Tl, H, dk = q.shape
    Hkv = k.shape[2]
    qg = q.reshape(B, Tl, Hkv, rep, dk).float()
    scale = 1.0 / math.sqrt(dk)
    m = torch.full((B, Hkv, rep, Tl, 1), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((B, Hkv, rep, Tl, dk), dtype=torch.float32, device=q.device)
    kb, vb, pos0 = k, v, kv_pos0
    offsets = torch.arange(Tl, device=q.device)
    for r in range(R):
        if pos0 <= kv_pos0:
            s = torch.einsum("bthrd,bshd->bhrts", qg, kb.float()) * scale
            causal = q_pos[:, None] >= (pos0 + offsets)[None, :]
            s = torch.where(causal, s, torch.full_like(s, NEG_INF))
            m2 = torch.maximum(m, s.amax(dim=-1, keepdim=True))
            corr = torch.exp(m - m2)
            p = torch.exp(s - m2)
            l = l * corr + p.sum(dim=-1, keepdim=True)
            acc = acc * corr + torch.einsum("bhrts,bshd->bhrtd", p, vb.float())
            m = m2
            del s, p
        if r < R - 1:
            kb, vb = collectives.ring_shift([kb, vb], group)
            pos0 = (pos0 - Tl) % (R * Tl)
    out = acc / torch.clamp(l, min=1e-30)                 # [B,Hkv,rep,Tl,dk]
    return out.permute(0, 3, 1, 2, 4).reshape(B, Tl, H, dk)


def seq_slice(x: torch.Tensor, mesh, seq_axis: str = "seq") -> torch.Tensor:
    """This rank's contiguous slice of x [B, T, ...] along time; T must
    divide by the seq-axis size."""
    T, R = x.shape[1], mesh.axis_size(seq_axis)
    assert T % R == 0, (T, R)
    Tl = T // R
    return x[:, mesh.axis_index(seq_axis) * Tl:][:, :Tl].contiguous()


def gather_seq(x_local: torch.Tensor, mesh, seq_axis: str = "seq") -> torch.Tensor:
    """The seq group's slices [B, Tl, ...] assembled into [B, T, ...] on
    every rank of the group (the JAX sp_forward's return shape)."""
    return collectives.all_gather(x_local, mesh.axis_group(seq_axis), dim=1)


@torch.no_grad()
def sp_forward(params: dict, cfg: LLMConfig, embeds: torch.Tensor, mesh,
               seq_axis: str = "seq") -> torch.Tensor:
    """Sequence-parallel causal forward. embeds: this rank's slice
    [B, T/R, D] of the sequence (seq_slice), R the seq-axis size. Returns
    this rank's slice of the final-norm hidden, equal to the unsharded
    forward's rows at the same positions. A ('data', 'seq') mesh runs one
    ring a data index, over the batch rows that index was given."""
    B, Tl, _ = embeds.shape
    R = mesh.axis_size(seq_axis)
    idx = mesh.axis_index(seq_axis)
    group = mesh.axis_group(seq_axis)
    H, Hkv, dk = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    rep = H // Hkv
    q_pos = idx * Tl + torch.arange(Tl, device=embeds.device)
    cos, sin = rotary_embed(q_pos, dk, cfg.rope_theta)
    cos = cos[None].expand(B, Tl, dk)
    sin = sin[None].expand(B, Tl, dk)

    def attend(q, k, v):
        att = ring_attention(q, k, v, q_pos, idx * Tl, rep, group, R)
        return att.reshape(B, Tl, H * dk).to(q.dtype)

    x = embeds
    for i in range(cfg.num_layers):
        x = _layer(layer_params(params["layers"], i), None, cfg, x, cos, sin,
                   attend, 1.0)
    return rms_norm(params["final_norm"], x, cfg.rms_eps)
