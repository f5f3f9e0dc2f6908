"""Pipeline parallelism for the LLM backbone: a GPipe forward over a 'stage'
mesh axis (counterpart of freeze_omni_tpu/parallel/pipeline_parallel.py).

The layer stack is cut into contiguous stages, one a rank of the 'stage'
group (`stage_tree` copies a rank's layers out of a full tree, so a rank
holds 1/P of them); the batch is cut into microbatches that flow from
stage to stage (collectives.send_recv, the JAX `ppermute` of a chain).
Stage 0 reads microbatch mb from the replicated embeds, every other stage
receives it from the stage before, runs its block and sends it on, and the
last stage keeps the outputs and broadcasts them to the group. The JAX
version steps every stage through all M + P - 1 steps of the schedule and
masks the steps with no microbatch; here such a stage does no work, with
the same result. A ('data', 'stage') mesh runs one pipeline a data index.

Forward only (training / prefill), as in the JAX package: returns the
hidden states of models/qwen2.train_forward.
"""

from __future__ import annotations

import torch

from ..config import LLMConfig
from ..models.layers import layer_params, rms_norm, rotary_embed
from ..models.qwen2 import _gqa_attention, _layer
from . import collectives
from .mesh import cut


def _depth(layers) -> int:
    return layers["ln1"]["scale"].shape[0]


def stage_tree(params: dict, stage: int, P: int) -> dict:
    """Stage `stage` of P: its contiguous num_layers / P layers, copied into
    new storage (the full tree's memory is released once nothing else
    holds it), and the final norm."""
    L = _depth(params["layers"])
    assert L % P == 0, (L, P)

    def rec(tree):
        if isinstance(tree, dict):
            return {k: rec(v) for k, v in tree.items()}
        return cut(tree, 0, stage, P)

    return {"layers": rec(params["layers"]), "final_norm": params["final_norm"]}


@torch.no_grad()
def pp_forward(params: dict, cfg: LLMConfig, embeds: torch.Tensor, mesh,
               num_microbatches: int, stage_axis: str = "stage") -> torch.Tensor:
    """GPipe forward. embeds: [B, T, D], the same on every rank of the
    stage group; B % num_microbatches == 0, and the layer count must divide
    by the stage-axis size. `params` is this rank's stage_tree, or a full
    tree to cut it from. Returns the final-norm hidden [B, T, D] on every
    rank of the group (equal to the unsharded forward's)."""
    B, T, D = embeds.shape
    M = num_microbatches
    assert B % M == 0, (B, M)
    P = mesh.axis_size(stage_axis)
    assert cfg.num_layers % P == 0, (cfg.num_layers, P)
    b, per = B // M, cfg.num_layers // P
    stage = mesh.axis_index(stage_axis)
    group = mesh.axis_group(stage_axis)
    layers = params["layers"]
    if _depth(layers) == cfg.num_layers and P > 1:
        layers = stage_tree(params, stage, P)["layers"]
    elif _depth(layers) != per:
        raise ValueError(f"a tree of {_depth(layers)} layers is neither the "
                         f"model's {cfg.num_layers} nor one stage's {per}")
    rep = cfg.num_heads // cfg.num_kv_heads
    dev = embeds.device
    cos, sin = rotary_embed(torch.arange(T, device=dev), cfg.head_dim,
                            cfg.rope_theta)
    cos, sin = cos[None].expand(b, T, -1), sin[None].expand(b, T, -1)
    idx = torch.arange(T, device=dev)
    causal = (idx[None, :] <= idx[:, None])[None].expand(b, T, T)

    def attend(q, k, v):
        return _gqa_attention(q, k, v, causal, rep)

    outputs = torch.empty((M, b, T, D), dtype=embeds.dtype, device=dev)
    collectives.prepare_p2p(group)
    for mb in range(M):
        if stage == 0:
            x = embeds[mb * b:(mb + 1) * b]
        else:
            x, = collectives.send_recv(recv=[torch.empty((b, T, D), dtype=embeds.dtype,
                                                         device=dev)],
                                       src=stage - 1, group=group)
        for i in range(per):
            x = _layer(layer_params(layers, i), None, cfg, x, cos, sin, attend, 1.0)
        if stage < P - 1:
            collectives.send_recv(send=[x.to(embeds.dtype)], dst=stage + 1,
                                  group=group)
        else:
            outputs[mb] = x
    collectives.broadcast_(outputs, src=mesh.rank_of(mesh.data_index, P - 1),
                           group=group)
    return rms_norm(params["final_norm"], outputs.reshape(B, T, D), cfg.rms_eps)
