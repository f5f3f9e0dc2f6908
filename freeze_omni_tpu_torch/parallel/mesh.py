"""Process mesh and the LLM's shard rules (counterpart of
freeze_omni_tpu/parallel/mesh.py).

The JAX package places one SPMD program on a ('data', 'model') device mesh
and lets XLA insert the collectives. The port runs one process per card
(or several processes sharing a card, over gloo), so a mesh here is this
process's place in a grid of ranks, laid out row-major as the JAX mesh
reshapes its devices (rank = data_index * inner + inner_index), with a
`torch.distributed` subgroup along each axis. The inner axis is 'model'
(tensor parallelism, below), 'seq' (parallel/ring_attention.py) or
'stage' (parallel/pipeline_parallel.py); a 1-D mesh has that axis alone.
On a ('data', 'model') mesh:

- sessions shard over 'data': each data index holds its share of the
  session rows (runtime/session.SessionStore.shard);
- the frozen LLM shards over 'model': attention heads and FFN columns
  split, column-parallel q/k/v/gate/up/lm_head, row-parallel o/down, a
  vocab-parallel embedding table. models/qwen2 adds the collectives: one
  all_reduce after each row-parallel projection, a masked lookup plus
  all_reduce for the embedding, an all-gather of the lm_head's columns;
- everything else (encoders, adapters, the state head, the speech decoder
  and codec) is replicated;
- KV caches shard kv heads over 'model' and session rows over 'data'.

`shard_llm_tree` cuts one rank's slice out of a full tree, contiguous and
in new storage (the kernels refuse strided tensors, and the full tree's
memory is released once nothing else holds it); its slices equal the JAX
mesh's addressable shards of `shard_llm_params` leaf for leaf.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from ..config import LLMConfig

AXES = ("data", "model")
# the axes a mesh may have beside 'data': tensor parallelism ('model'),
# ring attention's sequence axis ('seq', parallel/ring_attention.py) and the
# GPipe stages ('stage', parallel/pipeline_parallel.py)
INNER_AXES = ("model", "seq", "stage")


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This process's place in a (data, inner) grid of ranks; the inner
    axis is one of INNER_AXES (a 1-D mesh is data 1). Callers read an axis
    by name (`axis_size`, `axis_index`, `axis_group`); the tensor-parallel
    callers read `model`, `model_index` and `model_group`, which a mesh
    without a 'model' axis gives as one rank."""

    shape: Tuple[int, int]          # (data, inner)
    rank: int
    data_index: int
    inner_index: int
    inner_group: object = None      # the ranks of this data index
    data_group: object = None       # the ranks of this inner index
    inner_axis: str = "model"

    @property
    def data(self) -> int:
        return self.shape[0]

    @property
    def model(self) -> int:
        return self.shape[1] if self.inner_axis == "model" else 1

    @property
    def model_index(self) -> int:
        return self.inner_index if self.inner_axis == "model" else 0

    @property
    def model_group(self):
        return self.inner_group if self.inner_axis == "model" else None

    def _axis(self, name: str) -> int:
        if name == "data":
            return 0
        if name == self.inner_axis:
            return 1
        raise ValueError(f"the mesh has no axis {name!r} (its axes: data, "
                         f"{self.inner_axis})")

    def axis_size(self, name: str) -> int:
        return self.shape[self._axis(name)]

    def axis_index(self, name: str) -> int:
        return (self.data_index, self.inner_index)[self._axis(name)]

    def axis_group(self, name: str):
        """The torch.distributed group along axis `name` that holds this
        rank (None where the mesh has one rank)."""
        return (self.data_group, self.inner_group)[self._axis(name)]

    def rank_of(self, data_index: int, inner_index: int) -> int:
        """The global rank at (data_index, inner_index)."""
        return data_index * self.shape[1] + inner_index


def _grid(shape, axes) -> Tuple[Tuple[int, int], str]:
    """(data, inner) and the inner axis's name of a 1-D (X,) or 2-D
    ("data", X) mesh; ("data",) alone is (n, 1) with no inner ranks."""
    axes, shape = tuple(axes), tuple(int(n) for n in shape)
    if len(axes) != len(shape):
        raise ValueError(f"mesh shape {shape} does not match axes {axes}")
    if axes == ("data",):
        return (shape[0], 1), "model"
    if len(axes) == 1 and axes[0] in INNER_AXES:
        return (1, shape[0]), axes[0]
    if len(axes) == 2 and axes[0] == "data" and axes[1] in INNER_AXES:
        return (shape[0], shape[1]), axes[1]
    raise ValueError(f"axes must be (X,) or ('data', X) with X one of "
                     f"{INNER_AXES}, got {axes}")


def make_mesh(shape: Tuple[int, ...] = (1, 1), axes: Tuple[str, ...] = AXES
              ) -> Mesh:
    """The mesh over every process of the initialized job
    (torch.distributed.init_process_group; parallel/multihost.initialize):
    1-D (X,) or 2-D ("data", X), X one of INNER_AXES, laid out as the JAX
    mesh reshapes its devices. A mesh of one rank needs no process group.
    Every rank must call this, in the same order as any other group
    creation: it creates the subgroups."""
    import torch.distributed as dist

    (d, m), inner = _grid(shape, axes)
    n = d * m
    world = dist.get_world_size() if dist.is_initialized() else 1
    if n > world:
        raise ValueError(f"mesh {tuple(shape)} needs {n} devices, have {world}")
    if n < world:
        raise ValueError(f"mesh {tuple(shape)} covers {n} of the job's "
                         f"{world} processes")
    rank = dist.get_rank() if dist.is_initialized() else 0
    inner_group = data_group = None
    if n > 1:
        for di in range(d):   # every rank creates every group, in order
            g = dist.new_group([di * m + j for j in range(m)])
            if di == rank // m:
                inner_group = g
        for j in range(m):
            g = dist.new_group([di * m + j for di in range(d)])
            if j == rank % m:
                data_group = g
    return Mesh((d, m), rank, rank // m, rank % m, inner_group, data_group,
                inner)


# -- shard rules --------------------------------------------------------------
# A rule gives, per leaf, the axis cut over 'model' or None (replicated).


def _linear_axes(kind: str, lead: int, p: dict) -> dict:
    """Axes of one projection. kind='col' cuts the output axis, 'row' the
    input axis; lead=1 for stacked-layer weights [L, ...]. Matches float
    {"w"}, int8 {"w_q", "scale"} and grouped int4 {"w_q4", "scale4"} trees
    (ops/quant.py layouts): the int8 scale is per output column (cut with a
    column-parallel weight, replicated with a row-parallel one), the int4
    scale4 [*, in/group, out] follows the weight on either axis, a bias
    rides the column-parallel output axis."""
    col = kind == "col"
    if not col and "b" in p:
        raise ValueError("a row-parallel bias would be added once per model "
                         "rank (Qwen2's o and down have none)")
    w_axis = lead + 1 if col else lead
    rules = {"w": w_axis, "w_q": w_axis, "w_q4": w_axis, "scale4": w_axis,
             "scale": lead if col else None, "b": lead}
    unknown = set(p) - set(rules)
    if unknown:
        raise ValueError(f"no shard rule for projection leaves {sorted(unknown)}")
    return {k: rules[k] for k in p}


def llm_param_axes(params: dict) -> dict:
    """The tree of `params` (models/qwen2 layout, float or weight-only
    quantized) with each leaf's 'model' axis: column-parallel q/k/v/gate/up
    (output axis), row-parallel o/down (input axis), vocab-parallel embed
    (rows; an int8 table's per-row scale with them) and lm_head (output
    axis); norms replicated."""
    lp = params["layers"]
    col, row = ("q", "k", "v", "gate", "up"), ("o", "down")
    layers = {name: _linear_axes("col" if name in col else "row", 1, lp[name])
              for name in col + row}
    layers.update({name: {k: None for k in lp[name]} for name in ("ln1", "ln2")})
    embed = {k: 0 for k in params["embed"]}
    axes = {"embed": embed, "layers": layers,
            "final_norm": {k: None for k in params["final_norm"]}}
    if "lm_head" in params:
        axes["lm_head"] = _linear_axes("col", 0, params["lm_head"])
    return axes


# the KV cache [L, B, S, Hkv, dk] (and scales [L, B, S, Hkv]): sessions over
# 'data' on axis 1, kv heads over 'model' on axis 3; kv.length [B] over
# 'data' only
KV_CACHE_AXES = {"data": 1, "model": 3}


def cut(t: torch.Tensor, axis: Optional[int], index: int, parts: int
        ) -> torch.Tensor:
    """Part `index` of `parts` equal parts of `t` along `axis`, contiguous
    and in new storage; None: `t` itself (replicated)."""
    if axis is None or parts == 1:
        return t
    n = t.shape[axis]
    if n % parts:
        raise ValueError(f"axis {axis} of {tuple(t.shape)} does not split "
                         f"into {parts} parts")
    size = n // parts
    return t.narrow(axis, index * size, size).clone(
        memory_format=torch.contiguous_format)


def shard_llm_tree(params: dict, index: int, parts: int) -> dict:
    """Model rank `index`'s slice of a full LLM tree, `parts` ways (no
    process group needed: a pure function of the tree)."""
    def rec(tree, axes):
        if isinstance(tree, dict):
            return {k: rec(v, axes[k]) for k, v in tree.items()}
        return cut(tree, axes, index, parts)

    return rec(params, llm_param_axes(params))


def check_divisible(cfg: LLMConfig, parts: int) -> None:
    """Every axis the model shards must split `parts` ways."""
    for name in ("num_heads", "num_kv_heads", "ffn", "vocab_size"):
        if getattr(cfg, name) % parts:
            raise ValueError(f"{name} = {getattr(cfg, name)} does not split "
                             f"over {parts} model ranks")


def shard_llm_params(params: dict, mesh: Mesh, cfg: LLMConfig) -> dict:
    """This rank's LLM tree on `mesh`: the slice of `shard_llm_tree` plus
    the key "mesh", which models/qwen2 reads for the head counts and the
    collectives. Shard after a LoRA merge or a voice-prompt load, as the JAX
    server does: both work on the full tree."""
    check_divisible(cfg, mesh.model)
    tree = {k: v for k, v in params.items() if k != "mesh"}
    out = shard_llm_tree(tree, mesh.model_index, mesh.model)
    out["mesh"] = mesh
    return out
