"""The collectives of the port's multi-process paths, in one place.

Every caller (the tensor-parallel LLM, the sharded session store, the
engine's result gathers, the lockstep bundle broadcast, data-parallel
training, ring attention's KV rotation, the pipeline's stage-to-stage
sends) goes through these helpers and picks no collective of its own. A
group runs over NCCL when every rank has a CUDA card of its own, and over
gloo for CPU ranks or for ranks that share one card
(parallel/multihost.choose_backend). gloo takes
CUDA tensors only in `broadcast` and `all_reduce`: under gloo the helpers
here stage every other collective through host memory, so a caller hands
them tensors on its own device either way. Point-to-point transfers
(`send_recv`, `ring_shift`) post every send and receive of a rank in one
`dist.batch_isend_irecv` before waiting on any: a blocking send followed
by a receive deadlocks around a ring.

`group=None` means the default (world) group. A helper on a group of one
rank returns its input unchanged and runs no collective.
"""

from __future__ import annotations

from typing import Any, List, Optional, Sequence

import torch
import torch.distributed as dist


def group_size(group) -> int:
    return dist.get_world_size(group) if dist.is_initialized() else 1


def _staged(t: torch.Tensor, group) -> bool:
    """Whether `t` must go through host memory for a collective other than
    broadcast or all_reduce: a CUDA tensor on a gloo group."""
    return t.is_cuda and dist.get_backend(group) == "gloo"


def comm_device(group=None) -> torch.device:
    """Where a tensor made only for a collective lives: the current card
    under NCCL, the host under gloo."""
    if dist.get_backend(group) == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def all_reduce_(t: torch.Tensor, group=None) -> torch.Tensor:
    """Sum `t` over the group, in place (gloo takes CUDA tensors here)."""
    if group_size(group) > 1:
        dist.all_reduce(t, group=group)
    return t


def broadcast_(t: torch.Tensor, src: int, group=None) -> torch.Tensor:
    """`t` of global rank `src` into every rank's `t`, in place."""
    if group_size(group) > 1:
        dist.broadcast(t, src=src, group=group)
    return t


def all_gather(t: torch.Tensor, group=None, dim: int = 0) -> torch.Tensor:
    """The group's tensors (equal shapes) concatenated along `dim` in rank
    order, on `t`'s device."""
    n = group_size(group)
    if n == 1:
        return t
    src = t.detach().cpu().contiguous() if _staged(t, group) else t.contiguous()
    parts = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(parts, src, group=group)
    return torch.cat(parts, dim=dim).to(t.device)


def all_gather_object(obj: Any, group=None) -> List[Any]:
    """Every rank's picklable `obj`, in rank order."""
    n = group_size(group)
    if n == 1:
        return [obj]
    out: List[Any] = [None] * n
    dist.all_gather_object(out, obj, group=group)
    return out


def broadcast_object(obj: Any, src: int, group=None) -> Any:
    """The picklable `obj` of global rank `src` on every rank (the others
    pass anything, None for instance)."""
    if group_size(group) == 1:
        return obj
    box: List[Optional[Any]] = [obj]
    dist.broadcast_object_list(box, src=src, group=group)
    return box[0]


def _global_rank(group, index: int) -> int:
    return index if group is None else dist.get_global_rank(group, index)


def prepare_p2p(group=None) -> None:
    """Before point-to-point calls that involve only some ranks of `group`:
    under NCCL, one collective on the group, which sets up its
    communicator (NCCL wants every rank of a group in its first call).
    Nothing under gloo or on a group of one rank."""
    if group_size(group) > 1 and dist.get_backend(group) == "nccl":
        dist.all_reduce(torch.zeros(1, device=comm_device(group)), group=group)


def send_recv(send: Sequence[torch.Tensor] = (), dst: Optional[int] = None,
              recv: Sequence[torch.Tensor] = (), src: Optional[int] = None,
              group=None) -> List[torch.Tensor]:
    """Send the tensors `send` to the rank at group index `dst` and receive
    into `recv` (in place, in order) from group index `src`, all posted in
    one batch; either list may be empty. Returns `recv`. A call that
    involves only some ranks of the group follows prepare_p2p(group)."""
    ops, landing = [], []
    for t in send:
        buf = (t.detach().cpu() if _staged(t, group) else t).contiguous()
        ops.append(dist.P2POp(dist.isend, buf, _global_rank(group, dst), group))
    for t in recv:
        land = torch.empty(t.shape, dtype=t.dtype) if _staged(t, group) else t
        ops.append(dist.P2POp(dist.irecv, land, _global_rank(group, src), group))
        landing.append(land)
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    for t, land in zip(recv, landing):
        if land is not t:
            t.copy_(land)
    return list(recv)


def ring_shift(tensors: List[torch.Tensor], group=None) -> List[torch.Tensor]:
    """The `ppermute` of a ring: every rank sends each tensor to group
    index i + 1 (mod n) and gets back, in new tensors on the same devices,
    what index i - 1 sent, in one send_recv. A group of one rank returns
    `tensors`."""
    n = group_size(group)
    if n == 1:
        return list(tensors)
    me = dist.get_rank(group)
    fresh = [torch.empty(t.shape, dtype=t.dtype, device=t.device) for t in tensors]
    return send_recv(tensors, (me + 1) % n, fresh, (me - 1) % n, group)
