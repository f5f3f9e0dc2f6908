"""Multi-process and multi-host set-up: process-group init, global meshes,
host-local feeding (counterpart of freeze_omni_tpu/parallel/multihost.py).

The JAX package runs one process per host, each owning that host's chips.
The port runs one process per card: a host with k cards runs k processes,
laid out host-major, rank = host_id * k + local_rank, so a global mesh's
leading (data) axis spans hosts and its model axis stays inside one host.

The backend is NCCL when every local rank has a CUDA card of its own, and
gloo for CPU ranks and for ranks that share a card (NCCL refuses two ranks
on one device). It is chosen from the device and the card count before
init (`choose_backend`), never by catching an NCCL error. gloo runs
`broadcast` and `all_reduce` on CUDA tensors; parallel/collectives stages
the other collectives through the host.
"""

from __future__ import annotations

import atexit
import json
import os
import socket
import subprocess
import sys
from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

# The job's layout, set by `initialize` (torch.distributed keeps the rest of
# the job's state process-wide too): hosts, and processes on each host.
_LAYOUT = {"num_hosts": 1, "local_ranks": 1}


def choose_backend(device, local_ranks: int) -> str:
    """The backend of a job with `local_ranks` processes on each host:
    NCCL when the host has a CUDA card for every local rank, else gloo (CPU
    ranks, or ranks sharing the cards in turn). `device` is the serving
    device ("cpu", "cuda" or None for the card)."""
    dev = torch.device(device) if device is not None else torch.device("cuda")
    if dev.type == "cpu":
        return "gloo"
    n = torch.cuda.device_count()
    if n == 0:
        raise RuntimeError("a CUDA rank on a host without a CUDA card")
    return "nccl" if n >= local_ranks else "gloo"


def rank_device(device, local_rank: int) -> torch.device:
    """The device of local rank `local_rank`: the host for CPU ranks, a
    card `device` names, else card local_rank (taken in turn where ranks
    share the cards)."""
    dev = torch.device(device) if device is not None else torch.device("cuda")
    if dev.type == "cpu" or dev.index is not None:
        return dev
    return torch.device("cuda", local_rank % torch.cuda.device_count())


def initialize(coordinator: str, num_hosts: int, host_id: int,
               local_ranks: int = 1, local_rank: int = 0,
               device=None, backend: Optional[str] = None) -> torch.device:
    """Join the job: `num_hosts * local_ranks` processes, this one at rank
    host_id * local_ranks + local_rank, rendezvous at tcp://coordinator.
    Returns this rank's device (a CUDA rank's card is made current).
    `backend` defaults to choose_backend(device, local_ranks); a caller
    whose "hosts" share one machine's cards chooses it for the machine."""
    backend = backend or choose_backend(device, local_ranks)
    dev = rank_device(device, local_rank)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    _LAYOUT.update(num_hosts=num_hosts, local_ranks=local_ranks)
    dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                            world_size=num_hosts * local_ranks,
                            rank=host_id * local_ranks + local_rank)
    return dev


def resolve_job(coordinator: Optional[str], num_hosts: int, host_id: int
                ) -> Optional[Tuple[str, int, int]]:
    """(coordinator, num_hosts, host_id) of a multi-host job from the flags
    or the FO_COORDINATOR / FO_NUM_HOSTS / FO_HOST_ID env triple (which
    wins); None without a coordinator."""
    coordinator = coordinator or os.environ.get("FO_COORDINATOR")
    if not coordinator:
        return None
    num_hosts = int(os.environ.get("FO_NUM_HOSTS", num_hosts))
    host_id = int(os.environ.get("FO_HOST_ID", host_id))
    if num_hosts < 2:
        raise ValueError("--coordinator given but --num_hosts < 2")
    return coordinator, num_hosts, host_id


def maybe_initialize_from_args(coordinator: Optional[str], num_hosts: int,
                               host_id: int, local_ranks: int = 1,
                               local_rank: int = 0, device=None) -> bool:
    """CLI glue: initialize iff a coordinator was given (or the env triple
    of `resolve_job` is set). Returns True when running multi-host."""
    job = resolve_job(coordinator, num_hosts, host_id)
    if job is None:
        return False
    initialize(*job, local_ranks, local_rank, device)
    return True


def join_local_ranks(module: str, argv: List[str], local_ranks: int,
                     env_name: str, device, coordinator: Optional[str],
                     num_hosts: int, host_id: int
                     ) -> Tuple[torch.device, List[subprocess.Popen]]:
    """The CLIs' job of `local_ranks` processes a host (bin/serve --tp,
    bin/train over a host's cards). Local rank 0 of a host starts the
    others first: `python -m module *argv` (its own command line, so every
    rank parses the same flags), each with its place in the env variable
    `env_name`. The job is --coordinator's hosts (maybe_initialize_from_args)
    or else this host alone, met at a free localhost port. Returns this
    rank's device and the processes it started, which are killed at exit
    unless reaped first (after a failed start they would wait for rank 0
    forever)."""
    place = json.loads(os.environ.get(env_name, "{}"))
    local_rank, local_coord = place.get("local_rank", 0), place.get("coordinator")
    if resolve_job(coordinator, num_hosts, host_id) is None and local_coord is None:
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            local_coord = f"127.0.0.1:{s.getsockname()[1]}"
    started: List[subprocess.Popen] = []
    if local_rank == 0 and local_ranks > 1:
        atexit.register(_kill_ranks, started)
        for r in range(1, local_ranks):
            env = dict(os.environ, **{env_name: json.dumps(
                {"local_rank": r, "coordinator": local_coord})})
            started.append(subprocess.Popen([sys.executable, "-m", module, *argv],
                                            env=env))
    if not maybe_initialize_from_args(coordinator, num_hosts, host_id,
                                      local_ranks, local_rank, device):
        initialize(local_coord, 1, 0, local_ranks, local_rank, device)
    return rank_device(device, local_rank), started


def reap_ranks(procs: List[subprocess.Popen], timeout: float) -> List[int]:
    """The exit codes of the processes join_local_ranks started, each
    waited for up to `timeout` seconds and killed if it still runs."""
    codes = []
    for p in procs:
        try:
            codes.append(p.wait(timeout=timeout))
        except subprocess.TimeoutExpired:
            p.kill()
            codes.append(p.wait())
    return codes


def _kill_ranks(procs: List[subprocess.Popen]) -> None:
    """Kill the processes of `procs` that still run."""
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.wait()


def is_primary() -> bool:
    return not dist.is_initialized() or dist.get_rank() == 0


def host_index() -> int:
    """This process's host in the job (0 outside one)."""
    return dist.get_rank() // _LAYOUT["local_ranks"] if dist.is_initialized() else 0


def make_global_mesh(axes: Tuple[str, ...] = ("data",), model_par: int = 1):
    """A global mesh with the host boundary respected.

    1-D ('data',): every rank on the data axis, hosts outermost (pure DP);
    1-D (X,) with X 'model', 'seq' or 'stage': every rank on that axis.
    2-D ('data', X): model_par (the size of X) must divide the per-host
    process count so that every group of X lives inside one host (its
    per-layer collectives must not cross hosts); 'data' spans hosts."""
    from .mesh import make_mesh

    n = dist.get_world_size() if dist.is_initialized() else 1
    local = _LAYOUT["local_ranks"] if dist.is_initialized() else 1
    if len(axes) == 1:
        return make_mesh((n,), tuple(axes))
    if len(axes) != 2:
        raise ValueError(f"axes must be 1-D or 2-D, got {axes}")
    if model_par > local or local % model_par != 0:
        raise ValueError(
            f"model_par={model_par} must divide the per-host device count "
            f"{local}: tensor-parallel groups may not straddle hosts (their "
            f"per-layer collectives would cross the host network)")
    return make_mesh((n // model_par, model_par), tuple(axes))


def local_batch_slice(batch: dict, num_hosts: int, host_id: int) -> dict:
    """Every host builds the same global batch (same seed/manifest order);
    each keeps only its contiguous row block. Requires the leading dim to be
    divisible by num_hosts."""
    out = {}
    for k, v in batch.items():
        v = np.asarray(v)
        if v.shape[0] % num_hosts != 0:
            raise ValueError(
                f"batch[{k!r}] leading dim {v.shape[0]} not divisible by "
                f"{num_hosts} hosts")
        per = v.shape[0] // num_hosts
        out[k] = v[host_id * per:(host_id + 1) * per]
    return out


def sync(tag: str = "sync") -> None:
    """Barrier across all processes (`tag` names it in a hang's traceback)."""
    if dist.is_initialized():
        dist.barrier()


def shutdown() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()
    _LAYOUT.update(num_hosts=1, local_ranks=1)


def tree_checksum(tree) -> float:
    """Order-independent scalar digest of a tree's float values (tensors or
    arrays in nested dicts/lists/tuples): a cheap cross-rank divergence
    probe (identical params give identical checksums)."""
    total = 0.0
    stack = [tree]
    while stack:
        x = stack.pop()
        if isinstance(x, dict):
            stack.extend(x.values())
        elif isinstance(x, (list, tuple)):
            stack.extend(x)
        elif isinstance(x, torch.Tensor):
            if x.is_floating_point():
                total += float(x.detach().double().abs().sum())
        elif isinstance(x, np.ndarray) and np.issubdtype(x.dtype, np.floating):
            total += float(np.abs(x.astype(np.float64)).sum())
    return total
