"""Process-group initialization and pod-aware meshes.

Port of ``deep_vision_tpu/parallel/distributed.py``.  The reference
wires ``jax.distributed`` (one process a host, holding every device of
the host); the port runs one process a card (a *rank*), joined by
``torch.distributed``:

    from deep_vision_tpu_torch.parallel import distributed
    distributed.initialize()          # no-op single-process; torchrun
    mesh = distributed.make_pod_mesh({"data": -1})

``initialize`` reads the variables ``python -m torch.distributed.run``
sets (``MASTER_ADDR``, ``MASTER_PORT``, ``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``); explicit arguments win over them.  The backend is NCCL
for a CUDA device and gloo for the CPU.  NCCL refuses two ranks on one
device, so two ranks share a card only under an explicit
``backend="gloo"`` (gloo takes CUDA tensors in ``broadcast`` and
``all_reduce`` only, which is all the device collectives of the port
use).  Every collective has a timeout, so a dead peer fails the run
rather than hanging it.
"""

from __future__ import annotations

import datetime
import math
import os
from typing import Mapping

import torch
import torch.distributed as dist

#: seconds any collective may wait for its peers before it fails the run
DEFAULT_TIMEOUT_S = 600.0

_STATE: dict = {}


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None,
               backend: str | None = None, device=None,
               timeout_s: float = DEFAULT_TIMEOUT_S) -> bool:
    """Join (or create) the process group; True once a group exists.

    A no-op returning False for a single process with nothing
    configured (no argument, no ``MASTER_ADDR``/``WORLD_SIZE`` in the
    environment).  ``coordinator_address`` is ``host:port`` of rank 0
    (default ``MASTER_ADDR:MASTER_PORT``); ``num_processes`` and
    ``process_id`` default to ``WORLD_SIZE`` and ``RANK``.  ``device``
    is the rank's device; by default ``cuda:LOCAL_RANK`` (set as the
    process's current device), which raises naming both numbers when
    the machine has fewer cards.  ``backend`` defaults to ``nccl`` on
    a CUDA device and ``gloo`` on the CPU."""
    if dist.is_initialized():
        return True
    env = os.environ
    if coordinator_address is None and "MASTER_ADDR" in env:
        coordinator_address = (f"{env['MASTER_ADDR']}:"
                               f"{env.get('MASTER_PORT', '29500')}")
    world = num_processes if num_processes is not None \
        else env.get("WORLD_SIZE")
    rank = process_id if process_id is not None else env.get("RANK")
    if coordinator_address is None and world is None:
        return False  # one process, nothing configured
    if coordinator_address is None:
        raise ValueError(
            f"a group of {world} processes needs a coordinator address "
            f"(coordinator_address= or MASTER_ADDR/MASTER_PORT)")
    world = 1 if world is None else int(world)
    rank = 0 if rank is None else int(rank)
    local_rank = int(env.get("LOCAL_RANK", rank))
    if device is None:
        count = torch.cuda.device_count()
        if local_rank >= count:
            raise RuntimeError(
                f"rank {rank} has LOCAL_RANK {local_rank}, but this machine "
                f"has {count} CUDA device(s); launch at most {count} ranks "
                f"a machine, or pass device= (two ranks share a card only "
                f"under backend='gloo'; --device cpu for the CPU)")
        device = torch.device("cuda", local_rank)
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available on this machine; pass device='cpu' "
                "(--device cpu) to run the ranks on the CPU")
        if device.index is None:
            device = torch.device("cuda", local_rank)
        torch.cuda.set_device(device)
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    if backend == "nccl" and device.type != "cuda":
        raise ValueError("backend 'nccl' needs a CUDA device")
    dist.init_process_group(
        backend, init_method=f"tcp://{coordinator_address}",
        world_size=world, rank=rank,
        timeout=datetime.timedelta(seconds=float(timeout_s)))
    _STATE["timeout_s"] = float(timeout_s)
    return True


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def process_index() -> int:
    """This rank (0 without a group)."""
    return dist.get_rank() if is_initialized() else 0


def process_count() -> int:
    """The number of ranks (1 without a group)."""
    return dist.get_world_size() if is_initialized() else 1


def backend() -> str | None:
    """The group's backend (None without a group)."""
    return dist.get_backend() if is_initialized() else None


def timeout_s() -> float:
    return float(_STATE.get("timeout_s", DEFAULT_TIMEOUT_S))


def shutdown() -> None:
    """Leave the group (idempotent)."""
    if is_initialized():
        dist.destroy_process_group()
    _STATE.clear()


def make_pod_mesh(axis_sizes: Mapping[str, int], dcn_axis: str = "data"):
    """The mesh of every rank; ``-1`` sizes resolve against the world
    size.  One process a card leaves no slice structure to order the
    axes by, so ``dcn_axis`` only names the axis that would span hosts
    (the data axis's collectives are the only ones in this slice)."""
    from deep_vision_tpu_torch.parallel.mesh import make_mesh

    world = process_count()
    names = list(axis_sizes)
    sizes = list(axis_sizes.values())
    if -1 in sizes:
        known = math.prod(s for s in sizes if s != -1)
        sizes[sizes.index(-1)] = world // known
    return make_mesh(dict(zip(names, sizes)))
