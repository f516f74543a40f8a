"""The ranks of a training run on named axes: the port's one source of
parallelism.

Port of ``deep_vision_tpu/parallel/mesh.py``.  The reference's
``jax.sharding.Mesh`` puts devices on named axes, shards batches over
``data`` and lets XLA insert the gradient all-reduce.  The port runs one
process a device (a *rank*, ``parallel/distributed.py``), so a device of
the mesh is a rank, and the collectives are explicit calls of
:class:`Mesh` on the ``torch.distributed`` group:

* a batch is the rank's local shard (the reference's multi-process
  semantics: each process contributes its host batch to the global
  array), so :func:`shard_batch` checks the global batch and moves the
  shard to the rank's device;
* the trainers all-reduce the gradients once a step over a flat buffer
  (``core/trainer.py``), the BatchNorm layers their per-channel sums
  (``models/common.py``), and :func:`replicate` broadcasts rank 0's
  weights.

The rank mesh has the ``data`` axis over ranks and, for the pipeline
training mode (``parallel/pipelined.py``), a ``pipe`` axis inside each
rank: ``Mesh.pipe_devices``, the rank's own grid of places, as the
reference lays ``data`` across processes and ``pipe`` within each
(``tests/dist_pipe_worker.py``).  With an explicit device (``cpu`` or
``cuda:K``) every pipe place is that device; with a plain ``cuda``, rank
``r`` of ``pipe=p`` takes the machine's cards ``r·p … r·p+p−1``, and a
machine with fewer raises (no place falls back to the CPU or to fewer
cards).  The reference's trainer never shards over ``model``, and a
``spatial`` axis above 1 raises naming the module still to be ported.
``torch.distributed.device_mesh.DeviceMesh`` is not used: with one axis
and one process a device it would add a CUDA-or-CPU device type to the
group without changing a collective.

Serving's mesh is the other form (:class:`LocalMesh`):
``make_mesh({"data": D, "model": M}, devices=[torch.device, ...])``
lays this process's own devices on a ``data × model`` grid, as the
reference's single-controller server lays its local chips.  One process
drives every device of the grid (``serve/mesh_view.py``): no ranks, no
process group.  A device may repeat (``[cuda:0] * 4``, ``["cpu"] * 4``),
as ``ReplicatedEngine(devices=[cuda:0, cuda:0])`` allows.

Device collectives (``all_reduce_``, ``broadcast_``) take tensors on the
rank's device and use only ``all_reduce`` and ``broadcast``, the two
collectives gloo also runs on CUDA tensors, so the same code runs under
NCCL, under gloo on the CPU and under gloo with two ranks on one card.
Host collectives (a flag, a barrier, pickled objects) run on a gloo
group of the same ranks on the CPU.
"""

from __future__ import annotations

import math
from typing import Any, Mapping

import numpy as np
import torch
import torch.distributed as dist

from deep_vision_tpu_torch.parallel import distributed

DATA_AXIS = "data"
MODEL_AXIS = "model"
SPATIAL_AXIS = "spatial"  # image-row (context) axis
PIPE_AXIS = "pipe"

#: where each axis other than ``data`` stands for the rank mesh
LATER_AXES = {
    MODEL_AXIS: "is serving's alone: a grid of this process's devices "
                "(make_mesh(..., devices=[torch.device, ...]) with "
                "parallel/partition.py); the trainer never shards over "
                "it, as the reference's does not",
    SPATIAL_AXIS: "is not ported yet (parallel/spatial.py)",
    PIPE_AXIS: "is the trainer's: a rank's own grid of pipeline places "
               "(make_mesh({'data': d, 'pipe': p}, pipe_device=...), "
               "parallel/pipelined.py); serving runs the monolithic "
               "network",
}


class Mesh:
    """``shape`` (axis name → size) over the ranks of the process group
    (none: one rank, every collective a no-op).  ``rank`` is this
    process's place on the data axis; ``devices`` the rank grid;
    ``pipe_devices`` the rank's pipeline places (``torch.device``s, one a
    place of the ``pipe`` axis; empty without that axis)."""

    def __init__(self, shape: Mapping[str, int], pipe_devices=()):
        self.shape = dict(shape)
        self.pipe_devices = [torch.device(d) for d in pipe_devices]
        self.axis_names = tuple(self.shape)
        self.size = math.prod(self.shape.values())
        self.grouped = distributed.is_initialized()
        self.rank = distributed.process_index()
        self.backend = distributed.backend()
        # host collectives run on gloo; the group's own is gloo already
        self._host = None
        if self.grouped and self.backend != "gloo":
            self._host = dist.new_group(
                backend="gloo", timeout=_timeout())

    def __deepcopy__(self, memo):  # a model's layers hold it; never copy
        return self

    def __repr__(self) -> str:
        pipe = f", pipe={self.pipe_devices}" if self.pipe_devices else ""
        return (f"Mesh({self.shape}, rank={self.rank}, "
                f"backend={self.backend}{pipe})")

    @property
    def devices(self) -> np.ndarray:
        """The ranks, shaped as the rank axes (every axis but ``pipe``,
        which lies inside a rank)."""
        return np.arange(self.size // self.pipe_size).reshape(tuple(
            v for k, v in self.shape.items() if k != PIPE_AXIS))

    @property
    def data_size(self) -> int:
        return int(self.shape.get(DATA_AXIS, 1))

    @property
    def pipe_size(self) -> int:
        return int(self.shape.get(PIPE_AXIS, 1))

    @property
    def reduces(self) -> bool:
        """More than one rank on the data axis: batch statistics and
        gradients must be reduced across ranks."""
        return self.data_size > 1

    @property
    def is_writer(self) -> bool:
        """Rank 0 writes the run's files; the others wait at barriers."""
        return self.rank == 0

    # ---------------------------------------------------- device collectives

    def all_reduce_(self, tensor: torch.Tensor) -> torch.Tensor:
        """Sum ``tensor`` over the ranks in place (a no-op without a
        group; an identity collective in a group of one rank)."""
        if self.grouped:
            dist.all_reduce(tensor)
        return tensor

    def mean_(self, tensors: list[torch.Tensor]) -> list[torch.Tensor]:
        """The ranks' mean of each tensor, through one all-reduce of a
        float32 buffer of their values a device (``Σ / ranks``; a group
        of one rank divides by nothing).  Returns new tensors,
        contiguous, in the order, shapes and dtypes given."""
        if not self.grouped:
            return list(tensors)
        out: list = [None] * len(tensors)
        for idx in _by_device(tensors).values():
            part = [tensors[i] for i in idx]
            flat = torch.cat([t.detach().reshape(-1).to(torch.float32)
                              for t in part])
            self.all_reduce_(flat)
            if self.data_size > 1:
                flat.div_(float(self.data_size))
            for i, c, t in zip(idx, flat.split([t.numel() for t in part]),
                               part):
                out[i] = c.view(t.shape).to(t.dtype)
        return out

    @torch.no_grad()
    def broadcast_(self, tensors: list[torch.Tensor], src: int = 0) -> None:
        """Overwrite ``tensors`` with rank ``src``'s values, one flat
        broadcast a dtype and device."""
        if not self.grouped:
            return
        groups: dict = {}
        for t in tensors:
            groups.setdefault((t.dtype, t.device), []).append(t)
        for ts in groups.values():
            flat = torch.cat([t.reshape(-1) for t in ts])
            dist.broadcast(flat, src)
            for c, t in zip(flat.split([t.numel() for t in ts]), ts):
                t.copy_(c.view(t.shape))

    # ------------------------------------------------------ host collectives

    def any(self, flag: bool) -> bool:
        """True on every rank when ``flag`` is True on any."""
        if not self.grouped:
            return bool(flag)
        t = torch.tensor([int(bool(flag))], dtype=torch.int32)
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self._host)
        return bool(t.item())

    def barrier(self) -> None:
        if self.grouped:
            dist.barrier(group=self._host)

    def gather_objects(self, obj: Any) -> list | None:
        """Every rank's ``obj`` in rank order on rank 0, None elsewhere."""
        if not self.grouped:
            return [obj]
        out = [None] * dist.get_world_size() if self.is_writer else None
        dist.gather_object(obj, out, dst=0, group=self._host)
        return out

    def broadcast_object(self, obj: Any) -> Any:
        """Rank 0's ``obj`` on every rank."""
        if not self.grouped:
            return obj
        box = [obj]
        dist.broadcast_object_list(box, src=0, group=self._host)
        return box[0]


def _by_device(tensors: list[torch.Tensor]) -> dict:
    """``{device: [index, ...]}`` of ``tensors``, in order."""
    groups: dict = {}
    for i, t in enumerate(tensors):
        groups.setdefault(t.device, []).append(i)
    return groups


def pipe_places(size: int, device=None, local_rank: int | None = None
                ) -> list[torch.device]:
    """The ``size`` pipeline places of this rank: ``device`` at every
    place when it is ``cpu`` or names a card (``cuda:K``); otherwise
    (None or a plain ``cuda``) the machine's cards ``r·size …
    r·size+size−1`` for local rank ``r`` (``LOCAL_RANK``, else the
    rank).  Raises the reference's ``ValueError`` when the machine has
    fewer cards: no place falls back to the CPU."""
    if device is not None:
        dev = torch.device(device)
        if dev.type == "cpu" or dev.index is not None:
            return [dev] * size
    if local_rank is None:
        local_rank = distributed.local_rank()
    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    first = local_rank * size
    if first + size > count:
        raise ValueError(f"mesh {{'{PIPE_AXIS}': {size}}} of local rank "
                         f"{local_rank} needs {first + size} devices, have "
                         f"{count}")
    return [torch.device("cuda", first + i) for i in range(size)]


def _timeout():
    import datetime

    return datetime.timedelta(seconds=distributed.timeout_s())


class LocalMesh:
    """A ``data × model`` grid of this process's devices: ``shape`` (axis
    name → size, as given), ``devices`` the ``(D, M)`` object array of
    ``torch.device`` (row ``r`` is data shard ``r``; its first device
    runs what is not split over ``model``)."""

    def __init__(self, shape: Mapping[str, int], grid: np.ndarray):
        self.shape = dict(shape)
        self.axis_names = tuple(self.shape)
        self.size = math.prod(self.shape.values())
        self.devices = grid

    def __repr__(self) -> str:
        return f"LocalMesh({self.shape}, {self.device_list()})"

    @property
    def data_size(self) -> int:
        return int(self.shape.get(DATA_AXIS, 1))

    @property
    def model_size(self) -> int:
        return int(self.shape.get(MODEL_AXIS, 1))

    def device_list(self) -> list:
        return [d for row in self.devices for d in row]


def _is_local(devices) -> bool:
    return any(isinstance(d, (torch.device, str)) for d in devices)


def _local_mesh(names, sizes, devices) -> LocalMesh:
    for name, size in zip(names, sizes):
        if name not in (DATA_AXIS, MODEL_AXIS) and size > 1:
            raise NotImplementedError(
                f"mesh axis '{name}'={size}: a local device grid has the "
                f"'{DATA_AXIS}' and '{MODEL_AXIS}' axes; '{name}' "
                f"{LATER_AXES.get(name, 'is not ported yet')}")
    shape = dict(zip(names, sizes))
    d, m = int(shape.get(DATA_AXIS, 1)), int(shape.get(MODEL_AXIS, 1))
    grid = np.empty((d, m), dtype=object)
    for i, dev in enumerate(devices[:d * m]):
        grid[i // m, i % m] = torch.device(dev)
    return LocalMesh(shape, grid)


def make_mesh(axis_sizes: Mapping[str, int] | None = None,
              devices=None, pipe_device=None):
    """A :class:`Mesh` of the process group's ranks (``devices`` the
    ranks, default ``range(world size)``), or with ``devices`` given as
    ``torch.device``s (or their names) a :class:`LocalMesh` of them.
    Default: everything on the ``data`` axis.  ``-1`` means all the
    remaining ranks or devices.  A ``pipe`` axis lies inside each rank:
    its places are :func:`pipe_places` of ``pipe_device``."""
    if devices is None:
        devices = list(range(distributed.process_count()))
    local = _is_local(devices)
    if axis_sizes is None:
        axis_sizes = {DATA_AXIS: len(devices)}
    names = tuple(axis_sizes.keys())
    sizes = list(axis_sizes.values())
    if -1 in sizes:
        # the pipe axis of a rank mesh lies inside a rank: no rank's share
        known = math.prod(s for n, s in zip(names, sizes) if s != -1
                          and (local or n != PIPE_AXIS))
        sizes[sizes.index(-1)] = len(devices) // known
    shape = dict(zip(names, sizes))
    total = math.prod(sizes)
    if local:
        if total > len(devices):
            raise ValueError(f"mesh {shape} needs {total} devices, "
                             f"have {len(devices)}")
        return _local_mesh(names, sizes, list(devices))
    # the pipe axis lies inside a rank: the others are the ranks
    ranks = total // int(shape.get(PIPE_AXIS, 1))
    if ranks > len(devices):
        raise ValueError(f"mesh {shape} needs {ranks} devices, have "
                         f"{len(devices)}")
    for name, size in zip(names, sizes):
        if name not in (DATA_AXIS, PIPE_AXIS) and size > 1:
            raise NotImplementedError(
                f"mesh axis '{name}'={size}: the rank mesh has the "
                f"'{DATA_AXIS}' axis over ranks and '{PIPE_AXIS}' within "
                f"each; '{name}' {LATER_AXES.get(name, 'is not ported yet')}")
    if ranks < len(devices):
        raise ValueError(
            f"mesh {shape} uses {ranks} of the {len(devices)} ranks; "
            f"every rank of the group must be on the mesh (one process a "
            f"device)")
    places = ()
    if PIPE_AXIS in shape:
        places = pipe_places(int(shape[PIPE_AXIS]), pipe_device)
    return Mesh(shape, places)


def batch_sharding(mesh: Mesh, ndim: int = 0) -> tuple:
    """The placement of a batch leaf, as the reference's
    ``PartitionSpec``: dim 0 over ``data``, the rest whole."""
    del mesh
    return (DATA_AXIS,) + (None,) * max(ndim - 1, 0)


def replicated_sharding(mesh: Mesh) -> tuple:
    """The placement of a replicated leaf: every rank holds it whole."""
    del mesh
    return ()


def _check_global(local: int, mesh: Mesh) -> None:
    global_batch = local * distributed.process_count()
    if global_batch % mesh.data_size != 0:
        raise ValueError(
            f"global batch {global_batch} (local {local}) not "
            f"divisible by data axis {mesh.data_size}")


def shard_batch(batch: dict, mesh: Mesh, device=None) -> dict:
    """The rank's batch on ``device``: a host batch is this rank's local
    shard of the global batch (each rank's loader yields its own), which
    must split over the data axis; 0-d leaves are replicated."""
    from deep_vision_tpu_torch.core.trainer import to_device

    for v in batch.values():
        if np.ndim(v) > 0:
            _check_global(int(np.shape(v)[0]), mesh)
    return batch if device is None else to_device(batch, device)


def shard_batch_stacked(batch: dict, mesh: Mesh, device=None) -> dict:
    """:func:`shard_batch` for K-stacked batches: leaves are (K, B, ...)
    — dim 0 the step axis, dim 1 the rank's batch."""
    from deep_vision_tpu_torch.core.trainer import to_device

    for v in batch.values():
        if np.ndim(v) > 1:
            _check_global(int(np.shape(v)[1]), mesh)
    return batch if device is None else to_device(batch, device)


def replicate(tree: Any, mesh: Mesh) -> Any:
    """Rank 0's values on every rank, in place: a module's parameters and
    buffers, a train state's (with its EMA), or a list or dict of
    tensors.  Every rank builds the same init from the same seed (or
    reads the same checkpoint); the broadcast makes it so."""
    mesh.broadcast_(_tensors(tree))
    return tree


def _tensors(tree: Any) -> list[torch.Tensor]:
    if isinstance(tree, torch.nn.Module):
        return [t.data for t in tree.parameters()] + list(tree.buffers())
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _tensors(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _tensors(v)]
    if hasattr(tree, "model"):  # a TrainState
        return _tensors(tree.model) + [e for e in getattr(tree, "ema", [])]
    raise TypeError(f"cannot replicate a {type(tree).__name__}")
