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

Only the ``data`` axis is ported in this slice; a ``model``, ``spatial``
or ``pipe`` axis above 1 raises naming the slice that brings it.
``torch.distributed.device_mesh.DeviceMesh`` is not used: with one axis
and one process a device it would add a CUDA-or-CPU device type to the
group without changing a collective.

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

#: the slice of the port that brings each axis other than ``data``
LATER_AXES = {
    MODEL_AXIS: "serving's mesh (parallel/partition.py)",
    SPATIAL_AXIS: "the pipeline and spatial slice (parallel/spatial.py)",
    PIPE_AXIS: "the pipeline and spatial slice (parallel/pipeline.py)",
}


class Mesh:
    """``shape`` (axis name → size) over the ranks of the process group
    (none: one rank, every collective a no-op).  ``rank`` is this
    process's place on the data axis; ``devices`` the rank grid."""

    def __init__(self, shape: Mapping[str, int]):
        self.shape = dict(shape)
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
        return (f"Mesh({self.shape}, rank={self.rank}, "
                f"backend={self.backend})")

    @property
    def devices(self) -> np.ndarray:
        """The ranks, shaped as the axes."""
        return np.arange(self.size).reshape(tuple(self.shape.values()))

    @property
    def data_size(self) -> int:
        return int(self.shape.get(DATA_AXIS, 1))

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
        float32 buffer of their values (``Σ / ranks``; a group of one
        rank divides by nothing).  Returns new tensors, contiguous, in
        the shapes and dtypes given."""
        if not self.grouped:
            return list(tensors)
        flat = torch.cat([t.detach().reshape(-1).to(torch.float32)
                          for t in tensors])
        self.all_reduce_(flat)
        if self.data_size > 1:
            flat.div_(float(self.data_size))
        return [c.view(t.shape).to(t.dtype) for c, t in
                zip(flat.split([t.numel() for t in tensors]), tensors)]

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


def _timeout():
    import datetime

    return datetime.timedelta(seconds=distributed.timeout_s())


def make_mesh(axis_sizes: Mapping[str, int] | None = None,
              devices=None) -> Mesh:
    """A :class:`Mesh` of the process group's ranks.  Default: every rank
    on the ``data`` axis.  ``-1`` means all remaining ranks.  ``devices``
    (the ranks) defaults to ``range(world size)``."""
    if devices is None:
        devices = list(range(distributed.process_count()))
    if axis_sizes is None:
        axis_sizes = {DATA_AXIS: len(devices)}
    names = tuple(axis_sizes.keys())
    sizes = list(axis_sizes.values())
    if -1 in sizes:
        known = math.prod(s for s in sizes if s != -1)
        sizes[sizes.index(-1)] = len(devices) // known
    total = math.prod(sizes)
    if total > len(devices):
        raise ValueError(
            f"mesh {dict(zip(names, sizes))} needs {total} devices, "
            f"have {len(devices)}")
    for name, size in zip(names, sizes):
        if name != DATA_AXIS and size > 1:
            raise NotImplementedError(
                f"mesh axis '{name}'={size}: the port has only the "
                f"'{DATA_AXIS}' axis so far; '{name}' comes with "
                f"{LATER_AXES.get(name, 'a later slice')}")
    if total < len(devices):
        raise ValueError(
            f"mesh {dict(zip(names, sizes))} uses {total} of the "
            f"{len(devices)} ranks; every rank of the group must be on "
            f"the mesh (one process a device)")
    return Mesh(dict(zip(names, sizes)))


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
