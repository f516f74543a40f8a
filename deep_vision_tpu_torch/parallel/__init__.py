"""Parallelism: training ranks on the data axis (one process a device)
with each rank's pipeline places on the ``pipe`` axis, and serving's
``data × model`` grid of one process's devices with the partition rules
that lay weights over ``model``.

Port of ``deep_vision_tpu/parallel``'s mesh, multi-process, partition
and pipeline modules (``pipeline_apply``, ``stack_stages``,
``unstack_stages``; the training mode in ``parallel/pipelined.py``)."""

from deep_vision_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    PIPE_AXIS,
    SPATIAL_AXIS,
    LocalMesh,
    Mesh,
    batch_sharding,
    make_mesh,
    replicate,
    replicated_sharding,
    shard_batch,
    shard_batch_stacked,
)
from deep_vision_tpu_torch.parallel.pipeline import (
    pipeline_apply,
    stack_stages,
    unstack_stages,
)

__all__ = [
    "DATA_AXIS",
    "MODEL_AXIS",
    "PIPE_AXIS",
    "SPATIAL_AXIS",
    "LocalMesh",
    "Mesh",
    "make_mesh",
    "replicate",
    "shard_batch",
    "shard_batch_stacked",
    "batch_sharding",
    "replicated_sharding",
    "pipeline_apply",
    "stack_stages",
    "unstack_stages",
]
