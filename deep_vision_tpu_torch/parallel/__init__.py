"""Parallelism over ranks (one process a device): the data axis.

Port of ``deep_vision_tpu/parallel``'s mesh and multi-process modules;
the pipeline's ``pipeline_apply``, ``stack_stages`` and
``unstack_stages`` come with the pipeline slice."""

from deep_vision_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    PIPE_AXIS,
    SPATIAL_AXIS,
    Mesh,
    batch_sharding,
    make_mesh,
    replicate,
    replicated_sharding,
    shard_batch,
    shard_batch_stacked,
)

__all__ = [
    "DATA_AXIS",
    "MODEL_AXIS",
    "PIPE_AXIS",
    "SPATIAL_AXIS",
    "Mesh",
    "make_mesh",
    "replicate",
    "shard_batch",
    "shard_batch_stacked",
    "batch_sharding",
    "replicated_sharding",
]
