"""Parallelism: training ranks on the data axis (one process a device),
and serving's ``data × model`` grid of one process's devices with the
partition rules that lay weights over ``model``.

Port of ``deep_vision_tpu/parallel``'s mesh, multi-process and partition
modules; the pipeline's ``pipeline_apply``, ``stack_stages`` and
``unstack_stages`` come with the pipeline slice."""

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
]
