"""Pipeline (inter-layer) parallelism: a GPipe microbatch schedule over
the ``pipe`` places of a rank.

Port of ``deep_vision_tpu/parallel/pipeline.py``.  The reference stacks
``S`` same-shape stages on a leading axis, shards it over the ``pipe``
mesh axis, and runs ``M + n − 1`` ticks of a ``lax.scan`` inside
``shard_map``, handing each activation to the next device with a
``ppermute``; reverse-mode autodiff of the scan is the backward
pipeline.  Here the stages are ``nn.Module``s already placed on the
rank's pipe devices (``Mesh.pipe_devices``: device ``d`` holds stages
``d·S/n … (d+1)·S/n − 1``), and :func:`pipeline_apply` issues the same
schedule eagerly: at tick ``t`` place ``d`` runs microbatch ``m = t − d``
(``m + d = t``), so the work of distinct cards overlaps, and the
hand-off is ``.to(next device)``, whose autograd is the copy back.  No
bubble computes: a tick runs the real microbatches only, so the outputs
and gradients are those of the sequential stage loop over the same
microbatches.

As in the reference:

* microbatches are contiguous: microbatch ``m`` is rows ``m·mb …
  (m+1)·mb − 1`` of the rank's batch (``pipeline.py:144``; grad-accum
  splits the other, interleaved way, ``core/trainer.py``);
* a stage's BatchNorm normalizes by its microbatch alone (the
  reference's stage runs inside ``shard_map`` on the local data shard),
  and its running statistics move once per microbatch, in microbatch
  order; the caller averages them over the ``data`` ranks
  (``parallel/pipelined.py``);
* every stage's outputs come back in batch order.

``stack_stages``/``unstack_stages`` are the reference's layout helpers
over ``{name: tensor}`` dicts: the flax tree of a pipelined model holds
each stage leaf stacked on a leading ``S`` axis (``convert.py``).
"""

from __future__ import annotations

from typing import Any

import torch

from deep_vision_tpu_torch.parallel.mesh import DATA_AXIS, PIPE_AXIS

__all__ = ["PIPE_AXIS", "pipeline_apply", "stack_stages", "unstack_stages"]


def stack_stages(stage_dicts: list[dict]) -> dict:
    """Per-stage ``{name: array}`` dicts (the same names) → one dict of
    arrays with a leading stage axis (numpy or tensors)."""
    import numpy as np

    out = {}
    for k in stage_dicts[0]:
        leaves = [d[k] for d in stage_dicts]
        out[k] = torch.stack(leaves) if isinstance(leaves[0], torch.Tensor) \
            else np.stack([np.asarray(a) for a in leaves])
    return out


def unstack_stages(stacked: dict) -> list[dict]:
    """The inverse of :func:`stack_stages`."""
    n = next(iter(stacked.values())).shape[0]
    return [{k: v[i] for k, v in stacked.items()} for i in range(n)]


def _map(fn, tree: Any) -> Any:
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map(fn, t) for t in tree)
    raise TypeError(f"stage output of type {type(tree).__name__}")


def _cat(parts: list) -> Any:
    """Microbatch outputs (each the same tree of tensors) → one tree of
    tensors over the whole batch, in microbatch order (one microbatch's
    as it is)."""
    first = parts[0]
    if len(parts) == 1:
        return first
    if isinstance(first, torch.Tensor):
        return torch.cat(parts)
    return type(first)(_cat([p[i] for p in parts])
                       for i in range(len(first)))


def check_pipeline(mesh, num_stages: int, batch: int,
                   num_microbatches: int) -> None:
    """The reference's ``ValueError``s: a mesh of other axes than
    ``data`` and ``pipe``, stages that do not divide over the pipe
    places, a batch that does not divide into the microbatches."""
    extra = set(mesh.shape) - {PIPE_AXIS, DATA_AXIS}
    if extra:
        raise ValueError(f"pipeline_apply handles {{data, pipe}} meshes; "
                         f"mesh has extra axes {sorted(extra)}")
    n = int(mesh.shape[PIPE_AXIS])
    if num_stages % n:
        raise ValueError(f"stages S={num_stages} not divisible by pipe "
                         f"axis {n}")
    if batch % num_microbatches:
        raise ValueError(f"per-shard batch {batch} not divisible by "
                         f"num_microbatches={num_microbatches}")


def pipeline_apply(stages, x: torch.Tensor, mesh,
                   num_microbatches: int) -> list:
    """Run ``stages`` (``stage(carry) -> (carry, output)``, the carry's
    shape kept) as a microbatch pipeline over ``mesh.pipe_devices``.

    ``x`` is the rank's ``(B, ...)`` carry; ``B`` must divide into
    ``num_microbatches``.  Stage ``s`` must already sit on place
    ``s // (S/n)``.  Returns one output per stage, each the stage's
    output tree over the whole batch in batch order, on the first
    place."""
    S, B, M = len(stages), int(x.shape[0]), int(num_microbatches)
    check_pipeline(mesh, S, B, M)
    places = mesh.pipe_devices
    n = len(places)
    per = S // n
    carries = list(x.split(B // M))
    outs: list = [[None] * M for _ in range(S)]
    for t in range(M + n - 1):
        for d in range(min(t, n - 1), -1, -1):
            m = t - d
            if m >= M:
                continue
            c = carries[m].to(places[d])
            for s in range(d * per, (d + 1) * per):
                c, outs[s][m] = stages[s](c)
            carries[m] = c
    return [_map(lambda o: o.to(places[0]), _cat(o)) for o in outs]
