"""Continuous train→deploy pipeline: the hands-off loop.

Port of ``deep_vision_tpu/deploy``.  The pieces exist downstream: the
trainer writes checkpoints, ``core/restore.py`` fingerprints them from
filesystem metadata alone, and the control plane (serve/models.py) does
shadow → canary → auto-promote/rollback.  This package closes the loop:

  watcher.py    a supervised thread per model polls the checkpoint
                fingerprint (debounced across two intervals, so an
                in-progress async save never deploys half a
                checkpoint), runs the held-out ACCURACY GATE on the
                candidate, and only on pass hands it to
                ``plane.reload()`` for the normal gradual rollout;
  history.py    an append-only JSONL ledger per model — every
                candidate, gate verdict, promote/rollback/revert, with
                fingerprint + digest + metrics — behind
                ``GET /v1/deploy/{name}/history``, and the state
                ``POST /v1/deploy/{name}/revert`` rolls back to;
  autoscale.py  demand-side elasticity: scale ``ReplicatedEngine``
                replicas between ``--min-replicas``/``--max-replicas``
                on the admission controller's observed load, with
                hysteresis windows and a cooldown so it never flaps.

All control logic is stdlib-only (threads, Events, JSON); torch is
touched only through the serving models it manages.
"""

from deep_vision_tpu_torch.deploy.autoscale import ReplicaAutoscaler
from deep_vision_tpu_torch.deploy.history import DeploymentHistory
from deep_vision_tpu_torch.deploy.watcher import (
    AccuracyGate,
    CheckpointWatcher,
    DeployPipeline,
)

__all__ = [
    "AccuracyGate",
    "CheckpointWatcher",
    "DeployPipeline",
    "DeploymentHistory",
    "ReplicaAutoscaler",
]
