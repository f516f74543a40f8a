"""Workload adapters: what the serving tier knows per model kind.

Port of the classify half of ``deep_vision_tpu/serve/workloads.py``: the
``SLO`` service class, the ``Workload`` base and ``ClassifyWorkload``
(dense-logits rows → ``{"model", "top": [{class, prob, logit}]}``).  The
other verbs, and classify's cascade top-k epilogue, wait for later
slices.
"""

from __future__ import annotations

import numpy as np


class SLO:
    """A workload's service class: the default per-request deadline and
    the per-model admission queue bound."""

    def __init__(self, name: str, deadline_ms: float, max_queue: int):
        self.name = name
        self.deadline_ms = float(deadline_ms)
        self.max_queue = int(max_queue)

    def bound_queue(self, requested: int) -> int:
        """The operator's ``--max-queue`` capped by this class."""
        return min(int(requested), self.max_queue)


class Workload:
    """Base adapter; stateless, one shared instance per verb."""

    verb = ""
    slo = SLO("interactive", deadline_ms=30_000.0, max_queue=256)

    def respond(self, model, body: dict, row) -> dict:
        raise NotImplementedError


class ClassifyWorkload(Workload):
    verb = "classify"
    slo = SLO("interactive", deadline_ms=30_000.0, max_queue=256)

    @staticmethod
    def top1(row):
        """``(class, prob)`` of a dense-logits row, or ``(None, None)``
        for a row with no top-1."""
        if isinstance(row, np.ndarray) and row.ndim >= 1 and row.size:
            logits = row.astype(np.float64)
            z = np.exp(logits - logits.max())
            c = int(np.argmax(logits))
            return c, float(z[c] / z.sum())
        return None, None

    def respond(self, model, body: dict, row) -> dict:
        logits = np.asarray(row)
        k = min(int(body.get("top_k", 5)), logits.shape[-1])
        top = np.argsort(logits)[-k:][::-1]
        z = np.exp(logits - logits.max())
        probs = z / z.sum()
        return {"model": model.name,
                "top": [{"class": int(c), "prob": float(probs[c]),
                         "logit": float(logits[c])} for c in top]}


WORKLOADS = {"classify": ClassifyWorkload()}
_BY_TASK = {"classification": "classify"}


def workload_for_task(task: str) -> Workload:
    """The adapter serving ``task``; tasks of later slices raise."""
    verb = _BY_TASK.get(str(task))
    if verb is None:
        raise ValueError(f"task '{task}' has no serving workload in this "
                         f"port yet (have {sorted(_BY_TASK)})")
    return WORKLOADS[verb]
