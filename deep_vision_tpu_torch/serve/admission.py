"""Admission control: shed doomed work at the door, not after the queue.

Copy of ``deep_vision_tpu/serve/admission.py`` (``Shed``,
``AdmissionController``) for one engine; the replica divisor and the
per-tenant QoS classes wait for later slices.

Two bounds, both checked at submit time (and deadlines re-checked at
batch-formation time, so a request that expired while queued is dropped
rather than executed late):

  * queue depth — beyond ``max_queue`` the engine is over capacity and
    every additional request only adds latency for everyone; reject
    immediately so the client can retry against another replica.
  * deadline feasibility — if ``now + estimated_service_time`` already
    exceeds the request's deadline, executing it wastes a batch slot on
    an answer nobody will read.  The estimate is the batcher's drain
    window plus PER-BUCKET EWMAs of recent batch execution time — a
    request that will pad into the 32-bucket is judged by the
    32-bucket's history, not by a global average dragged down by
    1-image batches — scaled by the pipelined engine's current
    in-flight depth (each outstanding batch adds roughly one more
    execution before this request's batch reaches the device).
    Pessimistic before any batch has run: only already-expired
    deadlines are shed.
"""

from __future__ import annotations

import dataclasses
import threading
import time

from deep_vision_tpu_torch.obs.log import event, get_logger

_log = get_logger("dvt.serve.admission")


@dataclasses.dataclass
class Shed:
    """Result delivered to a request the engine refused to execute.

    ``retry_after_s`` is a hint for the client (surfaced as the HTTP
    ``Retry-After`` header on 429s): for ``queue_full`` it is the
    current estimated service time — when the backlog should have
    drained enough to admit a retry.  Deadline sheds carry the same
    bucket-EWMA estimate: the first attempt's deadline is dead either
    way, but the estimate is when a FRESH deadline stops being doomed
    on arrival, so clients back off instead of immediately re-offering
    work the estimator will shed again.  Shutdown sheds carry no hint
    (this server is going away)."""

    reason: str   # "queue_full" | "deadline" | "shutdown"
    detail: str = ""
    retry_after_s: float | None = None

    def __bool__(self):  # `if result:` reads as "was served"
        return False


class AdmissionController:
    """Queue-depth and deadline-feasibility admission for one engine."""

    def __init__(self, max_queue: int = 256, max_wait_ms: float = 5.0,
                 ewma_alpha: float = 0.2):
        self.max_queue = max_queue
        self._max_wait_s = max_wait_ms / 1e3
        self._alpha = ewma_alpha
        self._exec_ewma_s: float | None = None      # all-bucket fallback
        self._bucket_ewma_s: dict[int, float] = {}  # bucket → EWMA
        self._lock = threading.Lock()
        self.shed_queue_full = 0  # guarded-by: _lock
        self.shed_deadline = 0  # guarded-by: _lock
        self.admitted = 0  # guarded-by: _lock
        # edge-triggered overload logging: one line when queue_full
        # shedding STARTS, one when an admit clears it — never a line
        # per shed request (a saturated engine must not also saturate
        # its own log)
        self._overloaded = False  # guarded-by: _lock

    def observe_exec(self, seconds: float, bucket: int | None = None):
        """Feed one batch's execution time into the EWMAs (global + the
        bucket it actually ran in)."""
        with self._lock:
            if self._exec_ewma_s is None:
                self._exec_ewma_s = seconds
            else:
                self._exec_ewma_s += self._alpha * (seconds -
                                                    self._exec_ewma_s)
            if bucket is not None:
                prev = self._bucket_ewma_s.get(bucket)
                self._bucket_ewma_s[bucket] = seconds if prev is None \
                    else prev + self._alpha * (seconds - prev)

    def estimated_service_s(self, bucket: int | None = None,
                            inflight: int = 0) -> float:
        """Worst-case time-to-result for a request admitted right now: a
        full drain window, one execution of the bucket it will likely
        run in (global EWMA until that bucket has history), plus one
        more execution per batch already in the pipeline ahead of it."""
        with self._lock:
            e = self._bucket_ewma_s.get(bucket) if bucket is not None \
                else None
            if e is None:
                e = self._exec_ewma_s or 0.0
            return self._max_wait_s + (1 + max(0, inflight)) * e

    def admit(self, queue_depth: int, deadline: float | None,
              now: float | None = None, bucket: int | None = None,
              inflight: int = 0) -> Shed | None:
        """None = admitted; a ``Shed`` = rejected (reason inside)."""
        if queue_depth >= self.max_queue:
            with self._lock:
                self.shed_queue_full += 1
                entered = not self._overloaded
                self._overloaded = True
            if entered:
                event(_log, "overload_shed_start",
                      queue_depth=queue_depth, max_queue=self.max_queue,
                      inflight=inflight)
            return Shed("queue_full",
                        f"queue depth {queue_depth} >= {self.max_queue}",
                        retry_after_s=self.estimated_service_s(
                            bucket, inflight))
        with self._lock:
            cleared = self._overloaded
            self._overloaded = False
        if cleared:
            event(_log, "overload_cleared", queue_depth=queue_depth,
                  shed_queue_full=self.shed_queue_full)
        if deadline is not None:
            now = time.monotonic() if now is None else now
            est = self.estimated_service_s(bucket, inflight)
            if now + est > deadline:
                with self._lock:
                    self.shed_deadline += 1
                return Shed("deadline",
                            f"needs ~{est * 1e3:.1f}ms, "
                            f"deadline in {(deadline - now) * 1e3:.1f}ms",
                            retry_after_s=est)
        return None

    def record_admit(self):
        """Count one admitted request (called by the engine AFTER a None
        verdict from ``admit`` — the controller can't count it itself
        because ``admit`` doesn't know whether the caller enqueued)."""
        with self._lock:
            self.admitted += 1

    def expired(self, deadline: float | None,
                now: float | None = None) -> Shed | None:
        """Batch-formation-time re-check: queued past its deadline?"""
        if deadline is None:
            return None
        now = time.monotonic() if now is None else now
        if now > deadline:
            with self._lock:
                self.shed_deadline += 1
            return Shed("deadline",
                        f"expired {(now - deadline) * 1e3:.1f}ms ago in "
                        f"queue",
                        retry_after_s=self.estimated_service_s())
        return None

    def stats(self) -> dict:
        with self._lock:
            return {"shed_queue_full": self.shed_queue_full,
                    "shed_deadline": self.shed_deadline,
                    "admitted": self.admitted,
                    "exec_ewma_ms": (self._exec_ewma_s or 0.0) * 1e3,
                    "exec_ewma_ms_by_bucket": {
                        str(b): round(v * 1e3, 3)
                        for b, v in sorted(self._bucket_ewma_s.items())},
                    "max_queue": self.max_queue}
