"""Trough-filling batch scheduler: bulk jobs strictly below every
interactive tenant.

Port of ``deep_vision_tpu/serve/batch_sched.py`` (``BatchScheduler``).
One daemon thread drains ``JobStore`` shards through the serving
engines, one shard at a time, and submits a shard only when the target
engine's interactive pressure is LOW on both signals the admission
controller already keeps:

- ``engine.queue_depth <= max_interactive_depth`` (default 0: any
  queued interactive request parks the batch tier outright), and
- ``queue_depth × bucket exec EWMA`` under ``pressure_high_ms``: the
  same queue-depth × service-time product deploy/autoscale.py calls
  pressure, so "trough" means the same thing to the scheduler and the
  autoscaler.

That check plus one shard in flight is the whole priority band: a shard
is at most ``max_batch`` images (one engine cohort), so the worst an
interactive request ever sees is ONE batch-sized cohort ahead of it,
the same worst case a burst of interactive traffic already produces.
There is no preemption and no priority queue; the band lives in *when*
batch work is submitted, not in how the engine treats it afterwards.
It works over a ``BatchingEngine`` and a ``ReplicatedEngine`` alike:
both expose ``queue_depth``, ``admission`` and ``submit``.

Starvation-freedom the other way is inherent: interactive troughs occur
between arrivals (the check samples queue depth, which an idle engine
holds at 0), so any workload short of 100% sustained interactive
saturation lets batch shards through; each completed shard is durably
checkpointed (serve/jobs.py), so progress is monotone across restarts.

At brownout L1 and above (``brownout``, serve/brownout.py) the tier is
optional work: shard admission freezes outright and jobs wait.

Shed results (engine shutdown, queue races, the shard timeout) retry
the WHOLE shard later: results are recorded shard-atomically or not at
all, which keeps the JSONL replay exactly-once.  Quarantined or
undecodable items record as per-item ``error`` results: a poison item
must not wedge its job forever.

Lock order: ``BatchScheduler._lock`` guards only local counters and the
busy-interval window; it is a leaf, never held across ``submit`` or any
store or engine call.
"""

from __future__ import annotations

import threading
import time
from collections import deque

from deep_vision_tpu_torch.obs.log import event, get_logger
from deep_vision_tpu_torch.serve.admission import Shed
from deep_vision_tpu_torch.serve.faults import Quarantined
from deep_vision_tpu_torch.serve.jobs import Job, JobStore

_log = get_logger("dvt.serve.batch")


class BatchScheduler:
    """Drains job shards through serving engines during interactive
    troughs.

    ``resolve(model_name) -> (model, engine)`` is the routing closure
    the CLI wires up (registry + engines dict on the single-model path,
    the model control plane on ``--models``); it raises KeyError
    for unknown/undeployed models, which fails the job terminally."""

    def __init__(self, store: JobStore, resolve, *,
                 interval_s: float = 0.02,
                 max_interactive_depth: int = 0,
                 pressure_high_ms: float = 10.0,
                 shard_timeout_s: float = 300.0,
                 occupancy_window_s: float = 10.0):
        self.store = store
        self._resolve = resolve
        self.interval_s = max(0.001, float(interval_s))
        self.max_interactive_depth = max(0, int(max_interactive_depth))
        self.pressure_high_ms = float(pressure_high_ms)
        self.shard_timeout_s = float(shard_timeout_s)
        self.occupancy_window_s = float(occupancy_window_s)
        self._lock = threading.Lock()
        # optional BrownoutController (serve/brownout.py): at L1+ the
        # batch tier is optional work — cohort admission freezes
        # entirely, jobs just drain more slowly; read racily
        self.brownout = None
        # rolling (t_end, busy_s) intervals of batch shard executions —
        # the dvt_batch_occupancy numerator
        self._busy: deque = deque()  # guarded-by: _lock
        self.images_total = 0  # guarded-by: _lock
        self.shards_done = 0  # guarded-by: _lock
        self.shards_shed = 0  # whole-shard retries, guarded-by: _lock
        # trough checks that said "not now", guarded-by: _lock
        self.deferred = 0
        self.frozen_deferred = 0  # brownout L1+ freezes, guarded-by: _lock
        self.decode_errors = 0  # guarded-by: _lock
        self.item_errors = 0  # quarantined/timeout items, guarded-by: _lock
        self.jobs_failed = 0  # guarded-by: _lock
        self._kick = threading.Event()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    # -- lifecycle ----------------------------------------------------------

    def start(self) -> "BatchScheduler":
        if self._thread is None or not self._thread.is_alive():
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._loop, name="batch-sched", daemon=True)
            self._thread.start()
        return self

    def stop(self, timeout: float = 5.0) -> None:
        self._stop.set()
        self._kick.set()
        t = self._thread
        if t is not None:
            t.join(timeout)

    def kick(self) -> None:
        """Wake the loop now (called by the HTTP handler on job
        submit, instead of waiting out the idle sleep)."""
        self._kick.set()

    # -- the band -----------------------------------------------------------

    def _trough(self, engine) -> bool:
        """True when interactive pressure is low enough to slip one
        batch shard in.  Both terms come from live interactive state:
        queue depth is requests *waiting* (batch's own in-flight shard
        does not count — it already left the queue), and the EWMA is
        the admission controller's per-bucket execution estimate."""
        depth = engine.queue_depth
        if depth > self.max_interactive_depth:
            return False
        ewma = engine.admission.bucket_ewma_s() or 0.0
        return depth * ewma * 1e3 <= self.pressure_high_ms

    # -- the loop -----------------------------------------------------------

    def _loop(self) -> None:
        while not self._stop.is_set():
            nxt = self.store.next_shard()
            if nxt is None:
                self._kick.wait(self.interval_s * 10)
                self._kick.clear()
                continue
            job, index = nxt
            try:
                model, engine = self._resolve(job.model)
            except KeyError as e:
                with self._lock:
                    self.jobs_failed += 1
                detail = e.args[0] if e.args else job.model
                self.store.fail(job.job_id,
                                f"model not servable: {detail}")
                continue
            bo = self.brownout
            if bo is not None and bo.at_least(1):
                # brownout L1+: admission frozen regardless of the
                # trough check — under overload the next cohort is
                # pure optional load on a saturated engine
                with self._lock:
                    self.deferred += 1
                    self.frozen_deferred += 1
                self._kick.wait(self.interval_s)
                self._kick.clear()
                continue
            if not self._trough(engine):
                with self._lock:
                    self.deferred += 1
                self._kick.wait(self.interval_s)
                self._kick.clear()
                continue
            self._run_shard(job, index, model, engine)

    def _run_shard(self, job: Job, index: int, model, engine) -> None:
        lo, hi = job.shard_range(index)
        items = job.manifest[lo:hi]  # manifest is immutable post-submit
        wl = model.workload
        inputs: list = []
        for item in items:
            try:
                inputs.append(wl.decode_manifest_item(item, model))
            except ValueError as e:
                inputs.append(e)  # permanent per-item error
        t0 = time.monotonic()
        # submit the whole shard as one cohort: no per-request deadline
        # (bulk work outlives any interactive SLO; the shard timeout
        # below bounds it instead)
        futures = [None if isinstance(x, ValueError)
                   else engine.submit(x) for x in inputs]
        deadline = t0 + self.shard_timeout_s
        rows: list = []
        for fut, x in zip(futures, inputs):
            if fut is None:
                rows.append(x)
                continue
            try:
                rows.append(fut.result(
                    timeout=max(0.1, deadline - time.monotonic())))
            except Exception as e:  # noqa: BLE001 — timeout/executor
                # faults map to a retriable shed: the engine may still
                # deliver later, but this shard attempt is over
                rows.append(Shed("timeout", detail=str(e)))
        if any(isinstance(r, Shed) for r in rows):
            # whole-shard retry: nothing recorded, nothing emitted —
            # shard results are all-or-nothing so replay stays
            # exactly-once
            with self._lock:
                self.shards_shed += 1
            event(_log, "shard_shed", job=job.job_id, shard=index,
                  sheds=sum(isinstance(r, Shed) for r in rows))
            self._kick.wait(self.interval_s)
            self._kick.clear()
            return
        t_end = time.monotonic()
        results: list = []
        served = 0
        decode_errs = item_errs = 0
        for item, row in zip(items, rows):
            if isinstance(row, ValueError):
                decode_errs += 1
                results.append({"error": f"bad manifest entry: {row}"})
            elif isinstance(row, Quarantined):
                item_errs += 1
                results.append({"error":
                                f"quarantined ({row.reason}): "
                                f"{row.detail}"})
            else:
                served += 1
                results.append(wl.respond(model, item, row))
        recorded = self.store.record_shard(job.job_id, index, results,
                                           served)
        with self._lock:
            self.decode_errors += decode_errs
            self.item_errors += item_errs
            if recorded:
                self.shards_done += 1
                self.images_total += served
                self._busy.append((t_end, t_end - t0))
                self._prune_busy_locked(t_end)

    # -- observability ------------------------------------------------------

    def _prune_busy_locked(self, now: float) -> None:
        horizon = now - self.occupancy_window_s
        while self._busy and self._busy[0][0] < horizon:
            self._busy.popleft()

    def occupancy(self) -> float:
        """Fraction of the trailing window the batch tier kept an
        engine busy — the trough-filling duty cycle (0 when idle or
        parked behind interactive load, →1 when saturating)."""
        now = time.monotonic()
        with self._lock:
            self._prune_busy_locked(now)
            busy = sum(dt for _, dt in self._busy)
        return min(1.0, busy / self.occupancy_window_s)

    def stats(self) -> dict:
        occ = self.occupancy()
        with self._lock:
            return {"running": self._thread is not None
                    and self._thread.is_alive(),
                    "images_total": self.images_total,
                    "shards_done": self.shards_done,
                    "shards_shed": self.shards_shed,
                    "deferred": self.deferred,
                    "frozen_deferred": self.frozen_deferred,
                    "decode_errors": self.decode_errors,
                    "item_errors": self.item_errors,
                    "jobs_failed": self.jobs_failed,
                    "occupancy": round(occ, 4),
                    "max_interactive_depth": self.max_interactive_depth,
                    "pressure_high_ms": self.pressure_high_ms}
