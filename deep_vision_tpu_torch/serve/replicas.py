"""Engine replication: one admission queue, N replicas, one process.

Port of ``deep_vision_tpu/serve/replicas.py`` (``local_devices``,
``ReplicatedEngine``) without the mesh path (``--shard-batches``, the
parallelism slice's).  ``ReplicatedEngine`` scales the single-engine
stack over several replicas without changing the per-replica execution
path:

  one queue      ``submit`` feeds a single admission-controlled queue
                 (the shed estimate divides its exec term by the number
                 of routable replicas, admission.py);
  one router     a shared router thread forms cohorts exactly like the
                 single-engine batcher (first request + drain window),
                 so batch formation is the same at any replica count,
                 and it is the thread that launches on every replica's
                 CUDA stream (``dispatch_cohort``);
  N replicas     one ``BatchingEngine`` per device in external-batcher
                 mode: its OWN copy of the weights (``for_device``, made
                 once when the replica is built, never per batch), its
                 own bucket callables, stream, staging pool, pipeline
                 window, drainer and watchdog;
  routing        each formed cohort goes to the replica with the least
                 outstanding work, (in-flight + forming batches) × the
                 bucket's exec EWMA, with a rotating tie-break so an
                 idle fleet still spreads instead of piling onto
                 replica 0.

Two replicas may share one CUDA device (``devices=[cuda:0, cuda:0]`` or
``add_replica(device="cuda:0")``): each owns a copy of the weights and
a stream on it.

Warmup runs on the router thread, on each replica's stream: PyTorch's
cuDNN and cuBLAS handles are per thread and their workspaces per stream,
and the first call of a thread pays for them.  A router the supervisor
restarts warms every live replica again before it takes a request, and
``add_replica`` opens a new slot to routing only after the router warmed
it.

Failure semantics (the reference's):

  * a replica's watchdog fast-fails its stuck window as before, but the
    still-pending requests are first OFFERED to a healthy replica
    (``rescue``) and bisect-retried there;
  * a replica that goes DEAD is masked out of routing and out of the
    admission divisor; the supervisor EVACUATES its in-flight cohorts
    onto a healthy replica, so killing a replica mid-load loses no
    admitted request (poison quarantines excepted);
  * ``health_report`` answers ``can_serve`` False only when NO replica
    can serve (all DEAD, or the router's restart budget is spent).

The replica set is elastic: ``add_replica()`` builds a new view on a
spare device (or the one given) and opens it to routing;
``remove_replica(drain_deadline=)`` masks a slot out of routing and the
divisor, drains its in-flight cohorts (evacuating stragglers onto a
healthy peer), stops it and releases the view's device weights under
the ``record_stream`` rule (``ServingModel.spill_weights``).  Slots are
append-only: a removed replica is masked, never popped, so rescue
closures and routing counters keep stable indices.
``deploy/autoscale.py`` drives both ends.
"""

from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import Future

import numpy as np
import torch

from deep_vision_tpu_torch.core.metrics import LatencyHistogram
from deep_vision_tpu_torch.obs.log import event, get_logger
from deep_vision_tpu_torch.obs.mfu import MfuMeter
from deep_vision_tpu_torch.obs.trace import Tracer
from deep_vision_tpu_torch.serve.admission import AdmissionController, Shed
from deep_vision_tpu_torch.serve.engine import (
    BatchingEngine,
    _Request,
    _Warm,
)
from deep_vision_tpu_torch.serve.faults import FaultPlane, KillThread
from deep_vision_tpu_torch.serve.health import DEAD, OK, EngineHealth

_log = get_logger("dvt.serve.replicas")

#: seconds a replica's warmup may take on the router (a cold cuDNN plan
#: search of every bucket of a large model)
WARMUP_TIMEOUT_S = 600.0


def local_devices(limit: int | None = None) -> list[torch.device]:
    """The CUDA devices serving replicates over, ``cuda:0`` up
    (``--serve-devices`` caps them; asking for more than exist is an
    operator error, not a silent truncation).  Without a GPU this
    raises: CPU replicas are passed explicitly (``devices=``)."""
    if limit is not None and int(limit) < 1:
        raise ValueError(f"--serve-devices {int(limit)}: need at least 1")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available on this machine; replicas run on "
            "NVIDIA GPUs by default — pass CPU devices explicitly "
            "(devices=[torch.device('cpu'), ...])")
    devs = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    if limit is not None:
        n = int(limit)
        if n > len(devs):
            raise ValueError(f"--serve-devices {n}: only {len(devs)} local "
                             f"device(s) present (cuda)")
        devs = devs[:n]
    return devs


def _canonical(device) -> torch.device:
    """``cuda`` → ``cuda:<current>``, so device sets compare equal."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


class _ReplicaWarm(_Warm):
    """A warmup run of one bucket on one replica, queued to the router."""

    __slots__ = ("replica",)

    def __init__(self, replica: int, bucket: int):
        super().__init__(bucket)
        self.replica = replica


class ReplicatedEngine:
    """N per-device ``BatchingEngine`` replicas behind one queue.

    Drop-in for a single engine everywhere the serving stack touches
    one: ``start/stop/submit/infer/warmup/stats/health_report``,
    ``queue_depth``, ``occupancy`` and the ``faults``/``admission``
    attributes.  Extra engine knobs (exec timeouts, retry budgets, state
    thresholds, output validation) pass through to every replica."""

    def __init__(self, model, *, devices: list | None = None,
                 max_batch: int = 32, max_wait_ms: float = 5.0,
                 buckets: list[int] | None = None,
                 admission: AdmissionController | None = None,
                 pipeline_depth: int = 2,
                 faults: FaultPlane | None = None,
                 watchdog_interval_s: float = 0.05,
                 restart_budget: int = 3,
                 tracer: Tracer | None = None,
                 **engine_kwargs):
        self.devices = [_canonical(d) for d in devices] \
            if devices is not None else local_devices()
        if not self.devices:
            raise ValueError("a ReplicatedEngine needs at least one device")
        self.model = model
        self.max_wait_s = max_wait_ms / 1e3
        self.admission = admission or AdmissionController(
            max_wait_ms=max_wait_ms)
        self.faults = faults or FaultPlane.from_env()
        self.watchdog_interval_s = watchdog_interval_s
        self.restart_budget = restart_budget
        # the ROUTER's own health (each replica owns its state machine);
        # its restarts feed the aggregate health_report
        self.health = EngineHealth()
        # one tracer for the whole fleet: a request's span crosses
        # replicas on rescue
        self.tracer = tracer or Tracer()
        self.replicas: list[BatchingEngine] = []
        # kept so add_replica() builds later replicas like the first
        self._replica_kwargs = dict(
            max_batch=max_batch, max_wait_ms=max_wait_ms, buckets=buckets,
            pipeline_depth=pipeline_depth,
            watchdog_interval_s=watchdog_interval_s,
            restart_budget=restart_budget, **engine_kwargs)
        for i, dev in enumerate(self.devices):
            self.replicas.append(self._build_replica(i, dev))
        self.buckets = self.replicas[0].buckets
        # later replicas reuse the resolved ladder: _bucket_for must
        # agree across the fleet
        self._replica_kwargs["buckets"] = list(self.buckets)
        self.max_batch = self.replicas[0].max_batch
        self.pipeline_depth = self.replicas[0].pipeline_depth
        self.wire_dtype = self.replicas[0].wire_dtype
        # DEAD replicas drop out of the shed estimate as they drop out
        # of routing; retired slots drop out of both gauges
        self.admission.set_free_replicas(self._free_replicas)
        self.admission.set_live_replicas(self.live_replicas)
        self._queue: queue.Queue = queue.Queue()
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._accepting = False
        self._forming = 0
        self._thread: threading.Thread | None = None
        self._supervisor: threading.Thread | None = None
        self._rr = 0  # round-robin tie-break cursor
        # the buckets warmup() ran: a restarted router and an added
        # replica are warmed on them before they take traffic
        self._warm_buckets: list[int] | None = None
        self._evacuated = [False] * len(self.replicas)
        # slots are append-only (rescue closures and routing counters
        # are index-keyed): a removed replica is MASKED here, never
        # popped, so indices stay stable for the life of the engine
        self._retired = [False] * len(self.replicas)  # guarded-by: _lock
        # an added replica stays out of routing until the router warmed
        # it
        self._warming = [False] * len(self.replicas)  # guarded-by: _lock
        self.submitted = 0  # guarded-by: _lock
        self.shed_shutdown = 0  # guarded-by: _lock
        self.routed_batches = [0] * len(self.replicas)  # guarded-by: _lock
        self.rescued_requests = 0  # guarded-by: _lock
        self.evacuations = 0  # guarded-by: _lock
        self.shed_all_dead = 0  # guarded-by: _lock
        self.replicas_added = 0  # guarded-by: _lock
        self.replicas_removed = 0  # guarded-by: _lock

    def _build_replica(self, i: int, dev) -> BatchingEngine:
        return BatchingEngine(
            self.model.for_device(dev), admission=self.admission,
            faults=self.faults, external_batcher=True,
            rescue=(lambda pending, err, _i=i:
                    self._rescue_from(_i, pending, err)),
            tracer=self.tracer, **self._replica_kwargs)

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> "ReplicatedEngine":
        if not self._accepting:
            self._stop.clear()
            self.health.revive()
            self._evacuated = [False] * len(self.replicas)
            for i, rep in enumerate(self.replicas):
                if not self._retired[i]:
                    rep.start()
            self._thread = threading.Thread(
                target=self._route_loop,
                name=f"router-{self.model.name}", daemon=True)
            self._thread.start()
            self._supervisor = threading.Thread(
                target=self._supervise_loop,
                name=f"supervisor-{self.model.name}", daemon=True)
            self._supervisor.start()
            self._accepting = True
        return self

    def stop(self, timeout: float = 5.0,
             drain_deadline: float | None = None):
        """Same contract as ``BatchingEngine.stop``: submits fail fast at
        once; with ``drain_deadline`` admitted work finishes across ALL
        replicas first."""
        was_running = self._accepting
        self._accepting = False
        if drain_deadline is not None and was_running:
            t_end = time.monotonic() + drain_deadline
            while time.monotonic() < t_end:
                if self._queue.qsize() == 0 and self._forming == 0 \
                        and self.total_inflight() == 0:
                    break
                time.sleep(0.005)
        self._stop.set()
        self.faults.cancel.set()
        if self._supervisor is not None:
            self._supervisor.join(timeout)
            self._supervisor = None
        if self._thread is not None:
            self._thread.join(timeout)
            self._thread = None
        for rep in self.replicas:
            rep.stop(timeout)
        while True:
            try:
                req = self._queue.get_nowait()
            except queue.Empty:
                break
            if isinstance(req, _Warm):
                req.future.set_exception(RuntimeError("engine stopped"))
            elif not req.future.done():
                req.future.set_result(Shed("shutdown", "engine stopped"))

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()

    def warmup(self, buckets: list[int] | None = None,
               timeout: float = WARMUP_TIMEOUT_S):
        """Build and run every bucket of every live replica once before
        traffic, on the router thread (where traffic will launch) and on
        each replica's stream.  The engine must be started."""
        if not self._accepting:
            raise RuntimeError("warmup needs a started engine")
        self._warm_buckets = list(buckets or self.buckets)
        with self._lock:
            live = [i for i in range(len(self.replicas))
                    if not self._retired[i]]
        self._warm_through_router(live, timeout)

    def _warm_through_router(self, indices: list[int], timeout: float):
        warms = [_ReplicaWarm(i, b) for i in indices
                 for b in self._warm_buckets]
        for w in warms:
            self._queue.put(w)
        for w in warms:
            w.future.result(timeout)

    # -- request path ------------------------------------------------------

    def total_inflight(self) -> int:
        return sum(r._inflight + r._forming for r in self.replicas)

    @property
    def compiles(self) -> int:
        return sum(r.compiles for r in self.replicas)

    def submit(self, image, deadline_ms: float | None = None,
               span=None) -> Future:
        fut: Future = Future()
        # same span ownership as BatchingEngine.submit
        if span is None and self.tracer.enabled:
            span = self.tracer.start()
            fut.add_done_callback(
                lambda _f, _s=span: self.tracer.finish(_s))
        if not self._accepting:
            with self._lock:
                self.submitted += 1
                self.shed_shutdown += 1
            if span is not None:
                span.note("shed", "shutdown")
            fut.set_result(Shed(
                "shutdown", "engine is not accepting requests "
                            "(stopped or not started)"))
            return fut
        now = time.monotonic()
        deadline = now + deadline_ms / 1e3 if deadline_ms is not None \
            else None
        with self._lock:
            self.submitted += 1
        depth = self._queue.qsize()
        shed = self.admission.admit(
            depth, deadline, now,
            bucket=self.replicas[0]._bucket_for(
                min(depth + 1, self.max_batch)),
            inflight=self.total_inflight())
        if shed is not None:
            if span is not None:
                span.note("shed", shed.reason)
            fut.set_result(shed)
            return fut
        self.admission.record_admit()
        poison = self.faults.mark_poison() if self.faults.enabled else False
        if span is not None:
            span.mark("admit")
        self._queue.put(_Request(np.asarray(image, self.wire_dtype),
                                 deadline, now, fut, poison, span))
        return fut

    def infer(self, image, deadline_ms: float | None = None,
              timeout: float | None = 30.0, span=None):
        return self.submit(image, deadline_ms, span=span).result(timeout)

    # -- shared batcher + router -------------------------------------------

    def _run_warm(self, warm: _ReplicaWarm):
        self.replicas[warm.replica].run_warm(warm)

    def _rewarm(self):
        """A restarted router's first act: warm every live replica on
        this thread before it routes a request."""
        with self._lock:
            live = [i for i in range(len(self.replicas))
                    if not self._retired[i]]
        for i in live:
            for b in self._warm_buckets:
                w = _ReplicaWarm(i, b)
                self._run_warm(w)
                if w.future.exception() is not None:
                    event(_log, "router_rewarm_failed",
                          model=self.model.name, replica=i, bucket=b,
                          error=repr(w.future.exception()))

    def _route_loop(self, rewarm: bool = False):
        """The single-engine batcher's cohort formation (engine._loop),
        then a routing decision instead of a local dispatch.  Dying here
        is survivable: the supervisor restarts the router within
        ``restart_budget``."""
        try:
            if rewarm and self._warm_buckets:
                self._rewarm()
            while not self._stop.is_set():
                self.health.beat("batcher")
                if self.faults.enabled:
                    self.faults.inject("batcher", stop=self._stop)
                try:
                    first = self._queue.get(timeout=0.05)
                except queue.Empty:
                    continue
                if isinstance(first, _Warm):
                    self._run_warm(first)
                    continue
                if first.span is not None:
                    first.span.mark("queue_wait")
                self._forming = 1
                warm = None
                try:
                    batch = [first]
                    drain_until = time.monotonic() + self.max_wait_s
                    while len(batch) < self.max_batch:
                        remaining = drain_until - time.monotonic()
                        if remaining <= 0:
                            break
                        try:
                            req = self._queue.get(timeout=remaining)
                        except queue.Empty:
                            break
                        if isinstance(req, _Warm):
                            warm = req  # run after this batch
                            break
                        if req.span is not None:
                            req.span.mark("queue_wait")
                        batch.append(req)
                    self._route(batch)
                finally:
                    self._forming = 0
                if warm is not None:
                    self._run_warm(warm)
        except KillThread:
            return  # injected death: the supervisor restarts the router

    def _route(self, batch: list[_Request]):
        bucket = self.replicas[0]._bucket_for(len(batch))
        i = self._pick(bucket)
        if i is None:
            with self._lock:
                self.shed_all_dead += len(batch)
            for req in batch:
                if not req.future.done():
                    req.future.set_result(
                        Shed("shutdown", "all replicas are DEAD"))
            return
        with self._lock:
            self.routed_batches[i] += 1
        # blocking while replica i's in-flight window is full IS the
        # router's backpressure
        self.replicas[i].dispatch_cohort(batch)
        self.health.record_success()

    def _routable(self, i: int) -> bool:
        return not self._retired[i] and not self._warming[i] \
            and self.replicas[i].health.state != DEAD

    def _pick(self, bucket: int) -> int | None:
        """Least outstanding work = (in-flight + forming batches) × the
        bucket's exec EWMA, over routable replicas.  Scores tie whenever
        the fleet is idle, so the scan starts at a rotating offset and
        strict less-than keeps the first-seen minimum: ties round-robin.
        None = nothing routable."""
        ewma = self.admission.bucket_ewma_s(bucket) or 1.0
        n = len(self.replicas)
        start = self._rr % n
        self._rr += 1
        best = best_score = None
        for k in range(n):
            i = (start + k) % n
            if not self._routable(i):
                continue
            rep = self.replicas[i]
            score = (rep._inflight + rep._forming) * ewma
            if best_score is None or score < best_score:
                best, best_score = i, score
        return best

    def _free_replicas(self) -> int:
        return sum(1 for i in range(len(self.replicas)) if self._routable(i))

    def live_replicas(self) -> int:
        """Provisioned (non-retired) slots, DEAD included: the capacity
        the autoscaler reasons about (a DEAD replica still holds its
        device until revived or retired)."""
        return sum(1 for f in self._retired if not f)

    # -- elasticity (deploy/autoscale.py drives these) ---------------------

    def _spare_device(self):
        """A local device no live replica uses; ``ValueError`` when every
        one is taken (two replicas on one device are asked for by
        ``add_replica(device=...)``)."""
        used = {self.devices[i] for i in range(len(self.replicas))
                if not self._retired[i]}
        devs = local_devices()
        for dev in devs:
            if dev not in used:
                return dev
        raise ValueError(
            f"no free local device: {len(devs)} present, "
            f"{self.live_replicas()} live replica(s)")

    def add_replica(self, device=None) -> int:
        """Scale up: build one more replica (its own weight copy, bucket
        callables, stream, pipeline window, watchdog) and open it to
        routing, after the router warmed it when ``warmup`` ran.  Returns
        the new slot index.  The view's bytes register with the source
        model's weight cache when one manages it, so replica residency
        is budgeted like any version's weights."""
        device = self._spare_device() if device is None \
            else _canonical(device)
        i = len(self.replicas)
        rep = self._build_replica(i, device)
        warm = self._accepting and self._warm_buckets is not None
        with self._lock:
            # the slot's flags and counters first: the router and the
            # supervisor index them by ``range(len(self.replicas))``
            # without the lock
            self.devices.append(device)
            self.routed_batches.append(0)
            self._evacuated.append(False)
            self._retired.append(False)
            self._warming.append(warm)
            self.replicas.append(rep)
            self.replicas_added += 1
        cache = self.model._cache
        if cache is not None:
            cache.register(rep.model)
        if self._accepting:
            rep.start()
        if warm:
            try:
                self._warm_through_router([i], WARMUP_TIMEOUT_S)
            except Exception:
                self._retire_slot(i)
                raise
            with self._lock:
                self._warming[i] = False
        event(_log, "replica_added", model=self.model.name, replica=i,
              device=str(device), live=self.live_replicas())
        return i

    def remove_replica(self, index: int | None = None,
                       drain_deadline: float = 5.0) -> int:
        """Scale down without dropping admitted work: mask the replica out
        of routing (and the admission divisor), let its in-flight
        cohorts finish, evacuate whatever outlives ``drain_deadline``
        onto a healthy peer, then stop it and release its device
        weights.  Refuses to retire the last live replica.  Returns the
        retired slot index."""
        with self._lock:
            live = [i for i in range(len(self.replicas))
                    if not self._retired[i]]
            if len(live) <= 1:
                raise ValueError("refusing to retire the last live replica")
            if index is None:
                # idlest live slot; ties break to the HIGHEST index so
                # repeated scale-downs unwind recent scale-ups first
                index = max(live, key=lambda i: (
                    -(self.replicas[i]._inflight
                      + self.replicas[i]._forming), i))
            elif index not in live:
                raise ValueError(f"replica {index} is not live")
            self._retired[index] = True
            self.replicas_removed += 1
        rep = self.replicas[index]
        t_end = time.monotonic() + drain_deadline
        while time.monotonic() < t_end:
            if rep._inflight + rep._forming == 0:
                break
            time.sleep(0.005)
        if rep._inflight + rep._forming > 0:
            # deadline blown: the replica-death path re-homes the cohorts
            self._evacuated[index] = True
            self._evacuate(index, reason="scale-down drain deadline")
        self._retire_slot(index)
        event(_log, "replica_removed", model=self.model.name,
              replica=index, live=self.live_replicas())
        return index

    def _retire_slot(self, index: int):
        """Mask slot ``index``, stop its engine and give its weights
        back: out of the cache's budget, device storage released once
        every stream that ran it has finished (``record_stream``)."""
        with self._lock:
            self._retired[index] = True
        rep = self.replicas[index]
        rep.stop(timeout=5.0)
        view = rep.model
        if view._cache is not None:
            view._cache.drop(view)
        view.release_device_weights()

    # -- failure handling (rescue + evacuation) ----------------------------

    def _rescue_from(self, source: int, pending: list[_Request],
                     err: Exception) -> bool:
        """Re-home a failed cohort from ``source`` onto the least-loaded
        healthy replica and bisect-retry it there (innocents served,
        poison quarantined).  False = nobody else can take it; the
        caller fails the futures."""
        target = None
        best_score = None
        for i, rep in enumerate(self.replicas):
            if i == source or not self._routable(i):
                continue
            score = rep._inflight + rep._forming
            if best_score is None or score < best_score:
                target, best_score = i, score
        if target is None:
            return False
        with self._lock:
            self.rescued_requests += len(pending)
        for r in pending:
            if r.span is not None:
                r.span.note("rescued", f"replica {source} -> {target}")
        event(_log, "rescue", model=self.model.name, source=source,
              target=target, requests=len(pending),
              error=f"{type(err).__name__}: {err}")
        # straight to isolation: the failure is the source's, and going
        # through target._cohort_failed would count it against the
        # healthy replica's state machine
        rep = self.replicas[target]
        rep._isolate(pending, err, [rep.retry_budget])
        return True

    def _supervise_loop(self):
        while not self._stop.is_set():
            time.sleep(self.watchdog_interval_s)
            if self._stop.is_set():
                return
            try:
                self._supervise_tick()
            except Exception as e:  # noqa: BLE001 — the supervisor never dies
                event(_log, "supervisor_error", model=self.model.name,
                      error=f"{type(e).__name__}: {e}")

    def _supervise_tick(self):
        t = self._thread
        if t is not None and not t.is_alive():
            self._restart_router()
        for i, rep in enumerate(self.replicas):
            if self._retired[i]:
                continue  # scale-down owns its own drain and evacuation
            if rep.health.state == DEAD and not self._evacuated[i]:
                self._evacuated[i] = True
                self._evacuate(i)
            elif rep.health.state != DEAD and self._evacuated[i]:
                self._evacuated[i] = False  # an operator revived it

    def _restart_router(self):
        if self._stop.is_set():
            return
        self.health.record_failure()
        if self.health.watchdog_restarts >= self.restart_budget:
            self.health.force_dead(
                f"router died and the restart budget "
                f"({self.restart_budget}) is exhausted")
            event(_log, "router_dead", model=self.model.name,
                  restart_budget=self.restart_budget)
            return
        self.health.record_restart()
        event(_log, "router_restart", model=self.model.name,
              restarts=self.health.watchdog_restarts,
              budget=self.restart_budget)
        self._thread = threading.Thread(
            target=self._route_loop, kwargs={"rewarm": True},
            name=f"router-{self.model.name}", daemon=True)
        self._thread.start()

    def _evacuate(self, i: int, reason: str | None = None):
        """Replica ``i`` left service with cohorts in flight (went DEAD,
        or blew its scale-down drain deadline): cancel its window
        records (a late drain is discarded) and re-home every
        still-pending request on a healthy replica.  Only an all-DEAD
        fleet fails futures."""
        rep = self.replicas[i]
        if reason is None:
            reason = f"DEAD: {rep.health.dead_reason}"
        with rep._lock:
            recs = [r for r in rep._inflight_recs if not r.cancelled]
            for r in recs:
                r.cancelled = True
        for r in recs:
            if r.cancel is not None:
                r.cancel.set()  # release any injected hang
        with self._lock:
            self.evacuations += 1
        pending = [q for r in recs for q in r.requests
                   if not q.future.done()]
        event(_log, "evacuation", model=self.model.name, replica=i,
              reason=reason, requests=len(pending))
        if not pending:
            return
        for q in pending:
            if q.span is not None:
                q.span.note("evacuated", f"replica {i}: {reason}")
        err = RuntimeError(
            f"replica {i} left service ({reason}); cohort re-routed")
        if not self._rescue_from(i, pending, err):
            BatchingEngine._fail_requests(pending, err)

    # -- observability -----------------------------------------------------

    def health_report(self) -> dict:
        now = time.monotonic()
        rep = self.health.report(now)
        router_state = rep["state"]
        t = self._thread
        rep["batcher_alive"] = bool(t is not None and t.is_alive())
        rep["drainer_alive"] = None  # replicas own their drainers
        rep["accepting"] = self._accepting
        rep["inflight"] = self.total_inflight()
        replicas = {}
        states = []  # live slots only: retired replicas can't 503 us
        for i, r in enumerate(self.replicas):
            h = r.health_report()
            h["retired"] = self._retired[i]
            replicas[str(i)] = h
            if not self._retired[i]:
                states.append(h["state"])
        rep["replicas"] = replicas
        if router_state == DEAD or not states \
                or all(s == DEAD for s in states):
            state = DEAD
        elif router_state == OK and all(s == OK for s in states):
            state = OK
        else:
            state = "degraded"
        rep["state"] = state
        # the fleet serves while ANY replica is routable: a degraded
        # replica drains, it does not take the fleet down
        rep["can_serve"] = state != DEAD
        rep["batch_failures"] = sum(r.batch_failures for r in self.replicas)
        rep["retry_executions"] = sum(r.retry_executions
                                      for r in self.replicas)
        rep["quarantined"] = sum(r.quarantined for r in self.replicas)
        rep["exec_timeouts"] = sum(r.exec_timeouts for r in self.replicas)
        rep["watchdog_restarts"] += sum(r.health.watchdog_restarts
                                        for r in self.replicas)
        rep["shed_shutdown"] = self.shed_shutdown
        ages = [a for r in replicas.values() if not r.get("retired")
                if (a := r.get("last_batch_age_s")) is not None]
        rep["last_batch_age_s"] = min(ages) if ages else None
        rep["param_shard_bytes"] = self.model.param_bytes()
        heads = [h for r in replicas.values() if not r.get("retired")
                 if (h := r.get("hbm_headroom_bytes")) is not None]
        rep["hbm_headroom_bytes"] = min(heads) if heads else None
        if self.faults.enabled:
            rep["faults"] = self.faults.stats()
        return rep

    @property
    def queue_depth(self) -> int:
        """Requests awaiting routing in the shared queue (the QoS and
        autoscaler pressure signal)."""
        return self._queue.qsize()

    def occupancy(self) -> float:
        """Mean compute occupancy over live slots: the fleet's duty cycle
        for the batchy-SLO autoscaler (one busy replica among idle ones
        reads fractional, as capacity says it should)."""
        occ = [r.occupancy() for i, r in enumerate(self.replicas)
               if not self._retired[i]]
        return round(sum(occ) / len(occ), 4) if occ else 0.0

    def stats(self) -> dict:
        merged = LatencyHistogram()
        per = []
        img_per_sec = 0.0
        for i, rep in enumerate(self.replicas):
            merged.merge(rep.latency.state_dict())
            ips = rep.throughput.images_per_sec
            img_per_sec += ips
            with self._lock:
                routed = self.routed_batches[i]
            per.append({
                "replica": i,
                "device": rep.model.placement_desc(),
                "state": rep.health.state,
                "retired": self._retired[i],
                "routed_batches": routed,
                "batches": rep.batches,
                "served": rep.served,
                "quarantined": rep.quarantined,
                "img_per_sec": round(ips, 2),
                "inflight": rep._inflight,
                "max_inflight": rep.max_inflight,
                "compiles": rep.compiles})
        weight_bytes = self.model.param_bytes()
        with self._lock:
            out = {"model": self.model.name,
                   "version": getattr(self.model, "serve_version", None),
                   "submitted": self.submitted,
                   "served": sum(r.served for r in self.replicas),
                   "batches": sum(r.batches for r in self.replicas),
                   "compiles": sum(r.compiles for r in self.replicas),
                   "padded_images": sum(r.padded_images
                                        for r in self.replicas),
                   "quarantined": sum(r.quarantined for r in self.replicas),
                   "queue_depth": self._queue.qsize(),
                   "buckets": list(self.buckets),
                   "max_wait_ms": self.max_wait_s * 1e3,
                   "workload": self.model.workload.verb,
                   "wire_dtype": str(self.wire_dtype),
                   "infer_dtype": self.model.infer_dtype,
                   # one replica's footprint (each holds a full copy),
                   # the single engine's keys
                   "weight_hbm_bytes": weight_bytes,
                   "param_shard_bytes": weight_bytes,
                   "routing": {
                       "policy": "least_outstanding_work",
                       "replicas": len(self.replicas),
                       "live_replicas": self.live_replicas(),
                       "free_replicas": self._free_replicas(),
                       "rescued_requests": self.rescued_requests,
                       "evacuations": self.evacuations,
                       "shed_all_dead": self.shed_all_dead,
                       "replicas_added": self.replicas_added,
                       "replicas_removed": self.replicas_removed}}
        out["replicas"] = per
        pooled: dict = {}
        h2d_by_bucket: dict = {}
        d2h_by_bucket: dict = {}
        for r in self.replicas:
            for b, nbuf in r.staging.stats()["pooled"].items():
                pooled[b] = pooled.get(b, 0) + nbuf
            with r._lock:
                for b, nb in r.h2d_bytes_by_bucket.items():
                    h2d_by_bucket[b] = h2d_by_bucket.get(b, 0) + nb
                for b, nb in r.d2h_bytes_by_bucket.items():
                    d2h_by_bucket[b] = d2h_by_bucket.get(b, 0) + nb
        out["pipeline"] = {
            "depth": self.pipeline_depth,
            "inflight": self.total_inflight(),
            "max_inflight": max(r.max_inflight for r in self.replicas),
            "h2d_transfers": sum(r.h2d_transfers for r in self.replicas),
            "h2d_bytes": sum(r.h2d_bytes for r in self.replicas),
            "h2d_bytes_by_bucket": h2d_by_bucket,
            "d2h_bytes": sum(r.d2h_bytes for r in self.replicas),
            "d2h_bytes_by_bucket": d2h_by_bucket,
            # the single engine's host proxy does not compose across
            # replicas (their windows overlap in wall time)
            "device_idle_frac": None,
            "occupancy": self.occupancy(),
            "staging": {
                "allocated": sum(r.staging.allocated for r in self.replicas),
                "reused": sum(r.staging.reused for r in self.replicas),
                "dtype": str(self.replicas[0].staging.dtype),
                "pooled": pooled}}
        out["latency"] = merged.percentiles()
        out["latency_hist"] = merged.state_dict()
        out["img_per_sec"] = round(img_per_sec, 2)
        out["admission"] = self.admission.stats()
        out["health"] = self.health_report()
        out["mfu"] = MfuMeter.merged_report([r.mfu for r in self.replicas])
        out["trace"] = self.tracer.summary()
        return out
