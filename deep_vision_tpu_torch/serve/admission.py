"""Admission control: shed doomed work at the door, not after the queue.

Copy of ``deep_vision_tpu/serve/admission.py`` (``Shed``,
``AdmissionController`` with its replica divisors, ``QoSClass``,
``TenantQoS``).

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

from deep_vision_tpu_torch.core.metrics import LatencyHistogram
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

    reason: str   # "queue_full" | "deadline" | "shutdown" | "quota" | "priority"
    detail: str = ""
    retry_after_s: float | None = None

    def __bool__(self):  # `if result:` reads as "was served"
        return False


class AdmissionController:
    """Queue-depth and deadline-feasibility admission for one engine.

    ``name`` tags the controller with the model it accounts for: the
    control plane (serve/models.py) shares ONE controller across every
    version of one model name, so the per-bucket EWMAs and the
    admitted/shed counters survive a hot reload."""

    def __init__(self, max_queue: int = 256, max_wait_ms: float = 5.0,
                 ewma_alpha: float = 0.2, name: str | None = None):
        self.name = name
        self.max_queue = max_queue
        self._max_wait_s = max_wait_ms / 1e3
        self._alpha = ewma_alpha
        self._exec_ewma_s: float | None = None      # all-bucket fallback
        self._bucket_ewma_s: dict[int, float] = {}  # bucket → EWMA
        # replicas able to absorb work right now: an int, or a zero-arg
        # callable the ReplicatedEngine wires to its routing mask (DEAD
        # replicas drop out of the divisor as they drop out of routing;
        # replicas added/removed at runtime move it the same way)
        self._free_replicas = 1
        # provisioned replicas (DEAD included) — the /v1/stats capacity
        # gauge; None falls back to the free-replica divisor
        self._live_replicas = None
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

    def set_free_replicas(self, provider):
        """Wire the replica divisor: an int, or a zero-arg callable
        returning the count of replicas currently routable (≥ 1 is
        enforced at read time so a fully-DEAD set stays finite)."""
        self._free_replicas = provider

    def _replica_divisor(self) -> int:
        # resolved OUTSIDE self._lock: the callable may read engine state
        n = self._free_replicas() if callable(self._free_replicas) \
            else self._free_replicas
        return max(1, int(n))

    def set_live_replicas(self, provider):
        """Wire the provisioned-replica gauge (int or zero-arg
        callable): how many replicas exist right now, DEAD included —
        what the autoscaler changes.  Unset, it mirrors the free-replica
        divisor (a single engine is one replica either way)."""
        self._live_replicas = provider

    def _live_count(self) -> int:
        p = self._live_replicas
        if p is None:
            return self._replica_divisor()
        n = p() if callable(p) else p
        return max(0, int(n))

    def estimated_service_s(self, bucket: int | None = None,
                            inflight: int = 0) -> float:
        """Worst-case time-to-result for a request admitted right now: a
        full drain window, one execution of the bucket it will likely
        run in (global EWMA until that bucket has history), plus one
        more execution per batch already in the pipeline ahead of it.
        With N free replicas the outstanding executions drain N-wide,
        so the exec term divides by N (the drain window doesn't — batch
        formation is one shared queue either way)."""
        n = self._replica_divisor()
        with self._lock:
            e = self._bucket_ewma_s.get(bucket) if bucket is not None \
                else None
            if e is None:
                e = self._exec_ewma_s or 0.0
            return self._max_wait_s + ((1 + max(0, inflight)) * e) / n

    def bucket_ewma_s(self, bucket: int | None = None) -> float | None:
        """Raw exec EWMA for ``bucket`` (global fallback, None before
        any batch has run): the watchdog's exec-timeout base."""
        with self._lock:
            e = self._bucket_ewma_s.get(bucket) if bucket is not None \
                else None
            return e if e is not None else self._exec_ewma_s

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
        n = self._replica_divisor()  # outside the lock, see above
        live = self._live_count()
        with self._lock:
            out = {"shed_queue_full": self.shed_queue_full,
                   "shed_deadline": self.shed_deadline,
                   "admitted": self.admitted,
                   "exec_ewma_ms": (self._exec_ewma_s or 0.0) * 1e3,
                   "exec_ewma_ms_by_bucket": {
                       str(b): round(v * 1e3, 3)
                       for b, v in sorted(self._bucket_ewma_s.items())},
                   "free_replicas": n,
                   "live_replicas": live,
                   "max_queue": self.max_queue}
        if self.name is not None:
            out["name"] = self.name
        return out


# ---------------------------------------------------------------------------
# Per-tenant QoS: priority classes, token-bucket quotas, weighted shedding
# ---------------------------------------------------------------------------

TENANT_HEADER = "X-DVT-Tenant"

DEFAULT_QOS_SPEC = ("premium:rate=0,shed_at=1.0;"
                    "standard:rate=200,burst=50,shed_at=0.8;"
                    "best_effort:rate=50,burst=10,shed_at=0.5;"
                    "default=standard")


@dataclasses.dataclass
class QoSClass:
    """One priority class.

    ``rate``/``burst`` parameterize each member tenant's token bucket
    (requests/second sustained, requests of headroom); ``rate=0`` means
    unmetered.  ``shed_at`` is the weighted-shedding knee: the fraction
    of engine queue capacity beyond which this class's cache-missing
    requests are shed pre-engine, so under pressure best-effort
    (shed_at 0.5) absorbs the 429s half a queue before premium
    (shed_at 1.0) loses anything.  ``always_big`` is the cascade
    premium knob: members of the class bypass the cascade's cheap tiers
    and its brownout degradation (serve/cascade.py ``force_big``, set
    by serve/http.py from the tenant's class)."""

    name: str
    rate: float = 0.0
    burst: float = 1.0
    shed_at: float = 1.0
    tenants: tuple = ()
    always_big: bool = False


class TenantQoS:
    """Maps the ``X-DVT-Tenant`` header to a priority class and applies
    two independent controls at the edge:

      quota     a per-tenant token bucket (class rate/burst), checked
                BEFORE the response cache — a tenant over quota is 429'd
                even for cached answers, otherwise a hot payload would
                make quotas unenforceable.
      priority  deterministic weighted shedding on engine queue
                pressure, checked only on a cache MISS just before the
                engine — pressure = queue_depth / max_queue, and a class
                is shed when pressure ≥ its ``shed_at``.  Cache hits
                bypass this (they cost no engine capacity).

    Spec grammar (``--qos``):
        ``premium:rate=0,shed_at=1.0,tenants=acme|bigco;``
        ``best_effort:rate=20,burst=5,shed_at=0.5;default=best_effort``
    ``tenants=`` pins named tenants to a class; everything else lands in
    the ``default=`` class (first class declared if omitted);
    ``always_big=1`` marks the class as cascade-premium (its tenants'
    requests go straight to the big tier, serve/cascade.py)."""

    def __init__(self, classes: list, default: str):
        if not classes:
            raise ValueError("QoS spec declares no classes")
        self.classes = {c.name: c for c in classes}
        if default not in self.classes:
            raise ValueError(f"QoS default class {default!r} not declared")
        self.default = default
        self._tenant_class = {t: c.name for c in classes
                              for t in c.tenants}
        self._lock = threading.Lock()
        # tenant → [tokens, last_refill_monotonic]  guarded-by: _lock
        self._buckets: dict[str, list] = {}
        # class → counters/histogram  guarded-by: _lock
        self._served = {c.name: 0 for c in classes}
        self._shed_quota = {c.name: 0 for c in classes}
        self._shed_priority = {c.name: 0 for c in classes}
        self._cache_hits = {c.name: 0 for c in classes}
        self._latency = {c.name: LatencyHistogram() for c in classes}

    @classmethod
    def parse(cls, spec: str) -> "TenantQoS":
        classes, default = [], None
        for part in filter(None, (p.strip() for p in spec.split(";"))):
            if part.startswith("default="):
                default = part[len("default="):].strip()
                continue
            name, _, opts = part.partition(":")
            kw: dict = {"name": name.strip()}
            for opt in filter(None, (o.strip() for o in opts.split(","))):
                k, _, v = opt.partition("=")
                k = k.strip()
                if k == "tenants":
                    kw["tenants"] = tuple(
                        t for t in v.strip().split("|") if t)
                elif k in ("rate", "burst", "shed_at"):
                    kw[k] = float(v)
                elif k == "always_big":
                    kw["always_big"] = v.strip().lower() \
                        not in ("", "0", "false", "no")
                else:
                    raise ValueError(f"unknown QoS option {k!r} in "
                                     f"{part!r}")
            classes.append(QoSClass(**kw))
        return cls(classes, default or (classes[0].name if classes
                                        else ""))

    def class_of(self, tenant: str) -> QoSClass:
        return self.classes[self._tenant_class.get(tenant, self.default)]

    def check_quota(self, tenant: str,
                    now: float | None = None) -> Shed | None:
        """Token-bucket admission for one request from ``tenant``.
        None = within quota (one token consumed)."""
        cls = self.class_of(tenant)
        if cls.rate <= 0:
            return None  # unmetered class
        now = time.monotonic() if now is None else now
        with self._lock:
            bucket = self._buckets.get(tenant)
            if bucket is None:
                bucket = [cls.burst, now]
                self._buckets[tenant] = bucket
            tokens = min(cls.burst,
                         bucket[0] + cls.rate * (now - bucket[1]))
            bucket[1] = now
            if tokens >= 1.0:
                bucket[0] = tokens - 1.0
                return None
            bucket[0] = tokens
            self._shed_quota[cls.name] += 1
            wait_s = (1.0 - tokens) / cls.rate
        return Shed("quota",
                    f"tenant {tenant!r} ({cls.name}) over "
                    f"{cls.rate:g} req/s quota",
                    retry_after_s=wait_s)

    def check_pressure(self, tenant: str, queue_depth: int,
                       max_queue: int,
                       floor: float = 0.0) -> Shed | None:
        """Weighted shedding on a cache miss: shed this class once
        engine queue pressure (``queue_depth / max_queue``) crosses its
        knee.  ``floor`` bounds the pressure the knees see from below:
        at brownout L3 (serve/brownout.py ``qos_pressure_floor``) it is
        just under 1.0, so every class whose ``shed_at`` is below 1.0
        sheds whatever the queue holds and premium (``shed_at=1.0``)
        goes on."""
        cls = self.class_of(tenant)
        pressure = queue_depth / max_queue if max_queue > 0 else 0.0
        pressure = max(pressure, float(floor))
        if pressure < cls.shed_at:
            return None
        with self._lock:
            self._shed_priority[cls.name] += 1
        return Shed("priority",
                    f"{cls.name} sheds at {cls.shed_at:g} queue "
                    f"pressure (now {pressure:.2f})",
                    retry_after_s=1.0)

    def record_served(self, tenant: str, seconds: float,
                      cache_hit: bool = False):
        cls = self.class_of(tenant)
        with self._lock:
            self._served[cls.name] += 1
            if cache_hit:
                self._cache_hits[cls.name] += 1
            self._latency[cls.name].record(seconds)

    def stats(self) -> dict:
        with self._lock:
            return {name: {
                        "rate": c.rate, "burst": c.burst,
                        "shed_at": c.shed_at,
                        "always_big": c.always_big,
                        "served": self._served[name],
                        "shed_quota": self._shed_quota[name],
                        "shed_priority": self._shed_priority[name],
                        "cache_hits": self._cache_hits[name],
                        "latency": self._latency[name].percentiles(),
                        "default": name == self.default}
                    for name, c in self.classes.items()}
