"""Cross-host serving gateway: health-routed failover across backends.

Port of ``deep_vision_tpu/serve/gateway.py``: host code only, with
``threading.Lock`` where the reference names its locks through its
sanitizer (the names stay in the comments).  The gateway runs no device
code: it proxies to ``cli.serve`` processes that run on the card.

``--serve-devices`` scales one process across its local GPUs; the next
scale axis is *processes and hosts*.  The gateway is a thin HTTP front
tier that proxies every workload inference verb (``/v1/classify``,
``/v1/detect``, ``/v1/pose``, ``/v1/generate`` — the route table
derives from ``serve/workloads.py``) across a table of
backend serve processes (each a full stack: batcher, pipeline,
fault plane, deep health) so N backends look like one endpoint that
survives any single backend dying:

  state machine   per-backend OK → DEGRADED → DEAD, driven by BOTH
                  active ``/v1/healthz`` probes (a prober thread, every
                  ``probe_interval_s``) and passive request outcomes —
                  connect errors, timeouts, and 5xx count as failures;
                  any 2xx/4xx response or a 200 probe resets to OK.  A
                  503 probe means *alive but can't serve* (draining, or
                  the backend's own health machine flipped): the
                  backend leaves routing with NO breaker penalty and
                  rejoins on the next 200 probe.
  routing         least outstanding work over routable backends —
                  outstanding requests × the backend's latency EWMA,
                  scanned from a rotating offset with strict less-than
                  (ties round-robin), mirroring the in-process replica
                  router (serve/replicas.py).
  circuit breaker per backend: CLOSED → OPEN after ``breaker_threshold``
                  consecutive failures (probe or request) → HALF_OPEN
                  once ``breaker_cooldown_s`` elapses, admitting one
                  trial (the next probe or one live request); success
                  closes, failure re-opens with a fresh cooldown.  An
                  OPEN breaker takes the backend out of routing within
                  one probe interval of it dying — no traffic required.
  retries         inference requests are idempotent, so a connect
                  error / timeout / 5xx is retried with jittered
                  exponential backoff, bounded by ``retry_budget``
                  attempts per request, FAILING OVER to a different
                  backend when one is routable — killing one of two
                  backends mid-load loses zero admitted requests from
                  the client's view.
  retry budget    the per-request attempt cap bounds one request; it
                  does NOT bound the fleet-level retry *ratio* — under
                  a total backend outage every request still burns its
                  full attempt allowance, and the retry storm is load
                  the dying backends must also absorb.  So each retry
                  additionally draws one token from the TARGET
                  backend's bucket, refilled ``retry_budget_ratio``
                  per successful response (capped at
                  ``retry_budget_burst``): sustained retries are
                  bounded to a fixed fraction of sustained successes,
                  the classic success-refilled retry budget (Finagle,
                  "The Site Reliability Workbook" ch. 21).  A dry
                  bucket denies the retry; the request answers with
                  what it has (last 429/502) instead of amplifying.
                  Remaining tokens ride the ``X-DVT-Retry-Budget``
                  response header so a cooperating client (a closed-loop
                  load generator) suppresses ITS retries too — gateway
                  and client never jointly exceed the budget.
  429s            a shed (429) is failed over once to a less-loaded
                  backend when one exists; otherwise it propagates to
                  the client unchanged, ``Retry-After`` header included,
                  so client backoff semantics survive the extra hop.
  tail hedging    optional: if the primary hasn't answered after a
                  p99-based delay (``hedge_after_ms``, or the gateway's
                  own measured p99 once it has history), the request is
                  duplicated to a second backend — first answer wins,
                  the loser's response is discarded.

``GET /v1/stats`` aggregates every backend's own stats under the
gateway's counters (retries, failovers, hedges, breaker transitions),
plus the fleet-level latency DISTRIBUTION (per-backend histogram
states merged bin-wise — a true fleet p99, not an average of p99s) and
the aggregate serving MFU; ``GET /metrics`` renders the same as
Prometheus text; ``GET /v1/traces`` exposes the gateway's trace ring.
Every proxied request carries an ``X-DVT-Request-Id`` header to the
backend (client-provided or minted here) so one id names the whole
gateway→backend→engine path — ``?debug=1`` responses carry both the
backend's ``trace`` and the gateway-side ``gateway_trace`` breakdown.
``GET /v1/healthz`` answers 200 while ANY backend is routable.  Entry
point: ``python -m deep_vision_tpu_torch.cli.gateway``; parity with the
reference: ``tests/test_torch_gateway.py`` and
``tests/test_torch_gateway_http.py``; a real SIGKILL of a backend
process on the card: ``chip_smoke.py`` phase ``gateway``.  Zero new
dependencies: stdlib ``http.client`` out, the ``serve/edge.py``
selector loop in (``ThreadingHTTPServer`` behind ``edge=False``).

Forwarding rides per-backend keep-alive connection POOLS with
retry-on-stale (an error on a reused socket drops the pool and retries
once fresh; an error on a fresh socket is a real backend failure), and
``affinity=True`` switches routing to rendezvous hashing on the
payload digest so repeats of one payload land where the backend's
response cache already holds the answer.
"""

from __future__ import annotations

import hashlib
import json
import math
import random
import threading
import time
from concurrent.futures import FIRST_COMPLETED, ThreadPoolExecutor, wait
from http.client import HTTPConnection, HTTPException
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs

from deep_vision_tpu_torch.core.metrics import LatencyHistogram
from deep_vision_tpu_torch.obs.log import event, get_logger
from deep_vision_tpu_torch.obs.mfu import round_mfu
from deep_vision_tpu_torch.obs.trace import (
    REQUEST_ID_HEADER,
    Tracer,
    new_request_id,
)
from deep_vision_tpu_torch.serve.edge import DEFAULT_MAX_CONNECTIONS, EdgeServer
from deep_vision_tpu_torch.serve.faults import InjectedFault
from deep_vision_tpu_torch.serve.health import DEAD, DEGRADED, OK

_log = get_logger("dvt.serve.gateway")

CLOSED = "closed"
OPEN = "open"
HALF_OPEN = "half_open"

# retry-able HTTP verdicts vs. final ones: anything below 500 except a
# 429 means the backend is alive and answered THIS request definitively
_PROXY_HEADERS = ("Content-Type", "Retry-After", "X-DVT-Cache",
                  "X-DVT-Tier", "X-DVT-Degraded")

#: response header carrying the answering backend's remaining retry
#: tokens — a value below 1.0 tells a cooperating client that retrying
#: now would exceed the budget the gateway itself is held to
RETRY_BUDGET_HEADER = "X-DVT-Retry-Budget"


class Backend:
    """One backend serve process: address + breaker + health + load.

    All mutation goes through ``record_*``/``begin``/``done_*`` under
    one lock; the router reads ``routable()`` and the outstanding/EWMA
    score.  The breaker is the ROUTING gate; the OK/DEGRADED/DEAD state
    is the observability verdict — both are driven by the same
    consecutive-failure count so they can't disagree about a dead
    backend.
    """

    def __init__(self, url: str, *, breaker_threshold: int = 3,
                 breaker_cooldown_s: float = 1.0,
                 degraded_after: int = 1, dead_after: int = 5,
                 ewma_alpha: float = 0.2,
                 retry_ratio: float = 0.1,
                 retry_burst: float = 10.0):
        addr = url.removeprefix("http://").rstrip("/")
        host, _, port = addr.rpartition(":")
        if not host or not port.isdigit():
            raise ValueError(f"backend '{url}': expected host:port")
        self.host, self.port = host, int(port)
        self.name = f"{self.host}:{self.port}"
        self.breaker_threshold = max(1, int(breaker_threshold))
        self.breaker_cooldown_s = breaker_cooldown_s
        self.degraded_after = max(1, int(degraded_after))
        self.dead_after = max(self.degraded_after, int(dead_after))
        self._alpha = ewma_alpha
        self._lock = threading.Lock()  # serve.gateway.Backend._lock
        self.state = OK  # guarded-by: _lock
        self.breaker = CLOSED  # guarded-by: _lock
        self.opened_at: float | None = None  # guarded-by: _lock
        self._trial_inflight = False  # guarded-by: _lock
        # a 503 healthz: alive but can't serve (reason from its body)
        self.unavailable: str | None = None  # guarded-by: _lock
        self.outstanding = 0  # guarded-by: _lock
        self.ewma_s: float | None = None  # guarded-by: _lock
        self.consecutive_failures = 0  # guarded-by: _lock
        self.failures = 0  # guarded-by: _lock
        self.successes = 0  # guarded-by: _lock
        self.sheds = 0  # guarded-by: _lock
        self.probes = 0  # guarded-by: _lock
        self.breaker_opens = 0  # guarded-by: _lock
        self.breaker_closes = 0  # guarded-by: _lock
        self.half_open_trials = 0  # guarded-by: _lock
        # success-refilled retry budget: each retry routed HERE spends
        # one token; each successful response refills ``retry_ratio``
        # (capped at ``retry_burst``).  The bucket starts full so a
        # cold gateway can still fail over, but sustained retries are
        # bounded to ratio × sustained successes — a retry RATIO, not
        # a per-request count.
        self.retry_ratio = max(0.0, float(retry_ratio))
        self.retry_burst = max(1.0, float(retry_burst))
        self.retry_tokens = self.retry_burst  # guarded-by: _lock
        self.retries_granted = 0  # guarded-by: _lock
        self.retries_denied = 0  # guarded-by: _lock
        self.last_probe_at: float | None = None  # guarded-by: _lock
        self.last_error: str | None = None  # guarded-by: _lock
        # model names this backend reports serving (from its healthz
        # payload); empty until the first 200 probe — an empty list
        # routes everything, so a pre-probe gateway still forwards
        self.models: list[str] = []  # guarded-by: _lock
        # per-engine mesh advertisement from the healthz payload —
        # {engine: {mesh_shape, param_shard_bytes, hbm_headroom_bytes}}
        # — the gateway's capacity view of this backend's GPUs
        self.mesh: dict = {}  # guarded-by: _lock
        # keep-alive connection pool for forwarding: connections check
        # out per exchange and return unless the response closed them.
        # Its own leaf lock — pool operations never nest under _lock.
        self._conn_lock = threading.Lock()  # serve.gateway.Backend._conn_lock
        self._conns: list[HTTPConnection] = []  # guarded-by: _conn_lock
        self.conns_created = 0  # guarded-by: _conn_lock
        self.conns_reused = 0  # guarded-by: _conn_lock

    # -- keep-alive connection pool ----------------------------------------

    def acquire_conn(self, timeout: float,
                     fresh: bool = False) -> tuple[HTTPConnection, bool]:
        """Check out a connection: ``(conn, reused)``.  ``fresh=True``
        bypasses the pool — the retry-on-stale second attempt must not
        draw another possibly-stale keep-alive socket."""
        conn = None
        if not fresh:
            with self._conn_lock:
                if self._conns:
                    conn = self._conns.pop()
                    self.conns_reused += 1
        if conn is None:
            conn = HTTPConnection(self.host, self.port, timeout=timeout)
            with self._conn_lock:
                self.conns_created += 1
            return conn, False
        if conn.sock is not None:
            # per-use deadline: probes (1 s) and requests (30 s) share
            # the pool, so the timeout rides the checkout, not the conn
            conn.sock.settimeout(timeout)
        return conn, True

    def release_conn(self, conn: HTTPConnection):
        with self._conn_lock:
            if len(self._conns) < 8:
                self._conns.append(conn)
                return
        conn.close()

    def discard_conn(self, conn: HTTPConnection):
        try:
            conn.close()
        except OSError:
            pass

    def close_conns(self):
        """Drop every pooled connection — on gateway stop, and when a
        stale keep-alive surfaces (a restarted backend invalidates the
        WHOLE pool, not just the socket that noticed)."""
        with self._conn_lock:
            conns, self._conns = self._conns, []
        for conn in conns:
            try:
                conn.close()
            except OSError:
                pass

    # -- routing gate ------------------------------------------------------

    def serves(self, model: str | None) -> bool:
        """Does this backend serve ``model``?  None (no path param) and
        an un-probed backend (empty list) both route — the backend
        itself 404s a truly unknown model."""
        if model is None:
            return True
        with self._lock:
            return not self.models or model in self.models

    def routable(self, now: float | None = None) -> bool:
        """May the router send this backend a request right now?  OPEN →
        HALF_OPEN happens here (time-based), so the first caller after
        the cooldown sees the trial slot."""
        now = time.monotonic() if now is None else now
        with self._lock:
            if self.unavailable is not None:
                return False
            if self.breaker == CLOSED:
                return True
            if self.breaker == OPEN:
                if now - (self.opened_at or now) < self.breaker_cooldown_s:
                    return False
                self.breaker = HALF_OPEN
                self._trial_inflight = False
            return not self._trial_inflight

    def begin(self):
        """A request was routed here (claims the half-open trial slot)."""
        with self._lock:
            self.outstanding += 1
            if self.breaker == HALF_OPEN and not self._trial_inflight:
                self._trial_inflight = True
                self.half_open_trials += 1

    # -- outcome recording -------------------------------------------------

    def _failure_locked(self, err: str, now: float):
        self.consecutive_failures += 1
        self.failures += 1
        self.last_error = err
        opened = False
        if self.breaker == HALF_OPEN:
            # the trial failed: re-open with a fresh cooldown
            self.breaker = OPEN
            self.opened_at = now
            self.breaker_opens += 1
            opened = True
        elif self.breaker == CLOSED and \
                self.consecutive_failures >= self.breaker_threshold:
            self.breaker = OPEN
            self.opened_at = now
            self.breaker_opens += 1
            opened = True
        if opened:
            event(_log, "breaker_open", backend=self.name, error=err,
                  consecutive_failures=self.consecutive_failures)
        if self.consecutive_failures >= self.dead_after:
            self.state = DEAD
        elif self.consecutive_failures >= self.degraded_after:
            self.state = DEGRADED

    def _success_locked(self):
        self.consecutive_failures = 0
        if self.breaker != CLOSED:
            self.breaker = CLOSED
            self.breaker_closes += 1
            event(_log, "breaker_close", backend=self.name)
        self._trial_inflight = False
        self.state = OK

    def done_success(self, elapsed_s: float):
        with self._lock:
            self.outstanding -= 1
            self.successes += 1
            self.ewma_s = elapsed_s if self.ewma_s is None else \
                self.ewma_s + self._alpha * (elapsed_s - self.ewma_s)
            # only REAL successes refill the retry budget — sheds and
            # probes don't, so a 100%-shedding backend's bucket stays
            # dry and retries against it stop at the burst allowance
            self.retry_tokens = min(self.retry_burst,
                                    self.retry_tokens + self.retry_ratio)
            self._success_locked()

    def done_shed(self):
        """A 429: the backend is healthy, just out of capacity — resets
        the breaker, but sheds don't feed the service-latency EWMA."""
        with self._lock:
            self.outstanding -= 1
            self.sheds += 1
            self._success_locked()

    def done_failure(self, err: str, now: float | None = None):
        with self._lock:
            self.outstanding -= 1
            self._trial_inflight = False
            self._failure_locked(err, time.monotonic()
                                 if now is None else now)

    # -- retry budget ------------------------------------------------------

    def try_retry(self) -> bool:
        """Spend one retry token against this backend.  False means the
        budget is dry: the caller must NOT retry here — under a
        sustained outage nothing refills the bucket and the retry storm
        dies at the burst allowance instead of amplifying the load."""
        with self._lock:
            if self.retry_tokens >= 1.0:
                self.retry_tokens -= 1.0
                self.retries_granted += 1
                return True
            self.retries_denied += 1
            return False

    def retry_tokens_left(self) -> float:
        with self._lock:
            return self.retry_tokens

    def probe_ok(self, now: float, models: list[str] | None = None,
                 mesh: dict | None = None):
        with self._lock:
            self.probes += 1
            self.last_probe_at = now
            self.unavailable = None
            if models is not None:
                self.models = list(models)
            if mesh is not None:
                self.mesh = dict(mesh)
            self.consecutive_failures = 0
            if self.breaker == CLOSED:
                self.state = OK
            elif now - (self.opened_at or now) >= self.breaker_cooldown_s:
                # the probe IS the half-open trial: close on success
                self.half_open_trials += 1
                self._success_locked()

    def probe_unavailable(self, reason: str, now: float):
        """healthz answered 503: out of routing, no breaker penalty."""
        with self._lock:
            self.probes += 1
            self.last_probe_at = now
            self.unavailable = reason

    def probe_failure(self, err: str, now: float):
        with self._lock:
            self.probes += 1
            self.last_probe_at = now
            self._failure_locked(err, now)

    # -- observability -----------------------------------------------------

    def score(self) -> float:
        """Least-outstanding-work routing score (lower = preferred)."""
        return self.outstanding * (self.ewma_s or 1.0)

    def report(self, now: float | None = None) -> dict:
        now = time.monotonic() if now is None else now
        with self._conn_lock:
            conns = {"pooled": len(self._conns),
                     "created": self.conns_created,
                     "reused": self.conns_reused}
        with self._lock:
            return {
                "conns": conns,
                "url": f"http://{self.name}",
                "state": self.state,
                "breaker": self.breaker,
                "unavailable": self.unavailable,
                "outstanding": self.outstanding,
                "ewma_ms": round(self.ewma_s * 1e3, 3)
                if self.ewma_s is not None else None,
                "consecutive_failures": self.consecutive_failures,
                "failures": self.failures,
                "successes": self.successes,
                "sheds": self.sheds,
                "probes": self.probes,
                "breaker_opens": self.breaker_opens,
                "breaker_closes": self.breaker_closes,
                "half_open_trials": self.half_open_trials,
                "retry_budget": {
                    "tokens": round(self.retry_tokens, 3),
                    "burst": self.retry_burst,
                    "ratio": self.retry_ratio,
                    "granted": self.retries_granted,
                    "denied": self.retries_denied},
                "last_probe_age_s": round(now - self.last_probe_at, 4)
                if self.last_probe_at is not None else None,
                "last_error": self.last_error,
                "models": list(self.models),
                "mesh": dict(self.mesh)}


class _Outcome:
    """One attempt's verdict: ``ok`` (2xx / non-429 4xx — final),
    ``shed`` (429), or ``fail`` (connect error / timeout / 5xx)."""

    __slots__ = ("kind", "status", "headers", "payload", "backend",
                 "error", "hedge_backend")

    def __init__(self, kind, status, headers, payload, backend,
                 error=None):
        self.kind = kind
        self.status = status
        self.headers = headers
        self.payload = payload
        self.backend = backend
        self.error = error
        self.hedge_backend = None  # a hedge that ALSO failed


class Gateway:
    """Health-routed failover proxy over N backend serve processes."""

    def __init__(self, backends: list[str], *,
                 probe_interval_s: float = 0.25,
                 probe_timeout_s: float = 1.0,
                 request_timeout_s: float = 30.0,
                 retry_budget: int = 3,
                 retry_budget_ratio: float = 0.1,
                 retry_budget_burst: float = 10.0,
                 backoff_ms: float = 10.0,
                 backoff_max_ms: float = 250.0,
                 breaker_threshold: int = 3,
                 breaker_cooldown_s: float = 1.0,
                 degraded_after: int = 1, dead_after: int = 5,
                 hedge: bool = False,
                 hedge_after_ms: float | None = None,
                 hedge_min_history: int = 32,
                 affinity: bool = False,
                 tracer: Tracer | None = None,
                 faults=None):
        if not backends:
            raise ValueError("gateway needs at least one backend")
        self.backends = [Backend(u, breaker_threshold=breaker_threshold,
                                 breaker_cooldown_s=breaker_cooldown_s,
                                 degraded_after=degraded_after,
                                 dead_after=dead_after,
                                 retry_ratio=retry_budget_ratio,
                                 retry_burst=retry_budget_burst)
                         for u in backends]
        names = [b.name for b in self.backends]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate backends in {names}")
        self.probe_interval_s = probe_interval_s
        self.probe_timeout_s = probe_timeout_s
        self.request_timeout_s = request_timeout_s
        self.retry_budget = max(0, int(retry_budget))
        self.backoff_ms = backoff_ms
        self.backoff_max_ms = backoff_max_ms
        self.hedge = hedge
        self.hedge_after_ms = hedge_after_ms
        self.hedge_min_history = hedge_min_history
        # payload-digest consistent hashing (rendezvous): repeats of
        # one payload land on one backend so ITS response cache hits,
        # instead of spreading a hot image's repeats across N cold
        # caches.  Opt-in: load-based routing stays the default.
        self.affinity = affinity
        self.tracer = tracer or Tracer()
        self.retry_budget_ratio = retry_budget_ratio
        self.retry_budget_burst = retry_budget_burst
        # optional FaultPlane (serve/faults.py): the "gateway" stage
        # fires per backend attempt, modeling the NETWORK between the
        # gateway and its backends (conn_reset / slow_drip / blackhole)
        self.faults = faults
        self.latency = LatencyHistogram()
        self._lock = threading.Lock()  # serve.gateway.Gateway._lock
        self._stop = threading.Event()
        self._prober: threading.Thread | None = None
        self._pool: ThreadPoolExecutor | None = None  # guarded-by: _lock
        self._rr = 0  # rotating scan offset: idle ties round-robin; guarded-by: _lock
        self.proxied = 0  # guarded-by: _lock
        self.retries = 0  # guarded-by: _lock
        self.failovers = 0  # guarded-by: _lock
        self.hedges = 0  # guarded-by: _lock
        self.hedge_wins = 0  # guarded-by: _lock
        self.exhausted = 0  # guarded-by: _lock
        self.no_backend = 0  # guarded-by: _lock
        self.retry_budget_denied = 0  # guarded-by: _lock

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> "Gateway":
        if self._prober is None:
            self._stop.clear()
            self._probe_all()  # know the fleet before the first request
            self._prober = threading.Thread(target=self._probe_loop,
                                            name="gateway-prober",
                                            daemon=True)
            self._prober.start()
        return self

    def stop(self, timeout: float = 5.0):
        self._stop.set()
        if self._prober is not None:
            self._prober.join(timeout)
            self._prober = None
        with self._lock:
            pool, self._pool = self._pool, None
        if pool is not None:
            pool.shutdown(wait=False)
        for b in self.backends:
            b.close_conns()

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()

    # -- probing (active health) -------------------------------------------

    def _probe_loop(self):
        while not self._stop.wait(self.probe_interval_s):
            self._probe_all()

    def _probe_all(self):
        for b in self.backends:
            if self._stop.is_set():
                return
            now = time.monotonic()
            try:
                status, _, payload = self._call(
                    b, "GET", "/v1/healthz", None, self.probe_timeout_s,
                    pooled=False)
            except (OSError, HTTPException) as e:
                # the listener is gone: every pooled keep-alive socket
                # to it is now a liability — drop them so requests
                # can't ride a half-dead backend past its breaker
                b.close_conns()
                b.probe_failure(f"probe: {type(e).__name__}: {e}", now)
                continue
            if status == 200:
                models = None
                mesh = None
                try:
                    doc = json.loads(payload)
                    if isinstance(doc.get("models"), list):
                        models = [str(m) for m in doc["models"]]
                    # mesh advertisement: each engine's health report
                    # carries its weight layout + per-GPU headroom —
                    # the fleet capacity table in gateway /v1/stats
                    engines = doc.get("engines")
                    if isinstance(engines, dict):
                        mesh = {
                            str(en): {
                                "mesh_shape": rep.get("mesh_shape"),
                                "param_shard_bytes":
                                    rep.get("param_shard_bytes"),
                                "hbm_headroom_bytes":
                                    rep.get("hbm_headroom_bytes")}
                            for en, rep in engines.items()
                            if isinstance(rep, dict)}
                except (ValueError, AttributeError):
                    pass
                b.probe_ok(now, models=models, mesh=mesh)
            else:
                reason = "unavailable"
                try:
                    reason = json.loads(payload).get("status", reason)
                except (ValueError, AttributeError):
                    pass
                b.probe_unavailable(reason, now)

    # -- request path ------------------------------------------------------

    def forward(self, path: str, body: bytes,
                request_id: str | None = None
                ) -> tuple[int, dict, bytes]:
        """Proxy one inference request: route, retry, fail over, hedge.
        Returns ``(status, headers, payload)`` for the client.  The
        request id (client-provided or minted here) rides the
        ``X-DVT-Request-Id`` header to the backend and back, so one id
        names the whole gateway→backend→engine path; ``?debug=1``
        responses additionally carry the gateway-side span as
        ``gateway_trace`` next to the backend's ``trace``."""
        rid = request_id or new_request_id()
        span = self.tracer.start(rid, origin="recv")
        try:
            status, headers, payload = self._forward(path, body, rid,
                                                     span)
            if span is not None:
                span.mark("respond")
                if status == 200 and self._debug_requested(path):
                    payload = self._attach_gateway_trace(payload, span)
            headers = dict(headers)
            headers[REQUEST_ID_HEADER] = rid
            return status, headers, payload
        finally:
            self.tracer.finish(span)

    @staticmethod
    def _debug_requested(path: str) -> bool:
        q = path.partition("?")[2]
        return parse_qs(q).get("debug", ["0"])[0] not in ("", "0")

    @staticmethod
    def _attach_gateway_trace(payload: bytes, span) -> bytes:
        try:
            doc = json.loads(payload)
            doc["gateway_trace"] = span.to_dict()
            return json.dumps(doc).encode()
        except (ValueError, TypeError):
            return payload  # not JSON: leave the body alone

    @staticmethod
    def _path_model(path: str) -> str | None:
        """The model name a /v1/models/<name>/<verb> path routes on
        (None for the classic un-named routes)."""
        parts = path.partition("?")[0].split("/")
        if len(parts) == 5 and parts[1] == "v1" and parts[2] == "models":
            return parts[3]
        return None

  
    def _forward(self, path: str, body: bytes, rid: str, span
                 ) -> tuple[int, dict, bytes]:
        t0 = time.monotonic()
        model = self._path_model(path)
        # rendezvous affinity key: the payload digest, hashed once per
        # request (retries reuse it — failover is just the next-highest
        # backend in the same hash ranking)
        akey = hashlib.blake2b(body, digest_size=8).digest() \
            if self.affinity and body else None
        with self._lock:
            self.proxied += 1
        tried: list[Backend] = []
        last_shed: _Outcome | None = None
        last_fail: _Outcome | None = None
        prev: Backend | None = None
        for attempt in range(1 + self.retry_budget):
            b = self._pick(tried, model, akey)
            if b is None and tried:
                # every routable backend failed this request once —
                # clear the exclusions so the backoff'd retry may
                # revisit (a transient blip shouldn't 502 the client)
                tried = []
                b = self._pick(tried, model, akey)
            if b is None:
                break
            if attempt > 0:
                if not b.try_retry():
                    # the target's retry budget is dry: retrying would
                    # push the storm past the configured ratio.  Skip
                    # this backend (another may have tokens); when all
                    # are dry the loop runs out and the request answers
                    # with the last verdict it holds.
                    with self._lock:
                        self.retry_budget_denied += 1
                    if span is not None:
                        span.note("retry_budget_denied", b.name)
                    tried.append(b)
                    continue
                with self._lock:
                    self.retries += 1
                    if prev is not None and b is not prev:
                        self.failovers += 1
                if span is not None:
                    span.note("failover" if b is not prev else "retry",
                              b.name)
                if last_shed is None or b is prev:
                    # backoff applies to failures and same-backend
                    # retries; failing a 429 over to a DIFFERENT
                    # backend goes immediately
                    self._backoff(attempt)
            prev = b
            if span is not None:
                span.note("attempt", b.name)
            out = self._attempt(b, path, body, allow_hedge=attempt == 0,
                                rid=rid, span=span)
            if span is not None:
                # one backend_hop segment per attempt (accumulates):
                # the span's proxy-side time is attempts + respond
                span.mark("backend_hop")
            if out.kind == "ok":
                with self._lock:  # histogram increments aren't atomic
                    self.latency.record(time.monotonic() - t0)
                return out.status, self._client_headers(out), out.payload
            tried.append(out.backend)
            if out.hedge_backend is not None:
                tried.append(out.hedge_backend)
            if out.kind == "shed":
                last_shed = out
                if span is not None:
                    span.note("shed", out.backend.name)
                if self._pick(tried, model, akey) is None:
                    break  # nobody with headroom: propagate the 429
            else:
                last_fail = out
        with self._lock:
            if last_shed is None and last_fail is None:
                self.no_backend += 1
            else:
                self.exhausted += 1
        if last_shed is not None:
            # propagate the shed verbatim, Retry-After included
            return (last_shed.status, self._client_headers(last_shed),
                    last_shed.payload)
        if last_fail is not None:
            detail = last_fail.error or f"HTTP {last_fail.status}"
            return 502, {
                "Content-Type": "application/json",
                RETRY_BUDGET_HEADER:
                    f"{last_fail.backend.retry_tokens_left():.2f}",
            }, json.dumps(
                {"error": f"all backends failed after "
                          f"{1 + self.retry_budget} attempt(s): "
                          f"{detail}"}).encode()
        return 503, {"Content-Type": "application/json",
                     RETRY_BUDGET_HEADER: "0.00",
                     "Retry-After": max(1, math.ceil(
                         self.probe_interval_s))}, json.dumps(
            {"error": "no routable backend (all DEAD, draining, or "
                      "breaker-open)"}).encode()

    @staticmethod
    def _client_headers(out: _Outcome) -> dict:
        h = {k: out.headers[k] for k in _PROXY_HEADERS
             if k in out.headers}
        # budget state rides every proxied answer: a client deciding
        # whether to retry a 429/5xx sees the same bucket the gateway
        # spends from, so the two can't jointly exceed the ratio
        h[RETRY_BUDGET_HEADER] = \
            f"{out.backend.retry_tokens_left():.2f}"
        return h

    def _pick(self, exclude: list, model: str | None = None,
              affinity_key: bytes | None = None
              ) -> Backend | None:
        """Least outstanding work (outstanding × latency EWMA) over
        routable backends, scanning from a rotating offset with strict
        less-than — an idle fleet round-robins instead of piling onto
        backend 0 (same policy as serve/replicas.py).  ``model``
        (from a /v1/models/<name>/... path) filters to backends whose
        probed model list serves it.

        With an ``affinity_key`` (the payload digest, when
        ``affinity=True``), routing switches to rendezvous hashing:
        every candidate scores ``blake2b(key | backend-name)`` and the
        highest wins — repeats of one payload deterministically land on
        one backend (its response cache hits), a dead/excluded backend
        just drops out of the candidate set (only ITS keys move), and
        failover falls through to the next-highest hash."""
        now = time.monotonic()
        n = len(self.backends)
        with self._lock:
            start = self._rr % n
            self._rr += 1
        best = best_score = None
        for k in range(n):
            b = self.backends[(start + k) % n]
            if b in exclude or not b.routable(now) \
                    or not b.serves(model):
                continue
            if affinity_key is not None:
                # highest-random-weight: bigger hash wins
                score = -int.from_bytes(hashlib.blake2b(
                    affinity_key + b.name.encode(),
                    digest_size=8).digest(), "big")
            else:
                score = b.score()
            if best_score is None or score < best_score:
                best, best_score = b, score
        return best

    def _backoff(self, attempt: int):
        base = min(self.backoff_max_ms,
                   self.backoff_ms * (2 ** (attempt - 1)))
        # full jitter in [0.5, 1.5)×base: retries from a burst of
        # failovers must not re-converge on the survivor in lockstep
        time.sleep(base * (0.5 + random.random()) / 1e3)

    # -- single attempt + hedging ------------------------------------------

    def _attempt(self, b: Backend, path: str, body: bytes,
                 allow_hedge: bool, rid: str | None = None,
                 span=None) -> _Outcome:
        delay_s = self._hedge_delay_s() if allow_hedge else None
        if delay_s is None:
            return self._single(b, path, body, rid)
        pool = self._hedge_pool()
        primary = pool.submit(self._single, b, path, body, rid)
        done, _ = wait([primary], timeout=delay_s)
        if done:
            return primary.result()
        b2 = self._pick([b], self._path_model(path))
        if b2 is None:
            return primary.result()  # nobody to hedge to: just wait
        with self._lock:
            self.hedges += 1
        if span is not None:
            # noted from the forwarding thread only — the pool workers
            # never touch the span (single-writer ownership rule)
            span.note("hedge", b2.name)
        hedge = pool.submit(self._single, b2, path, body, rid)
        pending = {primary, hedge}
        while pending:
            done, pending = wait(pending, return_when=FIRST_COMPLETED)
            for f in done:
                out = f.result()
                if out.kind == "ok":
                    # first answer wins; the loser keeps running in the
                    # pool and its (counted) result is discarded
                    if f is hedge:
                        with self._lock:
                            self.hedge_wins += 1
                        if span is not None:
                            span.note("hedge_win", b2.name)
                    return out
        out = primary.result()
        if out.kind == "ok":  # pending-set raced: prefer any success
            return out
        out.hedge_backend = hedge.result().backend
        return out

    def _hedge_delay_s(self) -> float | None:
        if not self.hedge or len(self.backends) < 2:
            return None
        if self.hedge_after_ms is not None:
            return self.hedge_after_ms / 1e3
        # p99-based: hedge only the tail, and only once the gateway has
        # enough of its own history to know where the tail is
        p = self.latency.percentiles()
        if p["count"] < self.hedge_min_history:
            return None
        return p["p99_ms"] / 1e3

    def _hedge_pool(self) -> ThreadPoolExecutor:
        with self._lock:
            if self._pool is None:
                self._pool = ThreadPoolExecutor(
                    max_workers=2 * len(self.backends) + 2,
                    thread_name_prefix="gateway-hedge")
            return self._pool

    def _single(self, b: Backend, path: str, body: bytes,
                rid: str | None = None) -> _Outcome:
        b.begin()
        t0 = time.monotonic()
        try:
            if self.faults is not None and self.faults.enabled:
                # the injected NETWORK between gateway and backend:
                # conn_reset raises ConnectionResetError and blackhole
                # raises TimeoutError — both OSError subclasses, so
                # they ride the real failure path below untouched
                self.faults.inject("gateway", stop=self._stop)
            status, headers, payload = self._call(
                b, "POST", path, body, self.request_timeout_s,
                extra_headers={REQUEST_ID_HEADER: rid} if rid else None)
        except (OSError, HTTPException, InjectedFault) as e:
            err = f"{b.name}: {type(e).__name__}: {e}"
            b.done_failure(err)
            return _Outcome("fail", 0, {}, b"", b, error=err)
        if status >= 500:
            b.done_failure(f"{b.name}: HTTP {status}")
            return _Outcome("fail", status, headers, payload, b,
                            error=f"{b.name}: HTTP {status}")
        if status == 429:
            b.done_shed()
            return _Outcome("shed", status, headers, payload, b)
        b.done_success(time.monotonic() - t0)
        return _Outcome("ok", status, headers, payload, b)

    @staticmethod
    def _call(b: Backend, method: str, path: str, body: bytes | None,
              timeout: float, extra_headers: dict | None = None,
              pooled: bool = True) -> tuple[int, dict, bytes]:
        """One HTTP exchange over the backend's keep-alive pool.

        A REUSED connection can die for a reason that says nothing
        about the backend — it closed the idle socket between our
        requests — so an error on a reused connection discards the
        whole pool (a restarted backend invalidates every pooled
        socket) and retries ONCE on a fresh connection.  An error on a
        FRESH connection is the real thing (SIGKILL'd process, TCP
        reset) and propagates — failure detection stays exactly as
        sharp as the old connection-per-call scheme.  Retrying the
        exchange is safe even for POSTs: a stale keep-alive fails at
        send time, before the backend saw the request.

        ``pooled=False`` forces a fresh dial-and-close exchange —
        health probes use it, because a probe's whole job is proving
        the backend still ACCEPTS connections; probing over a pooled
        socket would let an established keep-alive mask a backend
        whose listener is gone."""
        headers = {"Content-Type": "application/json"} if body else {}
        if extra_headers:
            headers.update(extra_headers)
        if not pooled:
            conn = HTTPConnection(b.host, b.port, timeout=timeout)
            try:
                conn.request(method, path, body=body, headers=headers)
                resp = conn.getresponse()
                return resp.status, dict(resp.getheaders()), resp.read()
            finally:
                conn.close()
        for attempt in (0, 1):
            conn, reused = b.acquire_conn(timeout, fresh=attempt > 0)
            try:
                conn.request(method, path, body=body, headers=headers)
                resp = conn.getresponse()
                payload = resp.read()
            except (OSError, HTTPException):
                b.discard_conn(conn)
                if reused:
                    b.close_conns()
                    continue  # stale keep-alive: one fresh retry
                raise
            if resp.will_close:
                b.discard_conn(conn)
            else:
                b.release_conn(conn)
            return resp.status, dict(resp.getheaders()), payload
        raise HTTPException(f"{b.name}: unreachable retry state")

    # -- observability -----------------------------------------------------

    def routable_backends(self, now: float | None = None) -> list[str]:
        now = time.monotonic() if now is None else now
        return [b.name for b in self.backends if b.routable(now)]

    def counters(self) -> dict:
        with self._lock:
            return {"proxied": self.proxied, "retries": self.retries,
                    "failovers": self.failovers, "hedges": self.hedges,
                    "hedge_wins": self.hedge_wins,
                    "exhausted": self.exhausted,
                    "no_backend": self.no_backend,
                    "retry_budget_denied": self.retry_budget_denied,
                    "retry_budget_ratio": self.retry_budget_ratio,
                    "retry_budget_burst": self.retry_budget_burst,
                    "breaker_opens": sum(b.breaker_opens
                                         for b in self.backends),
                    "breaker_closes": sum(b.breaker_closes
                                          for b in self.backends)}

    def healthz(self) -> tuple[bool, dict]:
        now = time.monotonic()
        routable = self.routable_backends(now)
        ok = bool(routable)
        return ok, {"status": "ok" if ok else "unhealthy",
                    "routable": routable,
                    "backends": {b.name: b.report(now)
                                 for b in self.backends},
                    "gateway": self.counters()}

    def stats(self, include_backend_stats: bool = True) -> dict:
        now = time.monotonic()
        with self._lock:
            gw_latency = self.latency.percentiles()
            gw_hist = self.latency.state_dict()
        out = {"gateway": {**self.counters(),
                           "latency": gw_latency,
                           "latency_hist": gw_hist,
                           "trace": self.tracer.summary(),
                           "backends": {b.name: b.report(now)
                                        for b in self.backends}}}
        if self.faults is not None and self.faults.enabled:
            out["gateway"]["faults"] = self.faults.stats()
        if include_backend_stats:
            agg: dict = {}
            for b in self.backends:
                try:
                    status, _, payload = self._call(
                        b, "GET", "/v1/stats", None,
                        self.probe_timeout_s)
                    agg[b.name] = json.loads(payload) if status == 200 \
                        else {"error": f"HTTP {status}"}
                except (OSError, HTTPException, ValueError) as e:
                    agg[b.name] = {"error": f"{type(e).__name__}: {e}"}
            out["backends"] = agg
            merged, mfu, per_model = self._aggregate_backends(agg)
            # fleet-level latency DISTRIBUTION: per-backend histogram
            # states sum bin-wise (identical fixed edges), so the p99
            # here is the true fleet p99 — not an average of per-backend
            # p99s, which has no meaning
            out["gateway"]["backend_latency"] = \
                merged.percentiles() if merged is not None else None
            out["gateway"]["backend_latency_hist"] = \
                merged.state_dict() if merged is not None else None
            out["gateway"]["mfu"] = mfu
            out["gateway"]["models"] = per_model
            cas = self._aggregate_cascade(agg)
            if cas is not None:
                out["gateway"]["cascade"] = cas
        return out

    @staticmethod
    def _aggregate_cascade(agg: dict):
        """Fold each backend's reserved ``cascade`` stats block into
        one fleet view: summed tier/escalation/sample counters, a
        fleet-wide escalation rate, per-HOP escalation/sample/
        agreement-sample folds keyed by (hop, tier) across the chain,
        and per-tier latency percentiles from bin-wise-merged
        histograms (true fleet quantiles, same construction as the
        backend-latency merge above).  None when no backend runs a
        cascade."""
        served: dict = {}
        esc = esc_low = esc_shed = samples = forced = 0
        backends = []
        hists: dict = {}
        hops: dict = {}  # hop index -> folded per-hop block
        for bname, bstats in agg.items():
            cas = bstats.get("cascade") \
                if isinstance(bstats, dict) else None
            if not isinstance(cas, dict):
                continue
            backends.append(bname)
            for tier, n in (cas.get("served") or {}).items():
                served[tier] = served.get(tier, 0) + int(n or 0)
            esc += int(cas.get("escalations") or 0)
            esc_low += int(cas.get("escalated_lowconf") or 0)
            esc_shed += int(cas.get("escalated_shed") or 0)
            samples += int(cas.get("samples") or 0)
            forced += int(cas.get("forced_big") or 0)
            for hop in (cas.get("hops") or []):
                if not isinstance(hop, dict):
                    continue
                i = hop.get("hop")
                agg_hop = hops.setdefault(
                    i, {"hop": i, "tier": hop.get("tier"),
                        "token": hop.get("token"),
                        "escalations": 0, "samples": 0,
                        "sample_size": 0, "calibrated_backends": 0})
                agg_hop["escalations"] += int(
                    hop.get("escalations") or 0)
                agg_hop["samples"] += int(hop.get("samples") or 0)
                agg_hop["sample_size"] += int(
                    hop.get("sample_size") or 0)
                if hop.get("calibrated"):
                    agg_hop["calibrated_backends"] += 1
            for tier, h in (cas.get("latency_hist") or {}).items():
                if not h:
                    continue
                try:
                    mh = hists.get(tier)
                    if mh is None:
                        mh = hists[tier] = LatencyHistogram()
                        mh.load_state_dict(h)
                    else:
                        mh.merge(h)
                except (KeyError, ValueError, TypeError):
                    pass  # malformed or mismatched bins: skip
        if not backends:
            return None
        # everything a non-final tier answered was "judged" by the
        # chain; escalations that ended big-served or shed complete the
        # denominator (the 2-tier formula, generalized)
        routed = sum(n for t, n in served.items() if t != "big") \
            + esc_low + esc_shed
        return {"backends": backends,
                "served": served,
                "escalations": esc,
                "escalation_rate": ((esc_low + esc_shed) / routed)
                if routed else None,
                "samples": samples,
                "forced_big": forced,
                "hops": [hops[i] for i in sorted(hops)],
                "latency": {t: h.percentiles()
                            for t, h in hists.items()}}

    @staticmethod
    def _iter_engine_stats(bstats: dict):
        """Yield (model_name, engine_stats) from one backend's /v1/stats
        body — BOTH shapes: the legacy flat {name: engine.stats()} dict
        and the control-plane shape {"models": {name: {"engine": ...}},
        "cache": ..., "plane": ...}."""
        containers = bstats.get("models") \
            if isinstance(bstats.get("models"), dict) else bstats
        for name, mstats in containers.items():
            if not isinstance(mstats, dict):
                continue
            es = mstats.get("engine") \
                if isinstance(mstats.get("engine"), dict) else mstats
            if isinstance(es, dict) and "latency_hist" in es:
                yield name, es

    @staticmethod
    def _aggregate_backends(agg: dict):
        """Fold fetched backend /v1/stats into fleet-level views: one
        merged ``LatencyHistogram``, one MFU report (FLOPs and compute
        seconds sum across backends, MFU recomputes from the sums — a
        throughput-weighted aggregate by construction), and a per-model
        cross-backend table (served counts, merged-latency percentiles,
        which backends serve it)."""
        merged: LatencyHistogram | None = None
        flops = secs = 0.0
        batches = images = 0
        peak = None
        source = None
        per_model: dict = {}
        model_hists: dict = {}
        for bname, bstats in agg.items():
            if not isinstance(bstats, dict) or "error" in bstats:
                continue
            for name, mstats in Gateway._iter_engine_stats(bstats):
                hist = mstats.get("latency_hist")
                if hist:
                    try:
                        if merged is None:
                            merged = LatencyHistogram()
                            merged.load_state_dict(hist)
                        else:
                            merged.merge(hist)
                        mh = model_hists.get(name)
                        if mh is None:
                            mh = model_hists[name] = LatencyHistogram()
                            mh.load_state_dict(hist)
                        else:
                            mh.merge(hist)
                    except (KeyError, ValueError, TypeError):
                        pass  # malformed or mismatched bins: skip
                ent = per_model.setdefault(
                    name, {"served": 0, "submitted": 0, "backends": [],
                           "mesh": {}})
                ent["served"] += int(mstats.get("served") or 0)
                ent["submitted"] += int(mstats.get("submitted") or 0)
                ent["backends"].append(bname)
                # per-backend weight layout: the fleet capacity table —
                # which cells shard (per-GPU bytes < global) and which
                # replicate, straight from each engine's stats
                ent["mesh"][bname] = {
                    "mesh_shape": mstats.get("mesh_shape"),
                    "param_shard_bytes": mstats.get("param_shard_bytes"),
                    "param_global_bytes":
                        mstats.get("param_global_bytes")}
                m = mstats.get("mfu") or {}
                flops += float(m.get("flops_total") or 0.0)
                secs += float(m.get("compute_s") or 0.0)
                batches += int(m.get("batches") or 0)
                images += int(m.get("images") or 0)
                if peak is None:
                    peak = m.get("peak_flops_per_s")
                if source is None:
                    source = m.get("flops_source")
        for name, mh in model_hists.items():
            per_model[name]["latency"] = mh.percentiles()
        mfu_val = flops / secs / peak \
            if secs > 0 and flops > 0 and peak else None
        mfu = {"serving_mfu": round_mfu(mfu_val),
               "flops_total": flops, "compute_s": round(secs, 6),
               "batches": batches, "images": images,
               "peak_flops_per_s": peak, "flops_source": source}
        return merged, mfu, per_model


def render_gateway_metrics(gw: Gateway, edge: dict | None = None) -> str:
    """Prometheus text for ``GET /metrics`` on the gateway: its own
    counters + per-backend breaker/load gauges + its request-latency
    histogram, plus the fleet aggregates (merged backend latency
    distribution and ``dvt_gateway_serving_mfu``) fetched from backend
    /v1/stats — one scrape sees the whole serving tier.  ``edge`` (the
    front-end EdgeServer's ``stats()``) adds the connection gauges."""
    from deep_vision_tpu_torch.core.metrics import PromText

    s = gw.stats()
    g = s["gateway"]
    p = PromText()
    if isinstance(edge, dict):
        p.gauge("dvt_gateway_open_connections",
                edge.get("open_connections"),
                help="Client sockets open on the gateway edge")
        p.counter("dvt_gateway_edge_keepalive_reuses_total",
                  edge.get("keepalive_reuses"),
                  help="Client requests after the first per connection")
        p.counter("dvt_gateway_edge_accepted_total",
                  edge.get("accepted"),
                  help="Client connections accepted")
    p.counter("dvt_gateway_proxied_total", g["proxied"],
              help="Inference requests entering forward()")
    p.counter("dvt_gateway_retries_total", g["retries"],
              help="Attempts beyond each request's first")
    p.counter("dvt_gateway_failovers_total", g["failovers"],
              help="Retries that moved to a different backend")
    p.counter("dvt_gateway_hedges_total", g["hedges"],
              help="Tail-hedge duplicates issued")
    p.counter("dvt_gateway_hedge_wins_total", g["hedge_wins"],
              help="Hedged duplicates that answered first")
    p.counter("dvt_gateway_exhausted_total", g["exhausted"],
              help="Requests that failed every attempt")
    p.counter("dvt_gateway_no_backend_total", g["no_backend"],
              help="Requests with no routable backend at all")
    p.counter("dvt_gateway_retry_budget_denied_total",
              g["retry_budget_denied"],
              help="Retries refused because the target backend's "
                   "success-refilled token bucket was dry")
    p.gauge("dvt_gateway_retry_budget_ratio", g["retry_budget_ratio"],
            help="Tokens refilled per successful backend response")
    p.gauge("dvt_gateway_routable_backends",
            len(gw.routable_backends()),
            help="Backends currently accepting routed traffic")
    for b in gw.backends:
        r = b.report()
        lab = {"backend": b.name}
        p.gauge("dvt_gateway_backend_up",
                1 if r["breaker"] == CLOSED and not r["unavailable"]
                else 0, lab,
                help="1 while breaker-closed and not draining")
        p.gauge("dvt_gateway_backend_breaker_state",
                {CLOSED: 0, HALF_OPEN: 1, OPEN: 2}[r["breaker"]], lab,
                help="0 closed, 1 half-open, 2 open")
        p.counter("dvt_gateway_backend_successes_total",
                  r["successes"], lab)
        p.counter("dvt_gateway_backend_failures_total",
                  r["failures"], lab)
        p.counter("dvt_gateway_backend_sheds_total", r["sheds"], lab)
        p.counter("dvt_gateway_backend_breaker_opens_total",
                  r["breaker_opens"], lab)
        p.gauge("dvt_gateway_backend_outstanding", r["outstanding"],
                lab, help="Requests in flight to this backend")
        p.gauge("dvt_gateway_backend_ewma_seconds",
                r["ewma_ms"] / 1e3 if r["ewma_ms"] is not None
                else None, lab, help="Per-backend latency EWMA")
        rb = r.get("retry_budget") or {}
        p.gauge("dvt_gateway_backend_retry_tokens", rb.get("tokens"),
                lab, help="Retry-budget tokens available (refilled "
                          "by successes, spent by retries)")
        p.counter("dvt_gateway_backend_retries_granted_total",
                  rb.get("granted"), lab)
        p.counter("dvt_gateway_backend_retries_denied_total",
                  rb.get("denied"), lab)
        conns = r.get("conns") or {}
        p.counter("dvt_gateway_backend_conns_created_total",
                  conns.get("created"), lab,
                  help="Backend connections dialed")
        p.counter("dvt_gateway_backend_conns_reused_total",
                  conns.get("reused"), lab,
                  help="Keep-alive checkouts from the backend pool")
    p.histogram("dvt_gateway_request_latency_seconds",
                g["latency_hist"],
                help="Gateway-side forward() latency (incl. retries)")
    if g.get("backend_latency_hist"):
        p.histogram("dvt_gateway_backend_latency_seconds",
                    g["backend_latency_hist"],
                    help="Backend engine latency merged fleet-wide")
    mfu = g.get("mfu") or {}
    p.gauge("dvt_gateway_serving_mfu", mfu.get("serving_mfu"),
            help="Fleet serving MFU (summed FLOPs / summed compute "
                 "seconds / peak)")
    cas = g.get("cascade")
    if isinstance(cas, dict):
        p.counter("dvt_gateway_cascade_escalations_total",
                  cas.get("escalations"),
                  help="Cascade escalations summed across backends")
        p.gauge("dvt_gateway_cascade_escalation_rate",
                cas.get("escalation_rate"),
                help="Fleet-wide fraction of cheap-tier-judged "
                     "requests escalated down the chain")
        for tier, n in sorted((cas.get("served") or {}).items()):
            p.counter("dvt_gateway_cascade_requests_total", n,
                      {"tier": str(tier)},
                      help="Cascade answers fleet-wide by answering "
                           "tier")
        for hop in (cas.get("hops") or []):
            hlab = {"hop": str(hop.get("hop")),
                    "tier": str(hop.get("tier"))}
            p.counter("dvt_gateway_cascade_hop_escalations_total",
                      hop.get("escalations"), hlab,
                      help="Requests this hop escalated onward, "
                           "summed across backends")
            p.gauge("dvt_gateway_cascade_hop_calibrated_backends",
                    hop.get("calibrated_backends"), hlab,
                    help="Backends where this hop currently holds a "
                         "calibrated threshold")
    tr = g.get("trace") or {}
    p.counter("dvt_gateway_traces_finished_total", tr.get("finished"),
              help="Gateway spans sealed into the ring")
    p.counter("dvt_gateway_slow_traces_total", tr.get("slow_sampled"),
              help="Gateway traces over the slow threshold")
    for stage, secs in (tr.get("stage_s_total") or {}).items():
        p.counter("dvt_gateway_stage_seconds_total", secs,
                  {"stage": stage},
                  help="Cumulative gateway span stage time")
    return p.render()


class _GatewayHandler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    _rid = None

    def setup(self):
        # per-connection socket timeout (StreamRequestHandler applies
        # self.timeout): a stalled client can't pin a handler thread
        self.timeout = self.server.socket_timeout_s  # type: ignore
        super().setup()

    def log_message(self, fmt, *args):
        if self.server.verbose:  # type: ignore[attr-defined]
            super().log_message(fmt, *args)

    def _reply(self, status: int, payload: dict,
               headers: dict | None = None):
        blob = json.dumps(payload).encode()
        self._reply_raw(status, blob, headers)

    def _reply_raw(self, status: int, blob: bytes,
                   headers: dict | None = None):
        self.send_response(status)
        headers = dict(headers or {})
        headers.setdefault("Content-Type", "application/json")
        if self._rid is not None:
            headers.setdefault(REQUEST_ID_HEADER, self._rid)
        for k, v in headers.items():
            self.send_header(k, str(v))
        self.send_header("Content-Length", str(len(blob)))
        self.end_headers()
        self.wfile.write(blob)

    def do_GET(self):
        gw: Gateway = self.server.gateway  # type: ignore[attr-defined]
        path, _, query = self.path.partition("?")
        if path == "/v1/healthz":
            ok, payload = gw.healthz()
            self._reply(200 if ok else 503, payload)
        elif path == "/v1/stats":
            stats = gw.stats()
            edge_stats = getattr(self.server, "stats", None)
            if callable(edge_stats):
                stats["edge"] = edge_stats()
            self._reply(200, stats)
        elif path == "/metrics":
            edge_stats = getattr(self.server, "stats", None)
            text = render_gateway_metrics(
                gw, edge=edge_stats() if callable(edge_stats) else None)
            self._reply_raw(
                200, text.encode(),
                {"Content-Type":
                 "text/plain; version=0.0.4; charset=utf-8"})
        elif path == "/v1/traces":
            n = int(parse_qs(query).get("n", ["32"])[0])
            self._reply(200, {"traces": gw.tracer.recent(n),
                              "summary": gw.tracer.summary()})
        else:
            self._reply(404, {"error": f"no route {self.path}"})

    def do_POST(self):
        gw: Gateway = self.server.gateway  # type: ignore[attr-defined]
        path = self.path.partition("?")[0]
        # one id for the whole path: reuse the client's if it sent one,
        # mint otherwise; forward() sends it to the backend and its
        # reply echo lands on our response via _reply_raw
        self._rid = self.headers.get(REQUEST_ID_HEADER) \
            or new_request_id()
        try:
            # /v1/models/<name>/<verb> routes on the path's model (the
            # gateway filters to backends probing that name); lifecycle
            # verbs forward to EVERY backend serving it — a reload must
            # reach the whole fleet, not one member.  The inference
            # verb set derives from the workload registry
            # (serve/workloads.py) — same source as the backends, so
            # the gateway never 404s a verb a backend would serve
            from deep_vision_tpu_torch.serve.workloads import (
                LIFECYCLE_VERBS,
                infer_paths,
                infer_verbs,
            )

            parts = path.split("/")
            model_route = (len(parts) == 5 and parts[1] == "v1"
                           and parts[2] == "models")
            if model_route and parts[4] in LIFECYCLE_VERBS:
                self._lifecycle_fanout(gw, parts[3], parts[4])
                return
            if path not in infer_paths() and not (
                    model_route and parts[4] in infer_verbs()):
                self._reply(404, {
                    "error": f"no route {self.path}",
                    "supported_verbs": sorted(
                        infer_verbs() + LIFECYCLE_VERBS)})
                return
            length = int(self.headers.get("Content-Length") or 0)
            if length <= 0:
                self._reply(400, {"error": "empty body"})
                return
            cap = self.server.max_body_bytes  # type: ignore
            if length > cap:
                self.close_connection = True
                self._reply(413, {"error": f"body of {length} bytes "
                                           f"exceeds the {cap}-byte cap"})
                return
            body = self.rfile.read(length)
            status, headers, payload = gw.forward(self.path, body,
                                                  request_id=self._rid)
            self._reply_raw(status, payload, headers)
        except TimeoutError:
            # client stalled mid-body: answer 408 and drop the
            # connection instead of pinning this thread
            self.close_connection = True
            self._reply(408, {"error": "timed out reading request body"})
        except Exception as e:  # noqa: BLE001 — surface, don't kill worker
            self._reply(500, {"error": f"{type(e).__name__}: {e}"})
        finally:
            self._rid = None

    def _lifecycle_fanout(self, gw: Gateway, name: str, verb: str):
        """POST /v1/models/<name>/<verb> to every routable backend that
        serves ``name``; the per-backend verdicts come back keyed by
        backend.  200 when at least one backend accepted; 409 when none
        accepted but at least one answered 409 (reload already in
        progress / nothing to promote — the fleet is busy, not broken);
        502 only when every backend actually failed the call."""
        length = int(self.headers.get("Content-Length") or 0)
        body = self.rfile.read(length) if length > 0 else b"{}"
        now = time.monotonic()
        results: dict = {}
        any_ok = any_busy = False
        for b in gw.backends:
            if not b.routable(now) or not b.serves(name):
                continue
            try:
                status, _, payload = gw._call(
                    b, "POST", f"/v1/models/{name}/{verb}", body,
                    gw.request_timeout_s)
                try:
                    doc = json.loads(payload)
                except ValueError:
                    doc = {"raw": payload.decode(errors="replace")}
                # the HTTP code gets its own key: the backend's body
                # carries a "status" verdict string (reloading/refused/
                # in_progress) that must not mask it
                results[b.name] = {"http_status": status, **(
                    doc if isinstance(doc, dict) else {"body": doc})}
                any_ok = any_ok or status == 200
                any_busy = any_busy or status == 409
            except (OSError, HTTPException) as e:
                results[b.name] = {"http_status": None,
                                   "error": f"{type(e).__name__}: {e}"}
        if not results:
            self._reply(503, {"error": f"no routable backend serves "
                                       f"'{name}'"})
            return
        self._reply(200 if any_ok else (409 if any_busy else 502),
                    {"model": name, "verb": verb, "backends": results})


class GatewayServer:
    """HTTP front for a ``Gateway`` (mirrors ``serve.http.ServeServer``):
    the selector edge by default, ``edge=False`` for the
    thread-per-request baseline."""

    def __init__(self, gateway: Gateway, host: str = "127.0.0.1",
                 port: int = 0, verbose: bool = False,
                 max_body_bytes: int = 32 * 2**20,
                 socket_timeout_s: float | None = 30.0,
                 edge: bool = True,
                 max_connections: int = DEFAULT_MAX_CONNECTIONS,
                 http_workers: int = 8):
        self.gateway = gateway
        if edge:
            self.httpd = EdgeServer((host, port), _GatewayHandler,
                                    max_connections=max_connections,
                                    workers=http_workers,
                                    name="gateway")
        else:
            self.httpd = ThreadingHTTPServer((host, port),
                                             _GatewayHandler)
        self.httpd.gateway = gateway
        self.httpd.verbose = verbose
        self.httpd.max_body_bytes = max_body_bytes
        self.httpd.socket_timeout_s = socket_timeout_s
        self._thread: threading.Thread | None = None

    @property
    def host(self) -> str:
        return self.httpd.server_address[0]

    @property
    def port(self) -> int:
        return self.httpd.server_address[1]

    def serve_forever(self):
        self.httpd.serve_forever()

    def start_background(self) -> "GatewayServer":
        self._thread = threading.Thread(target=self.serve_forever,
                                        name="gateway-http", daemon=True)
        self._thread.start()
        return self

    def shutdown(self):
        self.httpd.shutdown()
        self.httpd.server_close()
        if self._thread is not None:
            self._thread.join(5.0)
            self._thread = None
