"""Engine health: heartbeats + an explicit OK → DEGRADED → DEAD machine.

Copy of ``deep_vision_tpu/serve/health.py``.  The port serves one engine
a model version (replicas come in a later slice).

Production model servers treat deep health as first-class (Clipper,
NSDI'17: supervised containers behind health probes); a static 200 from
``/v1/healthz`` tells a load balancer nothing when the batcher thread is
dead and every future parks forever.  ``EngineHealth`` is the one place
the engine's failure signals converge:

  * **heartbeats** — the batcher and drainer publish a timestamp every
    loop iteration (a dict store, no lock: GIL-atomic); the watchdog and
    the health report read the age.
  * **state machine** — ``record_failure`` counts consecutive batch
    failures: ``>= degraded_after`` → DEGRADED, ``>= dead_after`` →
    DEAD; any successful batch resets to OK.  ``force_dead`` (restart
    budget exhausted) is sticky — only an operator restart revives it.
  * **healthz semantics** — ``/v1/healthz`` returns 503 while any
    engine *cannot serve* (DEGRADED or DEAD), and 200 again once it can.

The failure *counters* live on the engine (retries, quarantines,
timeouts — they're batch-plumbing); the *verdict* lives here.
"""

from __future__ import annotations

import threading
import time

OK = "ok"
DEGRADED = "degraded"
DEAD = "dead"


class EngineHealth:
    def __init__(self, degraded_after: int = 1, dead_after: int = 5):
        self.degraded_after = max(1, int(degraded_after))
        self.dead_after = max(self.degraded_after, int(dead_after))
        self._lock = threading.Lock()
        self._beats: dict[str, float] = {}
        self.state = OK  # guarded-by: _lock
        self.consecutive_failures = 0  # guarded-by: _lock
        self.failures = 0  # guarded-by: _lock
        self.successes = 0  # guarded-by: _lock
        self.watchdog_restarts = 0  # guarded-by: _lock
        self.last_success_at: float | None = None  # guarded-by: _lock
        self.last_failure_at: float | None = None  # guarded-by: _lock
        self.dead_reason: str | None = None  # guarded-by: _lock
        self._forced_dead = False  # guarded-by: _lock

    # -- heartbeats --------------------------------------------------------

    def beat(self, name: str):
        self._beats[name] = time.monotonic()  # GIL-atomic store, no lock

    def heartbeat_age_s(self, name: str, now: float | None = None
                        ) -> float | None:
        t = self._beats.get(name)
        if t is None:
            return None
        return (now if now is not None else time.monotonic()) - t

    # -- state machine -----------------------------------------------------

    def record_failure(self, now: float | None = None):
        with self._lock:
            self.failures += 1
            self.consecutive_failures += 1
            self.last_failure_at = now if now is not None \
                else time.monotonic()
            if self._forced_dead:
                return
            if self.consecutive_failures >= self.dead_after:
                self.state = DEAD
                self.dead_reason = (f"{self.consecutive_failures} "
                                    f"consecutive batch failures")
            elif self.consecutive_failures >= self.degraded_after:
                self.state = DEGRADED

    def record_success(self, now: float | None = None):
        with self._lock:
            self.successes += 1
            self.consecutive_failures = 0
            self.last_success_at = now if now is not None \
                else time.monotonic()
            if not self._forced_dead:
                self.state = OK
                self.dead_reason = None

    def record_restart(self):
        with self._lock:
            self.watchdog_restarts += 1

    def force_dead(self, reason: str):
        """Sticky DEAD (restart budget exhausted): traffic can't revive
        it — only an operator stop()/start() cycle (``revive``)."""
        with self._lock:
            self.state = DEAD
            self.dead_reason = reason
            self._forced_dead = True

    def revive(self):
        with self._lock:
            self._forced_dead = False
            self.state = OK
            self.dead_reason = None
            self.consecutive_failures = 0

    # -- observability -----------------------------------------------------

    def report(self, now: float | None = None) -> dict:
        now = time.monotonic() if now is None else now
        with self._lock:
            out = {"state": self.state,
                   "consecutive_failures": self.consecutive_failures,
                   "failures": self.failures,
                   "successes": self.successes,
                   "watchdog_restarts": self.watchdog_restarts,
                   "dead_reason": self.dead_reason}
        out["heartbeat_age_s"] = {
            name: round(age, 4) for name in list(self._beats)
            if (age := self.heartbeat_age_s(name, now)) is not None}
        for k, attr in (("last_success_age_s", self.last_success_at),
                        ("last_failure_age_s", self.last_failure_at)):
            out[k] = round(now - attr, 4) if attr is not None else None
        return out
