"""Engine health: heartbeats + an explicit OK → DEGRADED → DEAD machine.

Copy of ``deep_vision_tpu/serve/health.py`` without the watchdog's
restart accounting (the watchdog waits for a later slice).

  * **heartbeats** — the batcher and drainer publish a timestamp every
    loop iteration (a dict store, no lock: GIL-atomic); the health
    report reads the age.
  * **state machine** — ``record_failure`` counts consecutive batch
    failures: ``>= degraded_after`` → DEGRADED, ``>= dead_after`` →
    DEAD; any successful batch resets to OK.
  * **healthz semantics** — ``/v1/healthz`` returns 503 while an engine
    is DEGRADED or DEAD, and 200 again once a batch succeeds.
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
        self.last_success_at: float | None = None  # guarded-by: _lock
        self.last_failure_at: float | None = None  # guarded-by: _lock
        self.dead_reason: str | None = None  # guarded-by: _lock

    def beat(self, name: str):
        self._beats[name] = time.monotonic()  # GIL-atomic store, no lock

    def heartbeat_age_s(self, name: str, now: float | None = None
                        ) -> float | None:
        t = self._beats.get(name)
        if t is None:
            return None
        return (now if now is not None else time.monotonic()) - t

    def record_failure(self, now: float | None = None):
        with self._lock:
            self.failures += 1
            self.consecutive_failures += 1
            self.last_failure_at = now if now is not None \
                else time.monotonic()
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
            self.state = OK
            self.dead_reason = None

    def revive(self):
        """Back to OK (an engine ``start()`` after a ``stop()``)."""
        with self._lock:
            self.state = OK
            self.dead_reason = None
            self.consecutive_failures = 0

    def report(self, now: float | None = None) -> dict:
        now = time.monotonic() if now is None else now
        with self._lock:
            out = {"state": self.state,
                   "consecutive_failures": self.consecutive_failures,
                   "failures": self.failures,
                   "successes": self.successes,
                   "dead_reason": self.dead_reason}
        out["heartbeat_age_s"] = {
            name: round(age, 4) for name in list(self._beats)
            if (age := self.heartbeat_age_s(name, now)) is not None}
        for k, attr in (("last_success_age_s", self.last_success_at),
                        ("last_failure_age_s", self.last_failure_at)):
            out[k] = round(now - attr, 4) if attr is not None else None
        return out
