"""Per-request spans + the process-wide trace ring and slow sampler.

A ``Span`` is an append-only list of ``(stage, monotonic_ts)`` marks
plus ``(event, detail, ts)`` notes.  The first mark is the origin; each
later mark NAMES THE SEGMENT THAT ENDS AT IT, so the breakdown is the
successive deltas and sums exactly to the span total by construction —
that is what lets a ``?debug=1`` response account for its whole
measured in-server latency instead of an approximation.

Copy of ``deep_vision_tpu/obs/trace.py``.  Stage names through the
serving stack:

    recv → decode → admit → queue_wait → batch_form → staging →
    h2d_dispatch → compute_d2h → respond

Hops that don't advance the pipeline are ``notes`` (shed,
batch_failure).

Ownership rule across thread boundaries: whoever CREATES a span
finishes it.  The engine auto-finishes spans it created (via a future
done-callback, so every terminal path — served, shed, failed — seals
the span); the HTTP front-end creates its own spans, passes them down,
and finishes them after the response is built.  The engine marks a
borrowed span only BEFORE resolving its future, so the creator's later
marks never race the engine's.

When tracing is off (``DVT_SERVE_TRACE=0`` / ``Tracer(enabled=False)``)
every touch point is a single ``span is None`` read.
"""

from __future__ import annotations

import collections
import os
import threading
import time
import uuid

from deep_vision_tpu_torch.obs.log import event, get_logger

_log = get_logger("dvt.serve.trace")

#: response/request header carrying the request id edge-to-edge
REQUEST_ID_HEADER = "X-DVT-Request-Id"


def new_request_id() -> str:
    return uuid.uuid4().hex[:16]


class Span:
    """One request's stage timeline.  Cheap: two lists, no locking —
    marks happen from one thread at a time by the ownership rule."""

    __slots__ = ("request_id", "marks", "notes", "finished")

    def __init__(self, request_id: str | None = None,
                 origin: str = "submit"):
        self.request_id = request_id or new_request_id()
        self.marks: list[tuple[str, float]] = [(origin, time.monotonic())]
        self.notes: list[tuple[str, str, float]] = []
        self.finished = False

    def mark(self, stage: str):
        self.marks.append((stage, time.monotonic()))

    def note(self, name: str, detail: str = ""):
        self.notes.append((name, str(detail)[:200], time.monotonic()))

    @property
    def total_s(self) -> float:
        return self.marks[-1][1] - self.marks[0][1]

    def to_dict(self) -> dict:
        marks = list(self.marks)
        t0 = marks[0][1]
        stages: dict[str, float] = {}
        prev = t0
        for name, t in marks[1:]:
            stages[name] = stages.get(name, 0.0) + (t - prev) * 1e3
            prev = t
        return {"request_id": self.request_id,
                "origin": marks[0][0],
                "total_ms": round((prev - t0) * 1e3, 3),
                "stages": {k: round(v, 3) for k, v in stages.items()},
                "notes": [{"event": e, "detail": d,
                           "at_ms": round((t - t0) * 1e3, 3)}
                          for e, d, t in self.notes]}


class Tracer:
    """Bounded ring of finished traces + slow sampler + stage sums.

    ``ring`` bounds memory (a deque of plain dicts); ``slow_ms`` set →
    any trace over the threshold also emits one structured JSONL line
    (``event: slow_request``) for after-the-fact tail debugging.  The
    per-stage aggregate (total seconds + samples per stage name) is
    what ``/v1/stats`` reports as the pipeline breakdown.
    """

    def __init__(self, ring: int = 256, slow_ms: float | None = None,
                 enabled: bool | None = None):
        if enabled is None:
            enabled = os.environ.get("DVT_SERVE_TRACE", "1") != "0"
        self.enabled = bool(enabled)
        self.slow_ms = slow_ms
        self.ring: collections.deque[dict] = \
            collections.deque(maxlen=max(1, int(ring)))
        self._lock = threading.Lock()
        self.started = 0  # guarded-by: _lock
        self.finished = 0  # guarded-by: _lock
        self.slow_sampled = 0  # guarded-by: _lock
        self.slow_suppressed = 0  # guarded-by: _lock
        # optional zero-arg predicate: True drops the slow_request log
        # line (the ring and stage sums still record).  The brownout L1
        # hook (serve/brownout.py): under saturation EVERY request is
        # slow, and one log line each would cost the overloaded process
        self.suppress_slow = None
        # stage -> [total_s, samples]; guarded-by: _lock
        self._stage_s: dict[str, list] = {}

    def start(self, request_id: str | None = None,
              origin: str = "submit") -> Span | None:
        """A new span, or None when tracing is off (every downstream
        touch point guards on that None)."""
        if not self.enabled:
            return None
        with self._lock:
            self.started += 1
        return Span(request_id, origin)

    def finish(self, span: Span | None):
        """Seal a span into the ring (idempotent; never raises — it runs
        inside future done-callbacks)."""
        if span is None or span.finished:
            return
        span.finished = True
        try:
            d = span.to_dict()
        except Exception:  # noqa: BLE001 — observability must not throw
            return
        slow = self.slow_ms is not None and d["total_ms"] > self.slow_ms
        suppress = False
        if slow and self.suppress_slow is not None:
            try:
                suppress = bool(self.suppress_slow())
            except Exception:  # noqa: BLE001 — observability must not throw
                suppress = False
        with self._lock:
            self.finished += 1
            for stage, ms in d["stages"].items():
                agg = self._stage_s.setdefault(stage, [0.0, 0])
                agg[0] += ms / 1e3
                agg[1] += 1
            if slow:
                if suppress:
                    self.slow_suppressed += 1
                else:
                    self.slow_sampled += 1
            self.ring.append(d)
        if slow and not suppress:
            event(_log, "slow_request", **d)

    def recent(self, n: int = 32) -> list[dict]:
        """The newest ``n`` finished traces, oldest first."""
        with self._lock:
            return list(self.ring)[-max(0, int(n)):]

    def summary(self) -> dict:
        with self._lock:
            return {"enabled": self.enabled,
                    "started": self.started,
                    "finished": self.finished,
                    "slow_sampled": self.slow_sampled,
                    "slow_suppressed": self.slow_suppressed,
                    "slow_ms": self.slow_ms,
                    "ring": len(self.ring),
                    "stage_ms_avg": {
                        k: round(v[0] / v[1] * 1e3, 3)
                        for k, v in sorted(self._stage_s.items()) if v[1]},
                    "stage_s_total": {
                        k: round(v[0], 6)
                        for k, v in sorted(self._stage_s.items())},
                    "stage_samples": {
                        k: v[1] for k, v in sorted(self._stage_s.items())}}
