"""Brownout: degrade on purpose under overload instead of failing at
random.

Port of ``deep_vision_tpu/serve/brownout.py`` (``BrownoutController``).
Admission bounds the queue, QoS knees shed by class, and each sheds on
its own, while a saturated process keeps spending capacity on OPTIONAL
work (cascade dual-run calibration samples, shadow duplication,
slow-trace logging) as paying clients get 429s.  One controller a
process reads the pressure signals the stack already computes and steps
a fixed ladder, cutting the cheapest work first and the paying work
last (DAGOR, Zhou et al. SoCC 2018; Brownout, Klein et al. ICSE 2014).

The ladder (each level includes everything above it):

  L0  normal       full service.
  L1  shed-optional pause cascade calibration sampling and shadow
                   duplication, suppress slow-trace log lines.
  L2  degrade      the cascade serves a calibrated hop's answer below
                   its threshold to non-premium tenants (marked
                   ``X-DVT-Degraded``), and the response cache may
                   answer a miss with the same payload's entry under a
                   retired params version, marked the same way.
  L3  hard-shed    the QoS knees see a pressure floor just below 1.0:
                   every class but premium (``shed_at=1.0``) sheds,
                   whatever the queue holds.

Signals, read racily off the live engines each tick (a torn int read
costs one tick of lag, never a lock on the request path):

  pressure_ms  the largest ``queue_depth × bucket exec EWMA`` over the
               engines, the backlog as device time; crossing
               ``l1/l2/l3_pressure_ms`` picks the target level.
  occupancy    the largest rolling compute duty cycle; at or above
               ``occupancy_high`` it engages L1 with an empty queue.
  shed_rate    sheds / offered over the tick window; at or above
               ``shed_rate_high`` it engages L1 too.

The ladder ENGAGES fast (``up_window`` hot ticks in a row jump straight
to the target level) and RELEASES slowly (one level at a time, each
step after ``down_window`` ticks in a row below ``down_ratio`` × the
engage thresholds and ``cooldown_s`` since the last change), so a spike
browns out in about half a second and recovery cannot flap.

Subsystems read the controller through ``level`` and ``at_least(n)``
(an optional ``brownout`` attribute each defaults to None); nothing on
the request path takes a lock.  A transition logs one event, never one
a request, and ``stats()`` is the reserved ``brownout`` block of
/v1/stats (the ``dvt_brownout_*`` series).  ``force(level)`` (``POST
/v1/brownout {"force": n}``, ``--brownout-force``) pins the ladder;
``force(None)`` hands it back to the signals.
"""

from __future__ import annotations

import threading
import time

from deep_vision_tpu_torch.obs.log import event, get_logger

_log = get_logger("dvt.serve.brownout")

#: Ladder levels, for docs/stats — index IS the level.
LEVEL_NAMES = ("normal", "shed_optional", "degrade_quality", "hard_shed")
MAX_LEVEL = len(LEVEL_NAMES) - 1

#: The QoS pressure floor L3 applies: just below 1.0, so every class
#: with a shed_at knee under 1.0 sheds while premium (shed_at=1.0)
#: keeps flowing — "premium last" falls out of the existing knees.
HARD_SHED_PRESSURE = 0.999


class BrownoutController:
    """Counters are written only by the tick thread (or a test driving
    ``tick()``) and read racily by ``stats()`` and the per-request
    ``level``/``at_least`` probes — no lock, by design: the ladder
    changes a few times per overload episode while ``at_least`` runs
    on every request, and a one-tick-stale level is harmless."""

    def __init__(self, engines, *, interval_s: float = 0.25,
                 l1_pressure_ms: float = 50.0,
                 l2_pressure_ms: float = 150.0,
                 l3_pressure_ms: float = 400.0,
                 occupancy_high: float = 0.97,
                 shed_rate_high: float = 0.10,
                 up_window: int = 2, down_window: int = 8,
                 cooldown_s: float = 2.0, down_ratio: float = 0.5,
                 forced: int | None = None):
        if not (0.0 < l1_pressure_ms <= l2_pressure_ms
                <= l3_pressure_ms):
            raise ValueError(
                f"pressure thresholds must ascend: "
                f"{l1_pressure_ms}/{l2_pressure_ms}/{l3_pressure_ms}")
        if not 0.0 < down_ratio < 1.0:
            raise ValueError(f"down_ratio {down_ratio}: need (0, 1) — "
                             f"release must undercut engage")
        # engines: a zero-arg callable returning the live engines to
        # sample (the plane wiring passes
        # ``lambda: plane.active_engines().values()`` so reloads swap
        # engines out from under the controller safely), or a static
        # iterable for the single-model path and tests
        self._engines = engines
        self.interval_s = float(interval_s)
        self.l1_pressure_ms = float(l1_pressure_ms)
        self.l2_pressure_ms = float(l2_pressure_ms)
        self.l3_pressure_ms = float(l3_pressure_ms)
        self.occupancy_high = float(occupancy_high)
        self.shed_rate_high = float(shed_rate_high)
        self.up_window = max(1, int(up_window))
        self.down_window = max(1, int(down_window))
        self.cooldown_s = float(cooldown_s)
        self.down_ratio = float(down_ratio)
        self.forced = forced if forced is None \
            else min(MAX_LEVEL, max(0, int(forced)))
        self._level = self.forced or 0
        self._up_ticks = 0
        self._down_ticks = 0
        self._last_change: float | None = None  # monotonic
        self._prev_sheds: int | None = None
        self._prev_offered = 0
        self._last_signals: dict = {}
        self._stop_evt = threading.Event()
        self._thread: threading.Thread | None = None
        self.ticks = 0
        self.transitions_up = 0
        self.transitions_down = 0
        # entries INTO each level > 0 (L0 entries == transitions down
        # to normal, not worth a separate counter)
        self.level_entries = [0] * (MAX_LEVEL + 1)
        self.signal_errors = 0

    # -- the cheap reads every subsystem probes ----------------------------

    @property
    def level(self) -> int:
        return self._level

    def at_least(self, n: int) -> bool:
        """True when the ladder sits at or above level ``n`` — the one
        probe the request-path hooks call."""
        return self._level >= n

    def qos_pressure_floor(self) -> float:
        """Effective queue-pressure floor for the QoS knees: at L3 the
        knees fire as if the queue were full (premium excepted)."""
        return HARD_SHED_PRESSURE if self._level >= 3 else 0.0

    def force(self, level: int | None):
        """Operator override: pin the ladder at ``level``, effective
        immediately (None hands control back to the signals; the
        pinned level then releases through the normal hysteresis path,
        not instantly).  The immediate transition may race the tick
        thread by one counter increment — an operator override is rare
        enough that the simplicity wins."""
        self.forced = level if level is None \
            else min(MAX_LEVEL, max(0, int(level)))
        event(_log, "brownout_forced", forced=self.forced,
              level=self._level)
        if self.forced is not None and self.forced != self._level:
            self._transition(self.forced, dict(self._last_signals),
                             why="forced")

    # -- signals -----------------------------------------------------------

    def signals(self) -> dict:
        """One coherent-enough snapshot across the live engines.
        Counter reads are racy by design (see class docstring)."""
        pressure_ms = 0.0
        occupancy = 0.0
        sheds = admitted = 0
        engines = self._engines() if callable(self._engines) \
            else self._engines
        for eng in engines:
            try:
                adm = eng.admission
                ewma = adm.bucket_ewma_s() or 0.0
                pressure_ms = max(pressure_ms,
                                  eng.queue_depth * ewma * 1e3)
                sheds += adm.shed_queue_full + adm.shed_deadline
                admitted += adm.admitted
                occ_fn = getattr(eng, "occupancy", None)
                if callable(occ_fn):
                    occupancy = max(occupancy, occ_fn() or 0.0)
            except Exception:  # noqa: BLE001 — an engine mid-teardown must not stall the ladder
                self.signal_errors += 1
        offered = sheds + admitted
        d_shed = d_off = 0
        if self._prev_sheds is not None:
            d_shed = max(0, sheds - self._prev_sheds)
            d_off = max(0, offered - self._prev_offered)
        self._prev_sheds, self._prev_offered = sheds, offered
        return {"pressure_ms": round(pressure_ms, 3),
                "occupancy": round(occupancy, 4),
                "shed_rate": round(d_shed / d_off, 4) if d_off else 0.0}

    def _target(self, sig: dict, scale: float = 1.0) -> int:
        """Level the signals call for; ``scale`` < 1 shrinks every
        threshold — the release check asks whether the signals clear
        even the EASIER bar, which is exactly hysteresis."""
        p = sig["pressure_ms"]
        if p >= self.l3_pressure_ms * scale:
            t = 3
        elif p >= self.l2_pressure_ms * scale:
            t = 2
        elif p >= self.l1_pressure_ms * scale:
            t = 1
        else:
            t = 0
        if t == 0 and (sig["occupancy"] >= self.occupancy_high * scale
                       or sig["shed_rate"] >=
                       self.shed_rate_high * scale):
            t = 1
        return t

    # -- the ladder --------------------------------------------------------

    def tick(self) -> int:
        """One ladder decision; returns the (possibly new) level.
        Public: tests and the smoke drive it synchronously, production
        runs it on the Event-paced daemon thread."""
        self.ticks += 1
        sig = self.signals()
        self._last_signals = sig
        if self.forced is not None:
            if self.forced != self._level:
                self._transition(self.forced, sig, why="forced")
            return self._level
        lvl = self._level
        engage = self._target(sig)
        release = self._target(sig, self.down_ratio)
        if engage > lvl:
            self._up_ticks += 1
            self._down_ticks = 0
            if self._up_ticks >= self.up_window:
                self._transition(engage, sig, why="pressure")
        elif release < lvl:
            self._down_ticks += 1
            self._up_ticks = 0
            now = time.monotonic()
            cooled = self._last_change is None \
                or now - self._last_change >= self.cooldown_s
            if self._down_ticks >= self.down_window and cooled:
                # release ONE level per cooldown: recovery re-admits
                # the optional work gradually, never as a herd
                self._transition(lvl - 1, sig, why="recovered")
        else:
            self._up_ticks = 0
            self._down_ticks = 0
        return self._level

    def _transition(self, new: int, sig: dict, why: str):
        old = self._level
        self._level = new
        self._up_ticks = 0
        self._down_ticks = 0
        self._last_change = time.monotonic()
        if new > old:
            self.transitions_up += 1
        else:
            self.transitions_down += 1
        for lvl in range(min(old, new) + 1, max(old, new) + 1):
            if new > old:
                self.level_entries[lvl] += 1
        # edge-triggered: one line per level CHANGE, never per request
        # (`level`/`name` are event()'s own params — field keys differ)
        event(_log,
              "brownout_level_up" if new > old else "brownout_level_down",
              to_level=new, prev=old, level_name=LEVEL_NAMES[new], why=why,
              **sig)

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> "BrownoutController":
        if self._thread is None or not self._thread.is_alive():
            self._stop_evt.clear()
            self._thread = threading.Thread(
                target=self._loop, name="brownout", daemon=True)
            self._thread.start()
        return self

    def stop(self, timeout: float = 5.0):
        self._stop_evt.set()
        t = self._thread
        if t is not None:
            t.join(timeout)
            self._thread = None

    def _loop(self):
        while not self._stop_evt.wait(self.interval_s):
            try:
                self.tick()
            except Exception:  # noqa: BLE001 — the ladder thread never dies
                pass

    # -- observability -----------------------------------------------------

    def stats(self) -> dict:
        """The reserved ``brownout`` block in /v1/stats — serve/http.py
        renders the ``dvt_brownout_*`` /metrics series from it."""
        lvl = self._level
        return {"level": lvl,
                "level_name": LEVEL_NAMES[lvl],
                "forced": self.forced,
                "interval_s": self.interval_s,
                "thresholds": {"l1_pressure_ms": self.l1_pressure_ms,
                               "l2_pressure_ms": self.l2_pressure_ms,
                               "l3_pressure_ms": self.l3_pressure_ms,
                               "occupancy_high": self.occupancy_high,
                               "shed_rate_high": self.shed_rate_high,
                               "down_ratio": self.down_ratio},
                "up_window": self.up_window,
                "down_window": self.down_window,
                "cooldown_s": self.cooldown_s,
                "ticks": self.ticks,
                "transitions_up": self.transitions_up,
                "transitions_down": self.transitions_down,
                "level_entries": {f"L{i}": n for i, n
                                  in enumerate(self.level_entries)
                                  if i > 0},
                "signal_errors": self.signal_errors,
                "signals": dict(self._last_signals)}
