"""Demand-side elasticity: replica count follows observed load.

Port of ``deep_vision_tpu/deploy/autoscale.py`` (``ReplicaAutoscaler``);
it drives the port's ``ReplicatedEngine`` (serve/replicas.py).

The admission controller already prices load — per-bucket exec EWMAs
and the shared queue's depth — so the autoscaler spends no new
measurement machinery.  Each tick reads three signals off the
``ReplicatedEngine``:

  pressure   ``queue_depth × exec_EWMA`` — the backlog expressed as
             device-time.  Sustained above ``high_water_ms`` for
             ``up_window`` consecutive ticks → ``add_replica()``.
  idleness   empty queue AND zero in-flight work, sustained for
             ``down_window`` consecutive ticks →
             ``remove_replica(drain_deadline=)`` (which drains before
             stopping — scale-down never drops admitted work).
  bounds     live replicas stay in [min_replicas, max_replicas].

Queue pressure is the wrong hot signal for THROUGHPUT workloads
(ROADMAP): a batchy-SLO engine (the "batchy" service class,
serve/workloads.py — generative models, and any engine the batch tier
saturates) runs flat out with an empty queue, because work arrives as
full cohorts that go straight in-flight.  For those engines the scaler
switches its hot signal to the engine's rolling compute **occupancy**
(``engine.occupancy()``, the same measurement the MFU denominator
uses): occupancy ≥ ``occupancy_high`` sustained for ``up_window`` →
scale up, and scale-down additionally requires occupancy ≤
``occupancy_low`` so the gap between two back-to-back shards can't
read as idle.  Interactive-SLO engines keep the original pressure
signal unchanged.

Stability is structural, not tuned: the two windows are hysteresis
(one hot tick can't scale up, one idle tick can't scale down; any
contrary tick resets the streak), and every action starts a
``cooldown_s`` during which no further action fires — so the replica
count is monotone within each window and the scaler cannot flap.
``tick()`` is public: tests and ``chip_smoke.py`` drive it
synchronously; production runs it on an Event-paced daemon thread.
"""

from __future__ import annotations

import threading
import time

from deep_vision_tpu_torch.obs.log import event, get_logger

_log = get_logger("dvt.deploy.autoscale")


class ReplicaAutoscaler:
    """Counters are written only by the tick thread (or the test
    driving ``tick()``) and read racily by ``stats()`` — no lock, by
    design: a torn gauge read costs nothing, and holding a lock across
    ``add_replica``/``remove_replica`` (which take the engine's lock)
    would add an ordering edge for zero benefit."""

    def __init__(self, engine, *, name: str | None = None,
                 min_replicas: int = 1, max_replicas: int | None = None,
                 interval_s: float = 0.5, high_water_ms: float = 50.0,
                 up_window: int = 3, down_window: int = 10,
                 cooldown_s: float = 5.0, drain_deadline_s: float = 5.0,
                 occupancy_high: float = 0.75,
                 occupancy_low: float = 0.2, history=None):
        if min_replicas < 1:
            raise ValueError(f"min_replicas {min_replicas}: need >= 1")
        if max_replicas is not None and max_replicas < min_replicas:
            raise ValueError(f"max_replicas {max_replicas} < "
                             f"min_replicas {min_replicas}")
        # engine may be the ReplicatedEngine itself, or a zero-arg
        # callable resolving it per tick — the production wiring passes
        # ``lambda: plane.active_engine(name)`` so a hot reload's engine
        # swap doesn't leave the scaler ticking a retired engine
        self._engine = engine
        self.name = name or getattr(
            getattr(self.engine, "model", None), "name", "model")
        self.min_replicas = int(min_replicas)
        self.max_replicas = int(max_replicas) if max_replicas is not None \
            else self.min_replicas
        self.interval_s = float(interval_s)
        self.high_water_ms = float(high_water_ms)
        self.up_window = int(up_window)
        self.down_window = int(down_window)
        self.cooldown_s = float(cooldown_s)
        self.drain_deadline_s = float(drain_deadline_s)
        self.occupancy_high = float(occupancy_high)
        self.occupancy_low = float(occupancy_low)
        self.history = history
        self._up_ticks = 0
        self._down_ticks = 0
        self._last_action: float | None = None  # monotonic
        self._stop_evt = threading.Event()
        self._thread: threading.Thread | None = None
        self.ticks = 0
        self.scale_ups = 0
        self.scale_downs = 0
        self.scale_errors = 0

    @property
    def engine(self):
        return self._engine() if callable(self._engine) else self._engine

    # -- the decision ------------------------------------------------------

    def signals(self) -> dict:
        """One coherent-enough snapshot of the engine's load signals."""
        eng = self.engine
        ewma = eng.admission.bucket_ewma_s() or 0.0
        depth = eng._queue.qsize()
        occ_fn = getattr(eng, "occupancy", None)
        wl = getattr(getattr(eng, "model", None), "workload", None)
        return {"queue_depth": depth,
                "exec_ewma_ms": round(ewma * 1e3, 3),
                "pressure_ms": round(depth * ewma * 1e3, 3),
                "inflight": eng.total_inflight(),
                "live": eng.live_replicas(),
                # rolling compute duty cycle; None on engines that
                # don't measure it (the pressure path still works)
                "occupancy": occ_fn() if callable(occ_fn) else None,
                # the signal switch: batchy-SLO engines scale on
                # occupancy, interactive ones on queue pressure
                "batchy": getattr(getattr(wl, "slo", None), "name",
                                  "") == "batchy"}

    def tick(self) -> dict | None:
        """One scaling decision; returns the action taken (or None).
        Exceptions from the engine (no spare device, last live replica)
        are absorbed — a failed action costs one cooldown, never the
        scaler."""
        self.ticks += 1
        sig = self.signals()
        live = sig["live"]
        use_occ = sig["batchy"] and sig["occupancy"] is not None
        hot = (sig["occupancy"] >= self.occupancy_high) if use_occ \
            else sig["pressure_ms"] > self.high_water_ms
        idle = sig["queue_depth"] == 0 and sig["inflight"] == 0
        if use_occ:
            # the gap between two back-to-back shards samples as
            # queue 0 / inflight 0; the rolling window doesn't lie
            idle = idle and sig["occupancy"] <= self.occupancy_low
        if hot and live < self.max_replicas:
            self._up_ticks += 1
            self._down_ticks = 0
        elif idle and live > self.min_replicas:
            self._down_ticks += 1
            self._up_ticks = 0
        else:
            self._up_ticks = 0
            self._down_ticks = 0
        now = time.monotonic()
        cooled = self._last_action is None \
            or now - self._last_action >= self.cooldown_s
        if not cooled:
            return None
        if self._up_ticks >= self.up_window:
            return self._act("scale_up", sig, now)
        if self._down_ticks >= self.down_window:
            return self._act("scale_down", sig, now)
        return None

    def _act(self, direction: str, sig: dict, now: float) -> dict | None:
        self._up_ticks = 0
        self._down_ticks = 0
        self._last_action = now  # a failed action also starts cooldown
        try:
            if direction == "scale_up":
                replica = self.engine.add_replica()
                self.scale_ups += 1
            else:
                replica = self.engine.remove_replica(
                    drain_deadline=self.drain_deadline_s)
                self.scale_downs += 1
        except Exception as e:  # noqa: BLE001 — a failed scale action must not kill the scaler
            self.scale_errors += 1
            event(_log, "autoscale_failed", model=self.name,
                  direction=direction,
                  error=f"{type(e).__name__}: {e}", **sig)
            return None
        action = {"action": direction, "replica": replica,
                  "live": self.engine.live_replicas(), **sig}
        event(_log, "autoscale", model=self.name, **action)
        if self.history is not None:
            self.history.record(self.name, direction, replica=replica,
                                live=action["live"],
                                pressure_ms=sig["pressure_ms"],
                                occupancy=sig["occupancy"])
        return action

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> "ReplicaAutoscaler":
        if self._thread is None or not self._thread.is_alive():
            self._stop_evt.clear()
            self._thread = threading.Thread(
                target=self._loop, name=f"autoscale-{self.name}",
                daemon=True)
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
            except Exception:  # noqa: BLE001 — the scaler thread never dies
                pass

    def stats(self) -> dict:
        out = {"model": self.name,
               "min_replicas": self.min_replicas,
               "max_replicas": self.max_replicas,
               "interval_s": self.interval_s,
               "high_water_ms": self.high_water_ms,
               "up_window": self.up_window,
               "down_window": self.down_window,
               "occupancy_high": self.occupancy_high,
               "occupancy_low": self.occupancy_low,
               "cooldown_s": self.cooldown_s,
               "ticks": self.ticks,
               "scale_ups": self.scale_ups,
               "scale_downs": self.scale_downs,
               "scale_errors": self.scale_errors}
        try:
            out.update(self.signals())
        except Exception as e:  # noqa: BLE001 — a torn engine swap must not break /v1/stats
            out["signals_error"] = f"{type(e).__name__}: {e}"
        return out
