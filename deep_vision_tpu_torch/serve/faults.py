"""Deterministic fault-injection plane for the serving engine.

Copy of ``deep_vision_tpu/serve/faults.py``.  The ``gateway`` stage
and the network modes (``conn_reset``, ``slow_drip``, ``blackhole``)
fire in ``serve/gateway.py Gateway._single``, once per backend attempt
(``cli.gateway --faults``).

Crash-only software (Candea & Fox, HotOS'03) argues the recovery path
must be the *tested* path — which requires failures you can produce on
demand, in-tree, deterministically.  A ``FaultPlane`` parses a spec
string into per-stage injection points that the engine (and the HTTP
front-end) consult at well-defined places in the request lifecycle:

    stage     where it fires
    -------   ------------------------------------------------------
    decode    http.py request decoding, before admission
    batcher   top of the batcher loop (mode ``die`` kills the thread)
    staging   after the batch's host buffer is checked out
    dispatch  immediately before the H2D + compiled call
    compute   the compiled program execution (and every retry of it)
    d2h       the drainer's bulk device_get
    gateway   the gateway's per-attempt backend call
              (serve/gateway.py ``_single``) — the NETWORK between
              gateway and backend, not the backend itself

    mode       effect
    ---------  -----------------------------------------------------
    exception  raise ``InjectedFault`` at the injection point
    latency    sleep ``delay_ms`` (spike, request still succeeds)
    hang       block up to ``hang_s`` or until cancelled (exercises
               the watchdog's exec-timeout fast-fail)
    nan        corrupt the fetched output with NaNs (caught by the
               engine's output validation → isolation path)
    poison     mark the ``nth`` submitted request poison: any cohort
               containing it fails at the compute stage, so
               bisect-retry must quarantine exactly that request
    die        raise ``KillThread`` (BaseException) so the stage's
               worker thread exits and the watchdog must restart it
    conn_reset raise ``ConnectionResetError`` (an OSError, exactly
               what a peer RST surfaces as) — the gateway's breaker/
               retry-budget machinery must absorb it
    slow_drip  sleep ``delay_ms`` mid-attempt — a congested link
               dripping bytes; pushes attempts past hedging and
               timeout thresholds without failing them outright
    blackhole  block up to ``hang_s`` (or until cancelled), then
               raise ``TimeoutError`` — packets leaving, nothing
               coming back, the worst network failure mode

Spec syntax (``--faults`` / env ``DVT_SERVE_FAULTS``): semicolon-
separated faults, each ``stage:mode[:key=value]...`` — e.g.

    compute:poison:nth=3
    compute:exception:times=1;d2h:latency:delay_ms=20
    batcher:die:times=1
    d2h:hang:hang_s=30:after=2

Keys: ``p`` (fire probability, seeded RNG → reproducible), ``after``
(skip the first N eligible hits), ``times`` (fire at most N times),
``delay_ms``, ``hang_s``, ``nth``.  A plane with an empty spec is
disabled and costs one attribute read per guarded call site — the
hot path stays hot.
"""

from __future__ import annotations

import dataclasses
import os
import random
import threading
import time

STAGES = ("decode", "batcher", "staging", "dispatch", "compute", "d2h",
          "gateway")
MODES = ("exception", "latency", "hang", "nan", "poison", "die",
         "conn_reset", "slow_drip", "blackhole")

ENV_SPEC = "DVT_SERVE_FAULTS"
ENV_SEED = "DVT_SERVE_FAULT_SEED"


class InjectedFault(RuntimeError):
    """Raised by an injection point (mode=exception, a poisoned cohort,
    or NaN-corrupted output caught by validation)."""


class KillThread(BaseException):
    """mode=die: BaseException so per-batch ``except Exception`` guards
    can't swallow it — it escapes the worker loop and kills the thread,
    leaving the watchdog to notice and restart."""


@dataclasses.dataclass
class Quarantined:
    """Structured error delivered to a request the engine isolated.

    ``reason`` is ``"poison"`` (bisect-retry converged on this request)
    or ``"retry_budget"`` (isolation ran out of retries before
    converging).  Falsy like ``Shed`` so ``if result:`` reads as
    "was served"."""

    reason: str
    detail: str = ""

    def __bool__(self):
        return False


@dataclasses.dataclass
class _Fault:
    stage: str
    mode: str
    p: float = 1.0
    after: int = 0
    times: int | None = None
    delay_ms: float = 50.0
    hang_s: float = 30.0
    nth: int = 0
    seen: int = 0
    fired: int = 0


def parse_faults(spec: str) -> list[_Fault]:
    """``stage:mode[:k=v]...[;...]`` → validated fault list."""
    faults = []
    for part in (spec or "").split(";"):
        part = part.strip()
        if not part:
            continue
        fields = part.split(":")
        if len(fields) < 2:
            raise ValueError(f"fault '{part}': need stage:mode")
        stage, mode = fields[0], fields[1]
        if stage not in STAGES:
            raise ValueError(f"fault '{part}': unknown stage '{stage}' "
                             f"(one of {', '.join(STAGES)})")
        if mode not in MODES:
            raise ValueError(f"fault '{part}': unknown mode '{mode}' "
                             f"(one of {', '.join(MODES)})")
        f = _Fault(stage, mode)
        for kv in fields[2:]:
            if "=" not in kv:
                raise ValueError(f"fault '{part}': bad option '{kv}'")
            k, v = kv.split("=", 1)
            if k == "p":
                f.p = float(v)
            elif k == "after":
                f.after = int(v)
            elif k == "times":
                f.times = int(v)
            elif k == "delay_ms":
                f.delay_ms = float(v)
            elif k == "hang_s":
                f.hang_s = float(v)
            elif k == "nth":
                f.nth = int(v)
            else:
                raise ValueError(f"fault '{part}': unknown key '{k}'")
        faults.append(f)
    return faults


class FaultPlane:
    """Seeded, thread-safe injection-point registry.

    One plane per engine.  ``enabled`` is False for an empty spec, and
    every call site guards on it first, so production (no faults) pays
    a single attribute read per site.
    """

    def __init__(self, spec: str = "", seed: int = 0):
        self.spec = spec or ""
        self.seed = int(seed)
        self.faults = parse_faults(self.spec)
        self.enabled = bool(self.faults)
        self._rng = random.Random(self.seed)
        self._lock = threading.Lock()
        self._submits = 0  # guarded-by: _lock
        #: set by the engine's watchdog / stop() to break injected hangs
        self.cancel = threading.Event()

    @classmethod
    def from_env(cls, environ=None) -> "FaultPlane":
        env = os.environ if environ is None else environ
        return cls(env.get(ENV_SPEC, ""),
                   int(env.get(ENV_SEED, "0") or 0))

    # -- request tagging ---------------------------------------------------

    def mark_poison(self) -> bool:
        """Called once per submitted request (in submit order): True tags
        this request as the poison a ``compute:poison:nth=K`` spec names."""
        if not self.enabled:
            return False
        with self._lock:
            idx = self._submits
            self._submits += 1
            return any(f.mode == "poison" and f.nth == idx
                       for f in self.faults)

    def cohort_poisoned(self, requests) -> bool:
        """True when any request in the cohort carries the poison tag."""
        return self.enabled and any(getattr(r, "poison", False)
                                    for r in requests)

    # -- injection ---------------------------------------------------------

    def _arm(self, stage: str) -> _Fault | None:
        """First fault eligible to fire at ``stage`` right now (poison is
        request-keyed, handled via mark_poison/cohort_poisoned)."""
        with self._lock:
            for f in self.faults:
                if f.stage != stage or f.mode == "poison":
                    continue
                f.seen += 1
                if f.seen <= f.after:
                    continue
                if f.times is not None and f.fired >= f.times:
                    continue
                if f.p < 1.0 and self._rng.random() >= f.p:
                    continue
                f.fired += 1
                return f
        return None

    def inject(self, stage: str, *, stop=None, cancel=None) -> str | None:
        """Fire any armed fault for ``stage``.

        Raises for ``exception``/``die``; sleeps for ``latency``; blocks
        for ``hang`` until ``cancel``/``stop``/``self.cancel`` is set or
        ``hang_s`` elapses.  Returns the fired mode (``"nan"`` tells the
        d2h call site to corrupt its fetched payload), or None.
        """
        if not self.enabled:
            return None
        f = self._arm(stage)
        if f is None:
            return None
        if f.mode == "exception":
            raise InjectedFault(
                f"injected {stage} exception #{f.fired} (spec '{self.spec}')")
        if f.mode == "die":
            raise KillThread(f"injected {stage} thread death #{f.fired}")
        if f.mode == "conn_reset":
            # OSError subclass: the caller's network-failure handling
            # (gateway breaker, retry budget) must treat it as real
            raise ConnectionResetError(
                f"injected {stage} conn-reset #{f.fired}")
        if f.mode in ("latency", "slow_drip"):
            time.sleep(f.delay_ms / 1e3)
        elif f.mode == "hang":
            self._wait_cancelled(f.hang_s, stop, cancel)
        elif f.mode == "blackhole":
            self._wait_cancelled(f.hang_s, stop, cancel)
            raise TimeoutError(
                f"injected {stage} blackhole #{f.fired} "
                f"({f.hang_s:g}s of silence)")
        return f.mode

    def _wait_cancelled(self, seconds: float, stop, cancel):
        t_end = time.monotonic() + seconds
        while time.monotonic() < t_end:
            if self.cancel.is_set():
                break
            if cancel is not None and cancel.is_set():
                break
            if stop is not None and stop.is_set():
                break
            time.sleep(0.005)

    # -- observability -----------------------------------------------------

    def stats(self) -> dict:
        with self._lock:
            return {"spec": self.spec, "seed": self.seed,
                    "injected": {f"{f.stage}:{f.mode}": f.fired
                                 for f in self.faults if f.fired}}
