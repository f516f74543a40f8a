"""The brownout ladder in the port (serve/brownout.py) and the two
degradation mechanisms it drives without an engine (the response
cache's stale path, the cascade ledger's restore), against the JAX
package on the CPU.

Both packages' ``BrownoutController``s fed one seeded signal script
(fake engines: queue depth, occupancy, shed counters, an engine that
raises) under one fake clock, with forced levels along the way: equal
level sequences and ``stats()``.  Both packages' ``ResponseCache``s over
one seeded sequence of puts (evictions among them), exact and stale
lookups: equal answers and stats.  Then the reference's
tests/test_brownout.py cases, recast for the port.
"""

import json
import os
import time
import types

import numpy as np
import pytest

from deep_vision_tpu.serve import brownout as jbo
from deep_vision_tpu.serve import cache as jcache
from deep_vision_tpu_torch.serve import brownout as pbo
from deep_vision_tpu_torch.serve import cache as pcache
from deep_vision_tpu_torch.serve.brownout import (
    HARD_SHED_PRESSURE,
    LEVEL_NAMES,
    MAX_LEVEL,
    BrownoutController,
)
from deep_vision_tpu_torch.serve.cache import ResponseCache
from deep_vision_tpu_torch.serve.cascade import CascadeRouter, CascadeSpec

pytestmark = [pytest.mark.brownout, pytest.mark.serve]


class FakeEngine:
    """Just the signal surface the controller samples: queue_depth,
    admission counters/EWMA, occupancy."""

    def __init__(self, ewma_s=0.01):
        self.queue_depth = 0
        self._occ = 0.0
        self.admission = types.SimpleNamespace(
            bucket_ewma_s=lambda: ewma_s,
            shed_queue_full=0, shed_deadline=0, admitted=0)

    def occupancy(self):
        return self._occ


def _controller(eng, **kw):
    kw.setdefault("up_window", 1)
    kw.setdefault("down_window", 2)
    kw.setdefault("cooldown_s", 0.0)
    return BrownoutController([eng], **kw)


# -- the ladder -------------------------------------------------------------


def test_engage_jumps_straight_to_target_level():
    """A hard spike must not climb one level per tick — the target is
    taken in one transition once up_window ticks confirm it."""
    eng = FakeEngine()           # 10 ms of pressure per queued request
    bc = _controller(eng)
    assert bc.level == 0 and bc.tick() == 0
    eng.queue_depth = 50         # 500 ms >= l3_pressure_ms
    assert bc.tick() == 3
    assert bc.transitions_up == 1          # ONE jump, not three steps
    assert bc.stats()["level_entries"] == {"L1": 1, "L2": 1, "L3": 1}
    assert bc.at_least(1) and bc.at_least(3)


def test_up_window_debounces_single_tick_spikes():
    eng = FakeEngine()
    bc = _controller(eng, up_window=2)
    eng.queue_depth = 50
    assert bc.tick() == 0        # one hot tick is noise
    eng.queue_depth = 0
    assert bc.tick() == 0        # streak broken: still normal
    eng.queue_depth = 50
    bc.tick()
    assert bc.tick() == 3        # two consecutive hot ticks engage


def test_release_steps_one_level_at_a_time():
    eng = FakeEngine()
    bc = _controller(eng, down_window=2)
    eng.queue_depth = 50
    bc.tick()
    assert bc.level == 3
    eng.queue_depth = 0
    assert bc.tick() == 3        # first cool tick: not yet
    assert bc.tick() == 2        # down_window reached: ONE level
    bc.tick()
    assert bc.tick() == 1
    bc.tick()
    assert bc.tick() == 0
    assert bc.transitions_down == 3
    assert LEVEL_NAMES[bc.level] == "normal"


def test_hysteresis_band_holds_level():
    """Signals below the engage bar but above down_ratio × it neither
    engage nor release — no flapping at the boundary."""
    eng = FakeEngine()
    bc = _controller(eng, down_window=1)
    eng.queue_depth = 6          # 60 ms >= l1
    bc.tick()
    assert bc.level == 1
    eng.queue_depth = 3          # 30 ms: < l1 (50) but >= 0.5*l1 (25)
    for _ in range(20):
        assert bc.tick() == 1


def test_cooldown_blocks_release():
    eng = FakeEngine()
    bc = _controller(eng, down_window=1, cooldown_s=60.0)
    eng.queue_depth = 6
    bc.tick()
    assert bc.level == 1
    eng.queue_depth = 0
    for _ in range(10):
        assert bc.tick() == 1    # cool ticks satisfied, cooldown not


def test_occupancy_and_shed_rate_engage_l1():
    eng = FakeEngine()
    bc = _controller(eng)
    eng._occ = 0.99              # saturated without backlog
    assert bc.tick() == 1
    eng._occ = 0.0
    eng2 = FakeEngine()
    bc2 = _controller(eng2)
    bc2.tick()                   # establish the counter baseline
    eng2.admission.shed_queue_full = 50
    eng2.admission.admitted = 50
    assert bc2.tick() == 1       # 50% shed rate over the tick window
    assert bc2.stats()["signals"]["shed_rate"] == pytest.approx(0.5)


def test_forced_pin_applies_immediately_and_releases_via_ladder():
    eng = FakeEngine()
    bc = _controller(eng, down_window=1)
    bc.force(2)
    assert bc.level == 2         # no tick needed: effective immediately
    eng.queue_depth = 50
    assert bc.tick() == 2        # signals scream L3; the pin wins
    bc.force(None)
    assert bc.tick() == 3        # signals back in control
    eng.queue_depth = 0
    bc.tick()
    assert bc.level == 2         # released ONE level, not snapped to 0
    st = bc.stats()
    assert st["forced"] is None and st["level_name"] == "degrade_quality"
    bc.force(99)
    assert bc.forced == MAX_LEVEL  # clamped


def test_qos_pressure_floor_only_at_l3():
    eng = FakeEngine()
    bc = _controller(eng)
    assert bc.qos_pressure_floor() == 0.0
    bc.force(2)
    assert bc.qos_pressure_floor() == 0.0
    bc.force(3)
    assert bc.qos_pressure_floor() == HARD_SHED_PRESSURE


def test_engine_errors_never_stall_the_ladder():
    class Exploding:
        @property
        def admission(self):
            raise RuntimeError("mid-teardown")

    eng = FakeEngine()
    eng.queue_depth = 50
    bc = BrownoutController([Exploding(), eng], up_window=1,
                            down_window=2, cooldown_s=0.0)
    assert bc.tick() == 3        # the healthy engine's signal got read
    assert bc.signal_errors == 1
    assert bc.stats()["signal_errors"] == 1


def test_threshold_validation():
    with pytest.raises(ValueError):
        BrownoutController([], l1_pressure_ms=200.0, l2_pressure_ms=100.0)
    with pytest.raises(ValueError):
        BrownoutController([], down_ratio=1.5)


# -- L2: version-stale response cache ---------------------------------------


def _key(digest, body="aa"):
    return ResponseCache.key("/v1/classify", "m", digest, "uint8",
                             "float32", body)


def test_stale_hit_serves_retired_version_only_on_request():
    cache = ResponseCache(1 << 20)
    cache.put(_key("v1"), b'{"old": 1}')
    # normal operation: a new params version misses — version purity
    assert cache.get(_key("v2")) is None
    # L2 path: the same payload under ANY retired version answers
    assert cache.get_stale(_key("v2")) == b'{"old": 1}'
    assert cache.stats()["stale_hits"] == 1
    # never for a different payload or route
    assert cache.get_stale(_key("v2", body="bb")) is None
    # the CURRENT version is not "stale" — exact get covers it
    cache.put(_key("v2"), b'{"new": 1}')
    assert cache.get_stale(_key("v2")) is None


def test_stale_alias_pruned_with_eviction():
    cache = ResponseCache(20)    # fits one 12-byte entry
    cache.put(_key("v1"), b"x" * 12)
    cache.put(_key("v1", body="bb"), b"y" * 12)   # evicts the first
    assert cache.get_stale(_key("v2")) is None
    assert cache.get_stale(_key("v2", body="bb")) == b"y" * 12
    cache.clear()
    assert cache.get_stale(_key("v2", body="bb")) is None


# -- cascade calibration persistence ----------------------------------------


class PersistPlane:
    """Resolvable models with params digests — the surface _restore and
    _append_ledger consult; no traffic runs through it."""

    def __init__(self, digests):
        self.digests = dict(digests)
        self.listeners = []

    def add_version_listener(self, fn):
        self.listeners.append(fn)

    def resolve(self, name):
        return types.SimpleNamespace(params_digest=self.digests[name])

    def canary_active(self, name):
        return False


def _spec(**kw):
    kw.setdefault("sample_period", 1000)
    kw.setdefault("min_sample", 5)
    kw.setdefault("min_agreement", 0.9)
    return CascadeSpec("small", "large", **kw)


def _calibrated_router(root, digests):
    router = CascadeRouter(PersistPlane(digests), _spec(), root=root)
    for _ in range(5):
        router.hist.record(0.8, True)
    router._recalibrate()
    assert router.threshold is not None
    return router


def test_calibration_survives_restart(tmp_path):
    root = str(tmp_path / "_cascade")
    digests = {"small": "f1", "large": "b1"}
    first = _calibrated_router(root, digests)
    ledger = first._ledger_path()
    assert os.path.exists(ledger)
    rec = json.loads(open(ledger).read().splitlines()[-1])
    assert rec["event"] == "calibrated" and rec["digest"] == "f1+b1"
    # a new process over the same workdir adopts the calibration
    second = CascadeRouter(PersistPlane(digests), _spec(), root=root)
    assert second.restored is True
    assert second.threshold == first.threshold
    assert second.stats()["restored"] is True


def test_restore_fails_closed_on_digest_mismatch(tmp_path):
    root = str(tmp_path / "_cascade")
    _calibrated_router(root, {"small": "f1", "large": "b1"})
    # the big tier reloaded while the server was down
    router = CascadeRouter(PersistPlane({"small": "f1", "large": "b2"}),
                           _spec(), root=root)
    assert router.restored is False and router.threshold is None


def test_restore_skips_torn_tail_line(tmp_path):
    root = str(tmp_path / "_cascade")
    first = _calibrated_router(root, {"small": "f1", "large": "b1"})
    with open(first._ledger_path(), "a") as f:
        f.write('{"event": "calib')       # crash mid-append
    router = CascadeRouter(PersistPlane({"small": "f1", "large": "b1"}),
                           _spec(), root=root)
    assert router.restored is True and router.threshold is not None


def test_trailing_reset_stays_fail_closed(tmp_path):
    root = str(tmp_path / "_cascade")
    first = _calibrated_router(root, {"small": "f1", "large": "b1"})
    first._on_version_swap("small")       # reload logged before crash
    router = CascadeRouter(PersistPlane({"small": "f1", "large": "b1"}),
                           _spec(), root=root)
    assert router.restored is False and router.threshold is None


def test_restore_rederives_threshold_under_new_knobs(tmp_path):
    """Retuned --cascade-min-sample applies to the restored sample: a
    sample now too thin stays fail-closed instead of trusting the
    stored threshold."""
    root = str(tmp_path / "_cascade")
    _calibrated_router(root, {"small": "f1", "large": "b1"})
    strict = CascadeSpec("small", "large", sample_period=1000,
                         min_sample=500, min_agreement=0.9)
    router = CascadeRouter(PersistPlane({"small": "f1", "large": "b1"}),
                           strict, root=root)
    assert router.restored is False and router.threshold is None


def test_ledger_write_failures_counted_never_raised(tmp_path):
    root = str(tmp_path / "_cascade")
    router = CascadeRouter(PersistPlane({"small": "f1", "large": "b1"}),
                           _spec(), root=root)
    os.makedirs(router._ledger_path())    # open(..., "a") now OSErrors
    for _ in range(5):
        router.hist.record(0.8, True)
    router._recalibrate()                 # must not raise
    assert router.threshold is not None   # the ledger observes only
    assert router.stats()["ledger_write_errors"] == 1


def test_memory_only_router_never_touches_disk(tmp_path):
    router = CascadeRouter(PersistPlane({"small": "f1", "large": "b1"}),
                           _spec(), root=None)
    for _ in range(5):
        router.hist.record(0.8, True)
    router._recalibrate()
    assert router.threshold is not None
    assert router.restored is False
    assert router.stats()["ledger_root"] is None


# -- both packages over one script --------------------------------------------


class _Clock:
    """``time.monotonic`` for both controllers: advanced by the script."""

    def __init__(self):
        self.t = 1000.0

    def __call__(self):
        return self.t


def _signal_script(n=400, seed=7):
    """Per tick: the two engines' queue depths, occupancy and counter
    increments, the seconds the clock moves, and an operator force."""
    rng = np.random.RandomState(seed)
    steps = []
    for i in range(n):
        phase = (i // 40) % 5  # idle, L1, L3 spike, L2, idle
        base = (0, 6, 50, 18, 0)[phase]
        depths = [max(0, base + int(rng.randint(-3, 4))),
                  max(0, base // 2 + int(rng.randint(-2, 3)))]
        occ = float(rng.choice([0.2, 0.5, 0.98], p=[0.6, 0.3, 0.1]))
        admitted = int(rng.randint(0, 20))
        sheds = int(rng.randint(0, 8)) if phase == 2 else \
            int(rng.randint(0, 2))
        force = "keep"
        if i == 150:
            force = 2
        elif i == 170:
            force = None
        elif i == 300:
            force = 3
        elif i == 305:
            force = None
        steps.append({"depths": depths, "occ": occ, "admitted": admitted,
                      "sheds": sheds, "dt": float(rng.choice([0.25, 0.5,
                                                              2.5])),
                      "force": force, "explode": i % 97 == 13})
    return steps


class _Exploding:
    @property
    def admission(self):
        raise RuntimeError("mid-teardown")


def _run_ladder(mod, steps, clock):
    engines = [FakeEngine(ewma_s=0.01), FakeEngine(ewma_s=0.004)]
    live = list(engines)
    bc = mod.BrownoutController(lambda: live, up_window=2, down_window=3,
                                cooldown_s=1.0)
    levels = []
    for st in steps:
        clock.t += st["dt"]
        for eng, depth in zip(engines, st["depths"]):
            eng.queue_depth = depth
            eng._occ = st["occ"]
            eng.admission.admitted += st["admitted"]
            eng.admission.shed_queue_full += st["sheds"]
        live[:] = engines + ([_Exploding()] if st["explode"] else [])
        if st["force"] != "keep":
            bc.force(st["force"])
        levels.append((bc.tick(), bc.qos_pressure_floor(),
                       bc.at_least(2)))
    return bc, levels


def test_ladder_matches_reference_over_one_script(monkeypatch):
    clock = _Clock()
    monkeypatch.setattr(time, "monotonic", clock)
    steps = _signal_script()
    jbc, jlev = _run_ladder(jbo, steps, clock)
    clock.t = 1000.0
    pbc, plev = _run_ladder(pbo, steps, clock)
    assert plev == jlev
    assert pbc.stats() == jbc.stats()
    # the script walked the whole ladder, both ways
    seen = {lvl for lvl, _, _ in plev}
    assert seen == {0, 1, 2, 3}
    st = pbc.stats()
    assert st["transitions_down"] >= 3 and st["signal_errors"] > 0
    ups = [b[0] - a[0] for a, b in zip(plev, plev[1:]) if b[0] < a[0]]
    assert ups and all(d == -1 for d in ups)  # releases one level a step


def test_stale_cache_matches_reference_over_one_sequence():
    rng = np.random.RandomState(2)
    caches = (pcache.ResponseCache(400), jcache.ResponseCache(400))
    answers = ([], [])
    for i in range(600):
        op = rng.choice(["put", "get", "stale", "clear"],
                        p=[0.45, 0.25, 0.29, 0.01])
        version = f"v{int(rng.randint(3))}"
        body = "abcdefgh"[int(rng.randint(8))]
        route = ("/v1/classify", "/v1/detect")[int(rng.randint(2))]
        tier = (None, "front", "big")[int(rng.randint(3))]
        size = int(rng.randint(20, 140))
        for cache, out in zip(caches, answers):
            key = cache.key(route, "m", version, "uint8", "int8", body)
            if op == "put":
                cache.put(key, bytes([i % 256]) * size, tier=tier)
            elif op == "get":
                out.append(cache.get(key))
            elif op == "stale":
                out.append(cache.get_stale(key))
            else:
                cache.clear()
    assert answers[0] == answers[1]
    assert caches[0].stats() == caches[1].stats()
    st = caches[0].stats()
    assert st["stale_hits"] > 0 and st["evictions"] > 0
    assert set(st["insertions_by_tier"]) == {"front", "big"}
