"""Model control plane: versioned model table, CUDA weight cache,
zero-downtime hot reload, and canary rollout.

Port of ``deep_vision_tpu/serve/models.py`` (``WeightCache``,
``CanaryPolicy``, ``ModelVersion``, ``AgreementHistogram``,
``ModelControlPlane``).  One process serves several models and takes a
new trainer checkpoint without a restart:

  versioned table    each model name owns an ordered list of
                     ``ModelVersion``s, each a ServingModel + its own
                     engine + checkpoint identity (step, params digest,
                     step-directory mtime) and a lifecycle state;
  weight cache       ``WeightCache``, an LRU over the bytes the weights
                     take on the device, with a budget.  An evicted
                     model's parameters and buffers point at a pinned
                     host copy (``ServingModel.spill_weights``: the
                     ``.data`` of each tensor is swapped, so the bucket
                     callables, which close over the ``nn.Module``,
                     survive); the next batch re-admits them into fresh
                     device storage with ``copy_`` on its own stream
                     before the forward (``admit_weights``), so a
                     re-admit costs one H2D copy and never rebuilds a
                     callable (the engine's ``compiles`` counter shows
                     it);
  lifecycle          LOADING → SHADOW → CANARY → ACTIVE → DRAINING →
                     RETIRED (or FAILED).  ``reload()`` re-walks the
                     workdir (core/restore.py) in a background thread,
                     optionally shadows (a sampled share of live
                     requests is duplicated onto the candidate, the
                     workload's ``agree`` rule records agreement, the
                     outputs are DISCARDED), then routes a
                     ``canary_frac`` slice of real traffic to the
                     candidate and promotes or rolls back on the
                     ``CanaryPolicy`` gates (error rate, p99 ratio,
                     shadow agreement);
  replicas           a version's engine may be a ``ReplicatedEngine``
                     (serve/replicas.py): every replica's weight view
                     is registered with the cache beside the version's
                     own model, at deploy and at ``add_replica``, and
                     gives its bytes back when the version retires or
                     the replica is removed;
  zero downtime      the old version serves until the new one is
                     ACTIVE; promote swaps the routing table first and
                     only then drains the old engine
                     (``stop(drain_deadline=)``), so in-flight cohorts
                     complete on the version that admitted them, and a
                     request that races the swap is resubmitted to the
                     new active: a reload under load loses no admitted
                     request.

CUDA specifics: an evicted storage is handed back to the caching
allocator only after the work every stream that ran the model had
queued (``record_stream``), and a model whose batch is being launched
is pinned (``pin``/``unpin``) so no other thread evicts it between
admission and launch.  A readmit that fails (an out-of-memory
allocation) fails its batch: the model never serves from host weights.

Lock order: plane._lock and cache._lock are leaf locks, never held
across an engine call (submits, stops and stats happen outside them).
The cache lock is held across a spill or readmit on purpose: two threads
admitting the same model must not both copy.
"""

from __future__ import annotations

import threading
import time
from concurrent.futures import Future

import numpy as np

from deep_vision_tpu_torch.obs.log import event, get_logger
from deep_vision_tpu_torch.serve.admission import Shed
from deep_vision_tpu_torch.serve.engine import _leaves
from deep_vision_tpu_torch.serve.faults import Quarantined

_log = get_logger("dvt.serve.models")

# -- lifecycle states ------------------------------------------------------

LOADING = "loading"
SHADOW = "shadow"
CANARY = "canary"
ACTIVE = "active"
DRAINING = "draining"
RETIRED = "retired"
FAILED = "failed"  # load/warmup raised before the version could serve

#: states in which a version's engine receives live traffic
_ROUTABLE = (SHADOW, CANARY, ACTIVE)

#: the detect decode knobs a reload carries over to the new version
DETECT_KNOBS = ("detect_decode", "detect_topk", "detect_score_threshold",
                "detect_iou_threshold", "detect_soft_nms",
                "detect_soft_sigma", "detect_max_per_class")


class WeightCache:
    """LRU over device bytes for registered serving models.

    A registered model's weights are resident on the device or spilled
    to their host copy.  ``pin`` is the hot-path entry (once per launched
    batch, from the bucket callable's ``weights_in_use``): a resident
    model is a hit (LRU touch); a spilled one is a miss that re-admits
    it, evicting least-recently-used unpinned residents until the budget
    holds.  A pinned model (a batch between admission and launch) is
    never evicted; once launched, its storage outlives the queued work
    through ``record_stream``.

    A model larger than the whole budget still serves: the admit
    proceeds over budget (counted in ``over_budget``).  ``budget_bytes
    <= 0`` means unbounded (residency tracking and counters only).  The
    unit is ``model.param_bytes()``; the caching allocator rounds each
    tensor up to its 512-byte block, which the budget does not count.
    """

    def __init__(self, budget_bytes: int = 0):
        self.budget_bytes = int(budget_bytes)
        # id(model) → entry; insertion order IS recency order (oldest
        # first), maintained by _touch_locked
        self._entries: dict[int, dict] = {}  # guarded-by: _lock
        self._lock = threading.Lock()
        self.hits = 0  # guarded-by: _lock
        self.misses = 0  # guarded-by: _lock
        self.evictions = 0  # guarded-by: _lock
        self.admits = 0  # guarded-by: _lock
        self.over_budget = 0  # guarded-by: _lock
        self.spilled_bytes_total = 0  # guarded-by: _lock

    def register(self, model) -> None:
        """Put ``model`` under residency management.  Resident weights
        count at once (admitting them may evict others when the budget
        is full); a model whose weights were released (a reverted
        version) is admitted by its first batch."""
        nbytes = int(model.param_bytes())
        with self._lock:
            self._entries[id(model)] = {
                "model": model, "nbytes": nbytes,
                "resident": bool(model._resident), "pins": 0}
            if model._resident:
                self._evict_for_locked(id(model))
        model._cache = self
        event(_log, "cache_register", model=model.name, bytes=nbytes,
              budget=self.budget_bytes)

    def drop(self, model) -> None:
        """Take ``model`` out of management (version retired or rolled
        back): its entry, resident bytes included, leaves the table."""
        model._cache = None
        with self._lock:
            self._entries.pop(id(model), None)

    def pin(self, model) -> bool:
        """Make ``model``'s weights resident and keep them so until
        ``unpin``.  False when the model is not under management (the
        caller then handles residency itself)."""
        with self._lock:
            entry = self._entries.get(id(model))
            if entry is None:
                return False
            if entry["resident"]:
                self.hits += 1
            else:
                self.misses += 1
                self._admit_locked(entry)
            self._touch_locked(id(model))
            entry["pins"] += 1
            return True

    def unpin(self, model) -> None:
        with self._lock:
            entry = self._entries.get(id(model))
            if entry is not None:
                entry["pins"] -= 1

    # -- internals (all under _lock) ---------------------------------------

    def _touch_locked(self, key: int):
        self._entries[key] = self._entries.pop(key)

    def _resident_bytes_locked(self) -> int:
        return sum(e["nbytes"] for e in self._entries.values()
                   if e["resident"])

    def _admit_locked(self, entry: dict):
        self.admits += 1
        self._evict_for_locked(id(entry["model"]), entry["nbytes"])
        entry["model"].admit_weights()
        entry["resident"] = True
        event(_log, "cache_admit", model=entry["model"].name,
              bytes=entry["nbytes"],
              resident_bytes=self._resident_bytes_locked())

    def _evict_for_locked(self, keep_key: int, incoming: int = 0):
        """Evict LRU unpinned residents (never ``keep_key``) until the
        budget holds the resident set + ``incoming`` bytes."""
        if self.budget_bytes <= 0:
            return
        while self._resident_bytes_locked() + incoming \
                > self.budget_bytes:
            victim_key = next(
                (k for k, e in self._entries.items()
                 if e["resident"] and not e["pins"] and k != keep_key),
                None)
            if victim_key is None:
                # only the incoming (or pinned) models remain: allow the
                # overrun (a model bigger than the budget still serves)
                self.over_budget += 1
                return
            self._evict_locked(victim_key)

    def _evict_locked(self, key: int):
        entry = self._entries[key]
        # the first eviction pays the D2H copy; later ones only drop
        # the device storage
        self.spilled_bytes_total += entry["model"].spill_weights()
        entry["resident"] = False
        self.evictions += 1
        event(_log, "cache_evict", model=entry["model"].name,
              bytes=entry["nbytes"])

    # -- observability -----------------------------------------------------

    def resident_models(self) -> list[str]:
        with self._lock:
            return [e["model"].name for e in self._entries.values()
                    if e["resident"]]

    def stats(self) -> dict:
        with self._lock:
            return {
                "budget_bytes": self.budget_bytes,
                "resident_bytes": self._resident_bytes_locked(),
                "hits": self.hits, "misses": self.misses,
                "evictions": self.evictions, "admits": self.admits,
                "over_budget": self.over_budget,
                "spilled_bytes_total": self.spilled_bytes_total,
                "models": {
                    e["model"].name: {
                        "bytes": e["nbytes"],
                        "resident": e["resident"],
                        "spilled": e["model"]._host_weights is not None}
                    for e in self._entries.values()}}


class CanaryPolicy:
    """Gates + pacing for the SHADOW/CANARY phases of a reload.

    ``canary_frac`` of live traffic routes to the candidate once it
    reaches CANARY; auto-promote requires ``min_requests`` canary
    answers with an error rate ≤ ``max_error_rate`` AND (when both
    sides have latency history) canary p99 ≤ active p99 ×
    ``max_p99_ratio``.  ``shadow_frac > 0`` first duplicates that
    fraction of live requests onto the candidate (outputs discarded)
    and requires ``min_agreement`` top-1 agreement over
    ``shadow_min_compared`` comparisons.  A phase that can't reach its
    quota within ``phase_timeout_s`` rolls back (timeouts are a
    failure, not a pass)."""

    def __init__(self, *, canary_frac: float = 0.1,
                 min_requests: int = 20,
                 max_error_rate: float = 0.0,
                 max_p99_ratio: float | None = 3.0,
                 shadow_frac: float = 0.0,
                 shadow_min_compared: int = 10,
                 min_agreement: float = 0.8,
                 phase_timeout_s: float = 30.0):
        if not 0.0 < canary_frac <= 1.0:
            raise ValueError(f"canary_frac {canary_frac}: need (0, 1]")
        if not 0.0 <= shadow_frac <= 1.0:
            raise ValueError(f"shadow_frac {shadow_frac}: need [0, 1]")
        self.canary_frac = canary_frac
        self.min_requests = int(min_requests)
        self.max_error_rate = float(max_error_rate)
        self.max_p99_ratio = max_p99_ratio
        self.shadow_frac = shadow_frac
        self.shadow_min_compared = int(shadow_min_compared)
        self.min_agreement = float(min_agreement)
        self.phase_timeout_s = float(phase_timeout_s)

    def describe(self) -> dict:
        return {"canary_frac": self.canary_frac,
                "min_requests": self.min_requests,
                "max_error_rate": self.max_error_rate,
                "max_p99_ratio": self.max_p99_ratio,
                "shadow_frac": self.shadow_frac,
                "shadow_min_compared": self.shadow_min_compared,
                "min_agreement": self.min_agreement,
                "phase_timeout_s": self.phase_timeout_s}


class ModelVersion:
    """One deployable version of one model: ServingModel + engine +
    checkpoint identity + lifecycle state.  Mutable fields are guarded
    by the owning plane's lock."""

    def __init__(self, version: int, model, engine, *,
                 workdir: str | None = None):
        self.version = version
        self.model = model
        self.engine = engine
        self.workdir = workdir
        self.state = LOADING
        self.loaded_at = time.monotonic()
        self.state_reason: str | None = None
        # ever held the default route?  revert() only targets versions
        # that actually served as ACTIVE (not rolled-back candidates)
        self.was_active = False
        # canary accounting (filled by the plane's done-callbacks)
        self.canary_requests = 0
        self.canary_errors = 0
        # shadow accounting
        self.shadow_compared = 0
        self.shadow_agreed = 0
        self.shadow_discarded = 0

    def describe(self) -> dict:
        d = {"version": self.version, "state": self.state,
             "state_reason": self.state_reason,
             "was_active": self.was_active,
             "step": self.model.restored_step,
             "digest": getattr(self.model, "params_digest", None),
             "mtime": getattr(self.model, "restored_mtime", None),
             "ema": getattr(self.model, "restored_ema", None),
             "loaded_age_s": round(time.monotonic() - self.loaded_at, 3)}
        if self.canary_requests or self.canary_errors:
            d["canary"] = {"requests": self.canary_requests,
                           "errors": self.canary_errors}
        if self.shadow_compared or self.shadow_discarded:
            d["shadow"] = {"compared": self.shadow_compared,
                           "agreed": self.shadow_agreed,
                           "discarded": self.shadow_discarded}
        return d


class AgreementHistogram:
    """Tier-vs-big agreement per tier-confidence bucket: one cascade
    hop's calibration sample (serve/cascade.py feeds it).

    Fixed bins over [0, 1): sample i lands in
    ``floor(conf * bins)`` and records whether the cheap tier's answer
    matched the big tier's.  ``threshold()`` answers the calibration
    question: the smallest confidence at which routing everything
    at-or-above it to the cheap tier still clears the operator's
    agreement floor — computed from suffix sums, so it is exactly "the
    measured agreement of the traffic the cheap tier would answer".
    Deterministic for a given sample sequence (no RNG anywhere), which
    is what makes calibration testable with a seeded sample.

    ``per_class=True`` adds a per-CLASS axis: each sample ALSO lands in
    its predicted class's own (bins)-count row, and
    ``class_thresholds()`` derives an independent threshold per class
    from the classes whose own sample is thick enough — so a class the
    cheap tier is systematically wrong about escalates at confidences
    where the pooled histogram would have served it (skewed-class
    calibration, the ROADMAP follow-up).  Class rows are lazy (a dict
    keyed by class id), so no class count is needed up front."""

    def __init__(self, bins: int = 20, per_class: bool = False):
        self.bins = max(1, int(bins))
        self.per_class = bool(per_class)
        self._lock = threading.Lock()
        self._total = [0] * self.bins  # guarded-by: _lock
        self._agree = [0] * self.bins  # guarded-by: _lock
        # class id -> per-bin counts, lazily created; guarded-by: _lock
        self._cls_total: dict = {}
        self._cls_agree: dict = {}

    def record(self, confidence: float, agreed: bool, cls=None):
        conf = min(max(float(confidence), 0.0), 1.0)
        i = min(int(conf * self.bins), self.bins - 1)
        with self._lock:
            self._total[i] += 1
            if agreed:
                self._agree[i] += 1
            if self.per_class and cls is not None:
                c = int(cls)
                t = self._cls_total.setdefault(c, [0] * self.bins)
                a = self._cls_agree.setdefault(c, [0] * self.bins)
                t[i] += 1
                if agreed:
                    a[i] += 1

    def reset(self):
        with self._lock:
            self._total = [0] * self.bins
            self._agree = [0] * self.bins
            self._cls_total = {}
            self._cls_agree = {}

    @staticmethod
    def _check_counts(bins: int, total, agree) -> tuple:
        total = [int(x) for x in total]
        agree = [int(x) for x in agree]
        if len(total) != bins or len(agree) != bins:
            raise ValueError(f"persisted bins {len(total)} != {bins}")
        if any(a > t or t < 0 or a < 0
               for t, a in zip(total, agree)):
            raise ValueError("persisted counts are inconsistent")
        return total, agree

    def restore(self, total, agree, per_class=None):
        """Adopt persisted per-bin counts (the cascade calibration
        ledger's boot replay).  Shape and sanity are
        the caller's digest check's problem; this only enforces that
        the counts fit THIS histogram's binning.  ``per_class`` maps
        class id (JSON string keys fine) to {"total", "agree"} rows and
        is ignored unless this histogram tracks the class axis."""
        total, agree = self._check_counts(self.bins, total, agree)
        cls_total: dict = {}
        cls_agree: dict = {}
        if self.per_class and per_class:
            for key, row in per_class.items():
                c = int(key)
                t, a = self._check_counts(
                    self.bins, row["total"], row["agree"])
                cls_total[c] = t
                cls_agree[c] = a
        with self._lock:
            self._total = total
            self._agree = agree
            self._cls_total = cls_total
            self._cls_agree = cls_agree

    @staticmethod
    def _derive(bins: int, total, agree, min_agreement: float,
                min_sample: int) -> float | None:
        """The suffix-sum walk over ONE count row (the pooled histogram
        or a single class's) — see ``threshold`` for the contract."""
        if sum(total) < max(1, int(min_sample)):
            return None
        suf_t = suf_a = 0
        best = None
        # walk top bin down so each step extends the suffix by one bin;
        # the LAST qualifying populated edge is the smallest qualifying t
        for i in range(bins - 1, -1, -1):
            suf_t += total[i]
            suf_a += agree[i]
            if total[i] > 0 and suf_a / suf_t >= float(min_agreement):
                best = i / bins
        return best

    def threshold(self, min_agreement: float,
                  min_sample: int) -> float | None:
        """Smallest bin lower-edge t where the agreement of all samples
        with confidence >= t clears ``min_agreement`` — or None (fail
        closed: all traffic to the big tier) when the whole sample is
        thinner than ``min_sample`` or no suffix clears the floor.

        The edge must sit on a POPULATED bin: empty bins below the
        lowest qualifying sample never extend the threshold downward,
        so confidence levels the sample has not observed escalate
        instead of riding an extrapolated threshold (conservative in
        the cheap direction — an extra big-tier answer costs
        throughput, never correctness)."""
        with self._lock:
            total = list(self._total)
            agree = list(self._agree)
        return self._derive(self.bins, total, agree,
                            min_agreement, min_sample)

    def class_thresholds(self, min_agreement: float,
                         min_sample: int) -> dict:
        """Per-class thresholds for every class whose OWN sample clears
        ``min_sample``: the class's qualifying threshold, or ``None``
        when no confidence level clears the floor — a measured-bad
        class FAILS CLOSED (always escalates) instead of riding the
        pooled threshold it is known to violate.  Classes absent from
        the map (sample too thin) fall back to the pooled threshold."""
        with self._lock:
            rows = {c: (list(self._cls_total[c]),
                        list(self._cls_agree[c]))
                    for c in self._cls_total}
        out = {}
        for c, (total, agree) in sorted(rows.items()):
            if sum(total) < max(1, int(min_sample)):
                continue
            out[c] = self._derive(self.bins, total, agree,
                                  min_agreement, min_sample)
        return out

    def stats(self) -> dict:
        with self._lock:
            total = list(self._total)
            agree = list(self._agree)
            cls_n = {c: sum(t) for c, t in self._cls_total.items()}
        n = sum(total)
        out = {"bins": self.bins,
               "samples": n,
               "agreement": (sum(agree) / n) if n else None,
               "total": total,
               "agree": agree}
        if self.per_class:
            out["class_samples"] = {str(c): cls_n[c]
                                    for c in sorted(cls_n)}
        return out

    def class_counts(self) -> dict:
        """Per-class count rows for the persistence ledger — JSON-safe
        {class id as str: {"total": [...], "agree": [...]}}."""
        with self._lock:
            return {str(c): {"total": list(self._cls_total[c]),
                             "agree": list(self._cls_agree[c])}
                    for c in sorted(self._cls_total)}


class ModelControlPlane:
    """Versioned model table + reload/canary lifecycle over N engines.

    ``engine_factory(model)`` builds (and does NOT start) an engine for
    a ServingModel — cli.serve wires the production BatchingEngine
    construction through it (with one ``AdmissionController`` per model
    name shared across its versions, so the per-bucket exec EWMAs carry
    over a reload), tests inject small ones.

    Drop-in engine surface for ``cli.serve``'s boot prints and
    shutdown: ``buckets``/``faults``/``model`` proxy the first deployed
    engine; ``stop(drain_deadline=)`` drains every
    routable version.
    """

    def __init__(self, registry, engine_factory, *,
                 cache: WeightCache | None = None,
                 policy: CanaryPolicy | None = None,
                 retain_retired: int = 5):
        self.registry = registry
        self.engine_factory = engine_factory
        self.cache = cache
        self.policy = policy or CanaryPolicy()
        self.retain_retired = int(retain_retired)
        # name → ordered list of ModelVersions (oldest first); the
        # versioned model table
        self._table: dict[str, list[ModelVersion]] = {}  # guarded-by: _lock
        # name → the version currently answering the default route
        self._active: dict[str, ModelVersion] = {}  # guarded-by: _lock
        # name → (candidate, period) canary routing: every period-th
        # submit goes to the candidate (deterministic, not sampled — a
        # 10% canary is exactly every 10th request)
        self._canary: dict[str, tuple] = {}  # guarded-by: _lock
        # name → (candidate, period) shadow duplication
        self._shadow: dict[str, tuple] = {}  # guarded-by: _lock
        self._counter: dict[str, int] = {}  # guarded-by: _lock
        self._reloading: dict[str, threading.Thread] = {}  # guarded-by: _lock
        # fns called as fn(name) after a version swap of name (deploy,
        # promote, and through promote revert): the cascade's
        # recalibration hook; mutated under _lock, snapshotted to fire
        self._version_listeners: list = []  # guarded-by: _lock
        self._lock = threading.Lock()
        self._stopping = threading.Event()
        self.reloads = 0  # guarded-by: _lock
        self.promotions = 0  # guarded-by: _lock
        self.rollbacks = 0  # guarded-by: _lock
        self.reverts = 0  # guarded-by: _lock
        self.resubmitted = 0  # guarded-by: _lock
        # optional BrownoutController (serve/brownout.py): at L1+ the
        # shadow duplicate is optional work and pauses (the shadow phase
        # compares more slowly); read racily, None = off
        self.brownout = None
        self.shadow_paused = 0  # guarded-by: _lock

    def add_version_listener(self, fn):
        """Register ``fn(name)`` to fire after any version swap of
        ``name`` (deploy, promote, and through promote a revert).  The
        cascade router drops a hop's calibration with it the moment a
        tier's weights change."""
        with self._lock:
            self._version_listeners.append(fn)

    def _fire_version_listeners(self, name: str):
        # snapshot, then call OUTSIDE _lock: a listener may call back
        # into the plane (resolve, canary_active)
        with self._lock:
            listeners = list(self._version_listeners)
        for fn in listeners:
            try:
                fn(name)
            except Exception as e:  # noqa: BLE001 — a listener must not break a deploy
                event(_log, "version_listener_error", model=name,
                      error=f"{type(e).__name__}: {e}")

    # -- deployment --------------------------------------------------------

    def deploy(self, model, *, workdir: str | None = None,
               start: bool = True) -> ModelVersion:
        """Install ``model`` as the next version of its name and make
        it ACTIVE immediately (the boot path; ``reload`` is the
        gradual-rollout path).  Builds + starts its engine, registers
        its weights with the cache, and publishes it in the registry."""
        engine = self.engine_factory(model)
        mv = ModelVersion(0, model, engine, workdir=workdir)
        # allocate the version number and publish the table entry in ONE
        # critical section — two concurrent deploys (or a deploy racing
        # a reload) must never mint the same number
        with self._lock:
            versions = self._table.setdefault(model.name, [])
            mv.version = (versions[-1].version + 1) if versions else 1
            model.serve_version = mv.version
            versions.append(mv)
        try:
            self._register(mv)
            if start:
                engine.start()
        except Exception:  # noqa: BLE001 — cleanup only; re-raised to the boot caller
            with self._lock:
                versions.remove(mv)  # failed boot leaves no table entry
            self._unregister(mv)
            raise
        self.registry.add(model, version=mv.version)
        with self._lock:
            old = self._active.get(model.name)
            self._active[model.name] = mv
            mv.state = ACTIVE
            mv.was_active = True
        if old is not None:
            self._retire(old, reason="replaced by deploy")
        self._fire_version_listeners(model.name)
        event(_log, "deploy", model=model.name, version=mv.version,
              step=model.restored_step)
        return mv

    # -- request path ------------------------------------------------------

    def resolve(self, name: str | None):
        """Routing-table model lookup for the HTTP layer: the ACTIVE
        version's ServingModel (KeyError lists the served names, same
        contract as ``ModelRegistry.get``)."""
        with self._lock:
            names = sorted(self._active)
            if name is None:
                if len(self._active) != 1:
                    raise KeyError(f"model name required "
                                   f"(serving {names})")
                return next(iter(self._active.values())).model
            mv = self._active.get(name)
        if mv is None:
            raise KeyError(f"unknown model '{name}'; serving {names}")
        return mv.model

    def active_version(self, name: str) -> ModelVersion:
        """The ACTIVE ModelVersion for ``name`` (workdir, model and
        engine in one handle): the deploy watcher's view."""
        with self._lock:
            mv = self._active.get(name)
            names = sorted(self._active)
        if mv is None:
            raise KeyError(f"unknown model '{name}'; serving {names}")
        return mv

    def load_candidate(self, name: str):
        """Load (but do NOT deploy) the newest checkpoint under
        ``name``'s workdir as a fresh ServingModel, by the restore path
        a reload takes: the deploy watcher's accuracy gate evaluates it
        before anything enters the version table."""
        return self._load_model(self.active_version(name))

    def active_engine(self, name: str):
        with self._lock:
            mv = self._active.get(name)
        if mv is None:
            raise KeyError(f"unknown model '{name}'; "
                           f"serving {sorted(self._active)}")
        return mv.engine

    def active_engines(self) -> dict:
        """name → active engine snapshot (the healthz/metrics view)."""
        with self._lock:
            return {name: mv.engine
                    for name, mv in sorted(self._active.items())}

    def versions(self, name: str) -> list:
        """Snapshot of ``name``'s version table, oldest first."""
        with self._lock:
            return list(self._table.get(name, []))

    def canary_active(self, name: str) -> bool:
        """True while a canary candidate takes a slice of ``name``'s
        traffic — the response cache must not INSERT during that window
        (a canary-served answer would be filed under the active
        version's digest), though lookups stay safe."""
        with self._lock:
            return name in self._canary

    def submit(self, name: str, image, deadline_ms: float | None = None,
               span=None) -> Future:
        """Route one request: the ACTIVE version, or — every canary
        period — the CANARY candidate; an optional SHADOW duplicate
        rides along with its output discarded.  The returned future
        resolves exactly like an engine's.  If the admitting version
        was drained out from under the request mid-reload (its engine
        answered ``Shed("shutdown")`` while a newer version is active),
        the request transparently resubmits to the current active —
        the zero-lost-requests half of zero-downtime."""
        fut: Future = Future()
        self._submit_once(name, image, deadline_ms, span, fut, retries=3)
        return fut

    def infer(self, name: str, image, deadline_ms: float | None = None,
              timeout: float | None = 30.0, span=None):
        return self.submit(name, image, deadline_ms,
                           span=span).result(timeout)

    def _submit_once(self, name, image, deadline_ms, span, fut: Future,
                     retries: int):
        with self._lock:
            mv = self._active.get(name)
            if mv is None:
                names = sorted(self._active)
                err: Exception = KeyError(
                    f"unknown model '{name}'; serving {names}")
                mv = None
            else:
                err = None
                self._counter[name] = self._counter.get(name, 0) + 1
                tick = self._counter[name]
                canary = self._canary.get(name)
                shadow = self._shadow.get(name)
                if canary is not None and tick % canary[1] == 0:
                    mv = canary[0]  # this request IS canary traffic
                    canary = None
        if err is not None:
            fut.set_exception(err)
            return
        is_canary = mv.state == CANARY
        inner = mv.engine.submit(image, deadline_ms, span=span)
        inner.add_done_callback(
            lambda f: self._request_done(f, name, mv, image,
                                         deadline_ms, span, fut,
                                         retries, is_canary))
        # shadow duplication: same image onto the candidate, result
        # compared against the primary then discarded — the candidate
        # never answers a client while shadowing
        if shadow is not None and tick % shadow[1] == 0:
            bo = self.brownout
            if bo is not None and bo.at_least(1):
                # brownout L1+: the duplicate is optional work; the
                # shadow phase compares more slowly, nothing breaks
                with self._lock:
                    self.shadow_paused += 1
            else:
                self._shadow_submit(shadow[0], image, inner)

    def _request_done(self, inner: Future, name, mv, image, deadline_ms,
                      span, fut: Future, retries: int, is_canary: bool):
        """Done-callback on the engine future: transfer the result out,
        count canary outcomes, and resubmit shutdown-shed requests that
        raced a version swap.  Runs on an engine worker thread — must
        never block."""
        try:
            result = inner.result()
        except Exception as e:  # noqa: BLE001 — the engine failed the future; propagate (after canary accounting)
            if is_canary:
                self._count_canary(mv, error=True)
            fut.set_exception(e)
            return
        if is_canary:
            self._count_canary(mv, error=self._is_bad(result))
        if isinstance(result, Shed) and result.reason == "shutdown" \
                and retries > 0 and not self._stopping.is_set():
            with self._lock:
                active = self._active.get(name)
            if active is not None and active is not mv:
                # the admitting version was drained mid-reload: the
                # new active owns this request now
                with self._lock:
                    self.resubmitted += 1
                self._submit_once(name, image, deadline_ms, span, fut,
                                  retries - 1)
                return
        fut.set_result(result)

    @staticmethod
    def _is_bad(result) -> bool:
        """Is this served result an error for canary gating?  Failed
        futures and Quarantined are; NaN float output is (a bad
        checkpoint's signature — serve/faults.py nan mode); sheds are
        capacity, not version quality."""
        if isinstance(result, Quarantined):
            return True
        if isinstance(result, Shed):
            return False
        for leaf in _leaves(result):
            arr = np.asarray(leaf)
            if arr.dtype.kind == "f" and np.isnan(arr).any():
                return True
        return False

    def _count_canary(self, mv: ModelVersion, *, error: bool):
        with self._lock:
            mv.canary_requests += 1
            if error:
                mv.canary_errors += 1

    # -- shadow ------------------------------------------------------------

    def _shadow_submit(self, mv: ModelVersion, image, primary: Future):
        sfut = mv.engine.submit(image)
        holder: dict = {}

        def arrived(which, f):
            with self._lock:
                holder[which] = f
                ready = len(holder) == 2 and not holder.get("_done")
                if ready:
                    holder["_done"] = True
                p, s = holder.get("p"), holder.get("s")
            if ready:
                self._compare_shadow(mv, p, s)

        primary.add_done_callback(lambda f: arrived("p", f))
        sfut.add_done_callback(lambda f: arrived("s", f))

    def _compare_shadow(self, mv: ModelVersion, p: Future, s: Future):
        """Both sides answered: record per-workload agreement, then
        DISCARD the shadow output (it never reaches a client).  The
        workload adapter owns the metric (serve/workloads.py): top-1
        argmax for classify, PCK-style keypoint proximity for pose,
        output-digest equality for generate, greedy IoU≥0.5 class-
        matched pairing fraction (the mAP proxy) for detect;
        ``agree()`` returning None means "not comparable"
        (Shed/Quarantined rows, host-path detect pyramids) — discarded
        without entering the compared count, the same accounting shape
        as before workloads existed."""
        try:
            pr, sr = p.result(), s.result()
        except Exception:  # noqa: BLE001 — either side failed: nothing to compare
            with self._lock:
                mv.shadow_discarded += 1
            return
        wl = getattr(mv.model, "workload", None)
        verdict = None
        if wl is not None:
            try:
                verdict = wl.agree(pr, sr)
            except Exception:  # noqa: BLE001 — a row the metric can't digest
                verdict = None
        with self._lock:
            mv.shadow_discarded += 1
            if verdict is None:
                return
            mv.shadow_compared += 1
            if verdict:
                mv.shadow_agreed += 1

    # -- reload lifecycle --------------------------------------------------

    def reload(self, name: str, *, force: bool = False,
               wait: bool = False, _loader=None) -> dict:
        """Kick a background reload of ``name`` from its workdir: load
        the newest checkpoint, shadow/canary per the policy, then
        auto-promote or auto-roll-back.  Returns immediately with the
        accepted/refused verdict (``wait=True`` blocks until the
        lifecycle completes — the test/CLI convenience).  One reload
        per model at a time (a second request answers ``in_progress``).
        ``_loader()`` (test seam) overrides the checkpoint walk and
        must return a ready ServingModel."""
        with self._lock:
            mv = self._active.get(name)
            if mv is None:
                raise KeyError(f"unknown model '{name}'; "
                               f"serving {sorted(self._active)}")
            t = self._reloading.get(name)
            if t is not None and t.is_alive():
                return {"status": "in_progress", "model": name}
        if _loader is None and mv.workdir is None:
            return {"status": "refused", "model": name,
                    "reason": "no workdir to reload from"}
        if not force and _loader is None:
            from deep_vision_tpu_torch.core.restore import \
                checkpoint_fingerprint

            fp = checkpoint_fingerprint(mv.workdir)
            if fp["step"] == mv.model.restored_step and \
                    fp["step"] is not None:
                return {"status": "no_new_step", "model": name,
                        "step": fp["step"]}
        worker = threading.Thread(
            target=self._reload_worker, args=(name, mv, _loader),
            name=f"reload-{name}", daemon=True)
        with self._lock:
            self._reloading[name] = worker
            self.reloads += 1
        worker.start()
        if wait:
            # wait=True's contract is "return only once the reload has
            # resolved" — compile time is unbounded, so no timeout
            worker.join()  # dvtlint: disable=DVT007
            with self._lock:
                versions = list(self._table.get(name, []))
            last = versions[-1].describe() if versions else None
            return {"status": "done", "model": name, "version": last}
        return {"status": "reloading", "model": name}

    def _load_model(self, mv: ModelVersion):
        """Default loader: the registry's restore path into a FRESH
        ServingModel (the old version keeps serving its weights), with
        the old version's dtypes, calibration provenance and detect
        knobs; int8 recalibrates on the new weights."""
        from deep_vision_tpu_torch.core.restore import load_state
        from deep_vision_tpu_torch.serve.registry import (
            CheckpointServingModel,
            stamp_restore,
        )

        old = mv.model
        info: dict = {}
        model = load_state(old.cfg, workdir=mv.workdir, tag="reload",
                           info=info)
        sm = CheckpointServingModel(
            old.name, old.cfg, model, wire_dtype=str(old.wire_dtype),
            infer_dtype=old.infer_dtype, calib_batches=old.calib_batches,
            calib_dir=old.calib_dir, device=old.device)
        for knob in DETECT_KNOBS:
            setattr(sm, knob, getattr(old, knob))
        # a cascade front tier keeps its fused confidence epilogue
        sm.cascade_topk = old.cascade_topk
        stamp_restore(sm, info)
        return sm

    def _reload_worker(self, name: str, old_mv: ModelVersion, _loader):
        try:
            sm = _loader() if _loader is not None \
                else self._load_model(old_mv)
        except Exception as e:  # noqa: BLE001 — a bad checkpoint must not kill the plane
            event(_log, "reload_failed", model=name,
                  error=f"{type(e).__name__}: {e}")
            return
        engine = self.engine_factory(sm)
        mv = ModelVersion(0, sm, engine, workdir=old_mv.workdir)
        # same single-critical-section allocation as deploy(): the
        # version number and the table entry are minted atomically
        with self._lock:
            versions = self._table.setdefault(name, [])
            mv.version = (versions[-1].version + 1) if versions else 1
            sm.serve_version = mv.version
            versions.append(mv)
        v = mv.version
        try:
            self._register(mv)
            engine.start()
            # warm EVERY bucket before entering shadow/canary: a canary
            # request landing on a cold bucket would pay the compile,
            # inflating the candidate's p99 and tripping the
            # max_p99_ratio gate on a healthy version
            engine.warmup()
        except Exception as e:  # noqa: BLE001 — version never served; mark and bail
            with self._lock:
                mv.state = FAILED
                mv.state_reason = f"{type(e).__name__}: {e}"
            engine.stop()
            self._unregister(mv)
            self._release_weights(mv)
            event(_log, "reload_failed", model=name, version=v,
                  error=mv.state_reason)
            return
        event(_log, "reload_loaded", model=name, version=v,
              step=sm.restored_step, digest=sm.params_digest)
        # each phase answers True (gates passed), False (gates failed),
        # or None (the operator promoted/rolled back the candidate out
        # from under the phase — the worker's verdict is moot and the
        # guarded transitions below would no-op anyway)
        if self.policy.shadow_frac > 0:
            ok = self._run_shadow(name, mv)
            if ok is None:
                return
            if not ok:
                self._rollback(name, mv, "shadow gate failed")
                return
        ok = self._run_canary(name, mv)
        if ok is None:
            return
        if not ok:
            self._rollback(name, mv, "canary gate failed")
            return
        self._promote(name, mv)

    def _phase_wait(self, done, timeout_s: float) -> bool:
        """Poll ``done()`` until true or the phase times out (timeouts
        fail the phase — an idle service can't validate a candidate)."""
        t_end = time.monotonic() + timeout_s
        while time.monotonic() < t_end:
            if done():
                return True
            if self._stopping.wait(0.005):
                return False
        return done()

    def _run_shadow(self, name: str, mv: ModelVersion) -> bool | None:
        period = max(1, round(1.0 / self.policy.shadow_frac))
        with self._lock:
            mv.state = SHADOW
            self._shadow[name] = (mv, period)
        event(_log, "shadow_start", model=name, version=mv.version,
              period=period)
        try:
            # an operator promote/rollback moves the candidate out of
            # SHADOW under the lock — that ends the phase immediately
            ok = self._phase_wait(
                lambda: mv.state != SHADOW
                or mv.shadow_compared
                >= self.policy.shadow_min_compared,
                self.policy.phase_timeout_s)
        finally:
            with self._lock:
                pair = self._shadow.get(name)
                if pair is not None and pair[0] is mv:
                    self._shadow.pop(name)
        with self._lock:
            if mv.state != SHADOW:
                return None  # operator decided mid-phase
            compared, agreed = mv.shadow_compared, mv.shadow_agreed
        if not ok:
            mv.state_reason = (f"shadow timeout: {compared}/"
                               f"{self.policy.shadow_min_compared} "
                               f"compared")
            return False
        agreement = agreed / compared if compared else 0.0
        event(_log, "shadow_done", model=name, version=mv.version,
              compared=compared, agreed=agreed,
              agreement=round(agreement, 4))
        if agreement < self.policy.min_agreement:
            mv.state_reason = (f"shadow agreement {agreement:.2f} < "
                               f"{self.policy.min_agreement}")
            return False
        return True

    def _run_canary(self, name: str, mv: ModelVersion) -> bool | None:
        period = max(1, round(1.0 / self.policy.canary_frac))
        with self._lock:
            mv.state = CANARY
            self._canary[name] = (mv, period)
        event(_log, "canary_start", model=name, version=mv.version,
              period=period)
        try:
            ok = self._phase_wait(
                lambda: mv.state != CANARY
                or mv.canary_requests >= self.policy.min_requests,
                self.policy.phase_timeout_s)
            with self._lock:
                if mv.state != CANARY:
                    return None  # operator decided mid-phase
                requests, errors = mv.canary_requests, mv.canary_errors
            if not ok:
                mv.state_reason = (f"canary timeout: {requests}/"
                                   f"{self.policy.min_requests} "
                                   f"requests")
                return False
            error_rate = errors / requests if requests else 1.0
            if error_rate > self.policy.max_error_rate:
                mv.state_reason = (f"canary error rate "
                                   f"{error_rate:.3f} > "
                                   f"{self.policy.max_error_rate}")
                return False
            # p99 regression gate: the candidate engine's own latency
            # distribution vs the active's (same histogram edges)
            if self.policy.max_p99_ratio is not None:
                with self._lock:
                    active = self._active.get(name)
                cp = mv.engine.stats()["latency"]
                ap = active.engine.stats()["latency"] \
                    if active is not None else {}
                if cp.get("count") and ap.get("count") and \
                        ap.get("p99_ms"):
                    ratio = cp["p99_ms"] / ap["p99_ms"]
                    if ratio > self.policy.max_p99_ratio:
                        mv.state_reason = (
                            f"canary p99 {cp['p99_ms']:.1f}ms is "
                            f"{ratio:.2f}x active "
                            f"{ap['p99_ms']:.1f}ms > "
                            f"{self.policy.max_p99_ratio}x")
                        return False
            event(_log, "canary_done", model=name, version=mv.version,
                  requests=requests, errors=errors)
            return True
        finally:
            with self._lock:
                pair = self._canary.get(name)
                if pair is not None and pair[0] is mv:
                    self._canary.pop(name)

    def _promote(self, name: str, mv: ModelVersion) -> bool:
        """Swap the routing table to ``mv`` FIRST, then drain the old
        version — no instant exists where neither serves.  The swap is
        a guarded transition: both the reload worker and the operator
        override land here, and only a candidate still in its rollout
        (LOADING/SHADOW/CANARY) can win — a candidate the other side
        already promoted or retired is left alone (returns False)."""
        with self._lock:
            if mv.state not in (LOADING, SHADOW, CANARY):
                return False
            old = self._active.get(name)
            self._active[name] = mv
            mv.state = ACTIVE
            mv.was_active = True
            self.promotions += 1
            # the candidate stops being canary/shadow traffic the same
            # instant it becomes the default route
            for routes in (self._canary, self._shadow):
                pair = routes.get(name)
                if pair is not None and pair[0] is mv:
                    routes.pop(name)
        self.registry.add(mv.model, version=mv.version)
        self._fire_version_listeners(name)
        event(_log, "promote", model=name, version=mv.version,
              step=mv.model.restored_step)
        if old is not None and old is not mv:
            self._retire(old, reason=f"superseded by v{mv.version}")
        return True

    @staticmethod
    def _views(mv: ModelVersion) -> list:
        """The replica weight views of ``mv``'s engine (none for a single
        engine), retired slots included."""
        return [rep.model for rep in getattr(mv.engine, "replicas", ())
                if rep.model is not mv.model]

    def _register(self, mv: ModelVersion):
        """Put the version's weights, and every replica view's, under the
        cache's budget."""
        if self.cache is not None:
            self.cache.register(mv.model)
            for view in self._views(mv):
                self.cache.register(view)

    def _unregister(self, mv: ModelVersion):
        if self.cache is not None:
            self.cache.drop(mv.model)
            for view in self._views(mv):
                self.cache.drop(view)

    @classmethod
    def _release_weights(cls, mv: ModelVersion):
        """Free a drained version's device weight copies (their host
        copies stay): the model's own and every replica view's."""
        mv.model.release_device_weights()
        for view in cls._views(mv):
            view.release_device_weights()

    def _rollback(self, name: str, mv: ModelVersion, why: str) -> bool:
        """Guarded like ``_promote``: only a candidate still in its
        rollout can be rolled back, so the worker's gate verdict can
        never retire a version the operator just made ACTIVE."""
        with self._lock:
            if mv.state not in (LOADING, SHADOW, CANARY):
                return False
            self.rollbacks += 1
            reason = mv.state_reason or why
            for routes in (self._canary, self._shadow):
                pair = routes.get(name)
                if pair is not None and pair[0] is mv:
                    routes.pop(name)
        event(_log, "rollback", model=name, version=mv.version,
              reason=reason)
        self._retire(mv, reason=reason or why, rolled_back=True)
        return True

    def _retire(self, mv: ModelVersion, *, reason: str,
                rolled_back: bool = False):
        """DRAINING → RETIRED: admitted work finishes on the version
        that admitted it, then the engine stops, the weights leave the
        cache, and the version's device weight copy is released (host
        spill) — a retained-for-observability retired version costs
        host RAM, never HBM."""
        with self._lock:
            if mv.state in (DRAINING, RETIRED, FAILED):
                return  # another thread is already retiring it
            mv.state = DRAINING
            if rolled_back or mv.state_reason is None:
                mv.state_reason = reason
        mv.engine.stop(drain_deadline=5.0)
        self._unregister(mv)
        self._release_weights(mv)
        with self._lock:
            mv.state = RETIRED
            versions = self._table.get(mv.model.name, [])
            retired = [x for x in versions
                       if x.state in (RETIRED, FAILED)]
            for stale in retired[:-self.retain_retired] \
                    if self.retain_retired > 0 else []:
                versions.remove(stale)
                # the registry's version table must not outlive the
                # retain window, or its refs pin the pruned weights
                self.registry.remove_version(mv.model.name,
                                             stale.version)
        event(_log, "retired", model=mv.model.name, version=mv.version,
              reason=reason)

    def promote(self, name: str) -> dict:
        """Operator override: promote the in-flight CANARY/SHADOW
        candidate immediately, skipping the remaining gates.  Decided
        through the same guarded transition the reload worker uses, so
        whichever side moves first wins and the other's verdict is a
        no-op (the worker re-checks the candidate's state and bails)."""
        with self._lock:
            pair = self._canary.get(name) or self._shadow.get(name)
        if pair is None:
            return {"status": "refused", "model": name,
                    "reason": "no candidate in canary/shadow"}
        if not self._promote(name, pair[0]):
            return {"status": "refused", "model": name,
                    "reason": f"v{pair[0].version} already decided"}
        return {"status": "promoted", "model": name,
                "version": pair[0].version}

    def rollback(self, name: str) -> dict:
        """Operator override: retire the in-flight candidate now (same
        guarded transition as ``promote``)."""
        with self._lock:
            pair = self._canary.get(name) or self._shadow.get(name)
        if pair is None:
            return {"status": "refused", "model": name,
                    "reason": "no candidate in canary/shadow"}
        if not self._rollback(name, pair[0], "operator rollback"):
            return {"status": "refused", "model": name,
                    "reason": f"v{pair[0].version} already decided"}
        return {"status": "rolled_back", "model": name,
                "version": pair[0].version}

    def revert(self, name: str) -> dict:
        """One-command rollback to the previous promoted version: mint
        a NEW version wrapping the newest RETIRED model that actually
        held the default route (``was_active``), start + warm its fresh
        engine, then swap it ACTIVE through the same guarded
        ``_promote`` transition every other path uses — the current
        active drains afterwards, so no instant exists where neither
        serves and admitted work finishes where it was admitted.

        Busy-vs-failed semantics match the gateway fan-out: a lifecycle
        already in flight answers ``in_progress`` (HTTP 409) without
        touching anything; nothing to revert to answers ``refused``; a
        revert whose engine fails to boot answers ``failed`` (500) and
        leaves the current active untouched."""
        with self._lock:
            active = self._active.get(name)
            if active is None:
                raise KeyError(f"unknown model '{name}'; "
                               f"serving {sorted(self._active)}")
            t = self._reloading.get(name)
            if (t is not None and t.is_alive()) \
                    or name in self._canary or name in self._shadow:
                return {"status": "in_progress", "model": name,
                        "reason": "a reload lifecycle is in flight"}
            target = None
            for old in reversed(self._table.get(name, [])):
                if old.version < active.version \
                        and old.state == RETIRED and old.was_active:
                    target = old
                    break
        if target is None:
            return {"status": "refused", "model": name,
                    "reason": "no previous promoted version to "
                              "revert to"}
        sm = target.model
        engine = self.engine_factory(sm)
        mv = ModelVersion(0, sm, engine, workdir=target.workdir)
        # same single-critical-section allocation as deploy()/reload
        with self._lock:
            versions = self._table.setdefault(name, [])
            mv.version = (versions[-1].version + 1) if versions else 1
            sm.serve_version = mv.version
            versions.append(mv)
        try:
            self._register(mv)
            engine.start()
            engine.warmup()  # no canary phase: warm before the swap
        except Exception as e:  # noqa: BLE001 — failed revert must not take the active down
            with self._lock:
                mv.state = FAILED
                mv.state_reason = f"{type(e).__name__}: {e}"
            engine.stop()
            self._unregister(mv)
            self._release_weights(mv)
            event(_log, "revert_failed", model=name, version=mv.version,
                  error=mv.state_reason)
            return {"status": "failed", "model": name,
                    "reason": mv.state_reason}
        if not self._promote(name, mv):
            self._retire(mv, reason="revert lost the promote race")
            return {"status": "refused", "model": name,
                    "reason": "another lifecycle decided first"}
        with self._lock:
            self.reverts += 1
        event(_log, "revert", model=name, version=mv.version,
              restores=target.version, from_version=active.version,
              step=sm.restored_step, digest=sm.params_digest)
        return {"status": "reverted", "model": name,
                "version": mv.version, "restores": target.version,
                "from_version": active.version}

    # -- lifecycle / engine-surface compatibility --------------------------

    @property
    def faults(self):
        with self._lock:
            mv = next(iter(self._active.values()), None)
        return mv.engine.faults if mv is not None else _NO_FAULTS

    @property
    def buckets(self):
        with self._lock:
            mv = next(iter(self._active.values()), None)
        return mv.engine.buckets if mv is not None else []

    @property
    def model(self):
        with self._lock:
            mv = next(iter(self._active.values()), None)
        return mv.model if mv is not None else None

    def warmup(self, buckets=None):
        for eng in self.active_engines().values():
            eng.warmup(buckets)

    def stop(self, timeout: float = 5.0,
             drain_deadline: float | None = None):
        """Stop every version's engine (reload workers bail at the next
        phase poll)."""
        self._stopping.set()
        with self._lock:
            workers = list(self._reloading.values())
            versions = [mv for vs in self._table.values() for mv in vs]
        for w in workers:
            w.join(timeout)
        for mv in versions:
            if mv.state in _ROUTABLE or mv.state == LOADING:
                mv.engine.stop(timeout, drain_deadline=drain_deadline)

    # -- observability -----------------------------------------------------

    def models(self) -> dict:
        """The /v1/models listing: per name, the version table + which
        one is active + the gate policy."""
        with self._lock:
            names = {name: (list(vs), self._active.get(name))
                     for name, vs in self._table.items()}
        out = {}
        for name, (versions, active) in sorted(names.items()):
            out[name] = {
                "active_version": active.version
                if active is not None else None,
                "model": (active.model.describe()
                          if active is not None else None),
                "versions": [mv.describe() for mv in versions]}
        return out

    def stats(self) -> dict:
        """The plane-shaped /v1/stats body: ``models`` (per name: the
        active engine's full stats + the version table), ``cache``, and
        ``plane`` counters.  serve/http.py renders /metrics from it."""
        with self._lock:
            snapshot = {name: (self._active.get(name),
                               list(self._table.get(name, [])))
                        for name in self._table}
            plane = {"reloads": self.reloads,
                     "promotions": self.promotions,
                     "rollbacks": self.rollbacks,
                     "reverts": self.reverts,
                     "resubmitted": self.resubmitted,
                     "shadow_paused": self.shadow_paused,
                     "policy": self.policy.describe()}
        models = {}
        for name, (active, versions) in sorted(snapshot.items()):
            entry = {
                "active_version": active.version
                if active is not None else None,
                "versions": [mv.describe() for mv in versions]}
            if active is not None:
                entry["engine"] = active.engine.stats()
            # a routable non-active candidate's engine stats ride along
            # so canary latency/error progress is observable mid-rollout
            for mv in versions:
                if mv is not active and mv.state in _ROUTABLE:
                    entry["candidate_engine"] = mv.engine.stats()
            models[name] = entry
        out = {"models": models, "plane": plane}
        if self.cache is not None:
            out["cache"] = self.cache.stats()
        return out


class _NoFaults:
    enabled = False
    spec = ""
    seed = 0


_NO_FAULTS = _NoFaults()
