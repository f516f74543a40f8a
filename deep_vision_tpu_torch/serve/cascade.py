"""Confidence-routed model cascade: serve the cheapest model that is
sure.

Port of ``deep_vision_tpu/serve/cascade.py`` (``CascadeSpec``,
``CascadeRouter``, ``base_tier``, ``is_degraded``).  The classifier zoo
spans ~50× in compute for one task, and most traffic does not need the
big model.  ``CascadeRouter`` sits on the model control plane
(serve/models.py) and routes every request addressed to the BIG model's
name through a chain of cheaper tiers first (``--cascade
t0:t1:...:big``): a request walks the chain front to back and escalates
past each tier whose confidence is below that HOP's calibrated
threshold; the final tier is always authoritative.

Clients name the big model (the name is the quality contract); the
answering tier is reported in the ``X-DVT-Tier`` header ("front", "t1",
..., "big").  A request naming a cheap tier directly bypasses the
cascade, and "always-big" QoS tenants (serve/admission.py) go straight
to the big tier.

Calibration is per hop: every ``sample_period``-th request ARRIVING at
hop i dual-runs tier i AND the big tier; the client gets the big answer
and tier-i-vs-big agreement is recorded in hop i's
``AgreementHistogram`` at tier i's confidence bucket.  A hop's threshold
is the smallest confidence whose measured at-or-above agreement clears
``min_agreement``; every hop calibrates against the FINAL tier, so
serving from any hop claims tier-vs-big quality directly.  A
``CascadeWorkloadRule`` (serve/workloads.py) from the big tier's
workload says what confidence and agreement are: the fused top-1
probability and top-1 match for classify, the best valid device-decoded
score and the greedy-IoU pairing for detect.  ``per_class=True`` adds a
per-class threshold axis (a class without enough sample of its own uses
the pooled threshold; a measured-bad class always escalates).

Fail closed, per hop: an UNCALIBRATED hop escalates THROUGH (its tier is
not run), so an uncalibrated chain serves everything from big, and any
tier failure (Shed, Quarantined, an exception, a row without a signal)
escalates the same way (counted in ``escalated_error``).  A version swap
of tier i (reload, promote, revert) resets ONLY hop i; a swap of the big
tier resets every hop.

Cheap classify tiers carry the fused confidence epilogue
(``ClassifyWorkload.make_epilogue``), detect tiers their fused decode,
so the router reads its signal off the bulk D2H row.  An escalated
request enters the next tier's admission queue with its REMAINING
deadline and its original trace span.

Brownout hooks (serve/brownout.py; ``router.brownout`` defaults to
None): at L1+ the dual-run samples pause at every hop (each skipped slot
counted in ``samples_paused``); at L2+ a non-premium request below a
CALIBRATED hop's threshold is served that tier's answer anyway, as a
``<tier>-degraded`` token that serve/http.py marks ``X-DVT-Degraded``.
Always-big tenants bypass both.

With ``root`` (``<workdir>/_cascade`` from cli.serve) calibration
persists as JSONL: a hop's threshold change appends its histogram counts
with the combined digest of ALL tiers, a reset appends a record naming
its hop (or none, for a big swap), and a boot replays the tail per hop,
adopting a hop's counts only when the digest matches every live tier
and re-deriving its thresholds under the current knobs.

All chaining is ``Future.add_done_callback``: the router never blocks an
engine's worker thread.  ``CascadeRouter._lock`` is a LEAF lock.
"""

from __future__ import annotations

import json
import os
import threading
import time
from concurrent.futures import Future

from deep_vision_tpu_torch.core.metrics import LatencyHistogram
from deep_vision_tpu_torch.obs.log import event, get_logger
from deep_vision_tpu_torch.serve.admission import Shed
from deep_vision_tpu_torch.serve.faults import Quarantined
from deep_vision_tpu_torch.serve.models import AgreementHistogram
from deep_vision_tpu_torch.serve.workloads import ClassifyWorkload

_log = get_logger("dvt.serve.cascade")

FRONT = "front"
BIG = "big"
#: suffix marking a brownout-L2 answer served BELOW the hop's
#: calibrated threshold — serve/http.py strips it for X-DVT-Tier and
#: adds X-DVT-Degraded: 1
DEGRADED_SUFFIX = "-degraded"
# the tier-0 degraded token, kept as a module constant for import
# compatibility (serve/http.py, tests)
DEGRADED = FRONT + DEGRADED_SUFFIX

_DEFAULT_DEADLINE_MS = 30_000.0


def is_degraded(token: str) -> bool:
    """True for any hop's brownout-L2 degraded tier token."""
    return isinstance(token, str) and token.endswith(DEGRADED_SUFFIX)


def base_tier(token: str) -> str:
    """The answering tier token with any degraded suffix stripped."""
    if is_degraded(token):
        return token[: -len(DEGRADED_SUFFIX)]
    return token


class CascadeSpec:
    """Parsed ``--cascade t0:t1:...:big`` plus the calibration knobs —
    one immutable value the CLI hands to the router and the boot
    print.  Two positional names give the 2-tier front:big form."""

    def __init__(self, *tiers: str,
                 min_agreement: float = 0.98,
                 sample_period: int = 10,
                 min_sample: int = 200,
                 bins: int = 20,
                 topk: int = 5,
                 per_class: bool = False,
                 class_min_sample: int = 50):
        names = [str(t).strip() for t in tiers]
        if len(names) < 2 or any(not n for n in names) \
                or len(set(names)) != len(names):
            raise ValueError(
                f"cascade needs >= 2 distinct model names, got "
                f"{':'.join(names)!r}")
        self.tiers = tuple(names)
        self.front = names[0]
        self.big = names[-1]
        self.min_agreement = float(min_agreement)
        self.sample_period = max(1, int(sample_period))
        self.min_sample = max(1, int(min_sample))
        self.bins = max(1, int(bins))
        self.topk = max(1, int(topk))
        self.per_class = bool(per_class)
        self.class_min_sample = max(1, int(class_min_sample))

    @classmethod
    def parse(cls, spec: str, **kw) -> "CascadeSpec":
        names = [t.strip() for t in str(spec).split(":")]
        if len(names) < 2:
            raise ValueError(
                f"--cascade wants 't0:t1:...:big', got {spec!r}")
        return cls(*names, **kw)

    @property
    def chain(self) -> str:
        return ":".join(self.tiers)

    def tier_token(self, i: int) -> str:
        """The public tier token for chain position ``i``: "front" for
        tier 0, "t<i>" for mid tiers, "big" for the final tier — the
        X-DVT-Tier header values and the ``served`` stats keys (the
        2-tier chain's tokens are "front" and "big")."""
        if i == len(self.tiers) - 1:
            return BIG
        return FRONT if i == 0 else f"t{i}"

    def describe(self) -> dict:
        return {"front": self.front, "big": self.big,
                "tiers": list(self.tiers),
                "min_agreement": self.min_agreement,
                "sample_period": self.sample_period,
                "min_sample": self.min_sample,
                "bins": self.bins, "topk": self.topk,
                "per_class": self.per_class,
                "class_min_sample": self.class_min_sample}


class _Hop:
    """One hop's calibration state: tier i vs the big tier.  Mutable
    fields are guarded by the router's leaf lock (the histogram has its
    own internal lock)."""

    def __init__(self, index: int, tier: str, token: str,
                 bins: int, per_class: bool):
        self.index = index
        self.tier = tier
        self.token = token
        self.hist = AgreementHistogram(bins=bins, per_class=per_class)
        # None = uncalibrated → fail closed (escalate-through)
        self.threshold: float | None = None
        self.class_thresholds: dict = {}
        self.tick = 0
        self.escalations = 0
        self.samples = 0
        self.samples_discarded = 0
        self.restored = False


class CascadeRouter:
    """Route traffic addressed to ``spec.big`` down the tier chain,
    escalating past each hop whose confidence misses its calibrated
    threshold."""

    def __init__(self, plane, spec: CascadeSpec,
                 root: str | None = None):
        self.plane = plane
        self.spec = spec
        # a LEAF lock: no plane or engine call happens under it
        self._lock = threading.Lock()
        self.hops = [
            _Hop(i, name, spec.tier_token(i), spec.bins, spec.per_class)
            for i, name in enumerate(spec.tiers[:-1])
        ]  # hop mutable state guarded-by: _lock
        self._tokens = [h.token for h in self.hops] + [BIG]
        # optional BrownoutController (serve/brownout.py) — the L1
        # sampling pause and L2 degraded hooks; read racily
        self.brownout = None
        self.served = {t: 0 for t in self._tokens}  # guarded-by: _lock
        self.escalations = 0  # guarded-by: _lock
        self.escalated_shed = 0  # no deadline left mid-chain; guarded-by: _lock
        self.escalated_lowconf = 0  # guarded-by: _lock
        self.escalated_error = 0  # tier Shed/Quarantined/raise; guarded-by: _lock
        self.forced_big = 0  # always-big tenants; guarded-by: _lock
        self.samples = 0  # dual-run calibration requests; guarded-by: _lock
        self.samples_discarded = 0  # guarded-by: _lock
        self.samples_paused = 0  # brownout L1 skipped slots; guarded-by: _lock
        self.degraded_served = 0  # brownout L2 below-threshold answers; guarded-by: _lock
        self.calibrations = 0  # threshold (re)computed; guarded-by: _lock
        self.resets = 0  # version-swap calibration drops; guarded-by: _lock
        self._latency = {t: LatencyHistogram()
                         for t in self._tokens}  # guarded-by: _lock
        self._rule = self._resolve_rule()
        # calibration ledger (None = memory-only, the test default)
        self._root = root
        self.restored = False
        self.ledger_write_errors = 0  # guarded-by: _lock
        if root is not None:
            os.makedirs(root, exist_ok=True)
            self._restore()
        plane.add_version_listener(self._on_version_swap)

    def _resolve_rule(self):
        """The verb's CascadeWorkloadRule, from the BIG tier's workload
        (every tier shares the verb — cli.serve validates the chain).
        Falls back to the classify rule when the plane can't resolve
        the tier yet (bare test planes)."""
        try:
            rule = self.plane.resolve(self.spec.big) \
                .workload.cascade_rule()
            if rule is not None:
                return rule
        except (KeyError, AttributeError):
            pass
        return ClassifyWorkload().cascade_rule()

    # -- routing table ------------------------------------------------------

    def serves(self, name: str) -> bool:
        """True when requests addressed to ``name`` route through the
        cascade (only the big/logical name; cheap tiers stay directly
        addressable)."""
        return name == self.spec.big

    @property
    def hist(self) -> AgreementHistogram:
        """Hop 0's histogram — the 2-tier compatibility alias."""
        return self.hops[0].hist

    @property
    def threshold(self) -> float | None:
        """Hop 0's pooled threshold — the 2-tier compatibility alias."""
        with self._lock:
            return self.hops[0].threshold

    def params_digest(self) -> str | None:
        """Combined version identity of ALL tiers — the response-cache
        digest slot and the calibration-ledger key, so a reload of ANY
        tier stops old cache keys and persisted calibrations from
        matching.  None (uncacheable) unless every tier carries a
        digest, same contract as a single model without one."""
        digests = []
        for name in self.spec.tiers:
            try:
                d = getattr(self.plane.resolve(name),
                            "params_digest", None)
            except KeyError:
                return None
            if not d:
                return None
            digests.append(d)
        return "+".join(digests)

    def canary_active(self) -> bool:
        """Cache inserts pause while ANY tier runs a canary — a
        canary-served answer must not be filed under the steady-state
        combined digest."""
        return any(self.plane.canary_active(name)
                   for name in self.spec.tiers)

    def describe_member(self, name: str) -> dict | None:
        """The ``cascade`` block for ``name``'s /v1/models entry: chain
        membership, hop role, and where that hop's threshold came from
        — None for models outside the chain."""
        if name not in self.spec.tiers:
            return None
        i = self.spec.tiers.index(name)
        out = {"chain": self.spec.chain, "tier": self.spec.tier_token(i)}
        if name == self.spec.big:
            out.update(role="big", hop=None,
                       threshold_source="authoritative")
            return out
        out["role"] = "front" if i == 0 else "mid"
        out["hop"] = i
        hop = self.hops[i]
        with self._lock:
            calibrated = hop.threshold is not None \
                or bool(hop.class_thresholds)
            restored = hop.restored
        out["threshold_source"] = (
            "restored" if restored else
            "calibrated" if calibrated else "uncalibrated")
        return out

    # -- request path -------------------------------------------------------

    def submit(self, image, deadline_ms: float | None = None,
               span=None, force_big: bool = False) -> Future:
        """Route one request.  The future resolves to ``(tier, row)``
        where ``tier`` is the answering tier's token ("front"/"t1"/...
        /"big", the ``X-DVT-Tier`` header; a ``-degraded`` suffix marks
        brownout-L2 answers) and ``row`` is exactly what that tier's
        engine produced — including Shed/Quarantined verdicts, which
        the HTTP layer maps to status codes the same way as for a plain
        model."""
        fut: Future = Future()
        t0 = time.monotonic()
        if deadline_ms is None:
            deadline_ms = _DEFAULT_DEADLINE_MS
        deadline_ms = float(deadline_ms)
        if force_big:
            with self._lock:
                self.forced_big += 1
            if span is not None:
                span.mark("cascade_forced_big")
            self._submit_final(image, deadline_ms, span, fut, t0)
            return fut
        self._enter_hop(0, image, deadline_ms, deadline_ms, span, fut,
                        t0)
        return fut

    def infer(self, image, deadline_ms: float | None = None,
              timeout: float | None = 30.0, span=None,
              force_big: bool = False):
        """Blocking wrapper → ``(tier, row)``."""
        return self.submit(image, deadline_ms, span=span,
                           force_big=force_big).result(timeout)

    def _enter_hop(self, i: int, image, deadline_ms, budget_ms, span,
                   fut: Future, t0):
        """One request arrives at hop ``i`` with ``budget_ms`` of its
        original ``deadline_ms`` left: maybe dual-run a calibration
        sample, escalate-through when the hop is uncalibrated, else run
        the tier and decide on its answer."""
        if i >= len(self.hops):
            self._submit_final(image, budget_ms, span, fut, t0)
            return
        hop = self.hops[i]
        bo = self.brownout
        with self._lock:
            hop.tick += 1
            tick = hop.tick
            calibrated = hop.threshold is not None \
                or bool(hop.class_thresholds)
        if tick % self.spec.sample_period == 0:
            if bo is None or not bo.at_least(1):
                self._submit_sample(hop, image, budget_ms, span, fut,
                                    t0)
                return
            # brownout L1+: the dual-run sample is optional work —
            # skip the slot and route the request like any other
            with self._lock:
                self.samples_paused += 1
        if not calibrated:
            # fail closed: an uncalibrated hop escalates THROUGH — the
            # tier is not run, no compute wasted on an answer nobody
            # would trust
            self._enter_hop(i + 1, image, deadline_ms, budget_ms, span,
                            fut, t0)
            return
        # decided at submit time so one request sees one policy even
        # if the ladder moves while the tier runs
        degrade = bo is not None and bo.at_least(2)
        tfut = self.plane.submit(hop.tier, image, budget_ms, span=span)
        tfut.add_done_callback(
            lambda f: self._hop_done(hop, f, image, deadline_ms, span,
                                     fut, t0, degrade))

    def _submit_final(self, image, budget_ms, span, fut: Future, t0):
        bfut = self.plane.submit(self.spec.big, image, budget_ms,
                                 span=span)
        bfut.add_done_callback(lambda f: self._finish(f, fut, t0, BIG))

    def _threshold_for(self, hop: _Hop, cls) -> float | None:
        """The threshold governing this answer: the class's own entry
        when the per-class axis has a qualifying sample for it — which
        may be ``None`` (a measured-bad class fails closed and always
        escalates) — else the hop's pooled threshold (None → escalate,
        fail-closed)."""
        with self._lock:
            if cls is not None and hop.class_thresholds:
                key = int(cls)
                if key in hop.class_thresholds:
                    return hop.class_thresholds[key]
            return hop.threshold

    def _hop_done(self, hop: _Hop, tfut: Future, image, deadline_ms,
                  span, fut: Future, t0, degrade: bool = False):
        """Tier ``hop.index`` answered (engine worker thread — never
        block): serve it when confident, escalate otherwise."""
        try:
            row = tfut.result()
        except Exception:  # noqa: BLE001 — tier failure must not reach the client; big owns the contract
            self._escalate(hop, image, deadline_ms, span, fut, t0,
                           "error")
            return
        if isinstance(row, (Shed, Quarantined)):
            # tier shed/quarantined: the request still deserves the
            # rest of the chain — the client addressed the big name
            self._escalate(hop, image, deadline_ms, span, fut, t0,
                           "error")
            return
        cls, conf = self._rule.signal(row)
        if conf is None:
            # no signal on the row (a tier missing its epilogue, a
            # foreign shape): never guess — escalate
            self._escalate(hop, image, deadline_ms, span, fut, t0,
                           "error")
            return
        thr = self._threshold_for(hop, cls)
        if thr is not None and conf >= thr:
            if span is not None:
                span.mark(f"cascade_{hop.token}_served")
            self._finish_row(row, fut, t0, hop.token)
            return
        if degrade and thr is not None:
            # brownout L2: trade quality for the escalation's slot —
            # this tier's answer stands, marked degraded
            with self._lock:
                self.degraded_served += 1
            if span is not None:
                span.mark("cascade_degraded")
            self._finish_row(row, fut, t0, hop.token, degraded=True)
            return
        self._escalate(hop, image, deadline_ms, span, fut, t0,
                       "lowconf")

    def _escalate(self, hop: _Hop, image, deadline_ms, span,
                  fut: Future, t0, why: str):
        """Re-enter the next hop with the REMAINING deadline — original
        budget minus everything earlier tiers burned — so a
        twice-escalated request never exceeds its original SLO
        budget."""
        with self._lock:
            self.escalations += 1
            hop.escalations += 1
            if why == "lowconf":
                self.escalated_lowconf += 1
            else:
                self.escalated_error += 1
        remaining_ms = deadline_ms - (time.monotonic() - t0) * 1e3
        if remaining_ms <= 0.0:
            with self._lock:
                self.escalated_shed += 1
            self._finish_row(
                Shed("deadline",
                     f"cascade escalation at hop {hop.index}: earlier "
                     f"tiers consumed the {deadline_ms:.0f}ms budget"),
                fut, t0, BIG)
            return
        if span is not None:
            span.mark("cascade_escalate")
        self._enter_hop(hop.index + 1, image, deadline_ms,
                        remaining_ms, span, fut, t0)

    def _finish(self, inner: Future, fut: Future, t0, tier: str):
        try:
            row = inner.result()
        except Exception as e:  # noqa: BLE001 — propagate the tier's failure as-is
            fut.set_exception(e)
            return
        self._finish_row(row, fut, t0, tier)

    def _finish_row(self, row, fut: Future, t0, tier: str,
                    degraded: bool = False):
        with self._lock:
            self.served[tier] += 1
            self._latency[tier].record(time.monotonic() - t0)
        fut.set_result(
            (tier + DEGRADED_SUFFIX if degraded else tier, row))

    # -- calibration --------------------------------------------------------

    def _submit_sample(self, hop: _Hop, image, budget_ms, span,
                       fut: Future, t0):
        """Dual-run calibration sample at hop ``hop.index``: the tier
        AND the big tier execute, the client gets the big answer
        (authoritative), and tier-vs-big agreement lands in the hop's
        histogram at the tier's confidence bucket.  Same holder-pair
        idiom as the plane's shadow compare."""
        with self._lock:
            self.samples += 1
            hop.samples += 1
        tfut = self.plane.submit(hop.tier, image, budget_ms)
        bfut = self.plane.submit(self.spec.big, image, budget_ms,
                                 span=span)
        holder: dict = {}

        def arrived(which, f):
            with self._lock:
                holder[which] = f
                ready = "f" in holder and "b" in holder \
                    and not holder.get("_done")
                if ready:
                    holder["_done"] = True
            if ready:
                self._record_sample(hop, holder["f"], holder["b"])

        tfut.add_done_callback(lambda f: arrived("f", f))
        bfut.add_done_callback(lambda f: arrived("b", f))
        bfut.add_done_callback(lambda f: self._finish(f, fut, t0, BIG))

    def _record_sample(self, hop: _Hop, tfut: Future, bfut: Future):
        try:
            tr, br = tfut.result(), bfut.result()
        except Exception:  # noqa: BLE001 — either side failed: nothing to compare
            with self._lock:
                self.samples_discarded += 1
                hop.samples_discarded += 1
            return
        cls, conf = self._rule.signal(tr)
        agreed = self._rule.agree(tr, br)
        if conf is None or agreed is None:
            with self._lock:
                self.samples_discarded += 1
                hop.samples_discarded += 1
            return
        hop.hist.record(conf, agreed, cls=cls)
        self._recalibrate(hop)

    def _recalibrate(self, hop: _Hop | None = None):
        """Recompute one hop's thresholds from its histogram (default
        hop 0, the 2-tier compatibility surface) and persist on
        change."""
        if hop is None:
            hop = self.hops[0]
        thr = hop.hist.threshold(self.spec.min_agreement,
                                 self.spec.min_sample)
        cls_thr = {}
        if self.spec.per_class:
            cls_thr = hop.hist.class_thresholds(
                self.spec.min_agreement, self.spec.class_min_sample)
        with self._lock:
            changed = thr != hop.threshold \
                or cls_thr != hop.class_thresholds
            hop.threshold = thr
            hop.class_thresholds = cls_thr
            if changed:
                self.calibrations += 1
        if changed:
            event(_log, "cascade_calibrated",
                  chain=self.spec.chain, hop=hop.index, tier=hop.tier,
                  threshold=thr, classes=len(cls_thr),
                  samples=hop.hist.stats()["samples"])
            h = hop.hist.stats()
            rec = {"event": "calibrated",
                   "hop": hop.index,
                   "tier": hop.tier,
                   "threshold": thr,
                   "digest": self.params_digest(),
                   "bins": h["bins"],
                   "total": h["total"],
                   "agree": h["agree"]}
            if self.spec.per_class:
                rec["class_counts"] = hop.hist.class_counts()
            self._append_ledger(rec)

    def _reset_hop(self, hop: _Hop):
        hop.hist.reset()
        with self._lock:
            had = hop.threshold is not None \
                or bool(hop.class_thresholds)
            hop.threshold = None
            hop.class_thresholds = {}
            hop.restored = False
            self.resets += 1
        return had

    def _on_version_swap(self, name: str):
        """Plane version listener: a reload/promote/revert of tier i
        invalidates ONLY hop i's calibration (its answer distribution
        changed; other hops compare different tiers against big) —
        while a swap of the BIG tier invalidates every hop (big is
        every hop's comparison target).  Fail closed and resample."""
        if name not in self.spec.tiers:
            return
        if name == self.spec.big:
            had = False
            for hop in self.hops:
                had = self._reset_hop(hop) or had
            self._append_ledger({"event": "reset", "model": name})
        else:
            hop = self.hops[self.spec.tiers.index(name)]
            had = self._reset_hop(hop)
            self._append_ledger({"event": "reset", "model": name,
                                 "hop": hop.index})
        if had:
            event(_log, "cascade_recalibrating", model=name,
                  chain=self.spec.chain)

    # -- calibration persistence --------------------------------------------

    def _ledger_path(self) -> str:
        safe = "".join(c if c.isalnum() or c in "-_." else "_"
                       for c in "+".join(self.spec.tiers))
        return os.path.join(self._root, f"{safe}.jsonl")

    def _append_ledger(self, record: dict):
        """Append one immutable calibration record (deploy-ledger
        idiom: write failures are counted, never raised — the ledger
        observes, it never gates serving)."""
        if self._root is None:
            return
        record = {"ts": round(time.time(), 3),
                  "front": self.spec.front, "big": self.spec.big,
                  "tiers": list(self.spec.tiers),
                  **record}
        try:
            with open(self._ledger_path(), "a", encoding="utf-8") as f:
                f.write(json.dumps(record) + "\n")
        except OSError as e:
            with self._lock:
                self.ledger_write_errors += 1
            event(_log, "cascade_ledger_write_failed",
                  error=f"{type(e).__name__}: {e}")

    def _restore(self):
        """Boot-time replay: adopt each hop's newest calibration iff
        its params digest matches EVERY live tier — the ledger key
        covers the whole chain, so ANY tier reloaded while down rejects
        the record.  A trailing reset for the hop, a digest mismatch, a
        torn tail line, or no ledger at all each leave that hop exactly
        where it started — uncalibrated and fail-closed."""
        last: dict = {}  # hop index -> last record affecting it
        try:
            with open(self._ledger_path(), encoding="utf-8") as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        rec = json.loads(line)
                    except ValueError:
                        continue  # torn tail line from a crash
                    ev = rec.get("event")
                    if ev == "calibrated":
                        hop = int(rec.get("hop", 0))
                        if 0 <= hop < len(self.hops):
                            last[hop] = rec
                    elif ev == "reset":
                        hop = rec.get("hop")
                        if hop is None:
                            # a big-tier swap (or a 2-tier record
                            # without hop info): every hop resets —
                            # unless it named the front tier, which
                            # only ever had hop 0
                            if rec.get("model") == self.spec.front:
                                last[0] = rec
                            else:
                                last = {i: rec
                                        for i in range(len(self.hops))}
                        elif 0 <= int(hop) < len(self.hops):
                            last[int(hop)] = rec
        except OSError:
            return  # no ledger yet — first boot
        digest = self.params_digest()
        restored_any = False
        for i, rec in sorted(last.items()):
            if rec.get("event") != "calibrated":
                continue
            hop = self.hops[i]
            if digest is None or rec.get("digest") != digest:
                event(_log, "cascade_restore_stale",
                      chain=self.spec.chain, hop=i,
                      ledger_digest=rec.get("digest"),
                      live_digest=digest)
                continue
            try:
                hop.hist.restore(rec["total"], rec["agree"],
                                 per_class=rec.get("class_counts"))
            except (KeyError, TypeError, ValueError) as e:
                event(_log, "cascade_restore_invalid", hop=i,
                      error=f"{type(e).__name__}: {e}")
                continue
            # RE-derive thresholds from the restored counts instead of
            # trusting the stored ones: retuned --cascade-min-agreement
            # / min-sample knobs apply to the old sample immediately,
            # and a sample now too thin for the knobs stays fail-closed
            thr = hop.hist.threshold(self.spec.min_agreement,
                                     self.spec.min_sample)
            cls_thr = {}
            if self.spec.per_class:
                cls_thr = hop.hist.class_thresholds(
                    self.spec.min_agreement,
                    self.spec.class_min_sample)
            calibrated = thr is not None or bool(cls_thr)
            with self._lock:
                hop.threshold = thr
                hop.class_thresholds = cls_thr
                hop.restored = calibrated
            restored_any = restored_any or calibrated
            event(_log, "cascade_restored",
                  chain=self.spec.chain, hop=i, tier=hop.tier,
                  threshold=thr, classes=len(cls_thr),
                  samples=hop.hist.stats()["samples"],
                  calibrated=calibrated)
        with self._lock:
            self.restored = restored_any

    # -- observability ------------------------------------------------------

    def _hop_stats(self, hop: _Hop) -> dict:
        """One hop's block for ``stats()["hops"]`` — caller holds no
        locks; this takes the router lock briefly."""
        hstats = hop.hist.stats()
        with self._lock:
            out = {
                "hop": hop.index,
                "tier": hop.tier,
                "token": hop.token,
                "threshold": hop.threshold,
                "calibrated": hop.threshold is not None
                or bool(hop.class_thresholds),
                "class_thresholds": {str(c): v for c, v in
                                     sorted(hop.class_thresholds
                                            .items())},
                "restored": hop.restored,
                "escalations": hop.escalations,
                "samples": hop.samples,
                "samples_discarded": hop.samples_discarded,
            }
        out["agreement"] = hstats["agreement"]
        out["sample_size"] = hstats["samples"]
        return out

    def stats(self) -> dict:
        """The reserved ``cascade`` block in /v1/stats — serve/http.py
        renders the ``dvt_cascade_*`` series from it, and the gateway
        folds it into its fleet view.  Top-level threshold/agreement
        keys mirror hop 0 (the 2-tier surface); ``hops`` carries
        the full per-hop picture."""
        hop0 = self.hops[0]
        h0stats = hop0.hist.stats()
        hop_blocks = [self._hop_stats(h) for h in self.hops]
        with self._lock:
            served = dict(self.served)
            routed = sum(served[t] for t in served if t != BIG) \
                + self.escalated_lowconf + self.escalated_shed
            out = {
                "front": self.spec.front,
                "big": self.spec.big,
                "tiers": list(self.spec.tiers),
                "per_class": self.spec.per_class,
                "threshold": hop0.threshold,
                "calibrated": hop0.threshold is not None
                or bool(hop0.class_thresholds),
                "min_agreement": self.spec.min_agreement,
                "sample_period": self.spec.sample_period,
                "min_sample": self.spec.min_sample,
                "served": served,
                "escalations": self.escalations,
                "escalated_lowconf": self.escalated_lowconf,
                "escalated_error": self.escalated_error,
                "escalated_shed": self.escalated_shed,
                # of the requests cheap tiers actually judged, how
                # many went upstairs — the live economics gauge
                "escalation_rate": ((self.escalated_lowconf
                                     + self.escalated_shed) / routed)
                if routed else None,
                "forced_big": self.forced_big,
                "samples": self.samples,
                "samples_discarded": self.samples_discarded,
                "samples_paused": self.samples_paused,
                "degraded_served": self.degraded_served,
                "calibrations": self.calibrations,
                "resets": self.resets,
                "restored": self.restored,
                "ledger_root": self._root,
                "ledger_write_errors": self.ledger_write_errors,
                "agreement": h0stats["agreement"],
                "agreement_bins": {"bins": h0stats["bins"],
                                   "samples": h0stats["samples"],
                                   "total": h0stats["total"],
                                   "agree": h0stats["agree"]},
                "latency": {t: h.percentiles()
                            for t, h in self._latency.items()},
                "latency_hist": {t: h.state_dict()
                                 for t, h in self._latency.items()},
            }
        out["hops"] = hop_blocks
        return out
