"""The cascade's contract in the port (serve/cascade.py, the classify
epilogue and the cascade rules of serve/workloads.py) against the JAX
package on the CPU.

The classify confidence epilogue of both packages on the same logits:
seeded rows, rows with exact ties, a row of equal logits and K at or
above the class count, with equal classes (the lower class first among
equal probabilities, as ``jax.lax.top_k``), probabilities within 1e-6
and logits exact.  Both packages' cascade rules on the same rows.  Both
``CascadeRouter``s over equivalent scripted planes (futures resolved
inline) with one request sequence: samples, escalations, tier errors,
always-big requests, version swaps and brownout levels, with equal tier
tokens, thresholds, ``stats()`` (latencies aside) and ledger records
(timestamps aside); each package restoring the other's ledger.  Then the
reference's tests/test_cascade.py cases, recast for the port, and a real
plane of LeNet-5 tiers on the CPU.
"""

import json
import time
import types
from concurrent.futures import Future

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deep_vision_tpu.serve import cascade as jcas
from deep_vision_tpu.serve import workloads as jwl
from deep_vision_tpu.serve.admission import Shed as JShed
from deep_vision_tpu.serve.faults import Quarantined as JQuarantined
from deep_vision_tpu_torch.serve import cascade as pcas
from deep_vision_tpu_torch.serve import workloads as pwl
from deep_vision_tpu_torch.serve.admission import Shed, TenantQoS
from deep_vision_tpu_torch.serve.cascade import (
    CascadeRouter,
    CascadeSpec,
    base_tier,
    is_degraded,
)
from deep_vision_tpu_torch.serve.faults import Quarantined
from deep_vision_tpu_torch.serve.models import AgreementHistogram
from deep_vision_tpu_torch.serve.workloads import ClassifyWorkload

pytestmark = [pytest.mark.models, pytest.mark.serve]

#: epilogue probabilities: both packages' float32 softmax
PROB_BOUND = 1e-6


# -- the classify epilogue ---------------------------------------------------


def _epilogue_cases():
    rng = np.random.RandomState(0)
    seeded = rng.randn(6, 1000).astype(np.float32) * 3.0
    tied = rng.randn(4, 10).astype(np.float32)
    tied[0, [2, 5, 7]] = tied[0].max() + 1.0   # a three-way tie for top-1
    tied[1, 3] = tied[1, 8]                     # a tie lower down
    tied[2, :] = np.round(tied[2] * 2) / 2      # many ties
    tied[3, 1::2] = tied[3, 0::2]               # pairs
    equal = np.full((2, 10), 0.25, np.float32)  # every logit equal
    small = rng.randn(3, 4).astype(np.float32)
    return [("seeded", seeded, 5), ("ties", tied, 5), ("equal", equal, 5),
            ("k_eq_classes", small, 4), ("k_over_classes", small, 9),
            ("k1", seeded, 1)]


@pytest.mark.parametrize("name,logits,k",
                         _epilogue_cases(),
                         ids=[c[0] for c in _epilogue_cases()])
def test_epilogue_matches_reference(name, logits, k):
    model = types.SimpleNamespace(cascade_topk=k)
    jpost = jwl.ClassifyWorkload().make_epilogue(model)
    ppost = pwl.ClassifyWorkload().make_epilogue(model)
    want = {key: np.asarray(v) for key, v in jpost(jnp.asarray(logits)).items()}
    got = {key: v.numpy() for key, v in ppost(torch.from_numpy(logits)).items()}
    assert set(got) == set(want) == {"topk_class", "topk_prob", "topk_logit"}
    kk = min(k, logits.shape[-1])
    assert got["topk_class"].dtype == np.int32
    assert got["topk_prob"].dtype == got["topk_logit"].dtype == np.float32
    assert got["topk_class"].shape == (len(logits), kk)
    np.testing.assert_array_equal(got["topk_class"], want["topk_class"])
    np.testing.assert_allclose(got["topk_prob"], want["topk_prob"],
                               rtol=0, atol=PROB_BOUND)
    np.testing.assert_array_equal(got["topk_logit"], want["topk_logit"])


def test_epilogue_ties_put_the_lower_class_first():
    logits = np.zeros((1, 6), np.float32)
    logits[0, [4, 1, 3]] = 2.0
    post = pwl.ClassifyWorkload().make_epilogue(
        types.SimpleNamespace(cascade_topk=4))
    assert post(torch.from_numpy(logits))["topk_class"].tolist() == \
        [[1, 3, 4, 0]]


def test_epilogue_is_gated_on_cascade_topk():
    for k in (0, None):
        assert pwl.ClassifyWorkload().make_epilogue(
            types.SimpleNamespace(cascade_topk=k)) is None
    assert pwl.ClassifyWorkload().make_epilogue(object()) is None


# -- the cascade rules -------------------------------------------------------


def _front(cls=3, prob=0.9):
    """A confidence-epilogue row as the front engine scatters it."""
    return {"topk_class": np.array([cls, 1, 2], np.int32),
            "topk_prob": np.array([prob, 0.05, 0.02], np.float32),
            "topk_logit": np.array([5.0, 1.0, 0.5], np.float32)}


def _big(cls=3, n=10, seed=0):
    """Dense logits with argmax ``cls``: what the big tier serves."""
    logits = np.random.RandomState(seed).randn(n).astype(np.float32)
    logits[cls] = logits.max() + 3.0
    return logits


def _det(scores, classes, boxes=None):
    k = len(scores)
    b = boxes if boxes is not None else \
        np.tile(np.array([0.1, 0.1, 0.3, 0.3], np.float32), (k, 1))
    return {"boxes": np.asarray(b, np.float32),
            "scores": np.asarray(scores, np.float32),
            "classes": np.asarray(classes, np.int32),
            "valid": (np.asarray(scores) > 0).astype(np.float32)}


def _classify_rows(shed, quarantined):
    rng = np.random.RandomState(1)
    rows = [_front(), _front(cls=7, prob=0.31), _big(), _big(cls=5),
            rng.randn(1000).astype(np.float32),
            {"topk_class": np.zeros(0, np.int32),
             "topk_prob": np.zeros(0, np.float32)},
            {"topk_prob": np.ones(3, np.float32)}, np.zeros(0, np.float32),
            shed, quarantined, "foreign"]
    tied = _big()
    tied[4] = tied[3]
    return rows + [tied]


def _detect_rows():
    return [_det([0.9, 0.4, 0.0], [2, 5, 0]), _det([0.0, 0.0], [0, 0]),
            _det([1.7, 0.2], [4, 1]), _det([0.5, 0.5], [6, 3]),
            _det([0.9], [2], boxes=[[0.7, 0.7, 0.9, 0.9]]),
            _det([0.8, 0.3], [2, 2]), np.zeros((13, 13, 18), np.float32),
            {"scores": np.ones(2), "classes": np.ones(3), "valid": np.ones(2)},
            {"boxes": np.zeros((1, 4))}]


@pytest.mark.parametrize("verb", ["classify", "detect"])
def test_cascade_rules_match_reference(verb):
    jrule = jwl.WORKLOADS[verb].cascade_rule()
    prule = pwl.WORKLOADS[verb].cascade_rule()
    if verb == "classify":
        jrows = _classify_rows(JShed("queue_full"), JQuarantined("poison"))
        prows = _classify_rows(Shed("queue_full"), Quarantined("poison"))
    else:
        jrows = prows = _detect_rows()
    for i, (jr, pr) in enumerate(zip(jrows, prows)):
        assert prule.signal(pr) == jrule.signal(jr), i
        for j, (jb, pb) in enumerate(zip(jrows, prows)):
            assert prule.agree(pr, pb) == jrule.agree(jr, jb), (i, j)


def test_pose_and_generate_have_no_rule():
    assert pwl.WORKLOADS["pose"].cascade_rule() is None
    assert pwl.WORKLOADS["generate"].cascade_rule() is None


def test_top1_and_respond_read_both_row_shapes():
    w, jw = pwl.ClassifyWorkload(), jwl.ClassifyWorkload()
    model = types.SimpleNamespace(name="m")
    for row in (_front(), _big(), _front(cls=9, prob=0.5)):
        assert w.top1(row) == jw.top1(row)
        for body in ({}, {"top_k": 2}, {"top_k": 10}):
            assert w.respond(model, body, row) == jw.respond(model, body, row)


# -- both routers over one script --------------------------------------------


class FakePlane:
    """Synchronous stand-in for ModelControlPlane.submit: resolves each
    future inline from a per-model row (value, callable of the image, or
    exception) and records every ``(name, deadline_ms)``.  ``digests``
    makes ``resolve`` answer models with a params digest."""

    def __init__(self, rows, delay_s=0.0, digests=None):
        self.rows = rows
        self.delay_s = delay_s
        self.digests = digests
        self.calls = []
        self.listeners = []

    def add_version_listener(self, fn):
        self.listeners.append(fn)

    def submit(self, name, image, deadline_ms=None, span=None):
        self.calls.append((name, deadline_ms))
        if self.delay_s:
            time.sleep(self.delay_s)
        fut = Future()
        row = self.rows[name]
        if callable(row):
            row = row(image)
        if isinstance(row, Exception):
            fut.set_exception(row)
        else:
            fut.set_result(row)
        return fut

    def resolve(self, name):
        if self.digests is None:
            raise KeyError(name)
        return types.SimpleNamespace(params_digest=self.digests[name])

    def canary_active(self, name):
        return False


TIERS = ("small", "mid", "large")


def _script(n=160, seed=3):
    """Per request: each tier's outcome (``("row", cls, prob)``, ``shed``
    or ``raise``), the big tier's class, whether the request is
    always-big, and the operator events before it."""
    rng = np.random.RandomState(seed)
    steps = []
    for i in range(n):
        big_cls = int(rng.randint(4))
        tiers = {}
        for t, agree_p in (("small", 0.9), ("mid", 0.97)):
            u = rng.uniform()
            if u < 0.04:
                tiers[t] = ("shed",)
            elif u < 0.07:
                tiers[t] = ("raise",)
            else:
                prob = float(np.float32(rng.uniform(0.3, 1.0)))
                cls = big_cls if rng.uniform() < agree_p * prob + 0.1 \
                    else (big_cls + 1) % 4
                tiers[t] = ("row", cls, prob)
        events = []
        if i == 70:
            events.append(("swap", "mid"))
        if i == 110:
            events.append(("swap", "large"))
        level = 1 if 50 <= i < 60 else 2 if 60 <= i < 68 else 0
        steps.append({"tiers": tiers, "big": big_cls,
                      "force_big": bool(rng.uniform() < 0.05),
                      "level": level, "events": events})
    return steps


class _Ladder:
    """The two reads the router takes of a brownout controller."""

    level = 0

    def at_least(self, n):
        return self.level >= n


def _run_script(cas_mod, shed_cls, root, steps):
    spec = cas_mod.CascadeSpec(*TIERS, sample_period=3, min_sample=6,
                               min_agreement=0.8, bins=10, per_class=True,
                               class_min_sample=4)
    cur = {}

    def tier_row(t):
        def row(_image):
            out = cur["step"]["tiers"][t]
            if out[0] == "shed":
                return shed_cls("queue_full", "scripted")
            if out[0] == "raise":
                return RuntimeError("scripted tier failure")
            return _front(cls=out[1], prob=out[2])
        return row

    rows = {"small": tier_row("small"), "mid": tier_row("mid"),
            "large": lambda _image: _big(cls=cur["step"]["big"])}
    plane = FakePlane(rows, digests={"small": "d0", "mid": "d1",
                                     "large": "d2"})
    router = cas_mod.CascadeRouter(plane, spec, root=root)
    ladder = _Ladder()
    router.brownout = ladder
    tokens, thresholds = [], []
    for step in steps:
        cur["step"] = step
        for ev, name in step["events"]:
            plane.listeners[0](name)
        ladder.level = step["level"]
        tier, _ = router.infer(np.zeros((4, 4, 1), np.float32),
                               force_big=step["force_big"])
        tokens.append(tier)
        thresholds.append([(h.threshold, dict(h.class_thresholds))
                           for h in router.hops])
    return router, tokens, thresholds


def _comparable(stats):
    return {k: v for k, v in stats.items()
            if k not in ("latency", "latency_hist", "ledger_root")}


def _ledger(router):
    with open(router._ledger_path(), encoding="utf-8") as f:
        return [{k: v for k, v in json.loads(line).items() if k != "ts"}
                for line in f]


def test_router_matches_reference_over_one_script(tmp_path):
    steps = _script()
    jr, jtok, jthr = _run_script(jcas, JShed, str(tmp_path / "jax"), steps)
    pr, ptok, pthr = _run_script(pcas, Shed, str(tmp_path / "port"), steps)
    assert ptok == jtok
    assert pthr == jthr
    got, want = _comparable(pr.stats()), _comparable(jr.stats())
    assert got == want
    # the script reached every path it is there for
    assert set(ptok) >= {"front", "t1", "big", "front-degraded"}
    assert got["escalated_error"] > 0 and got["escalated_lowconf"] > 0
    assert got["samples_paused"] > 0 and got["degraded_served"] > 0
    assert got["forced_big"] > 0 and got["resets"] == 3
    assert got["calibrations"] > 2
    assert _ledger(pr) == _ledger(jr)
    assert any(r["event"] == "reset" for r in _ledger(pr))


def _write_ledger(cas_mod, root, digests):
    spec = cas_mod.CascadeSpec(*TIERS, sample_period=1000, min_sample=10,
                               per_class=True, class_min_sample=5)
    router = cas_mod.CascadeRouter(FakePlane({}, digests=digests), spec,
                                   root=root)
    rng = np.random.RandomState(5)
    for hop, lo in zip(router.hops, (0.55, 0.8)):
        for _ in range(40):
            conf = float(rng.uniform(lo, 1.0))
            hop.hist.record(conf, bool(rng.uniform() < 0.97),
                            cls=int(rng.randint(3)))
            router._recalibrate(hop)
    return spec


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_ledger_restores_across_packages(tmp_path, writer):
    mods = {"jax": jcas, "port": pcas}
    reader = "port" if writer == "jax" else "jax"
    digests = {"small": "d0", "mid": "d1", "large": "d2"}
    root = str(tmp_path / "_cascade")
    spec = _write_ledger(mods[writer], root, digests)
    ref = mods[writer].CascadeRouter(FakePlane({}, digests=digests), spec,
                                     root=root)
    knobs = {k: v for k, v in spec.describe().items()
             if k not in ("front", "big", "tiers")}
    got = mods[reader].CascadeRouter(FakePlane({}, digests=digests),
                                     mods[reader].CascadeSpec(*TIERS, **knobs),
                                     root=root)
    assert ref.restored and got.restored
    assert any(h.threshold is not None for h in got.hops)
    for a, b in zip(got.hops, ref.hops):
        assert a.threshold == b.threshold
        assert a.class_thresholds == b.class_thresholds
        assert a.hist.stats() == b.hist.stats()
    # a tier's digest changed while down: the reader rejects the ledger
    stale = mods[reader].CascadeRouter(
        FakePlane({}, digests=dict(digests, mid="d1-new")),
        mods[reader].CascadeSpec(*TIERS, sample_period=1000, min_sample=10),
        root=root)
    assert not stale.restored
    assert all(h.threshold is None for h in stale.hops)


# -- the reference's cases, recast ---------------------------------------------


def _router(rows, *, delay_s=0.0, threshold=None, **spec_kw):
    spec_kw.setdefault("sample_period", 1000)  # no sampling by default
    spec = CascadeSpec("small", "large", **spec_kw)
    plane = FakePlane(dict(rows), delay_s=delay_s)
    router = CascadeRouter(plane, spec)
    if threshold is not None:
        for _ in range(max(spec.min_sample, 1)):
            router.hist.record(threshold, True)
        router._recalibrate()
        assert router.threshold is not None
    return router, plane


def test_histogram_threshold_deterministic_seeded_sample():
    hist = AgreementHistogram(bins=10)
    rng = np.random.RandomState(42)
    for conf in rng.uniform(0.0, 1.0, size=2000):
        agreed = bool(conf >= 0.7 or rng.uniform() < 0.5)
        hist.record(float(conf), agreed)
    thr = hist.threshold(min_agreement=0.95, min_sample=100)
    assert thr == pytest.approx(0.7)
    lax = hist.threshold(min_agreement=0.60, min_sample=100)
    assert lax is not None and lax <= thr
    assert hist.threshold(min_agreement=1.01, min_sample=100) is None


def test_histogram_fails_closed_on_thin_sample():
    hist = AgreementHistogram(bins=10)
    for _ in range(50):
        hist.record(0.95, True)
    for _ in range(49):
        hist.record(0.55, False)
    assert hist.threshold(min_agreement=0.9, min_sample=100) is None
    hist.record(0.55, False)
    assert hist.threshold(min_agreement=0.9, min_sample=100) == \
        pytest.approx(0.9)
    hist.reset()
    assert hist.threshold(min_agreement=0.9, min_sample=1) is None
    assert hist.stats()["samples"] == 0


def test_uncalibrated_routes_everything_big():
    router, plane = _router({"small": _front(), "large": _big()})
    for _ in range(20):
        tier, row = router.infer(np.zeros((4, 4, 1), np.float32))
        assert tier == "big"
        np.testing.assert_array_equal(row, plane.rows["large"])
    assert all(name == "large" for name, _ in plane.calls)
    st = router.stats()
    assert st["calibrated"] is False and st["threshold"] is None
    assert st["served"] == {"front": 0, "big": 20}
    assert st["escalation_rate"] is None


def test_confident_front_serves_lowconf_escalates_bit_identical():
    router, plane = _router({"small": _front(prob=0.9), "large": _big()},
                            threshold=0.5)
    x = np.zeros((4, 4, 1), np.float32)
    tier, row = router.infer(x)
    assert tier == "front" and isinstance(row, dict)
    assert ClassifyWorkload.top1(row) == (3, pytest.approx(0.9))
    plane.rows["small"] = _front(prob=0.2)
    tier, row = router.infer(x)
    assert tier == "big"
    assert row.tobytes() == plane.rows["large"].tobytes()
    st = router.stats()
    assert st["served"] == {"front": 1, "big": 1}
    assert st["escalations"] == 1 and st["escalated_lowconf"] == 1
    assert st["escalation_rate"] == pytest.approx(0.5)


@pytest.mark.parametrize("failure", [
    Shed("queue_full", "front full"), Quarantined("poison"),
    RuntimeError("front died"), {"no": "signal"}])
def test_front_failure_escalates(failure):
    router, _ = _router({"small": failure, "large": _big()}, threshold=0.5)
    tier, row = router.infer(np.zeros((4, 4, 1), np.float32))
    assert tier == "big" and isinstance(row, np.ndarray)
    assert router.stats()["escalated_error"] == 1


def test_escalation_preserves_original_deadline():
    router, plane = _router({"small": _front(prob=0.2), "large": _big()},
                            threshold=0.5, delay_s=0.02)
    tier, _ = router.infer(np.zeros((4, 4, 1), np.float32),
                           deadline_ms=500.0)
    assert tier == "big"
    (fname, fdl), (bname, bdl) = plane.calls
    assert (fname, fdl) == ("small", 500.0)
    assert bname == "large" and 0.0 < bdl <= 500.0 - 20.0
    plane.calls.clear()
    tier, row = router.infer(np.zeros((4, 4, 1), np.float32),
                             deadline_ms=5.0)
    assert tier == "big" and isinstance(row, Shed)
    assert row.reason == "deadline"
    assert [name for name, _ in plane.calls] == ["small"]
    assert router.stats()["escalated_shed"] == 1


def test_sampling_calibrates_then_version_swap_resets():
    router, plane = _router(
        {"small": _front(cls=3, prob=0.97), "large": _big(cls=3)},
        sample_period=1, min_sample=10, min_agreement=0.9)
    x = np.zeros((4, 4, 1), np.float32)
    for _ in range(10):
        tier, _ = router.infer(x)
        assert tier == "big"
    st = router.stats()
    assert st["samples"] == 10 and st["calibrated"] is True
    assert st["threshold"] == pytest.approx(0.95)
    assert st["agreement"] == pytest.approx(1.0)
    assert len(plane.listeners) == 1
    plane.listeners[0]("unrelated-model")
    assert router.threshold is not None
    plane.listeners[0]("small")
    st = router.stats()
    assert st["calibrated"] is False and st["resets"] == 1
    assert st["agreement_bins"]["samples"] == 0


def test_disagreeing_sample_never_calibrates():
    router, _ = _router({"small": _front(cls=1, prob=0.99),
                         "large": _big(cls=3)},
                        sample_period=1, min_sample=5, min_agreement=0.9)
    for _ in range(20):
        tier, _ = router.infer(np.zeros((4, 4, 1), np.float32))
        assert tier == "big"
    st = router.stats()
    assert st["calibrated"] is False and st["samples"] == 20


def test_force_big_bypasses_front():
    router, plane = _router({"small": _front(prob=0.99), "large": _big()},
                            threshold=0.1)
    tier, _ = router.infer(np.zeros((4, 4, 1), np.float32), force_big=True)
    assert tier == "big"
    assert [name for name, _ in plane.calls] == ["large"]
    assert router.stats()["forced_big"] == 1


def test_qos_always_big_spec_parses():
    qos = TenantQoS.parse("premium:rate=0,always_big=1,tenants=acme;"
                          "standard:rate=100;default=standard")
    assert qos.class_of("acme").always_big is True
    assert qos.class_of("someone").always_big is False
    st = qos.stats()
    assert st["premium"]["always_big"] is True
    assert st["standard"]["always_big"] is False


def test_serves_only_big_name_and_tokens():
    router, _ = _router({"small": _front(), "large": _big()})
    assert router.serves("large") and not router.serves("small")
    with pytest.raises(ValueError):
        CascadeSpec("same", "same")
    with pytest.raises(ValueError):
        CascadeSpec.parse("no-colon-here")
    assert is_degraded("t1-degraded") and not is_degraded("t1")
    assert base_tier("front-degraded") == "front" and base_tier("big") == "big"


def test_respond_identical_for_escalated_and_big_only():
    big = _big()
    router, _ = _router({"small": _front(prob=0.1), "large": big},
                        threshold=0.5)
    _, escalated = router.infer(np.zeros((4, 4, 1), np.float32))
    model = types.SimpleNamespace(name="large")
    w = ClassifyWorkload()
    assert json.dumps(w.respond(model, {}, escalated), sort_keys=True) == \
        json.dumps(w.respond(model, {}, big), sort_keys=True)


def _router3(rows, *, delay_s=0.0, thresholds=(None, None), **spec_kw):
    spec_kw.setdefault("sample_period", 1000)
    spec = CascadeSpec("small", "mid", "large", **spec_kw)
    plane = FakePlane(dict(rows), delay_s=delay_s)
    router = CascadeRouter(plane, spec)
    for hop, thr in zip(router.hops, thresholds):
        if thr is not None:
            for _ in range(max(spec.min_sample, 1)):
                hop.hist.record(thr, True)
            router._recalibrate(hop)
            assert hop.threshold is not None
    return router, plane


def test_three_tier_tokens_and_mid_serving():
    router, plane = _router3(
        {"small": _front(prob=0.2), "mid": _front(prob=0.9),
         "large": _big()}, thresholds=(0.5, 0.5))
    tier, row = router.infer(np.zeros((4, 4, 1), np.float32))
    assert tier == "t1" and isinstance(row, dict)
    assert [name for name, _ in plane.calls] == ["small", "mid"]
    st = router.stats()
    assert st["served"] == {"front": 0, "t1": 1, "big": 0}
    assert st["tiers"] == ["small", "mid", "large"]
    assert [h["token"] for h in st["hops"]] == ["front", "t1"]


def test_uncalibrated_hop_escalates_through_without_running_tier():
    router, plane = _router3(
        {"small": _front(prob=0.2), "mid": _front(prob=0.99),
         "large": _big()}, thresholds=(0.5, None))
    tier, row = router.infer(np.zeros((4, 4, 1), np.float32))
    assert tier == "big"
    assert [name for name, _ in plane.calls] == ["small", "large"]
    assert row.tobytes() == plane.rows["large"].tobytes()
    router2, plane2 = _router3({"small": _front(), "mid": _front(),
                                "large": _big()})
    tier, _ = router2.infer(np.zeros((4, 4, 1), np.float32))
    assert tier == "big"
    assert [name for name, _ in plane2.calls] == ["large"]


def test_twice_escalated_request_never_exceeds_original_budget():
    router, plane = _router3(
        {"small": _front(prob=0.1), "mid": _front(prob=0.1),
         "large": _big()}, thresholds=(0.5, 0.5), delay_s=0.02)
    tier, _ = router.infer(np.zeros((4, 4, 1), np.float32),
                           deadline_ms=500.0)
    assert tier == "big"
    (n0, d0), (n1, d1), (n2, d2) = plane.calls
    assert (n0, d0) == ("small", 500.0)
    assert n1 == "mid" and n2 == "large"
    assert 0.0 < d2 < d1 <= 500.0 - 20.0
    assert d2 <= 500.0 - 40.0
    assert router.stats()["escalations"] == 2
    plane.calls.clear()
    tier, row = router.infer(np.zeros((4, 4, 1), np.float32),
                             deadline_ms=30.0)
    assert tier == "big" and isinstance(row, Shed)
    assert row.reason == "deadline"
    assert [name for name, _ in plane.calls] == ["small", "mid"]
    assert router.stats()["escalated_shed"] == 1


def test_version_swap_resets_only_its_hop_big_resets_all():
    router, plane = _router3(
        {"small": _front(), "mid": _front(), "large": _big()},
        thresholds=(0.5, 0.7))
    plane.listeners[0]("mid")
    assert router.hops[0].threshold is not None
    assert router.hops[1].threshold is None
    for _ in range(200):
        router.hops[1].hist.record(0.7, True)
    router._recalibrate(router.hops[1])
    plane.listeners[0]("large")
    assert router.hops[0].threshold is None
    assert router.hops[1].threshold is None


def test_ledger_roundtrip_and_any_tier_digest_rejection(tmp_path):
    rows = {"small": _front(), "mid": _front(), "large": _big()}
    digests = {"small": "d0", "mid": "d1", "large": "d2"}
    spec = CascadeSpec("small", "mid", "large", sample_period=1000,
                       min_sample=10)
    router = CascadeRouter(FakePlane(rows, digests=dict(digests)), spec,
                           root=str(tmp_path))
    assert router.params_digest() == "d0+d1+d2"
    for _ in range(10):
        router.hops[0].hist.record(0.8, True)
    router._recalibrate(router.hops[0])
    for _ in range(10):
        router.hops[1].hist.record(0.6, True)
    router._recalibrate(router.hops[1])
    r2 = CascadeRouter(FakePlane(rows, digests=dict(digests)), spec,
                       root=str(tmp_path))
    assert r2.restored is True
    assert r2.hops[0].threshold == pytest.approx(0.8)
    assert r2.hops[1].threshold == pytest.approx(0.6)
    assert r2.describe_member("small")["threshold_source"] == "restored"
    assert r2.describe_member("large")["role"] == "big"
    assert r2.describe_member("other") is None
    r3 = CascadeRouter(FakePlane(rows, digests=dict(digests,
                                                    mid="d1-reloaded")),
                       spec, root=str(tmp_path))
    assert r3.restored is False
    assert r3.hops[0].threshold is None and r3.hops[1].threshold is None
    router._on_version_swap("mid")
    r4 = CascadeRouter(FakePlane(rows, digests=dict(digests)), spec,
                       root=str(tmp_path))
    assert r4.hops[0].threshold == pytest.approx(0.8)
    assert r4.hops[1].threshold is None


def test_per_class_thresholds_and_fail_closed_class():
    router, plane = _router(
        {"small": _front(cls=3, prob=0.9), "large": _big()},
        per_class=True, class_min_sample=20, min_sample=20,
        min_agreement=0.9)
    hop = router.hops[0]
    for _ in range(30):
        hop.hist.record(0.62, True, cls=3)
    for _ in range(30):
        hop.hist.record(0.9, False, cls=1)
    for _ in range(5):
        hop.hist.record(0.9, True, cls=7)
    router._recalibrate()
    assert hop.class_thresholds[3] == pytest.approx(0.60)
    assert hop.class_thresholds[1] is None
    assert 7 not in hop.class_thresholds
    tier, _ = router.infer(np.zeros((4, 4, 1), np.float32))
    assert tier == "front"
    plane.rows["small"] = _front(cls=1, prob=0.97)
    tier, _ = router.infer(np.zeros((4, 4, 1), np.float32))
    assert tier == "big"
    st = router.stats()
    assert st["hops"][0]["class_thresholds"]["3"] == pytest.approx(0.6)


def test_detect_cascade_rule_signal_and_agreement():
    rule = pwl.DetectWorkload().cascade_rule()
    cls, conf = rule.signal(_det([0.9, 0.4, 0.0], [2, 5, 0]))
    assert cls == 2 and conf == pytest.approx(0.9)
    cls, conf = rule.signal(_det([0.0, 0.0], [0, 0]))
    assert cls is None and conf == 0.0
    assert rule.signal(np.zeros((13, 13, 18))) == (None, None)
    a = _det([0.9], [2])
    assert rule.agree(a, a) is True
    assert rule.agree(a, _det([0.9], [2],
                              boxes=[[0.7, 0.7, 0.9, 0.9]])) is False


def test_inner_hop_calibrates_against_final_tier():
    router, _ = _router3(
        {"small": _front(cls=2, prob=0.97), "mid": _front(cls=3, prob=0.97),
         "large": _big(cls=3)},
        sample_period=2, min_sample=3, min_agreement=0.9)
    x = np.zeros((4, 4, 1), np.float32)
    tiers = [router.infer(x)[0] for _ in range(20)]
    st = router.stats()
    assert st["hops"][0]["samples"] == 10
    assert not st["hops"][0]["calibrated"]
    assert st["hops"][0]["agreement"] == pytest.approx(0.0)
    assert st["hops"][1]["samples"] == 5
    assert st["hops"][1]["calibrated"]
    assert st["served"]["t1"] >= 1 and "t1" in tiers
    assert st["served"]["front"] == 0


def test_brownout_hooks_pause_samples_and_degrade(tmp_path):
    """L1 skips the dual-run slots (counted), L2 serves a calibrated hop
    below its threshold as ``<tier>-degraded``; always-big requests are
    exempt from both, and an uncalibrated hop stays fail-closed."""
    router, plane = _router3(
        {"small": _front(prob=0.2), "mid": _front(prob=0.3),
         "large": _big()}, thresholds=(0.5, None), sample_period=2)
    ladder = _Ladder()
    router.brownout = ladder
    x = np.zeros((4, 4, 1), np.float32)
    ladder.level = 1
    before = router.stats()["samples"]
    tiers = [router.infer(x)[0] for _ in range(4)]
    st = router.stats()
    # every request escalates through both hops: two slots a hop
    assert st["samples"] == before and st["samples_paused"] == 4
    assert tiers == ["big"] * 4
    ladder.level = 2
    tier, row = router.infer(x)
    assert tier == "front-degraded" and isinstance(row, dict)
    assert router.infer(x, force_big=True)[0] == "big"
    assert router.stats()["degraded_served"] == 1
    # hop 1 has no threshold: nothing to degrade from
    router.hops[0].threshold = None
    assert router.infer(x)[0] == "big"


# -- a real plane -------------------------------------------------------------


def test_real_plane_front_epilogue_and_escalation(tmp_path):
    """LeNet-5 (front, cascade_topk=3: the fused confidence epilogue)
    and LeNet5Big (big, dense logits) on a real control plane on the
    CPU: front rows are top-K dicts equal to the front's own epilogue of
    its dense logits, big rows are dense logits equal to big-only
    serving, and a reload of the front keeps its epilogue and fires the
    version listener once."""
    from _torch_serve import write_step

    import _torch_zoo as tz
    from deep_vision_tpu_torch.serve.engine import BatchingEngine
    from deep_vision_tpu_torch.serve.models import (
        CanaryPolicy,
        ModelControlPlane,
    )
    from deep_vision_tpu_torch.serve.registry import ModelRegistry

    work = {n: str(tmp_path / n) for n in ("lenet5", "lenet5_big")}
    for n, d in work.items():
        write_step(d, 1, tz.port(n, tz.variables(n)))
    reg = ModelRegistry()
    front = reg.load_checkpoint("lenet5", workdir=work["lenet5"],
                                cascade_topk=3, device="cpu")
    big = reg.load_checkpoint("lenet5_big", workdir=work["lenet5_big"],
                              device="cpu")
    plane = ModelControlPlane(
        reg, lambda m: BatchingEngine(m, buckets=[4], max_wait_ms=2),
        policy=CanaryPolicy(canary_frac=1.0, min_requests=2))
    plane.deploy(front, workdir=work["lenet5"])
    plane.deploy(big, workdir=work["lenet5_big"])
    try:
        spec = CascadeSpec("lenet5", "lenet5_big", sample_period=1000,
                           min_sample=4, topk=3)
        router = CascadeRouter(plane, spec)
        swaps = []
        plane.add_version_listener(swaps.append)
        x = np.random.RandomState(0).randn(32, 32, 1).astype(np.float32)
        tier, row = router.infer(x, timeout=120)
        assert tier == "big"
        direct = plane.infer("lenet5_big", x, timeout=120)
        np.testing.assert_array_equal(np.asarray(row), np.asarray(direct))
        for _ in range(4):
            router.hist.record(0.0, True)
        router._recalibrate()
        assert router.threshold == 0.0
        tier, row = router.infer(x, timeout=120)
        assert tier == "front" and isinstance(row, dict)
        assert np.asarray(row["topk_class"]).shape == (3,)
        resp = ClassifyWorkload().respond(big, {"top_k": 3}, row)
        assert len(resp["top"]) == 3
        # the front's row is its own epilogue over its dense logits
        dense = front.compile_bucket(4, epilogue=False)(
            np.stack([x] * 4))[0:1]
        want = pwl.ClassifyWorkload().make_epilogue(front)(dense)
        np.testing.assert_array_equal(row["topk_class"],
                                      want["topk_class"][0].numpy())
        np.testing.assert_array_equal(row["topk_logit"],
                                      want["topk_logit"][0].numpy())
        # a reload keeps the epilogue, fires once, resets hop 0
        write_step(work["lenet5"], 2, tz.port("lenet5", tz.variables(
            "lenet5", seed=1)))
        assert plane.reload("lenet5")["status"] == "reloading"
        t_end = time.monotonic() + 120
        while plane.active_version("lenet5").version != 2:
            assert time.monotonic() < t_end, plane.models()["lenet5"]
            plane.infer("lenet5", x, timeout=120)  # the canary's traffic
        assert swaps == ["lenet5"]
        assert plane.resolve("lenet5").cascade_topk == 3
        assert router.threshold is None
        assert isinstance(plane.infer("lenet5", x, timeout=120), dict)
    finally:
        plane.stop()
