"""The port's model control plane on the CPU (mirrors
tests/test_models_plane.py case by case): the weight cache evicts and
re-admits without changing an output bit or rebuilding a bucket
callable, the LRU order is the touch order, an oversized model still
serves, a hot reload under live load loses no admitted request, the
canary gates roll back a NaN or a slow candidate, shadow traffic is
compared and discarded, operator promote/rollback race the background
worker safely, retired versions release their weights, a failed deploy
leaves no entry, and the registry answers per version.

LeNet-5 at full width (and yolov3_toy where a second, larger model is
needed) with seeded weights: lifecycle correctness is about routing and
residency, not learned weights."""

import copy
import threading
import time

import numpy as np
import pytest
import torch

import _torch_zoo as tz
from _torch_serve import lenet_model, lenet_variables, port_lenet, write_step
from deep_vision_tpu.serve.quant import _quantize_leaf as jax_quantize_leaf
from deep_vision_tpu_torch.serve.admission import AdmissionController, Shed
from deep_vision_tpu_torch.serve.engine import BatchingEngine
from deep_vision_tpu_torch.serve.faults import FaultPlane, Quarantined
from deep_vision_tpu_torch.serve.models import (
    ACTIVE,
    RETIRED,
    CanaryPolicy,
    ModelControlPlane,
    WeightCache,
)
from deep_vision_tpu_torch.serve.quant import quantize_tensor
from deep_vision_tpu_torch.serve.registry import (
    CheckpointServingModel,
    ModelRegistry,
)

pytestmark = pytest.mark.models


def _engine_factory(model):
    """Small test engine; a model tagged ``_test_faults`` gets that fault
    spec with output validation OFF, so an injected-NaN candidate SERVES
    its NaNs for the canary gate to catch."""
    spec = getattr(model, "_test_faults", "")
    return BatchingEngine(model, buckets=[4], max_wait_ms=2,
                          faults=FaultPlane(spec),
                          validate_outputs=False if spec else None)


def _fresh_sm(sm):
    """A new ServingModel over a copy of the same weights: the reload
    loader seam's "new checkpoint"."""
    new = CheckpointServingModel(sm.name, sm.cfg, copy.deepcopy(sm._model),
                                 device="cpu")
    new.restored_step = (sm.restored_step or 0) + 1
    new.params_digest = sm.params_digest
    return new


def _lenet(reg, name="lenet5", seed=0):
    return reg.add(port_lenet(lenet_variables(seed), name=name))


@pytest.fixture()
def lenet_plane(tmp_path):
    reg = ModelRegistry()
    sm = _lenet(reg)
    cache = WeightCache(budget_bytes=0)
    plane = ModelControlPlane(
        reg, _engine_factory, cache=cache,
        policy=CanaryPolicy(canary_frac=0.5, min_requests=3,
                            max_p99_ratio=None, phase_timeout_s=15.0))
    plane.deploy(sm, workdir=str(tmp_path / "lenet_workdir"))
    yield reg, sm, plane, cache
    plane.stop()


def _img(shape=(32, 32, 1), seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


class _LoadThread(threading.Thread):
    """A closed-loop client against one model name; every error (an
    exception, a Shed, a Quarantined, a NaN output) is a lost request."""

    def __init__(self, plane, name, img):
        super().__init__(daemon=True)
        self.plane, self.name, self.img = plane, name, img
        self.stop_flag = threading.Event()
        self.served = 0
        self.errors: list = []
        self.nan_outputs = 0

    def run(self):
        while not self.stop_flag.is_set():
            try:
                r = self.plane.infer(self.name, self.img, timeout=30)
            except Exception as e:  # noqa: BLE001 — every failure is a lost request
                self.errors.append(repr(e))
                continue
            if isinstance(r, (Shed, Quarantined)):
                self.errors.append(repr(r))
                continue
            if np.isnan(np.asarray(r)).any():
                self.nan_outputs += 1
            self.served += 1

    def finish(self):
        self.stop_flag.set()
        self.join(30)
        assert not self.is_alive()

    def wait_served(self, n, timeout=30.0):
        deadline = time.monotonic() + timeout
        while self.served < n and time.monotonic() < deadline:
            time.sleep(0.01)
        assert self.served >= n


# -- weight cache ------------------------------------------------------------


def test_evict_readmit_bit_identical_no_recompile():
    """A 1-byte budget sends every model switch through evict → spill →
    re-admit: outputs bit-identical, no bucket callable rebuilt."""
    reg = ModelRegistry()
    lenet = _lenet(reg)
    yolo = reg.load_checkpoint("yolov3_toy", device="cpu")
    cache = WeightCache(budget_bytes=1)
    plane = ModelControlPlane(reg, _engine_factory, cache=cache)
    plane.deploy(lenet)
    plane.deploy(yolo)
    try:
        img = _img()
        first = np.asarray(plane.infer("lenet5", img, timeout=30))
        compiles = plane.active_engine("lenet5").compiles
        assert plane.infer("yolov3_toy", _img((64, 64, 3)),
                           timeout=30) is not None
        assert "lenet5" not in cache.resident_models()
        assert not lenet._resident
        again = np.asarray(plane.infer("lenet5", img, timeout=30))
        assert np.array_equal(first, again)
        assert plane.active_engine("lenet5").compiles == compiles
        st = cache.stats()
        assert st["evictions"] >= 2 and st["admits"] >= 1
        assert st["spilled_bytes_total"] > 0
        assert st["models"]["lenet5"]["spilled"]
    finally:
        plane.stop()


def test_lru_order_is_touch_order():
    """3 models, budget = 2 of them: residency follows recency, not
    insertion."""
    reg = ModelRegistry()
    a, b, c = (_lenet(reg, name, seed)
               for seed, name in enumerate(("a", "b", "c")))
    cache = WeightCache(budget_bytes=2 * a.param_bytes())
    for m in (a, b, c):
        cache.register(m)  # admitting c evicts a (the LRU resident)
    assert sorted(cache.resident_models()) == ["b", "c"]
    assert cache.pin(b)  # touch b: the order is c, b
    cache.unpin(b)
    assert cache.pin(a)  # admit a → evict c
    cache.unpin(a)
    assert sorted(cache.resident_models()) == ["a", "b"]
    st = cache.stats()
    assert st["evictions"] == 2 and st["hits"] == 1 and st["misses"] == 1
    cache.drop(a)
    assert "a" not in cache.stats()["models"] and a._cache is None


def test_pinned_model_is_not_evicted():
    """A model whose batch is being launched (pinned) stays resident;
    the admit goes over budget instead."""
    reg = ModelRegistry()
    a, b = _lenet(reg, "a", 0), _lenet(reg, "b", 1)
    cache = WeightCache(budget_bytes=a.param_bytes())
    cache.register(a)
    cache.register(b)  # evicts a
    assert cache.pin(b)
    assert cache.pin(a)  # b is pinned: a admits over budget
    assert sorted(cache.resident_models()) == ["a", "b"]
    assert cache.stats()["over_budget"] >= 1
    cache.unpin(a)
    cache.unpin(b)


def test_oversized_model_still_serves_over_budget():
    reg = ModelRegistry()
    sm = _lenet(reg)
    cache = WeightCache(budget_bytes=1)
    plane = ModelControlPlane(reg, _engine_factory, cache=cache)
    plane.deploy(sm)
    try:
        assert plane.infer("lenet5", _img(), timeout=30) is not None
        assert cache.stats()["over_budget"] >= 1
    finally:
        plane.stop()


# -- hot reload --------------------------------------------------------------


@pytest.mark.chaos
def test_hot_reload_under_load_loses_zero_requests(lenet_plane):
    _, sm, plane, _ = lenet_plane
    load = _LoadThread(plane, "lenet5", _img())
    load.start()
    load.wait_served(5)
    out = plane.reload("lenet5", wait=True, _loader=lambda: _fresh_sm(sm))
    load.finish()
    assert out["status"] == "done"
    assert out["version"]["state"] == ACTIVE
    assert out["version"]["version"] == 2
    assert load.errors == []
    assert load.nan_outputs == 0 and load.served > 0
    st = plane.stats()
    assert st["plane"]["promotions"] == 1
    assert st["models"]["lenet5"]["active_version"] == 2
    states = [v["state"] for v in st["models"]["lenet5"]["versions"]]
    assert states == [RETIRED, ACTIVE]


@pytest.mark.chaos
def test_canary_rolls_back_nan_bad_version(lenet_plane):
    _, sm, plane, _ = lenet_plane

    def bad_loader():
        new = _fresh_sm(sm)
        new._test_faults = "d2h:nan"  # the engine factory serves NaNs
        return new

    load = _LoadThread(plane, "lenet5", _img())
    load.start()
    load.wait_served(5)
    out = plane.reload("lenet5", wait=True, _loader=bad_loader)
    load.finish()
    assert out["status"] == "done"
    assert out["version"]["version"] == 2
    assert out["version"]["state"] == RETIRED
    assert "canary error rate" in out["version"]["state_reason"]
    st = plane.stats()
    assert st["plane"]["rollbacks"] == 1 and st["plane"]["promotions"] == 0
    assert st["models"]["lenet5"]["active_version"] == 1
    r = np.asarray(plane.infer("lenet5", _img(), timeout=30))
    assert not np.isnan(r).any()


def test_quantize_keeps_a_nan_channel_non_finite():
    """A channel holding a NaN or an inf gets codes 0 and a NaN scale (the
    reference gives it scale 1 and finite codes, hiding the bad weight);
    every other channel is bit-equal to the reference's quantization of
    the same kernel (flax layout: output channel last)."""
    w = np.random.RandomState(0).randn(5, 3, 2, 2).astype(np.float32)
    w[1, 2, 0, 1] = np.nan
    w[3, 0, 1, 1] = np.inf
    q, scale = quantize_tensor(torch.from_numpy(w))
    with np.errstate(invalid="ignore"):  # the reference casts NaN codes
        jq, jscale = jax_quantize_leaf(w.transpose(2, 3, 1, 0))
    jq, bad = jq.transpose(3, 2, 0, 1), [1, 3]
    good = [0, 2, 4]
    assert np.isnan(scale[bad]).all() and (q[bad] == 0).all()
    np.testing.assert_array_equal(scale[good], jscale[good])
    np.testing.assert_array_equal(q[good], jq[good])
    assert jscale[1] == 1.0 and jscale[3] == np.inf  # the reference's


@pytest.mark.chaos
def test_canary_rolls_back_int8_nan_weight():
    """A NaN in an int8 candidate's classifier weight reaches its outputs
    (NaN scale), the canary counts them as errors, and its error-rate
    gate rolls the candidate back; the active version keeps answering
    finite."""
    reg = ModelRegistry()
    sm = reg.add(port_lenet(lenet_variables(0), infer="int8"))
    plane = ModelControlPlane(
        reg, _engine_factory,
        policy=CanaryPolicy(canary_frac=0.5, min_requests=3,
                            max_p99_ratio=None, phase_timeout_s=15.0))
    plane.deploy(sm)

    def nan_loader():
        model = tz.port("lenet5", lenet_variables(0))
        with torch.no_grad():
            model.classifier[2].weight[3, 7] = float("nan")
        new = CheckpointServingModel("lenet5", sm.cfg, model,
                                     infer_dtype="int8", device="cpu")
        new.restored_step = 2
        assert np.isnan(new._model.classifier[2].weight_scale[3].item())
        return new

    load = _LoadThread(plane, "lenet5", _img())
    load.start()
    try:
        load.wait_served(5)
        out = plane.reload("lenet5", wait=True, _loader=nan_loader)
    finally:
        load.finish()
    try:
        assert out["status"] == "done"
        assert out["version"]["state"] == RETIRED
        assert "canary error rate" in out["version"]["state_reason"]
        assert plane.stats()["models"]["lenet5"]["active_version"] == 1
        r = np.asarray(plane.infer("lenet5", _img(), timeout=30))
        assert np.isfinite(r).all()
    finally:
        plane.stop()


@pytest.mark.chaos
def test_canary_p99_gate_rolls_back_slow_version():
    reg = ModelRegistry()
    sm = _lenet(reg)
    plane = ModelControlPlane(
        reg, _engine_factory,
        policy=CanaryPolicy(canary_frac=0.5, min_requests=3,
                            max_error_rate=1.0, max_p99_ratio=3.0,
                            phase_timeout_s=20.0))
    plane.deploy(sm)
    plane.warmup()

    def slow_loader():
        new = _fresh_sm(sm)
        # 1 s a batch: far past 3× any active p99 on a loaded CPU
        new._test_faults = "d2h:latency:delay_ms=1000"
        return new

    load = _LoadThread(plane, "lenet5", _img())
    load.start()
    try:
        load.wait_served(10)
        out = plane.reload("lenet5", wait=True, _loader=slow_loader)
        assert out["status"] == "done"
        assert out["version"]["state"] == RETIRED
        assert "p99" in out["version"]["state_reason"]
        assert plane.stats()["plane"]["rollbacks"] == 1
        assert plane.stats()["models"]["lenet5"]["active_version"] == 1
    finally:
        load.finish()
        plane.stop()


def test_shadow_compares_then_discards(lenet_plane):
    _, sm, plane, _ = lenet_plane
    plane.policy = CanaryPolicy(canary_frac=0.5, min_requests=3,
                                shadow_frac=1.0, shadow_min_compared=3,
                                min_agreement=0.8, max_p99_ratio=None,
                                phase_timeout_s=15.0)
    load = _LoadThread(plane, "lenet5", _img())
    load.start()
    load.wait_served(5)
    out = plane.reload("lenet5", wait=True, _loader=lambda: _fresh_sm(sm))
    load.finish()
    assert out["status"] == "done"
    assert out["version"]["state"] == ACTIVE  # identical weights agree
    shadow = out["version"]["shadow"]
    assert shadow["compared"] >= 3
    assert shadow["agreed"] == shadow["compared"]
    assert shadow["discarded"] >= shadow["compared"]
    assert load.errors == []


def _wait_for_state(plane, name, version, state, timeout=20.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        for v in plane.models()[name]["versions"]:
            if v["version"] == version and v["state"] == state:
                return True
        time.sleep(0.01)
    return False


def _join_reload(plane, name, timeout=20.0):
    t = plane._reloading.get(name)
    if t is not None:
        t.join(timeout)
        assert not t.is_alive()


@pytest.mark.chaos
def test_operator_promote_wins_over_worker_rollback():
    reg = ModelRegistry()
    sm = _lenet(reg)
    plane = ModelControlPlane(
        reg, _engine_factory,
        policy=CanaryPolicy(canary_frac=0.5, min_requests=10**6,
                            max_p99_ratio=None, phase_timeout_s=30.0))
    plane.deploy(sm)
    try:
        out = plane.reload("lenet5", _loader=lambda: _fresh_sm(sm))
        assert out["status"] == "reloading"
        assert _wait_for_state(plane, "lenet5", 2, "canary")
        assert plane.promote("lenet5") == {"status": "promoted",
                                           "model": "lenet5", "version": 2}
        _join_reload(plane, "lenet5")
        st = plane.stats()
        assert st["models"]["lenet5"]["active_version"] == 2
        assert st["plane"]["promotions"] == 1
        assert st["plane"]["rollbacks"] == 0  # the worker stood down
        states = {v["version"]: v["state"]
                  for v in st["models"]["lenet5"]["versions"]}
        assert states == {1: RETIRED, 2: ACTIVE}
        r = plane.infer("lenet5", _img(), timeout=30)
        assert not isinstance(r, (Shed, Quarantined))
        assert reg.get("lenet5", version=2) is not None
        assert plane.promote("lenet5")["status"] == "refused"
    finally:
        plane.stop()


@pytest.mark.chaos
def test_operator_rollback_wins_over_worker_promote():
    reg = ModelRegistry()
    sm = _lenet(reg)
    plane = ModelControlPlane(
        reg, _engine_factory,
        policy=CanaryPolicy(canary_frac=0.5, min_requests=1,
                            shadow_frac=1.0, shadow_min_compared=10**6,
                            max_p99_ratio=None, phase_timeout_s=30.0))
    plane.deploy(sm)
    try:
        out = plane.reload("lenet5", _loader=lambda: _fresh_sm(sm))
        assert out["status"] == "reloading"
        assert _wait_for_state(plane, "lenet5", 2, "shadow")
        assert plane.rollback("lenet5") == {"status": "rolled_back",
                                            "model": "lenet5",
                                            "version": 2}
        _join_reload(plane, "lenet5")
        st = plane.stats()
        assert st["models"]["lenet5"]["active_version"] == 1
        assert st["plane"]["promotions"] == 0
        assert st["plane"]["rollbacks"] == 1
        states = {v["version"]: v["state"]
                  for v in st["models"]["lenet5"]["versions"]}
        assert states == {1: ACTIVE, 2: RETIRED}
        assert st["models"]["lenet5"]["versions"][-1]["state_reason"] \
            == "operator rollback"
        r = plane.infer("lenet5", _img(), timeout=30)
        assert not isinstance(r, (Shed, Quarantined))
    finally:
        plane.stop()


def test_retired_version_releases_weights_and_prunes_registry():
    reg = ModelRegistry()
    sm = _lenet(reg)
    plane = ModelControlPlane(
        reg, _engine_factory,
        policy=CanaryPolicy(canary_frac=0.5, min_requests=1,
                            max_p99_ratio=None, phase_timeout_s=15.0),
        retain_retired=1)
    plane.deploy(sm)
    load = _LoadThread(plane, "lenet5", _img())
    load.start()
    try:
        load.wait_served(3)
        sm2 = _fresh_sm(sm)
        out = plane.reload("lenet5", wait=True, _loader=lambda: sm2)
        assert out["version"]["state"] == ACTIVE
        # retired v1 points at its host copy; the active v2 is resident
        assert not sm._resident and sm._host_weights is not None
        assert all(t.data_ptr() == h.data_ptr() for t, h in
                   zip(sm._tensors(), sm._host_weights))
        assert sm2._resident
        out = plane.reload("lenet5", wait=True,
                           _loader=lambda: _fresh_sm(sm2))
        assert out["version"]["version"] == 3
        assert out["version"]["state"] == ACTIVE
        versions = [v["version"] for v in
                    plane.models()["lenet5"]["versions"]]
        assert 1 not in versions and versions[-1] == 3
        with pytest.raises(KeyError):
            reg.get("lenet5", version=1)
        assert reg.get("lenet5", version=2) is sm2
        assert load.errors == []
    finally:
        load.finish()
        plane.stop()


def test_revert_restores_the_previous_promoted_version():
    """``revert`` mints a new version wrapping the newest retired one
    that served, re-admits its released weights and answers as it did."""
    reg = ModelRegistry()
    sm = _lenet(reg)
    cache = WeightCache(budget_bytes=0)
    plane = ModelControlPlane(
        reg, _engine_factory, cache=cache,
        policy=CanaryPolicy(canary_frac=0.5, min_requests=1,
                            max_p99_ratio=None, phase_timeout_s=15.0))
    plane.deploy(sm)
    try:
        before = np.asarray(plane.infer("lenet5", _img(), timeout=30))
        assert plane.revert("lenet5")["status"] == "refused"
        other = port_lenet(lenet_variables(5))
        other.restored_step = 9
        load = _LoadThread(plane, "lenet5", _img())
        load.start()
        load.wait_served(3)
        out = plane.reload("lenet5", wait=True, _loader=lambda: other)
        load.finish()
        assert out["version"]["state"] == ACTIVE and not sm._resident
        res = plane.revert("lenet5")
        assert res["status"] == "reverted" and res["restores"] == 1
        assert res["version"] == 3
        after = np.asarray(plane.infer("lenet5", _img(), timeout=30))
        assert np.array_equal(before, after) and sm._resident
        assert plane.stats()["plane"]["reverts"] == 1
    finally:
        plane.stop()


def test_deploy_failure_leaves_no_table_entry():
    reg = ModelRegistry()
    sm = _lenet(reg)

    class _BoomEngine:
        def start(self):
            raise RuntimeError("boom")

    plane = ModelControlPlane(reg, lambda m: _BoomEngine())
    with pytest.raises(RuntimeError):
        plane.deploy(sm)
    listing = plane.models().get("lenet5", {})
    assert listing.get("versions", []) == []
    assert listing.get("active_version") is None
    plane2 = ModelControlPlane(reg, _engine_factory)
    mv = plane2.deploy(sm)
    try:
        assert mv.version == 1
    finally:
        plane2.stop()


def test_reload_refused_without_workdir_and_while_in_progress(tmp_path):
    reg = ModelRegistry()
    sm = _lenet(reg)
    plane = ModelControlPlane(
        reg, _engine_factory,
        policy=CanaryPolicy(canary_frac=0.5, min_requests=10**6,
                            max_p99_ratio=None, phase_timeout_s=30.0))
    plane.deploy(sm)  # no workdir
    try:
        out = plane.reload("lenet5")
        assert out["status"] == "refused" and "workdir" in out["reason"]
        with pytest.raises(KeyError):
            plane.reload("nope")
        assert plane.reload("lenet5", _loader=lambda: _fresh_sm(sm))[
            "status"] == "reloading"
        assert _wait_for_state(plane, "lenet5", 2, "canary")
        assert plane.reload("lenet5", _loader=lambda: _fresh_sm(sm))[
            "status"] == "in_progress"
        plane.rollback("lenet5")
        _join_reload(plane, "lenet5")
    finally:
        plane.stop()


def test_reload_from_workdir_walks_new_steps(tmp_path):
    """The default loader: a new step in the workdir becomes the next
    version (with its step and digest), an unchanged workdir answers
    ``no_new_step``."""
    wd = str(tmp_path / "lenet5")
    write_step(wd, 1, lenet_model(1))
    reg = ModelRegistry()
    sm = reg.load_checkpoint("lenet5", device="cpu", workdir=wd)
    plane = ModelControlPlane(
        reg, _engine_factory,
        policy=CanaryPolicy(canary_frac=1.0, min_requests=1,
                            max_p99_ratio=None, phase_timeout_s=15.0))
    plane.deploy(sm, workdir=wd)
    try:
        assert plane.reload("lenet5")["status"] == "no_new_step"
        write_step(wd, 2, lenet_model(2))
        load = _LoadThread(plane, "lenet5", _img())
        load.start()
        load.wait_served(2)
        out = plane.reload("lenet5", wait=True)
        load.finish()
        assert out["version"]["state"] == ACTIVE
        assert out["version"]["step"] == 2
        assert plane.resolve("lenet5").params_digest == \
            out["version"]["digest"] != sm.params_digest
        assert load.errors == []
    finally:
        plane.stop()


# -- satellites --------------------------------------------------------------


def test_registry_get_requires_name_with_multiple_models():
    reg = ModelRegistry()
    _lenet(reg)
    reg.load_checkpoint("yolov3_toy", device="cpu")
    with pytest.raises(KeyError) as exc:
        reg.get(None)
    msg = exc.value.args[0]
    assert msg.startswith("model name required")
    assert "lenet5" in msg and "yolov3_toy" in msg


def test_registry_versioned_get():
    reg = ModelRegistry()
    sm = _lenet(reg)
    sm.serve_version = 1
    reg.add(sm, version=1)
    assert reg.get("lenet5", version=1) is sm
    assert reg.get(None, version=1) is sm
    with pytest.raises(KeyError) as exc:
        reg.get("lenet5", version=99)
    assert "no version 99" in exc.value.args[0]
    reg.remove_version("lenet5", 1)
    with pytest.raises(KeyError):
        reg.get("lenet5", version=1)


def test_admitted_counter_and_named_admission():
    reg = ModelRegistry()
    sm = _lenet(reg)
    adm = AdmissionController(name="lenet5")
    with BatchingEngine(sm, buckets=[4], max_wait_ms=2,
                        admission=adm) as eng:
        for _ in range(3):
            assert eng.infer(_img(), timeout=30) is not None
        st = eng.stats()["admission"]
    assert st["admitted"] == 3
    assert st["name"] == "lenet5"


def test_agreement_histogram_matches_reference():
    """The cascade calibration sample (``AgreementHistogram``) ported
    with the plane: thresholds, per-class thresholds, restore and stats
    equal the reference's on the same seeded sample."""
    from deep_vision_tpu.serve.models import AgreementHistogram as JaxHist
    from deep_vision_tpu_torch.serve.models import AgreementHistogram

    rng = np.random.RandomState(3)
    sample = [(float(c), bool(a), int(k)) for c, a, k in zip(
        rng.uniform(-0.1, 1.1, 400), rng.uniform(size=400) < 0.85,
        rng.randint(0, 4, 400))]
    hists = [cls(bins=10, per_class=True)
             for cls in (AgreementHistogram, JaxHist)]
    for h in hists:
        for conf, agreed, k in sample:
            h.record(conf, agreed, cls=k)
    got, want = hists
    for floor, n in ((0.8, 50), (0.9, 50), (0.99, 10), (0.5, 10**6)):
        assert got.threshold(floor, n) == want.threshold(floor, n)
        assert got.class_thresholds(floor, 20) == \
            want.class_thresholds(floor, 20)
    assert got.stats() == want.stats()
    assert got.class_counts() == want.class_counts()
    fresh = AgreementHistogram(bins=10, per_class=True)
    fresh.restore(want.stats()["total"], want.stats()["agree"],
                  want.class_counts())
    assert fresh.stats() == want.stats()
    with pytest.raises(ValueError):
        fresh.restore([1] * 10, [2] * 10)
    fresh.reset()
    assert fresh.stats()["samples"] == 0
