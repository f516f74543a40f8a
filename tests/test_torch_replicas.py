"""The port's replicated engine on the CPU (counterpart of
tests/test_replicas.py without the sharded tests, which wait for the
parallelism slice): routing spreads work over every replica, answers are
bit-identical to the port's single engine at the same bucket and match
the JAX ``ReplicatedEngine`` on forced host devices, a replica killed
mid-load loses no admitted request, an all-DEAD fleet sheds instead of
hanging, the admission divisor equals the reference's, a ``for_device``
view leaves its base model untouched, and warmup runs on the thread that
launches (the router), again after the router is restarted.

CPU replicas are ``[torch.device("cpu")] * k``; LeNet-5 at full width
with seeded weights shared with the JAX serving model.  Tolerance of the
JAX comparison: the port's LeNet-5 serving parity bound, 1e-4 × max|ref|
(tests/test_torch_faults.py)."""

import threading
import time
from concurrent.futures import Future, wait

import numpy as np
import pytest
import torch

from _torch_serve import images, jax_lenet, lenet_variables, port_lenet
from deep_vision_tpu.serve.admission import (
    AdmissionController as JaxAdmission,
)
from deep_vision_tpu.serve.replicas import ReplicatedEngine as JaxReplicated
from deep_vision_tpu.serve.replicas import local_devices as jax_local_devices
from deep_vision_tpu_torch.serve.admission import AdmissionController, Shed
from deep_vision_tpu_torch.serve.engine import BatchingEngine, _Request
from deep_vision_tpu_torch.serve.faults import FaultPlane, Quarantined
from deep_vision_tpu_torch.serve.replicas import (
    ReplicatedEngine,
    local_devices,
)

pytestmark = [pytest.mark.serve, pytest.mark.replicas]

BOUND = 1e-4
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def lenet():
    variables = lenet_variables(0)
    return jax_lenet(variables), port_lenet(variables)


def _serve_all(engine, imgs, timeout=120):
    futs = [engine.submit(x) for x in imgs]
    wait(futs, timeout)
    return [f.result(0) for f in futs]


@pytest.fixture()
def two_gpus(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)


def test_local_devices_validation(two_gpus, host_devices):
    cuda = [torch.device("cuda", i) for i in range(2)]
    assert local_devices() == cuda
    assert local_devices(1) == cuda[:1]
    # over-asking is an operator error in both packages, never a
    # silent truncation
    with pytest.raises(ValueError, match="only 2 local"):
        local_devices(3)
    with pytest.raises(ValueError, match="only"):
        jax_local_devices(len(host_devices) + 1)
    with pytest.raises(ValueError, match="at least 1"):
        local_devices(0)
    with pytest.raises(ValueError, match="at least 1"):
        jax_local_devices(0)


def test_no_gpu_needs_explicit_cpu_replicas(lenet, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CPU devices explicitly"):
        local_devices()
    with pytest.raises(RuntimeError, match="CPU devices explicitly"):
        ReplicatedEngine(lenet[1])


def test_routing_spreads_across_replicas(lenet):
    """4 replicas under sequential singles and then a burst: every
    replica executes batches (the rotating tie-break), every routed
    batch is an executed one, everything is served."""
    _, sm = lenet
    imgs = images(48)
    with ReplicatedEngine(sm, devices=[CPU] * 4, max_batch=4,
                          max_wait_ms=1.0) as eng:
        for x in imgs[:16]:
            assert isinstance(eng.infer(x, timeout=60), np.ndarray)
        assert all(isinstance(r, np.ndarray)
                   for r in _serve_all(eng, imgs[16:]))
        st = eng.stats()
    per = [r["batches"] for r in st["replicas"]]
    assert all(n >= 1 for n in per), per
    assert st["served"] == len(imgs)
    assert sum(r["routed_batches"] for r in st["replicas"]) \
        == st["batches"]
    assert st["routing"]["replicas"] == 4
    assert [r["device"] for r in st["replicas"]] == ["cpu"] * 4


def test_replicated_answers_single_engine_and_jax(lenet, host_devices):
    """One-bucket ladder (every answer at bucket 8): bitwise equal to the
    port's single engine, and within the parity bound of the JAX
    ReplicatedEngine over 3 forced host devices."""
    jsm, sm = lenet
    imgs = images(32)
    with BatchingEngine(sm, buckets=[8], max_wait_ms=2.0) as eng:
        ref = _serve_all(eng, imgs)
    with ReplicatedEngine(sm, devices=[CPU] * 3, buckets=[8],
                          max_wait_ms=2.0) as eng:
        eng.warmup()
        got = _serve_all(eng, imgs)
        routed = eng.stats()["routing"]
    assert routed["replicas"] == 3
    for a, b in zip(ref, got):
        assert np.array_equal(a, b)
    with JaxReplicated(jsm, devices=host_devices[:3], buckets=[8],
                       max_wait_ms=2.0) as jeng:
        want = np.stack([np.asarray(r) for r in _serve_all(jeng, imgs)])
    mine = np.stack(got)
    atol = BOUND * np.abs(want).max()
    np.testing.assert_allclose(mine, want, rtol=0, atol=atol)
    # control: the same answers one request off must break the bound
    assert np.abs(np.roll(mine, 1, axis=0) - want).max() > atol


def test_dead_replica_loses_no_admitted_request(lenet):
    """Replica 0 forced DEAD mid-load: its in-flight cohorts are
    evacuated and bisect-retried elsewhere, no admitted request is lost,
    routing and the admission divisor drop to k-1, healthz stays
    serveable."""
    _, sm = lenet
    imgs = images(96)
    with BatchingEngine(sm, buckets=[4], max_wait_ms=5.0) as eng:
        ref = np.stack(_serve_all(eng, imgs))
    eng = ReplicatedEngine(sm, devices=[CPU] * 3, max_batch=4,
                           max_wait_ms=5.0, watchdog_interval_s=0.02)
    with eng:
        eng.warmup([4])
        futs = [eng.submit(x) for x in imgs]
        eng.replicas[0].health.force_dead("test kill")
        wait(futs, 120)
        results = [f.result(0) for f in futs]
        st = eng.stats()
        health = eng.health_report()
    lost = [r for r in results if not isinstance(r, np.ndarray)
            and not isinstance(r, Quarantined)]
    assert not lost, f"{len(lost)} admitted requests lost: {lost[:3]}"
    assert st["served"] == len(imgs)
    # rescued cohorts run at the smaller buckets of the ladder
    np.testing.assert_allclose(np.stack(results), ref, rtol=0,
                               atol=BOUND * np.abs(ref).max())
    assert st["replicas"][0]["state"] == "dead"
    assert st["routing"]["free_replicas"] == 2
    assert st["admission"]["free_replicas"] == 2
    assert st["admission"]["live_replicas"] == 3
    assert st["routing"]["evacuations"] >= 1
    assert health["state"] == "degraded"
    assert health["can_serve"] is True
    assert health["replicas"]["0"]["state"] == "dead"
    assert health["replicas"]["1"]["batcher_alive"] is None


def test_all_replicas_dead_sheds_a_formed_batch(lenet):
    _, sm = lenet
    with ReplicatedEngine(sm, devices=[CPU] * 2, max_batch=4,
                          max_wait_ms=1.0,
                          watchdog_interval_s=0.02) as eng:
        assert isinstance(eng.infer(images(1)[0], timeout=60), np.ndarray)
        for rep in eng.replicas:
            rep.health.force_dead("test kill")
        health = eng.health_report()
        assert health["state"] == "dead"
        assert health["can_serve"] is False
        r = eng.infer(images(1)[0], timeout=60)
        assert isinstance(r, Shed) and "DEAD" in r.detail
        assert eng.stats()["routing"]["shed_all_dead"] == 1


def test_admission_divisor_matches_reference():
    """The same EWMA, inflight and divisor sequence gives the JAX
    controller's estimate exactly; the divisor divides the exec term
    only.  Control: a divisor forced to 1 misses the 4-replica
    estimate."""
    port = AdmissionController(max_wait_ms=2.0)
    ref = JaxAdmission(max_wait_ms=2.0)
    for secs, bucket in ((0.1, 8), (0.05, 8), (0.3, 32), (0.02, 1)):
        port.observe_exec(secs, bucket=bucket)
        ref.observe_exec(secs, bucket=bucket)
    state = {"free": 0}
    for divisor in (1, 4, 0, 3, lambda: state["free"]):
        port.set_free_replicas(divisor)
        ref.set_free_replicas(divisor)
        for free in (0, 2, 5):
            state["free"] = free
            for bucket in (1, 8, 32, 16, None):
                for inflight in (0, 1, 3):
                    assert port.estimated_service_s(bucket, inflight) \
                        == ref.estimated_service_s(bucket, inflight)
    port.set_free_replicas(4)
    ref.set_free_replicas(4)
    port.set_live_replicas(lambda: 5)
    ref.set_live_replicas(lambda: 5)
    est = port.estimated_service_s(8, 3)
    assert est == pytest.approx(2e-3 + 4 * port.bucket_ewma_s(8) / 4)
    ps, rs = port.stats(), ref.stats()
    for key in ("free_replicas", "live_replicas",
                "exec_ewma_ms_by_bucket", "exec_ewma_ms"):
        assert ps[key] == rs[key], key
    port.set_free_replicas(1)
    assert port.estimated_service_s(8, 3) != est


def test_engine_wires_the_divisors(lenet):
    _, sm = lenet
    eng = ReplicatedEngine(sm, devices=[CPU] * 3, buckets=[4])
    st = eng.admission.stats()
    assert (st["free_replicas"], st["live_replicas"]) == (3, 3)
    eng.replicas[2].health.force_dead("test kill")
    st = eng.admission.stats()
    assert (st["free_replicas"], st["live_replicas"]) == (2, 3)


def test_for_device_view_leaves_base_untouched(lenet):
    """A view owns its own copy of the weights (equal values, other
    storage), answers like the base, and releasing or changing it
    leaves the base as it was."""
    _, sm = lenet
    before = {k: v.clone() for k, v in sm._model.state_dict().items()}
    view = sm.for_device("cpu")
    assert view._model is not sm._model
    for (k, a), b in zip(sm._model.state_dict().items(),
                         view._model.state_dict().values()):
        assert torch.equal(a, b), k
        assert a.data_ptr() != b.data_ptr(), k
    x = images(2)
    assert np.array_equal(view.compile_bucket(2)(x).numpy(),
                          sm.compile_bucket(2)(x).numpy())
    assert view.placement_desc() == "cpu"
    with torch.no_grad():
        next(view._model.parameters()).add_(1.0)
    view.release_device_weights()
    assert not view._resident and sm._resident
    assert sm.device == torch.device("cpu")
    for k, v in sm._model.state_dict().items():
        assert torch.equal(v, before[k]), k


def test_replica_mode_engine():
    """external_batcher=True: no batcher thread, warmup refused (the
    router warms replicas), dispatch_cohort serves a formed cohort, and
    a fast-failed window is offered to ``rescue`` first; a rescue that
    raises does not take the watchdog down."""
    sm = port_lenet(lenet_variables(0))
    offered = []

    def rescue(pending, err):
        offered.append((len(pending), type(err).__name__))
        if len(offered) == 1:
            for r in pending:
                r.future.set_result("rescued")
            return True
        raise RuntimeError("rescue broke")

    eng = BatchingEngine(sm, buckets=[4], external_batcher=True,
                         rescue=rescue, exec_timeout_min_s=0.2,
                         watchdog_interval_s=0.02,
                         faults=FaultPlane("d2h:hang:hang_s=30"))
    with eng:
        h = eng.health_report()
        assert h["batcher_alive"] is None and eng._thread is None
        with pytest.raises(RuntimeError, match="ReplicatedEngine.warmup"):
            eng.warmup()
        def cohort(n):
            return [_Request(x, None, 0.0, Future()) for x in images(n)]

        first = cohort(3)
        eng.dispatch_cohort(first)
        assert [r.future.result(30) for r in first] == ["rescued"] * 3
        second = cohort(2)
        eng.dispatch_cohort(second)
        for r in second:
            with pytest.raises(TimeoutError):
                r.future.result(30)
        assert eng._watchdog.is_alive()
        assert 0.0 <= eng.occupancy() <= 1.0
    assert offered == [(3, "TimeoutError"), (2, "TimeoutError")]


def _record_warms(eng):
    """Wrap every replica's run_warm to record (replica, bucket, thread
    name) of each warm."""
    calls = []
    lock = threading.Lock()

    def wrap(i, rep):
        inner = rep.run_warm

        def run_warm(warm):
            with lock:
                calls.append((i, warm.bucket,
                              threading.current_thread().name))
            inner(warm)
        rep.run_warm = run_warm

    for i, rep in enumerate(eng.replicas):
        wrap(i, rep)
    return calls, wrap


def test_warmup_runs_on_the_router_and_again_after_restart(lenet):
    """Warmup, an added replica's warmup and a restarted router's
    re-warm all run on the router thread, before it routes traffic."""
    _, sm = lenet
    eng = ReplicatedEngine(sm, devices=[CPU] * 2, buckets=[2, 4],
                           max_wait_ms=1.0, watchdog_interval_s=0.02,
                           faults=FaultPlane("batcher:die:after=40:times=1"))
    calls, wrap = _record_warms(eng)
    with eng:
        first_router = eng._thread
        eng.warmup()
        assert sorted((i, b) for i, b, _ in calls) == \
            [(0, 2), (0, 4), (1, 2), (1, 4)]
        assert {t for _, _, t in calls} == {first_router.name}
        # the injected death after 40 loop turns: the supervisor
        # restarts the router, whose first act is a re-warm
        t_end = time.monotonic() + 30
        while eng._thread is first_router and time.monotonic() < t_end:
            time.sleep(0.01)
        assert eng._thread is not first_router
        assert isinstance(eng.infer(images(1)[0], timeout=60), np.ndarray)
        again = calls[4:]
        assert sorted((i, b) for i, b, _ in again) == \
            [(0, 2), (0, 4), (1, 2), (1, 4)]
        assert eng.health_report()["watchdog_restarts"] >= 1
        # an added replica is warmed by the router before it is routable
        n = len(calls)
        orig = ReplicatedEngine._build_replica

        def build(self, i, dev):
            rep = orig(self, i, dev)
            wrap(i, rep)
            return rep
        eng._build_replica = build.__get__(eng)
        i = eng.add_replica(CPU)
        assert sorted((j, b) for j, b, _ in calls[n:]) == [(i, 2), (i, 4)]
        assert all(t.startswith("router-") for _, _, t in calls[n:])
        assert eng._free_replicas() == 3
