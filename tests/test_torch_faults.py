"""The port's fault plane and supervised engine on the CPU, against the
JAX package (mirrors tests/test_faults.py case by case).

The fault plane must fire exactly as the reference's for the same spec
and seed.  The engine runs LeNet-5 at full width on seeded weights
shared with the reference's serving model: a poisoned request is
quarantined at the same index as in the JAX engine, each innocent answer
lies within 1e-4·max|ref| of the JAX engine's and equals, bit for bit,
the port's own direct call on the same sub-cohort at the bucket the
retry ran at (the port bisects at the smaller buckets).  Then the
recovery contracts: transient failures retried to success, healthz
200 → 503 → 200, a killed batcher or drainer restarted, the restart
budget going sticky DEAD, a hung batch failed at its exec timeout,
lifecycle misuse failing fast, the drain deadline, and 413."""

import dataclasses
import json
import time

import numpy as np
import pytest

from _torch_serve import (
    get,
    images,
    jax_lenet,
    lenet_variables,
    port_lenet,
    post,
)
from deep_vision_tpu.serve import faults as jfaults
from deep_vision_tpu.serve.engine import BatchingEngine as JaxEngine
from deep_vision_tpu_torch.serve import faults as pfaults
from deep_vision_tpu_torch.serve.admission import Shed
from deep_vision_tpu_torch.serve.engine import BatchingEngine
from deep_vision_tpu_torch.serve.faults import (
    FaultPlane,
    Quarantined,
    parse_faults,
)
from deep_vision_tpu_torch.serve.http import ServeServer
from deep_vision_tpu_torch.serve.registry import ModelRegistry

pytestmark = [pytest.mark.serve, pytest.mark.chaos]

#: innocents vs the JAX engine's answers (float32 compute)
BOUND = 1e-4


@pytest.fixture(scope="module")
def lenet():
    variables = lenet_variables()
    return jax_lenet(variables), port_lenet(variables)


def _wait_until(cond, timeout=10.0, interval=0.005):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(interval)
    return cond()


# -- the fault plane ---------------------------------------------------------

PARSE_SPECS = [
    "compute:poison:nth=3;d2h:latency:delay_ms=20;"
    "batcher:die:times=1:after=2",
    "gateway:blackhole:hang_s=0.5;gateway:conn_reset:p=0.25",
    "staging:nan:p=0.5:times=3;dispatch:hang:hang_s=4",
    "", " ; ",
]
BAD_SPECS = ["compute", "nowhere:exception", "compute:explode",
             "compute:exception:bogus=1", "compute:exception:times"]


@pytest.mark.parametrize("spec", PARSE_SPECS)
def test_parse_faults_matches_reference(spec):
    assert [dataclasses.asdict(f) for f in parse_faults(spec)] == \
        [dataclasses.asdict(f) for f in jfaults.parse_faults(spec)]


@pytest.mark.parametrize("spec", BAD_SPECS)
def test_parse_faults_refuses_like_reference(spec):
    with pytest.raises(ValueError) as want:
        jfaults.parse_faults(spec)
    with pytest.raises(ValueError) as got:
        parse_faults(spec)
    assert str(got.value) == str(want.value)


#: specs over every mode, with p, after, times and nth; hangs and
#: blackholes are pre-cancelled and delays 0 so the sequence runs fast
FIRING_SPECS = [
    "compute:exception:p=0.5",
    "compute:exception:p=0.3:after=5:times=7",
    "d2h:nan:p=0.6;d2h:latency:delay_ms=0:p=0.5",
    "batcher:die:after=3:times=2;staging:exception:p=0.2",
    "dispatch:hang:hang_s=5:p=0.4;gateway:blackhole:hang_s=5:times=3",
    "gateway:conn_reset:p=0.7;gateway:slow_drip:delay_ms=0",
    "compute:poison:nth=2;compute:poison:nth=9;compute:exception:times=2",
]


def _firing(mod, spec, seed):
    plane = mod.FaultPlane(spec, seed)
    plane.cancel.set()  # injected hangs return at once
    seq = []
    for i in range(96):
        seq.append(("poison", plane.mark_poison()))
        stage = mod.STAGES[i % len(mod.STAGES)]
        try:
            seq.append((stage, plane.inject(stage)))
        except (mod.InjectedFault, mod.KillThread, ConnectionResetError,
                TimeoutError) as e:
            seq.append((stage, type(e).__name__))
    return seq, plane.stats()


@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("spec", FIRING_SPECS)
def test_fault_plane_fires_like_reference(spec, seed):
    got, got_stats = _firing(pfaults, spec, seed)
    want, want_stats = _firing(jfaults, spec, seed)
    assert got == want
    assert got_stats == want_stats
    assert any(v not in (None, False) for _, v in got)  # something fired


def test_fault_plane_disabled_is_inert():
    plane = FaultPlane("")
    assert not plane.enabled
    assert plane.inject("compute") is None
    assert plane.mark_poison() is False


def test_fault_plane_from_env():
    plane = FaultPlane.from_env({"DVT_SERVE_FAULTS": "compute:nan",
                                 "DVT_SERVE_FAULT_SEED": "5"})
    assert plane.enabled and plane.seed == 5 and plane.spec == "compute:nan"


# -- bisect-retry ------------------------------------------------------------


def _served_cohorts(idx, poison):
    """The sub-cohorts bisect-retry serves when ``idx`` failed and
    ``poison`` is the only bad request (the engine's ``_isolate``)."""
    mid, out = len(idx) // 2, []
    for sub in (idx[:mid], idx[mid:]):
        if poison not in sub:
            out.append(sub)
        elif len(sub) > 1:
            out += _served_cohorts(sub, poison)
    return out


def _direct(psm, imgs, cohort, buckets):
    bucket = next(b for b in buckets if b >= len(cohort))
    x = np.zeros((bucket, *psm.input_shape), psm.wire_dtype)
    x[:len(cohort)] = imgs[cohort]
    return psm.compile_bucket(bucket)(x).numpy()[:len(cohort)]


def test_poison_quarantined_like_reference(lenet):
    """A cohort of 8 with request 3 poisoned: both engines quarantine
    exactly request 3 and serve the other 7."""
    jsm, psm = lenet
    imgs = images(8)
    with JaxEngine(jsm, buckets=[8], max_wait_ms=250,
                   faults=jfaults.FaultPlane("compute:poison:nth=3"),
                   retry_backoff_ms=0) as jeng:
        want = [f.result(60) for f in [jeng.submit(im) for im in imgs]]
    buckets = [1, 2, 4, 8]
    with BatchingEngine(psm, buckets=buckets, max_wait_ms=250,
                        faults=FaultPlane("compute:poison:nth=3"),
                        retry_backoff_ms=0) as eng:
        got = [f.result(60) for f in [eng.submit(im) for im in imgs]]
        report = eng.health_report()
    assert isinstance(want[3], jfaults.Quarantined)
    assert isinstance(got[3], Quarantined) and got[3].reason == "poison"
    assert not got[3]  # falsy, like Shed
    ref = np.stack([want[i] for i in range(8) if i != 3])
    mine = np.stack([got[i] for i in range(8) if i != 3])
    np.testing.assert_allclose(mine, ref, rtol=0,
                               atol=BOUND * np.abs(ref).max())
    cohorts = _served_cohorts(list(range(8)), 3)
    assert cohorts == [[0, 1], [2], [4, 5, 6, 7]]
    for cohort in cohorts:
        direct = _direct(psm, imgs, cohort, buckets)
        for row, i in zip(direct, cohort):
            assert np.array_equal(got[i], row), i
    assert eng.quarantined == 1 == report["quarantined"]
    assert eng.batch_failures == 1  # ONE original cohort failure
    assert eng.retry_executions >= 3
    assert eng.served == 7
    # the served retries are the engine's executed batches, at the
    # smaller buckets they fit
    st = eng.stats()
    assert st["batches"] == len(cohorts)
    assert sorted(st["pipeline"]["d2h_bytes_by_bucket"]) == [1, 2, 4]


@pytest.mark.parametrize("spec,retries", [
    ("compute:exception:times=1", 2),
    ("d2h:nan:times=1", 2),  # NaN output → validation → isolation
])
def test_transient_failure_retried_to_success(lenet, spec, retries):
    _, psm = lenet
    imgs = images(4, seed=1)
    with BatchingEngine(psm, buckets=[1, 2, 4], max_wait_ms=250,
                        faults=FaultPlane(spec), retry_backoff_ms=0) as eng:
        results = [f.result(60) for f in [eng.submit(im) for im in imgs]]
        report = eng.health_report()
    for cohort in ([0, 1], [2, 3]):
        for row, i in zip(_direct(psm, imgs, cohort, [1, 2, 4]), cohort):
            assert np.array_equal(results[i], row), i
    assert eng.batch_failures == 1
    assert eng.retry_executions == retries
    assert eng.quarantined == 0
    assert report["state"] == "ok"
    stage_mode = spec.rsplit(":", 1)[0]
    assert report["faults"]["injected"] == {stage_mode: 1}


def test_retry_budget_exhaustion_quarantines(lenet):
    """A budget of one retry execution: the poisoned half spends it and
    fails, so every request still unserved is quarantined with reason
    ``retry_budget`` (the reference's ``_isolate`` order)."""
    _, psm = lenet
    with BatchingEngine(psm, buckets=[1, 2, 4], max_wait_ms=250,
                        faults=FaultPlane("compute:poison:nth=0"),
                        retry_budget=1, retry_backoff_ms=0) as eng:
        results = [f.result(60)
                   for f in [eng.submit(im) for im in images(4)]]
    assert all(isinstance(r, Quarantined) and r.reason == "retry_budget"
               for r in results)
    assert eng.quarantined == 4 and eng.retry_executions == 1


# -- deep health over HTTP ---------------------------------------------------


def test_healthz_flips_200_503_200(lenet):
    _, psm = lenet
    reg = ModelRegistry()
    reg.add(psm)
    eng = BatchingEngine(psm, buckets=[1], max_wait_ms=1,
                         faults=FaultPlane("compute:exception:times=1"),
                         degraded_after=1, singleton_retries=0,
                         retry_backoff_ms=0).start()
    srv = ServeServer(reg, {psm.name: eng}).start_background()
    body = {"pixels": np.zeros((32, 32, 1)).tolist()}
    try:
        status, payload = get(srv.port, "/v1/healthz")
        assert status == 200 and payload["status"] == "ok"
        # singleton_retries=0: the failure quarantines the lone request
        # (500) and leaves the engine DEGRADED
        status, reply, _ = post(srv.port, "/v1/classify", body)
        assert status == 500 and "quarantined" in reply["error"]
        status, payload = get(srv.port, "/v1/healthz")
        assert status == 503
        rep = payload["engines"]["lenet5"]
        assert rep["state"] == "degraded" and rep["quarantined"] == 1
        assert post(srv.port, "/v1/classify", body)[0] == 200
        status, payload = get(srv.port, "/v1/healthz")
        assert status == 200
        assert payload["engines"]["lenet5"]["state"] == "ok"
    finally:
        srv.shutdown()
        eng.stop()


# -- watchdog supervision ----------------------------------------------------


def test_batcher_killed_then_restarted(lenet):
    _, psm = lenet
    with BatchingEngine(psm, buckets=[1], max_wait_ms=1,
                        faults=FaultPlane("batcher:die:times=1"),
                        watchdog_interval_s=0.01) as eng:
        assert _wait_until(lambda: eng.health.watchdog_restarts >= 1), \
            "watchdog never restarted the dead batcher"
        result = eng.infer(images(1)[0], timeout=60)
        assert isinstance(result, np.ndarray)
        report = eng.health_report()
    assert report["watchdog_restarts"] >= 1
    assert report["batcher_alive"]
    assert report["state"] == "ok"
    assert report["faults"]["injected"] == {"batcher:die": 1}


def test_drainer_killed_mid_batch_frees_its_slot(lenet):
    """``d2h:die`` kills the drainer while it holds a batch: the batch's
    futures fail, its in-flight slot and staging buffer go back, the
    watchdog restarts the drainer, and traffic resumes."""
    _, psm = lenet
    with BatchingEngine(psm, buckets=[1], max_wait_ms=1, pipeline_depth=2,
                        faults=FaultPlane("d2h:die:times=1"),
                        watchdog_interval_s=0.01) as eng:
        fut = eng.submit(images(1)[0])
        with pytest.raises(RuntimeError, match="drainer"):
            fut.result(30)
        assert _wait_until(lambda: eng.health.watchdog_restarts >= 1)
        for im in images(4):  # more batches than in-flight slots
            assert isinstance(eng.infer(im, timeout=60), np.ndarray)
        # the drainer frees a batch's slot just after resolving its
        # futures, so the last slot may still be held when infer returns
        assert _wait_until(lambda: eng.health_report()["inflight"] == 0)
        report = eng.health_report()
    assert report["drainer_alive"] and report["inflight"] == 0


def test_restart_budget_exhaustion_is_sticky_dead(lenet):
    _, psm = lenet
    with BatchingEngine(psm, buckets=[1], max_wait_ms=1,
                        faults=FaultPlane("batcher:die"),
                        watchdog_interval_s=0.01, restart_budget=2) as eng:
        assert _wait_until(lambda: eng.health.state == "dead"), \
            "restart-budget exhaustion never forced DEAD"
        report = eng.health_report()
        assert report["watchdog_restarts"] == 2
        assert "restart budget" in report["dead_reason"]
        eng.health.record_success()  # traffic cannot revive it
        assert eng.health.state == "dead"


def test_hang_is_fast_failed_at_exec_timeout(lenet):
    _, psm = lenet
    img = images(1)[0]
    with BatchingEngine(psm, buckets=[1], max_wait_ms=1, pipeline_depth=2,
                        faults=FaultPlane("d2h:hang:hang_s=30:times=1"),
                        watchdog_interval_s=0.02,
                        exec_timeout_min_s=0.2) as eng:
        assert eng.exec_timeout_s(1) == 0.2  # no EWMA yet: the floor
        t0 = time.monotonic()
        fut = eng.submit(img)
        with pytest.raises(TimeoutError):
            fut.result(20)
        assert time.monotonic() - t0 < 5.0  # far under the 30 s hang
        assert eng.exec_timeouts == 1
        result = eng.infer(img, timeout=60)
        assert isinstance(result, np.ndarray)
        assert eng.health_report()["state"] == "ok"


# -- lifecycle ---------------------------------------------------------------


def test_submit_outside_lifecycle_fails_fast(lenet):
    _, psm = lenet
    img = images(1)[0]
    eng = BatchingEngine(psm, buckets=[1])
    before = eng.submit(img).result(1)
    assert isinstance(before, Shed) and before.reason == "shutdown"
    eng.start()
    assert isinstance(eng.infer(img, timeout=60), np.ndarray)
    eng.stop()
    after = eng.submit(img).result(1)
    assert isinstance(after, Shed) and after.reason == "shutdown"
    assert eng.shed_shutdown == 2


def test_warmup_needs_a_started_engine(lenet):
    """Warmup runs on the batcher thread, where traffic runs: an engine
    not yet started, or stopped, refuses it."""
    _, psm = lenet
    eng = BatchingEngine(psm, buckets=[1, 2])
    with pytest.raises(RuntimeError, match="started engine"):
        eng.warmup()
    eng.start()
    eng.warmup()
    assert sorted(eng._executables) == [1, 2] and eng.compiles == 2
    eng.stop()
    with pytest.raises(RuntimeError, match="started engine"):
        eng.warmup()


def test_stop_drain_deadline_finishes_admitted_work(lenet):
    _, psm = lenet
    eng = BatchingEngine(psm, buckets=[4], max_wait_ms=20).start()
    eng.warmup()
    futures = [eng.submit(im) for im in images(4)]
    eng.stop(drain_deadline=30.0)
    results = [f.result(1) for f in futures]
    assert all(isinstance(r, np.ndarray) for r in results)
    assert eng.served == 4


def test_oversized_body_rejected_413(lenet):
    _, psm = lenet
    reg = ModelRegistry()
    reg.add(psm)
    eng = BatchingEngine(psm, buckets=[1], max_wait_ms=1).start()
    srv = ServeServer(reg, {psm.name: eng},
                      max_body_bytes=1024).start_background()
    try:
        raw = b'{"pixels": [' + b"0," * 4096 + b"0]}"
        status, reply, _ = post(srv.port, "/v1/classify", None, raw=raw)
        assert status == 413 and "1024-byte cap" in reply["error"]
        assert get(srv.port, "/v1/healthz")[0] == 200
        assert eng.served == 0
    finally:
        srv.shutdown()
        eng.stop()


def test_decode_fault_answers_500_and_stats_show_it(lenet):
    _, psm = lenet
    reg = ModelRegistry()
    reg.add(psm)
    eng = BatchingEngine(psm, buckets=[1], max_wait_ms=1,
                         faults=FaultPlane("decode:exception:times=1"))
    eng.start()
    srv = ServeServer(reg, {psm.name: eng}).start_background()
    body = {"pixels": images(1)[0].tolist()}
    try:
        status, reply, _ = post(srv.port, "/v1/classify", body)
        assert status == 500 and "injected decode" in reply["error"]
        assert post(srv.port, "/v1/classify", body)[0] == 200
        status, payload = get(srv.port, "/v1/healthz")
        assert json.dumps(payload["engines"]["lenet5"]["faults"]) == \
            json.dumps({"spec": "decode:exception:times=1", "seed": 0,
                        "injected": {"decode:exception": 1}})
    finally:
        srv.shutdown()
        eng.stop()
