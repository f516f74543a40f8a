"""The port's continuous-deploy pipeline on the CPU (counterpart of
tests/test_deploy.py): the checkpoint fingerprint skips the port
``Checkpointer``'s staging directories as the reference's does, the
deployment ledger is the reference's format both ways, the accuracy
gate's verdicts equal the JAX ``AccuracyGate``'s on the same weights
and gate directory, the watcher debounces, acts once and keeps the
active version serving through a gate failure (the same status sequence
as the JAX watcher), revert restores the previous version under load,
the autoscaler's actions equal the JAX ``ReplicaAutoscaler``'s on the
same forced signals and clock, and a real CPU fleet scales up and back
down without dropping a request.

LeNet-5 at full width with seeded weights shared with the JAX serving
model, float32.  Gate tolerance: predictions are compared on the rows
whose top-1 margin exceeds 1e-4 × max|logit| (the port's LeNet-5
serving parity bound); every seeded row here clears it, so agreement
and accuracy must be equal, not close."""

import copy
import os
import queue
import threading
import time
import types

import numpy as np
import pytest
import torch

import _torch_zoo as tz
from _torch_serve import (
    images,
    jax_lenet,
    lenet_model,
    lenet_variables,
    port_lenet,
    write_step,
)
from deep_vision_tpu.core.restore import (
    checkpoint_fingerprint as jax_fingerprint,
)
from deep_vision_tpu.deploy import AccuracyGate as JaxGate
from deep_vision_tpu.deploy import CheckpointWatcher as JaxWatcher
from deep_vision_tpu.deploy import DeploymentHistory as JaxHistory
from deep_vision_tpu.deploy import ReplicaAutoscaler as JaxScaler
from deep_vision_tpu.serve.engine import BatchingEngine as JaxEngine
from deep_vision_tpu.serve.models import CanaryPolicy as JaxPolicy
from deep_vision_tpu.serve.models import ModelControlPlane as JaxPlane
from deep_vision_tpu.serve.models import WeightCache as JaxCache
from deep_vision_tpu.serve.registry import ModelRegistry as JaxRegistry
from deep_vision_tpu_torch.core.restore import checkpoint_fingerprint
from deep_vision_tpu_torch.deploy import (
    AccuracyGate,
    CheckpointWatcher,
    DeploymentHistory,
    DeployPipeline,
    ReplicaAutoscaler,
)
from deep_vision_tpu_torch.serve.admission import AdmissionController, Shed
from deep_vision_tpu_torch.serve.engine import BatchingEngine
from deep_vision_tpu_torch.serve.models import (
    ACTIVE,
    RETIRED,
    CanaryPolicy,
    ModelControlPlane,
    WeightCache,
)
from deep_vision_tpu_torch.serve.registry import (
    CheckpointServingModel,
    ModelRegistry,
)
from deep_vision_tpu_torch.serve.replicas import ReplicatedEngine

pytestmark = pytest.mark.deploy

BOUND = 1e-4
CPU = torch.device("cpu")


def _engine_factory(model):
    return BatchingEngine(model, buckets=[4], max_wait_ms=2)


def _policy(cls):
    return cls(canary_frac=0.5, min_requests=3, max_p99_ratio=None,
               phase_timeout_s=15.0)


def _scaled(variables, fn):
    """``variables`` with ``fn`` applied to every params leaf."""
    out = copy.deepcopy(variables)

    def walk(d):
        for k, v in d.items():
            if isinstance(v, dict):
                walk(v)
            else:
                d[k] = np.asarray(fn(np.asarray(v)), np.float32)
    walk(out["params"])
    return out


def _port_clone(sm, fn=None, step=None):
    """A new port ServingModel over ``sm``'s weights (``fn``-ed): the
    watcher loader seam's "new checkpoint"."""
    if fn is None:
        model = copy.deepcopy(sm._model)
    else:
        model = tz.port("lenet5", _scaled(lenet_variables(0), fn))
    new = CheckpointServingModel(sm.name, sm.cfg, model, device="cpu")
    new.restored_step = step if step is not None \
        else (sm.restored_step or 0) + 1
    new.params_digest = sm.params_digest
    return new


@pytest.fixture()
def lenet_plane(tmp_path):
    reg = ModelRegistry()
    workdir = str(tmp_path / "lenet5")
    sm = reg.add(port_lenet(lenet_variables(0)))
    plane = ModelControlPlane(reg, _engine_factory,
                              cache=WeightCache(budget_bytes=0),
                              policy=_policy(CanaryPolicy))
    plane.deploy(sm, workdir=workdir)
    yield reg, sm, plane, workdir
    plane.stop()


class _LoadThread(threading.Thread):
    """Closed-loop client keeping every failure (zero-lost contract)."""

    def __init__(self, plane, name, img):
        super().__init__(daemon=True)
        self.plane, self.name, self.img = plane, name, img
        self.stop_flag = threading.Event()
        self.served = 0
        self.errors: list = []

    def run(self):
        while not self.stop_flag.is_set():
            try:
                r = self.plane.infer(self.name, self.img, timeout=30)
            except Exception as e:  # noqa: BLE001 — every failure is a lost request
                self.errors.append(repr(e))
                continue
            if isinstance(r, Shed):
                self.errors.append(repr(r))
                continue
            self.served += 1

    def finish(self):
        self.stop_flag.set()
        self.join(30)
        assert not self.is_alive()


# -- checkpoint fingerprint --------------------------------------------------


def test_fingerprint_skips_checkpointer_staging(tmp_path):
    """A step the port's Checkpointer is still writing (its ``.<step>-``
    staging directory) and an empty step directory leave the fingerprint
    where it was, in both packages; the finished step moves it."""
    workdir = str(tmp_path / "w")
    assert checkpoint_fingerprint(workdir)["step"] is None
    write_step(workdir, 100, lenet_model(0))
    before = checkpoint_fingerprint(workdir)
    assert before["step"] == 100
    assert jax_fingerprint(workdir) == before
    ckdir = os.path.join(workdir, "checkpoints")
    staging = os.path.join(ckdir, ".101-abc123")
    os.makedirs(staging)
    with open(os.path.join(staging, "checkpoint.pt"), "wb") as f:
        f.write(b"partial")
    os.makedirs(os.path.join(ckdir, "102"))  # empty: not durable
    os.makedirs(os.path.join(ckdir, "tmpdir"))
    assert checkpoint_fingerprint(workdir) == before
    assert jax_fingerprint(workdir) == before
    write_step(workdir, 101, lenet_model(1))
    after = checkpoint_fingerprint(workdir)
    assert after["step"] == 101 and jax_fingerprint(workdir) == after
    write_step(workdir, 103, lenet_model(1), sub="checkpoints_best")
    assert checkpoint_fingerprint(workdir)["step"] == 103
    assert jax_fingerprint(workdir) == checkpoint_fingerprint(workdir)


# -- deployment history -------------------------------------------------------


@pytest.mark.parametrize("writer,reader", [(DeploymentHistory, JaxHistory),
                                           (JaxHistory, DeploymentHistory)])
def test_history_ledger_read_back_both_ways(tmp_path, writer, reader):
    """A ledger one package writes (torn tail included) reads back equal
    in the other, retain window and all."""
    root = str(tmp_path / "_deploy")
    h = writer(root, retain=4)
    for i in range(6):
        h.record("lenet5", "candidate", step=i, gate={"passed": True})
    h.record("other", "promoted", version=2)
    assert [e["step"] for e in h.entries("lenet5")] == [2, 3, 4, 5]
    with open(os.path.join(root, "lenet5.jsonl"), "a") as f:
        f.write('{"ts": 1, "model": "lenet5", "outco')
    got, want = reader(root, retain=4), writer(root, retain=4)
    assert got.names() == want.names() == ["lenet5", "other"]
    for name in ("lenet5", "other"):
        assert got.entries(name) == want.entries(name)
        assert got.last_outcome(name) == want.last_outcome(name)
    assert got.entries("lenet5", n=2) == want.entries("lenet5", n=2)
    assert [e["step"] for e in got.entries("lenet5")] == [2, 3, 4, 5]
    assert got.stats()["models"] == want.stats()["models"]
    # the full file keeps all six records of lenet5
    assert len(reader(root, retain=100).entries("lenet5")) == 6


# -- accuracy gate --------------------------------------------------------


def _gate_pair(tmp_path=None, labels=None):
    gate_dir = None
    if tmp_path is not None:
        gate_dir = str(tmp_path / "holdout")
        os.makedirs(gate_dir, exist_ok=True)
        rng = np.random.RandomState(0)
        for i in range(16):
            np.save(os.path.join(gate_dir, f"img_{i:02d}.npy"),
                    rng.randint(0, 256, (32, 32, 1), dtype=np.uint8))
        if labels is not None:
            np.savetxt(os.path.join(gate_dir, "labels.txt"),
                       np.asarray(labels, np.int64), fmt="%d")
    return AccuracyGate(gate_dir=gate_dir), JaxGate(gate_dir=gate_dir)


def _decisive(sm, gate):
    """True where the port model's top-1 margin clears the tolerance."""
    rows = []
    for b in gate._batches(sm):
        logits = sm.compile_bucket(len(b))(gate._wire(sm, b)).numpy()
        top2 = np.sort(logits, axis=-1)[:, -2:]
        rows.append(top2[:, 1] - top2[:, 0]
                    > BOUND * np.abs(logits).max())
    return np.concatenate(rows)


def _same_verdict(port_gate, jax_gate, pair_c, pair_a):
    out = port_gate.evaluate(pair_c[1], pair_a[1])
    ref = jax_gate.evaluate(pair_c[0], pair_a[0])
    assert out["passed"] == ref["passed"], (out, ref)
    for key in ("agreement", "candidate_acc", "active_acc", "delta",
                "images", "gate_dir"):
        assert out.get(key) == ref.get(key), (key, out, ref)
    return out


def _models(fn=None, infer="float32", wire="float32", variables=None):
    v = variables if variables is not None else lenet_variables(0) \
        if fn is None else _scaled(lenet_variables(0), fn)
    return (jax_lenet(v, wire=wire, infer=infer),
            port_lenet(v, wire=wire, infer=infer))


def test_gate_verdicts_equal_reference(tmp_path):
    """Identical weights pass (agreement 1.0), a NaN candidate fails,
    perturbed weights give the same agreement on decisive rows: each
    verdict and metric equal to the JAX gate's."""
    active = _models()
    gate, jgate = _gate_pair()
    assert _decisive(active[1], gate).all()
    out = _same_verdict(gate, jgate, _models(), active)
    assert out["passed"] and out["agreement"] == 1.0
    nan = _same_verdict(gate, jgate, _models(lambda a: a * np.nan), active)
    assert not nan["passed"] and "NaN" in nan["reason"]
    noisy = _models(lambda a: a + 0.02 * np.random.RandomState(
        a.size).randn(*a.shape))
    assert _decisive(noisy[1], gate).all()
    _same_verdict(gate, jgate, noisy, active)
    # a strict floor flips both verdicts together
    strict, jstrict = AccuracyGate(min_agreement=1.01), \
        JaxGate(min_agreement=1.01)
    assert not _same_verdict(strict, jstrict, _models(), active)["passed"]


def test_gate_labeled_accuracy_equals_reference(tmp_path):
    """labels.txt upgrades both gates to accuracy: identical weights pass
    at delta 0, a candidate with every bias reversed (its top-1 moves
    off the labels) fails on the accuracy drop; the labelled gate set is
    the same directory of .npy files both packages load."""
    active = _models()
    gate, _ = _gate_pair(tmp_path)
    preds, nan = gate._predict(active[1], gate._batches(active[1]))
    assert preds is not None and not nan
    gate, jgate = _gate_pair(tmp_path, labels=preds)
    assert _decisive(active[1], gate).all()
    out = _same_verdict(gate, jgate, _models(), active)
    assert out["passed"] and out["candidate_acc"] == 1.0 \
        and out["delta"] == 0.0
    moved = _same_verdict(gate, jgate, _models(
        lambda a: a[::-1] if a.ndim == 1 else a), active)
    assert moved["candidate_acc"] < 1.0
    assert not moved["passed"] and "dropped" in moved["reason"]


def test_gate_int8_nan_is_the_recorded_departure():
    """int8 on the uint8 wire, one NaN in the first conv's weight: the
    reference's quantizer turns the NaN channel into finite codes, so its
    gate passes the candidate (top-1 unchanged); the port's keeps the NaN
    and its gate fails it.  At float32 the two agree (above), and a NaN
    bias fails both."""
    v = copy.deepcopy(lenet_variables(0))
    v["params"]["Conv_0"]["kernel"].flat[0] = np.nan
    nan = _models(infer="int8", wire="uint8", variables=v)
    active = _models(infer="int8", wire="uint8")
    out = AccuracyGate().evaluate(nan[1], active[1])
    ref = JaxGate().evaluate(nan[0], active[0])
    assert not out["passed"] and "NaN" in out["reason"]
    assert ref["passed"]
    bias = _models(lambda a: a * np.nan if a.ndim == 1 else a,
                   infer="int8", wire="uint8")
    assert not AccuracyGate().evaluate(bias[1], active[1])["passed"]
    assert not JaxGate().evaluate(bias[0], active[0])["passed"]


# -- checkpoint watcher ------------------------------------------------------


def _fake_steps(workdir, step, mtime):
    """Step ``step`` as the port's trainer writes it, its directory's
    mtime forced (the fingerprint reads filesystem metadata only)."""
    d = write_step(workdir, step, lenet_model(0))
    os.utime(d, (mtime, mtime))


@pytest.fixture()
def jax_plane(tmp_path):
    reg = JaxRegistry()
    workdir = str(tmp_path / "jax_lenet5")
    sm = reg.add(jax_lenet(lenet_variables(0)))
    plane = JaxPlane(reg, lambda m: JaxEngine(m, buckets=[4],
                                              max_wait_ms=2),
                     cache=JaxCache(budget_bytes=0), policy=_policy(JaxPolicy))
    plane.deploy(sm, workdir=workdir)
    yield sm, plane, workdir
    plane.stop()


def _jax_clone(sm, fn=None):
    v = lenet_variables(0) if fn is None else _scaled(lenet_variables(0), fn)
    new = jax_lenet(v)
    new.restored_step = (sm.restored_step or 0) + 1
    return new


def _drive(watcher, workdir, script):
    """Run ``script`` (("step", step, mtime) or ("poll",)) and return the
    poll statuses."""
    out = []
    for item in script:
        if item[0] == "step":
            _fake_steps(workdir, item[1], item[2])
        else:
            out.append(watcher.poll_once("lenet5")["status"])
    return out


SCRIPT = [("poll",), ("step", 5, 1000.0), ("poll",), ("step", 5, 1001.0),
          ("poll",), ("step", 5, 1002.0), ("poll",), ("poll",), ("poll",)]


@pytest.mark.parametrize("gate_nan", [False, True])
def test_watcher_statuses_equal_reference(lenet_plane, jax_plane, gate_nan):
    """The same checkpoint script through both watchers: a fingerprint
    that moves between polls never graduates past debounce, a stable one
    is decided exactly once, a gate failure keeps the active version;
    both ledgers hold the same outcomes."""
    _, sm, plane, workdir = lenet_plane
    jsm, jplane, jworkdir = jax_plane
    fn = (lambda a: a * np.nan) if gate_nan else None
    w = CheckpointWatcher(plane, DeploymentHistory(), interval_s=0.05,
                          gate=AccuracyGate(),
                          loader=lambda p, n: _port_clone(sm, fn))
    jw = JaxWatcher(jplane, JaxHistory(), interval_s=0.05, gate=JaxGate(),
                    loader=lambda p, n: _jax_clone(jsm, fn))
    active = plane.active_version("lenet5")
    runs = []
    for p, watcher, wd in ((plane, w, workdir), (jplane, jw, jworkdir)):
        load = _LoadThread(p, "lenet5", images(1)[0])
        load.start()
        try:
            runs.append(_drive(watcher.watch("lenet5"), wd, SCRIPT))
        finally:
            load.finish()
        assert load.errors == [] and load.served > 0
    got, want = runs
    final = "gate_failed" if gate_nan else "promoted"
    assert got == want == ["no_checkpoint", "debounce", "debounce",
                           "debounce", final, "acted"]
    outcomes = [e["outcome"] for e in w.history.entries("lenet5")]
    assert outcomes == [e["outcome"] for e in jw.history.entries("lenet5")]
    assert outcomes == ["candidate", "gate_failed" if gate_nan
                        else "gate_passed"] + ([] if gate_nan
                                               else ["promoted"])
    st, jst = w.stats(), jw.stats()
    for key in ("polls", "debounces", "deploys", "gate_failures"):
        assert st[key] == jst[key], key
    if gate_nan:
        assert plane.active_version("lenet5") is active
        assert isinstance(plane.infer("lenet5", images(1)[0]), np.ndarray)
    else:
        assert plane.active_version("lenet5").version == 2


def test_watcher_restores_a_real_checkpoint(lenet_plane):
    """Without the loader seam: the candidate comes from the workdir by
    the reload restore path, passes the gate and is promoted; the next
    poll answers current."""
    _, sm, plane, workdir = lenet_plane
    w = CheckpointWatcher(plane, DeploymentHistory(), interval_s=0.05,
                          gate=AccuracyGate()).watch("lenet5")
    write_step(workdir, 7, lenet_model(0))
    assert w.poll_once("lenet5")["status"] == "debounce"
    load = _LoadThread(plane, "lenet5", images(1)[0])
    load.start()
    try:
        out = w.poll_once("lenet5")
    finally:
        load.finish()
    assert load.errors == []
    assert out["status"] == "promoted" and out["step"] == 7
    mv = plane.active_version("lenet5")
    assert mv.model.restored_step == 7
    assert w.poll_once("lenet5")["status"] == "current"
    x = images(4)
    assert np.array_equal(mv.model.compile_bucket(4)(x).numpy(),
                          sm.compile_bucket(4)(x).numpy())


def test_watcher_threads_poll_and_stop(lenet_plane):
    _, sm, plane, workdir = lenet_plane
    w = CheckpointWatcher(plane, DeploymentHistory(), interval_s=0.02,
                          loader=lambda p, n: _port_clone(sm))
    w.watch("lenet5").start()
    load = _LoadThread(plane, "lenet5", images(1)[0])
    load.start()
    try:
        _fake_steps(workdir, 3, 500.0)
        t_end = time.monotonic() + 30
        while w.stats()["deploys"] < 1 and time.monotonic() < t_end:
            time.sleep(0.02)
    finally:
        w.stop()
        load.finish()
    assert w.stats()["deploys"] == 1
    assert not any(t.is_alive() for t in w._threads.values())


# -- revert ----------------------------------------------------------------


def test_revert_under_load_restores_previous_version(lenet_plane):
    _, sm, plane, _ = lenet_plane
    pipeline = DeployPipeline(plane)
    v1_digest = plane.active_version("lenet5").model.params_digest
    x = images(4)
    v1_answers = sm.compile_bucket(4)(x).numpy()
    load = _LoadThread(plane, "lenet5", images(1)[0])
    load.start()
    try:
        out = plane.reload("lenet5", wait=True, _loader=lambda: _port_clone(
            sm, lambda a: a * 1.5))
        assert out["version"]["state"] == ACTIVE
        rv = pipeline.revert("lenet5")
    finally:
        load.finish()
    assert rv["status"] == "reverted" and rv["from_version"] == 2
    active = plane.active_version("lenet5")
    assert active.version == 3 and active.model.params_digest == v1_digest
    assert np.array_equal(active.model.compile_bucket(4)(x).numpy(),
                          v1_answers)
    assert load.errors == [] and load.served > 0
    assert pipeline.history.last_outcome("lenet5") == "reverted"
    assert plane.models()["lenet5"]["versions"][1]["state"] == RETIRED


def test_revert_refused(lenet_plane):
    _, sm, plane, _ = lenet_plane
    assert DeployPipeline(plane).revert("lenet5")["status"] == "refused"
    with pytest.raises(KeyError):
        DeployPipeline(plane).revert("nope")
    gate = threading.Event()

    def slow_loader():
        gate.wait(10)
        return _port_clone(sm)

    try:
        assert plane.reload("lenet5", _loader=slow_loader)["status"] \
            == "reloading"
        assert plane.revert("lenet5")["status"] == "in_progress"
    finally:
        gate.set()
        plane._reloading["lenet5"].join(30)


def test_pipeline_entries_and_stats(lenet_plane):
    _, _, plane, _ = lenet_plane
    pipeline = DeployPipeline(plane)
    pipeline.history.record("lenet5", "candidate", step=1)
    assert pipeline.entries("lenet5")[-1]["outcome"] == "candidate"
    with pytest.raises(KeyError):
        pipeline.entries("nope")
    assert pipeline.stats()["history"]["records"] == 1


# -- replica autoscaler --------------------------------------------------------


class _FakeEngine:
    """The signals and the two actions the scaler touches, no devices."""

    def __init__(self, live=1, ewma_s=0.01, batchy=False, fail_up=False):
        self._queue: queue.Queue = queue.Queue()
        self.admission = types.SimpleNamespace(
            bucket_ewma_s=lambda: ewma_s)
        slo = types.SimpleNamespace(name="batchy" if batchy else "interactive")
        self.model = types.SimpleNamespace(
            name="fake", workload=types.SimpleNamespace(slo=slo))
        self.live = live
        self.inflight = 0
        self.occ = 0.0
        self.fail_up = fail_up

    def total_inflight(self):
        return self.inflight

    def live_replicas(self):
        return self.live

    def occupancy(self):
        return self.occ

    def add_replica(self):
        if self.fail_up:
            raise ValueError("no free local device")
        self.live += 1
        return self.live - 1

    def remove_replica(self, drain_deadline=5.0):
        self.live -= 1
        return self.live

    def force(self, depth, inflight=0, occ=0.0):
        while self._queue.qsize() < depth:
            self._queue.put(object())
        while self._queue.qsize() > depth:
            self._queue.get_nowait()
        self.inflight, self.occ = inflight, occ


class _Clock:
    def __init__(self):
        self.now = 1000.0

    def monotonic(self):
        return self.now


SIGNALS = ([(10, 0, 0.0)] * 8 + [(1, 0, 0.0)] + [(0, 0, 0.0)] * 14
           + [(10, 2, 0.0)] * 3 + [(0, 1, 0.0)] * 2 + [(0, 0, 0.0)] * 12)


@pytest.mark.parametrize("kind", ["pressure", "batchy", "failing"])
def test_autoscaler_actions_equal_reference(monkeypatch, kind):
    """The same forced signal sequence and clock through both scalers
    gives the same action (and error) sequence: hysteresis windows, the
    cooldown, bounds, the batchy occupancy switch, and a failed action
    consuming the cooldown."""
    import deep_vision_tpu.deploy.autoscale as jax_mod
    import deep_vision_tpu_torch.deploy.autoscale as port_mod

    clock = _Clock()
    monkeypatch.setattr(jax_mod, "time", clock)
    monkeypatch.setattr(port_mod, "time", clock)
    runs = []
    for cls in (ReplicaAutoscaler, JaxScaler):
        eng = _FakeEngine(batchy=kind == "batchy",
                          fail_up=kind == "failing")
        s = cls(eng, min_replicas=1, max_replicas=3, high_water_ms=50.0,
                up_window=3, down_window=4, cooldown_s=5.0)
        clock.now = 1000.0
        seq = []
        for depth, inflight, _ in SIGNALS:
            occ = 0.9 if depth >= 10 else 0.1
            eng.force(0 if kind == "batchy" else depth, inflight, occ)
            act = s.tick()
            seq.append((act["action"], act["live"]) if act else None)
            clock.now += 1.0
        runs.append((seq, s.scale_ups, s.scale_downs, s.scale_errors,
                     eng.live))
    assert runs[0] == runs[1]
    seq, ups, downs, errors, _ = runs[0]
    if kind == "failing":
        assert errors >= 2 and ups == 0
    else:
        assert ups >= 2 and downs >= 1
    # never two actions inside one cooldown
    acted = [i for i, a in enumerate(seq) if a]
    assert all(b - a >= 5 for a, b in zip(acted, acted[1:]))


# -- elastic ReplicatedEngine on CPU replicas ---------------------------------


@pytest.fixture()
def elastic_engine():
    sm = port_lenet(lenet_variables(0))
    eng = ReplicatedEngine(sm, devices=[CPU], buckets=[4], max_wait_ms=2,
                           admission=AdmissionController(max_wait_ms=2))
    eng.start()
    yield eng
    eng.stop()


def test_add_remove_replica_live_accounting(elastic_engine):
    eng = elastic_engine
    assert eng.live_replicas() == 1
    i = eng.add_replica(CPU)
    assert i == 1 and eng.live_replicas() == 2
    assert eng.admission.stats()["live_replicas"] == 2
    assert eng.stats()["routing"]["live_replicas"] == 2
    for x in images(8):
        assert isinstance(eng.infer(x, timeout=30), np.ndarray)
    removed = eng.remove_replica(drain_deadline=10.0)
    assert eng.live_replicas() == 1
    assert eng.admission.stats()["live_replicas"] == 1
    per = eng.stats()["replicas"]
    assert per[removed]["retired"] is True
    assert [p["replica"] for p in per] == [0, 1]
    view = eng.replicas[removed].model
    assert not view._resident  # its weights were released
    assert isinstance(eng.infer(images(1)[0], timeout=30), np.ndarray)
    with pytest.raises(ValueError, match="last live replica"):
        eng.remove_replica()
    assert eng.add_replica(CPU) == 2  # slots are append-only
    with pytest.raises(ValueError, match="not live"):
        eng.remove_replica(removed)
    st = eng.stats()["routing"]
    assert (st["replicas_added"], st["replicas_removed"]) == (2, 1)
    assert st["live_replicas"] == 2 and st["replicas"] == 3


def test_scale_down_drains_inflight_cohorts(elastic_engine):
    eng = elastic_engine
    eng.add_replica(CPU)
    futs = [eng.submit(x) for x in images(24)]
    removed = eng.remove_replica(drain_deadline=10.0)
    for f in futs:
        r = f.result(timeout=30)
        assert isinstance(r, np.ndarray) and np.isfinite(r).all()
    assert eng.stats()["replicas"][removed]["retired"] is True


def test_replica_weights_budgeted_by_the_cache(lenet_plane):
    """Under the plane every replica view's bytes are registered with
    the weight cache at deploy and at add_replica, and given back by
    remove_replica and retirement."""
    reg, _, _, workdir = lenet_plane
    cache = WeightCache(budget_bytes=0)
    plane = ModelControlPlane(
        reg, lambda m: ReplicatedEngine(m, devices=[CPU] * 2, buckets=[4],
                                        max_wait_ms=2),
        cache=cache, policy=_policy(CanaryPolicy))
    sm = port_lenet(lenet_variables(0), name="lenet5_fleet")
    nbytes = sm.param_bytes()
    try:
        plane.deploy(sm, workdir=workdir)
        assert cache.stats()["resident_bytes"] == 3 * nbytes
        eng = plane.active_engine("lenet5_fleet")
        eng.add_replica(CPU)
        assert cache.stats()["resident_bytes"] == 4 * nbytes
        eng.remove_replica(drain_deadline=5.0)
        assert cache.stats()["resident_bytes"] == 3 * nbytes
        load = _LoadThread(plane, "lenet5_fleet", images(1)[0])
        load.start()
        try:
            out = plane.reload("lenet5_fleet", wait=True,
                               _loader=lambda: _port_clone(sm))
        finally:
            load.finish()
        assert out["version"]["state"] == ACTIVE and load.errors == []
        # the retired version's base and both views left the cache
        assert cache.stats()["resident_bytes"] == 3 * nbytes
        old = plane.versions("lenet5_fleet")[0]
        assert all(not r.model._resident for r in old.engine.replicas)
    finally:
        plane.stop()


def test_autoscaler_drives_real_cpu_fleet(elastic_engine):
    """Forced pressure scales the real engine up (the CPU's one device
    stands in for a spare), real idleness scales it back down, and the
    count stays inside [min, max] throughout."""
    eng = elastic_engine
    eng._spare_device = lambda: CPU

    class _Forced(ReplicaAutoscaler):
        forced: dict | None = None

        def signals(self):
            sig = super().signals()
            if self.forced is not None:
                sig.update(self.forced)
            return sig

    s = _Forced(eng, min_replicas=1, max_replicas=2, up_window=2,
                down_window=2, cooldown_s=0.0, high_water_ms=50.0)
    s.forced = {"pressure_ms": 500.0, "queue_depth": 5}
    acts = [s.tick() for _ in range(3)]
    assert [a["action"] for a in acts if a] == ["scale_up"]
    assert eng.live_replicas() == 2
    assert isinstance(eng.infer(images(1)[0], timeout=30), np.ndarray)
    assert s.tick() is None and s.tick() is None  # at max_replicas
    # real signals: queue empty, nothing in flight (a drained batch
    # leaves the window just after its future resolves)
    s.forced = None
    t_end = time.monotonic() + 30
    while eng.total_inflight() and time.monotonic() < t_end:
        time.sleep(0.005)
    acts = [s.tick() for _ in range(4)]
    assert [a["action"] for a in acts if a] == ["scale_down"]
    assert eng.live_replicas() == 1
    assert 1 <= s.stats()["live"] <= 2
    # no spare device: a failed action counts and consumes the cooldown
    del eng._spare_device
    s2 = ReplicaAutoscaler(eng, min_replicas=1, max_replicas=2,
                           up_window=1, cooldown_s=60.0)
    s2.signals = lambda: dict(ReplicaAutoscaler.signals(s2),
                              pressure_ms=500.0)
    assert s2.tick() is None and s2.scale_errors == 1
    assert s2.tick() is None and s2.scale_errors == 1
