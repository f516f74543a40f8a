"""The port's offline batch tier on the CPU, against the JAX package:
``serve/jobs.py`` (``JobStore``) and ``serve/batch_sched.py``
(``BatchScheduler``).

The stores: one scripted sequence (submit, out-of-order
``record_shard``, a double record, ``fail``, a spill past the payload
cache, a torn tail and a replay) runs through both packages' stores;
every return value, status view, ``stats()``, ``next_shard`` and
``results_items`` must be equal (job ids and timestamps apart), and so
must every ledger line but its ``job`` id and ``ts``, key order
included.  A ledger written by either package replays in the other.

The schedulers: both over the same stub engines (the trough check on a
grid of depths and EWMAs, deferral behind depth and pressure, a
whole-shard retry after a ``Shed`` recorded once, per-item error rows
for bad entries and quarantined items, an unknown model failing its job
with the same reason, the brownout freeze, occupancy after a drain
under one scripted clock).  Restart: a job stopped after its first
shard replays and resumes on a LeNet-5 float32 engine of the port, which
executes every image exactly once.  The manifest codec
(``Workload.decode_manifest_item``) answers each good and bad entry as
the reference's does, an ``image_b64`` entry without PIL included (an
item's error, not a failed shard).  Equality throughout is exact: these
are state machines and decodes, not numerics."""

import json
import os
import sys
import time
import types
from concurrent.futures import Future

import numpy as np
import pytest

from _torch_serve import images, jax_lenet, lenet_variables, port_lenet
from deep_vision_tpu.serve import batch_sched as jax_batch_sched
from deep_vision_tpu.serve.admission import Shed as JaxShed
from deep_vision_tpu.serve.batch_sched import BatchScheduler as JaxScheduler
from deep_vision_tpu.serve.faults import Quarantined as JaxQuarantined
from deep_vision_tpu.serve.jobs import JobStore as JaxStore
from deep_vision_tpu_torch.serve import batch_sched
from deep_vision_tpu_torch.serve.admission import Shed
from deep_vision_tpu_torch.serve.batch_sched import BatchScheduler
from deep_vision_tpu_torch.serve.engine import BatchingEngine
from deep_vision_tpu_torch.serve.faults import Quarantined
from deep_vision_tpu_torch.serve.jobs import JobStore
from deep_vision_tpu_torch.serve.registry import ModelRegistry

pytestmark = pytest.mark.serve

#: (store class, scheduler class, Shed, Quarantined) of each package
PORT = (JobStore, BatchScheduler, Shed, Quarantined)
REF = (JaxStore, JaxScheduler, JaxShed, JaxQuarantined)


def _wait(pred, what, timeout=60.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return
        time.sleep(0.002)
    raise AssertionError(f"timed out waiting for {what}")


def _view(v):
    """A status view without its job id and creation time."""
    return {k: x for k, x in v.items() if k not in ("job_id", "created_ts")}


def _ledger(root):
    """Every ledger line of every job file under ``root``, in file order,
    as (key, value) lists without ``job`` and ``ts``; files ordered by
    their first record's manifest so that random ids do not reorder
    them."""
    files = []
    for name in sorted(os.listdir(root)):
        with open(os.path.join(root, name), encoding="utf-8") as f:
            lines = f.read().split("\n")
        recs = []
        for line in lines:
            try:
                rec = json.loads(line)
            except ValueError:
                recs.append(("unparsed", line.split('"job"')[0]))
                continue
            recs.append([(k, v) for k, v in rec.items()
                         if k not in ("job", "ts")])
        files.append(recs)
    return sorted(files, key=lambda recs: json.dumps(recs[0]))


def _script(store_cls, root):
    """One fixed sequence of store calls; returns what every call
    answered and the store (ids replaced by job numbers)."""
    out = []
    store = store_cls(root, shard_size=2, max_cached_shards=1)
    ids = []
    for n, size in ((7, None), (3, 3), (6, None)):
        view = store.submit("m", "classify",
                            [{"pixels": [i, n]} for i in range(n)], size)
        ids.append(view["job_id"])
        out.append(("submit", _view(view)))
    with pytest.raises(ValueError):
        store.submit("m", "classify", [])
    num = {jid: i for i, jid in enumerate(ids)}

    def shard(j, i, k):
        rows = [{"top": [{"class": j * 100 + i * 10 + r}]} for r in range(k)]
        return store.record_shard(ids[j], i, rows, k)

    def nxt():
        got = store.next_shard()
        return None if got is None else (num[got[0].job_id], got[1])

    def results(j):
        return list(store.results_items(ids[j]))

    out.append(("next", nxt()))
    out.append(("rec", shard(0, 2, 2)))
    out.append(("results", results(0)))
    out.append(("rec", shard(0, 0, 2)))
    out.append(("double", shard(0, 0, 2)))
    out.append(("next", nxt()))
    out.append(("results", results(0)))
    out.append(("rec", shard(0, 3, 1)))
    out.append(("rec", shard(0, 1, 2)))
    out.append(("results", results(0)))
    out.append(("results again", results(0)))
    out.append(("next", nxt()))
    store.fail(ids[1], "model not servable: 'ghost'")
    store.fail(ids[1], "second failure ignored")
    store.fail(ids[0], "done already")
    out.append(("rec after fail", shard(1, 0, 3)))
    out.append(("next", nxt()))
    out.append(("rec", shard(2, 1, 2)))
    out.append(("rec", shard(2, 0, 2)))
    out.append(("jobs", [_view(v) for v in store.jobs()]))
    out.append(("stats", store.stats()))
    return out, store, ids


def _torn(root, store, jid):
    """Append a half-written shard record (no newline) to ``jid``'s
    ledger, as a crash mid-append leaves it."""
    with open(store._path(jid), "a", encoding="utf-8") as f:
        f.write('{"kind": "shard", "job": "%s", "index": 2, "res' % jid)


def _replay(store_cls, root, ids):
    store = store_cls(root)
    got = store.next_shard()
    return store, {"resumed": store.resumed,
                   "replayed": store.replayed_shards,
                   "torn": store.torn_lines,
                   "next": None if got is None
                   else (ids.index(got[0].job_id), got[1]),
                   "views": [_view(store.status(j)) for j in ids],
                   "results": [list(store.results_items(j)) for j in ids],
                   "stats": store.stats()}


@pytest.mark.parametrize("durable", [True, False], ids=["ledger", "memory"])
def test_store_sequence_matches_reference(durable, tmp_path):
    runs = {}
    for tag, (store_cls, *_) in (("port", PORT), ("ref", REF)):
        root = str(tmp_path / tag) if durable else None
        out, store, ids = _script(store_cls, root)
        runs[tag] = (out, store, ids, root)
    assert runs["port"][0] == runs["ref"][0]
    stats = runs["port"][0][-1][1]
    assert stats["spilled_shards"] == (4 if durable else 0)
    assert stats["states"] == {"pending": 0, "running": 1, "done": 1,
                               "failed": 1}
    if not durable:
        return
    assert _ledger(runs["port"][3]) == _ledger(runs["ref"][3])
    replays = {}
    for tag, (store_cls, *_) in (("port", PORT), ("ref", REF)):
        _, store, ids, root = runs[tag]
        _torn(root, store, ids[2])
        replays[tag] = _replay(store_cls, root, ids)[1]
        # the torn tail was terminated: the next append starts a line
        with open(store._path(ids[2]), encoding="utf-8") as f:
            assert f.read().endswith('"index": 2, "res\n')
    assert replays["port"] == replays["ref"]
    assert replays["port"]["torn"] == 1 and replays["port"]["resumed"] == 1
    assert replays["port"]["next"] == (2, 2)
    # replay leaves the payload cache cold: every row comes off the disk
    assert replays["port"]["stats"]["cached_shards"] == 0
    assert [i for i, _ in replays["port"]["results"][0]] == list(range(7))
    assert _ledger(runs["port"][3]) == _ledger(runs["ref"][3])


@pytest.mark.parametrize("writer,reader", [(REF, PORT), (PORT, REF)],
                         ids=["ref-to-port", "port-to-ref"])
def test_ledger_replays_across_packages(writer, reader, tmp_path):
    """A ledger one package wrote replays in the other exactly as in
    the writer itself, torn tail included; the reader then finishes the
    job and the writer replays the reader's appends."""
    root = str(tmp_path / "jobs")
    _, store, ids = _script(writer[0], root)
    _torn(root, store, ids[2])
    _, own = _replay(writer[0], root, ids)
    other_store, other = _replay(reader[0], root, ids)
    # the writer's replay terminated the torn line; the reader still
    # counts it as torn, once
    assert own == other and other["torn"] == 1
    assert other_store.record_shard(
        ids[2], 2, [{"top": [{"class": 7}]}] * 2, 2)
    _, after = _replay(writer[0], root, ids)
    assert after["views"][2]["state"] == "done"
    assert [i for i, _ in after["results"][2]] == list(range(6))
    assert after["results"] == [list(other_store.results_items(j))
                                for j in ids]


# -- the schedulers ---------------------------------------------------------


class _Workload:
    verb = "classify"

    def decode_manifest_item(self, item, model):
        if "x" not in item:
            raise ValueError("manifest entry needs 'x'")
        return item["x"]

    def respond(self, model, item, row):
        return {"y": row, "tag": item.get("tag")}


class _Engine:
    """The scheduler's view of an engine: queue depth, the admission's
    EWMA, and a submit that answers at once (a Shed for the first
    ``shed_next`` submits, a Quarantined for ``poison`` inputs)."""

    def __init__(self, shed_cls, quarantined_cls, ewma=0.005):
        self.queue_depth = 0
        self.ewma = ewma
        self.admission = types.SimpleNamespace(
            bucket_ewma_s=lambda bucket=None: self.ewma)
        self.shed_cls, self.q_cls = shed_cls, quarantined_cls
        self.served = 0
        self.submits = 0
        self.shed_next = 0
        self.poison = set()

    def submit(self, x):
        self.submits += 1
        fut: Future = Future()
        if self.shed_next > 0:
            self.shed_next -= 1
            fut.set_result(self.shed_cls("queue_full"))
        elif x in self.poison:
            fut.set_result(self.q_cls("poison", f"input {x}"))
        else:
            self.served += 1
            fut.set_result(x * 2)
        return fut


class _Brownout:
    def __init__(self, level=0):
        self.level = level

    def at_least(self, n):
        return self.level >= n


def _rig(pkg, **kw):
    store_cls, sched_cls, shed_cls, q_cls = pkg
    store = store_cls()
    eng = _Engine(shed_cls, q_cls)
    model = types.SimpleNamespace(name="stub", workload=_Workload())

    def resolve(name):
        if name != "stub":
            raise KeyError(f"unknown model '{name}'")
        return model, eng

    return store, eng, sched_cls(store, resolve, interval_s=0.002, **kw)


def _outcome(store, sched, ids):
    st = sched.stats()
    st.pop("running")
    st.pop("occupancy")
    st.pop("deferred")
    st.pop("frozen_deferred")
    return {"views": [_view(store.status(j)) for j in ids],
            "results": [list(store.results_items(j)) for j in ids],
            "stats": st, "store": store.stats()}


def test_trough_check_matches_reference():
    for max_depth in (0, 1, 3):
        for pressure in (0.0, 10.0, 25.0):
            verdicts = []
            for pkg in (PORT, REF):
                _, eng, sched = _rig(pkg, max_interactive_depth=max_depth,
                                     pressure_high_ms=pressure)
                row = []
                for depth in (0, 1, 2, 3, 4):
                    for ewma in (None, 0.0, 0.004, 0.009, 0.02):
                        eng.queue_depth, eng.ewma = depth, ewma
                        row.append(sched._trough(eng))
                verdicts.append(row)
            assert verdicts[0] == verdicts[1]
            assert any(verdicts[0]) and not all(verdicts[0])


@pytest.mark.parametrize("gate", ["depth", "pressure"])
def test_deferral_then_drain_matches_reference(gate):
    """Behind the gate nothing is submitted and the deferrals count;
    once it opens the job drains to the same results."""
    outs = []
    for pkg in (PORT, REF):
        store, eng, sched = _rig(pkg, max_interactive_depth=2,
                                 pressure_high_ms=10.0)
        if gate == "depth":
            eng.queue_depth = 3
        else:
            eng.queue_depth, eng.ewma = 2, 0.006  # 12 ms > 10 ms
        jid = store.submit("stub", "classify",
                           [{"x": i, "tag": i % 3} for i in range(10)],
                           shard_size=4)["job_id"]
        sched.start()
        try:
            _wait(lambda: sched.stats()["deferred"] >= 5, "deferrals")
            assert eng.submits == 0
            assert store.status(jid)["state"] == "pending"
            eng.queue_depth = 0
            sched.kick()
            _wait(lambda: store.status(jid)["state"] == "done", "drain")
        finally:
            sched.stop()
        assert sched.stats()["frozen_deferred"] == 0
        outs.append(_outcome(store, sched, [jid]))
    assert outs[0] == outs[1]
    assert [r["y"] for _, r in outs[0]["results"][0]] == \
        [2 * i for i in range(10)]


def test_shed_retries_the_whole_shard_once_like_reference():
    outs = []
    for pkg in (PORT, REF):
        store, eng, sched = _rig(pkg)
        jid = store.submit("stub", "classify",
                           [{"x": i} for i in range(6)],
                           shard_size=3)["job_id"]
        eng.shed_next = 2  # the first attempt at shard 0: 2 of 3 shed
        sched.start()
        try:
            _wait(lambda: store.status(jid)["state"] == "done", "drain")
        finally:
            sched.stop()
        assert sched.stats()["shards_shed"] == 1
        assert eng.submits == 9 and eng.served == 7
        outs.append(_outcome(store, sched, [jid]))
    assert outs[0] == outs[1]
    assert [i for i, _ in outs[0]["results"][0]] == list(range(6))
    assert outs[0]["views"][0]["images_done"] == 6


def test_per_item_error_rows_match_reference():
    outs = []
    for pkg in (PORT, REF):
        store, eng, sched = _rig(pkg)
        eng.poison = {3}
        manifest = [{"x": 0}, {"bad": 1}, "not an object", {"x": 3},
                    {"x": 4}]
        jid = store.submit("stub", "classify", manifest,
                           shard_size=5)["job_id"]
        sched.start()
        try:
            _wait(lambda: store.status(jid)["state"] == "done", "drain")
        finally:
            sched.stop()
        outs.append(_outcome(store, sched, [jid]))
    assert outs[0] == outs[1]
    rows = [r for _, r in outs[0]["results"][0]]
    assert rows[1] == {"error": "bad manifest entry: manifest entry "
                                "needs 'x'"}
    assert rows[3] == {"error": "quarantined (poison): input 3"}
    assert outs[0]["views"][0]["images_done"] == 2
    assert outs[0]["stats"]["decode_errors"] == 2
    assert outs[0]["stats"]["item_errors"] == 1


def test_unknown_model_fails_the_job_like_reference():
    outs = []
    for pkg in (PORT, REF):
        store, eng, sched = _rig(pkg)
        jid = store.submit("ghost", "classify", [{"x": 1}])["job_id"]
        sched.start()
        try:
            _wait(lambda: store.status(jid)["state"] == "failed", "failure")
        finally:
            sched.stop()
        assert store.next_shard() is None
        outs.append(_outcome(store, sched, [jid]))
    assert outs[0] == outs[1]
    assert outs[0]["views"][0]["error"] == \
        "model not servable: unknown model 'ghost'"
    assert outs[0]["stats"]["jobs_failed"] == 1


def test_brownout_freeze_matches_reference():
    """At L1 and above no shard is submitted, whatever the trough says,
    and every pass counts as frozen; at L0 the job drains."""
    outs = []
    for pkg in (PORT, REF):
        store, eng, sched = _rig(pkg)
        sched.brownout = _Brownout(1)
        jid = store.submit("stub", "classify",
                           [{"x": i} for i in range(8)],
                           shard_size=4)["job_id"]
        sched.start()
        try:
            _wait(lambda: sched.stats()["frozen_deferred"] >= 5, "freeze")
            sched.brownout.level = 3
            n = sched.stats()["frozen_deferred"]
            _wait(lambda: sched.stats()["frozen_deferred"] > n, "freeze")
            assert eng.submits == 0 and sched.stats()["shards_done"] == 0
            st = sched.stats()
            assert st["deferred"] >= st["frozen_deferred"]
            sched.brownout.level = 0
            sched.kick()
            _wait(lambda: store.status(jid)["state"] == "done", "drain")
        finally:
            sched.stop()
        outs.append(_outcome(store, sched, [jid]))
    assert outs[0] == outs[1]


class _Clock:
    """A monotonic clock that moves 0.25 s a read."""

    def __init__(self):
        self.t = 1000.0

    def monotonic(self):
        self.t += 0.25
        return self.t


def test_occupancy_after_drain_matches_reference(monkeypatch):
    """Shards run synchronously under one scripted clock in each
    package: the busy intervals, and so the occupancy, are equal."""
    occ = []
    for pkg, module in ((PORT, batch_sched), (REF, jax_batch_sched)):
        clock = _Clock()
        monkeypatch.setattr(module, "time", types.SimpleNamespace(
            monotonic=clock.monotonic, time=time.time))
        store, eng, sched = _rig(pkg, occupancy_window_s=4.0)
        assert sched.occupancy() == 0.0
        jid = store.submit("stub", "classify",
                           [{"x": i} for i in range(8)],
                           shard_size=2)["job_id"]
        model = types.SimpleNamespace(name="stub", workload=_Workload())
        while (nxt := store.next_shard()) is not None:
            job, index = nxt
            sched._run_shard(job, index, model, eng)
        assert store.status(jid)["state"] == "done"
        occ.append((sched.occupancy(), sched.stats()["occupancy"]))
    assert occ[0] == occ[1]
    assert 0.0 < occ[0][0] <= 1.0


# -- restart on a real engine ------------------------------------------------


class _StopAfter(JobStore):
    """A durable store that stops its scheduler once it has recorded
    ``stop_after`` shards: the deterministic stand-in for a kill
    mid-job (the loop checks its stop flag between shards)."""

    def __init__(self, root, *, stop_after, **kw):
        super().__init__(root, **kw)
        self.sched = None
        self.stop_after = stop_after
        self.recorded = 0

    def record_shard(self, *a, **kw):
        ok = super().record_shard(*a, **kw)
        if ok:
            self.recorded += 1
            if self.recorded >= self.stop_after and self.sched is not None:
                self.sched._stop.set()
        return ok


def test_restart_resumes_exactly_once_on_lenet(tmp_path):
    """Stop after the first shard, replay the ledger in a new store and
    resume: every index streams once, in order, and the engine executed
    each of the 12 images exactly once."""
    sm = port_lenet(lenet_variables(0))
    reg = ModelRegistry()
    reg.add(sm)
    root = str(tmp_path / "jobs")
    imgs = images(12, seed=3)
    manifest = [{"pixels": im.tolist()} for im in imgs]
    with BatchingEngine(sm, buckets=[4], max_wait_ms=2) as eng:
        def resolve(name):
            return reg.get(name), eng

        store1 = _StopAfter(root, stop_after=1, shard_size=4)
        jid = store1.submit(sm.name, "classify", manifest)["job_id"]
        sched1 = BatchScheduler(store1, resolve, interval_s=0.002)
        store1.sched = sched1
        sched1.start()
        _wait(lambda: not sched1._thread.is_alive(), "the stop mid-job")
        sched1.stop()
        done1 = store1.status(jid)["shards_done"]
        served1 = eng.served
        assert 1 <= done1 < 3 and served1 == 4 * done1

        store2 = JobStore(root)
        assert (store2.resumed, store2.replayed_shards) == (1, done1)
        assert store2.next_shard()[1] == done1
        sched2 = BatchScheduler(store2, resolve, interval_s=0.002).start()
        try:
            _wait(lambda: store2.status(jid)["state"] == "done", "resume")
        finally:
            sched2.stop()
        assert eng.served == 12
        assert eng.served - served1 == 12 - 4 * done1
        items = list(store2.results_items(jid))
        assert [i for i, _ in items] == list(range(12))
        # each row is the model's answer for its own image
        want = [sm.workload.respond(sm, {}, r) for r in
                sm.compile_bucket(4)(imgs[:4]).numpy()]
        for (_, got), ref in zip(items, want):
            assert [t["class"] for t in got["top"]] == \
                [t["class"] for t in ref["top"]]
            np.testing.assert_allclose([t["prob"] for t in got["top"]],
                                       [t["prob"] for t in ref["top"]],
                                       rtol=0, atol=1e-6)
        assert store2.status(jid)["images_done"] == 12


# -- the manifest codec -------------------------------------------------------


def _decode_both(item, monkeypatch, no_pil=False):
    """(port answer, reference answer): the decoded input, or the
    ValueError's text."""
    if no_pil:
        monkeypatch.setitem(sys.modules, "PIL", None)
    v = lenet_variables(0)
    out = []
    for sm in (port_lenet(v, wire="uint8"), jax_lenet(v, wire="uint8")):
        try:
            out.append(np.asarray(sm.workload.decode_manifest_item(item, sm)))
        except ValueError as e:
            out.append(str(e))
    return out


@pytest.mark.parametrize("item", [
    {"pixels": images(1, seed=4, wire="uint8")[0].tolist()},
    {"pixels": images(1, seed=4, wire="uint8")[0][..., 0].tolist()},
    {"pixels": [[1, 2], [3, 4]]},
    {"pixels": "x"},
    {"pixels": [[300] * 32] * 32},
    {"other": 1},
    [1, 2],
    "not an object"], ids=["pixels", "2-d", "shape", "text", "range",
                           "no-pixels", "list", "string"])
def test_manifest_item_decode_matches_reference(item, monkeypatch):
    got, want = _decode_both(item, monkeypatch)
    if isinstance(want, str):
        assert got == want
    else:
        assert got.dtype == want.dtype and np.array_equal(got, want)


def test_image_b64_without_pil_is_an_item_error(monkeypatch):
    """The card host has no PIL: an ``image_b64`` entry must become that
    item's error row (a ValueError), not a failed shard."""
    got, want = _decode_both({"image_b64": "aGVsbG8="}, monkeypatch,
                             no_pil=True)
    assert isinstance(got, str) and got == want
    assert "PIL" in got
