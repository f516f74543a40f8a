"""The port's batch tier behind ``/v1/jobs`` on the CPU, against the
JAX package.

LeNet-5 float32 at full width on both sides from the same variables: a
12-item job with shard 4 through each package's ``ServeServer`` answers
the same classes with probabilities within 1e-5 (float32 compute; the
reference computes with XLA); both servers answer the same status codes
and error texts; a job with a gap at shard 1 streams only rows 0-1 and a
``running`` status as chunked NDJSON, under the edge and under the
thread server; the ``/v1/stats`` ``batch`` block has the reference's
keys and the ``dvt_batch_*`` series render byte for byte as the
reference's on one stats dict.  ``cli.serve``'s batch flags parse to the
reference's defaults, ``--jobs-dir ''`` runs in memory, ``--brownout``
freezes the tier on both build paths, and on ``--models`` a shard after
a hot reload runs on the new ACTIVE engine.  DCGAN int8: a job of
``{"seed": i}`` items answers each image within one code of the JAX
package's int8 serving model on the same latent (measured: within one,
95% of codes equal), and equal to the port's own bucket callable."""

import base64
import copy
import json
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

import _torch_zoo as tz
import jax
from _torch_serve import (
    get,
    images,
    jax_lenet,
    lenet_variables,
    port_lenet,
    post,
    write_step,
)
from test_torch_generate_serve import _pair as gan_pair
from deep_vision_tpu.cli import serve as jax_cli
from deep_vision_tpu.core.metrics import PromText as JaxPromText
from deep_vision_tpu.serve import http as jax_http
from deep_vision_tpu.serve.batch_sched import BatchScheduler as JaxScheduler
from deep_vision_tpu.serve.engine import BatchingEngine as JaxEngine
from deep_vision_tpu.serve.jobs import JobStore as JaxStore
from deep_vision_tpu.serve.registry import ModelRegistry as JaxRegistry
from deep_vision_tpu_torch.cli import serve as cli
from deep_vision_tpu_torch.core.metrics import PromText
from deep_vision_tpu_torch.serve import http
from deep_vision_tpu_torch.serve.batch_sched import BatchScheduler
from deep_vision_tpu_torch.serve.engine import BatchingEngine
from deep_vision_tpu_torch.serve.http import ServeServer
from deep_vision_tpu_torch.serve.jobs import JobStore
from deep_vision_tpu_torch.serve.registry import ModelRegistry

pytestmark = pytest.mark.serve

#: port vs reference probabilities, float32 compute
PROB_TOL = 1e-5
BATCH_FLAGS = ("jobs_dir", "batch_shard_size", "batch_interval_ms",
               "batch_max_depth", "batch_pressure_ms", "batch_cache_shards")


def _wait(pred, what, timeout=60.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return
        time.sleep(0.005)
    raise AssertionError(f"timed out waiting for {what}")


def _stream(port, path):
    """GET a chunked NDJSON stream → (Transfer-Encoding, parsed lines)."""
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=60) as r:
        return r.headers.get("Transfer-Encoding"), \
            [json.loads(ln) for ln in r.read().splitlines()]


def _stack(pkg, sm, jobs=True, edge=True, shard_size=4):
    """(server, engine, store, scheduler) of one package over ``sm``."""
    if pkg == "port":
        reg, eng_cls, store_cls, sched_cls, srv_cls = (
            ModelRegistry(), BatchingEngine, JobStore, BatchScheduler,
            ServeServer)
    else:
        reg, eng_cls, store_cls, sched_cls, srv_cls = (
            JaxRegistry(), JaxEngine, JaxStore, JaxScheduler,
            jax_http.ServeServer)
    reg.add(sm)
    eng = eng_cls(sm, buckets=[4], max_wait_ms=2).start()
    store = sched = None
    if jobs:
        store = store_cls(shard_size=shard_size)

        def resolve(name):
            return reg.get(name), eng

        sched = sched_cls(store, resolve, interval_s=0.002).start()
    srv = srv_cls(reg, {sm.name: eng}, port=0, jobs=store,
                  batch_sched=sched, edge=edge).start_background()
    return srv, eng, store, sched


def _close(stack):
    srv, eng, _, sched = stack
    srv.shutdown()
    if sched is not None:
        sched.stop()
    eng.stop()


@pytest.fixture(scope="module")
def stacks():
    variables = lenet_variables(0)
    out = {"port": _stack("port", port_lenet(variables)),
           "ref": _stack("ref", jax_lenet(variables))}
    yield out
    for stack in out.values():
        _close(stack)


def _run_job(port, items, **kw):
    status, view, _ = post(port, "/v1/jobs", {"items": items, **kw})
    assert status == 202, view
    jid = view["job_id"]
    _wait(lambda: get(port, f"/v1/jobs/{jid}")[1]["state"] == "done",
          "the job's drain")
    return view, _stream(port, f"/v1/jobs/{jid}/results")


def test_job_results_match_reference(stacks):
    items = [{"pixels": im.tolist(), "top_k": 3}
             for im in images(12, seed=7)]
    got = {}
    for tag, (srv, eng, store, sched) in stacks.items():
        view, (te, lines) = _run_job(srv.port, items, model="lenet5")
        assert te == "chunked"
        assert (view["n_shards"], view["shard_size"]) == (3, 4)
        assert [ln["index"] for ln in lines[:-1]] == list(range(12))
        assert lines[-1]["status"]["state"] == "done"
        assert lines[-1]["status"]["images_done"] == 12
        got[tag] = (view, lines)
    drop = ("job_id", "created_ts")
    assert {k: v for k, v in got["port"][0].items() if k not in drop} == \
        {k: v for k, v in got["ref"][0].items() if k not in drop}
    for mine, ref in zip(got["port"][1][:-1], got["ref"][1][:-1]):
        assert mine["model"] == ref["model"] == "lenet5"
        assert [t["class"] for t in mine["top"]] == \
            [t["class"] for t in ref["top"]]
        np.testing.assert_allclose([t["prob"] for t in mine["top"]],
                                   [t["prob"] for t in ref["top"]],
                                   rtol=0, atol=PROB_TOL)


def _answer(port, method, path, body=None):
    url = f"http://127.0.0.1:{port}{path}"
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(url, data=data, method=method,
                                 headers={"Content-Type":
                                          "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


CASES = [("POST", "/v1/jobs", {"items": []}),
         ("POST", "/v1/jobs", {"items": "x"}),
         ("POST", "/v1/jobs", {}),
         ("POST", "/v1/jobs", {"items": [{}], "shard_size": "a"}),
         ("POST", "/v1/jobs", {"items": [{}], "shard_size": 0}),
         ("POST", "/v1/jobs", {"items": [{}], "shard_size": [1]}),
         ("GET", "/v1/jobs/nope", None),
         ("GET", "/v1/jobs/nope/results", None)]


def test_codes_and_error_texts_match_reference(stacks):
    answers = {}
    for tag, (srv, _, store, _) in stacks.items():
        rows = [_answer(srv.port, *case) for case in CASES]
        jid = store.submit("lenet5", "classify", [{"x": 1}])["job_id"]
        store.fail(jid, "held")
        rows.append(_answer(srv.port, "GET", f"/v1/jobs/{jid}/bogus")[0])
        rows.append(_answer(srv.port, "GET", f"/v1/jobs/{jid}/a/b")[0])
        rows.append(_answer(srv.port, "POST", "/v1/jobs",
                            {"items": [{}], "model": "ghost"})[0])
        answers[tag] = rows
    assert answers["port"] == answers["ref"]
    assert [a[0] for a in answers["port"][:len(CASES)]] == \
        [400] * 6 + [404] * 2
    assert answers["port"][len(CASES):] == [404, 404, 404]
    # the tier off: 503 naming --jobs-dir, on both routes
    variables = lenet_variables(0)
    off = {"port": _stack("port", port_lenet(variables), jobs=False),
           "ref": _stack("ref", jax_lenet(variables), jobs=False)}
    try:
        got = {tag: [_answer(s[0].port, "GET", "/v1/jobs"),
                     _answer(s[0].port, "GET", "/v1/jobs/x/results"),
                     _answer(s[0].port, "POST", "/v1/jobs",
                             {"items": [{}]})]
               for tag, s in off.items()}
    finally:
        for s in off.values():
            _close(s)
    assert got["port"] == got["ref"]
    assert all(code == 503 and "--jobs-dir" in body["error"]
               for code, body in got["port"])


@pytest.mark.parametrize("edge", [True, False],
                         ids=["edge", "thread-server"])
def test_partial_prefix_stream_both_front_ends(edge):
    """A job whose shard 1 is missing streams rows 0-1 and a "running"
    status, as the reference's server streams the same store."""
    variables = lenet_variables(0)
    lines = {}
    for tag, sm in (("port", port_lenet(variables)),
                    ("ref", jax_lenet(variables))):
        stack = _stack(tag, sm, edge=edge, shard_size=2)
        srv, _, store, sched = stack
        sched.stop()  # the store is scripted by hand
        try:
            jid = store.submit(sm.name, "classify",
                               [{"k": i} for i in range(6)])["job_id"]
            store.record_shard(jid, 0, [{"y": 0}, {"y": 1}], 2)
            store.record_shard(jid, 2, [{"y": 4}, {"y": 5}], 2)
            te, got = _stream(srv.port, f"/v1/jobs/{jid}/results")
            assert te == "chunked"
            # the stream again on the same keep-alive-capable server
            assert _stream(srv.port, f"/v1/jobs/{jid}/results")[1] == got
        finally:
            _close(stack)
        for k in ("job_id", "created_ts"):
            got[-1]["status"].pop(k)
        lines[tag] = got
    assert lines["port"] == lines["ref"]
    assert [ln["index"] for ln in lines["port"][:-1]] == [0, 1]
    assert lines["port"][-1]["status"]["state"] == "running"


def _keys(d):
    """The nested keys of a stats block; the per-state and per-model
    maps count as leaves."""
    return {k: _keys(v) if isinstance(v, dict) and k not in (
        "states", "mfu_occupancy_weighted") else None
        for k, v in d.items()}


def test_stats_block_keys_and_batch_series_match_reference(stacks):
    blocks = {}
    for tag, (srv, *_) in stacks.items():
        status, stats = get(srv.port, "/v1/stats")
        assert status == 200
        blocks[tag] = stats["batch"]
    assert _keys(blocks["port"]) == _keys(blocks["ref"])
    # the port prices no MFU on a CPU (no peak rate), so its map of
    # weighted MFUs is empty there; the reference's holds lenet5: None
    assert blocks["port"]["mfu_occupancy_weighted"] == {}
    # one stats dict through both renderers: the dvt_batch_* text equal
    block = copy.deepcopy(blocks["port"])
    block["jobs"]["states"] = {"pending": 1, "running": 2, "done": 3,
                               "failed": 4}
    block["mfu_occupancy_weighted"] = {"lenet5": 0.0123, "b": 0.5}
    p, jp = PromText(), JaxPromText()
    http._render_batch_metrics(p, block)
    jax_http._render_batch_metrics(jp, block)
    assert p.render() == jp.render()
    assert "dvt_batch_images_total" in p.render()
    # /metrics of each server: the same dvt_batch_* series
    names = {}
    for tag, (srv, *_) in stacks.items():
        status, text = get(srv.port, "/metrics", text=True)
        assert status == 200
        names[tag] = sorted(ln.split(" ")[0] for ln in text.splitlines()
                            if ln.startswith("dvt_batch_")
                            and "mfu" not in ln)
    assert names["port"] == names["ref"]
    assert "dvt_batch_images_total" in names["port"]


class _Parsed(Exception):
    def __init__(self, args):
        super().__init__("parsed")
        self.args_ns = args


@pytest.mark.parametrize("extra", [
    [],
    ["--jobs-dir", "", "--batch-shard-size", "8", "--batch-interval-ms",
     "5", "--batch-max-depth", "2", "--batch-pressure-ms", "3.5",
     "--batch-cache-shards", "0"]], ids=["defaults", "set"])
def test_cli_batch_flags_parse_to_reference(monkeypatch, extra):
    """The namespace the reference's ``main`` parses (its
    ``build_server`` raises it back before anything starts) against
    the port's parser."""
    import deep_vision_tpu.core.compile_cache as jcc
    import deep_vision_tpu.obs.log as jlog

    def capture(args):
        raise _Parsed(args)

    monkeypatch.setattr(jax_cli, "build_server", capture)
    monkeypatch.setattr(jlog, "configure_logging", lambda level: None)
    monkeypatch.setattr(jcc, "enable_compile_cache", lambda *a, **k: None)
    argv = ["-m", "lenet5", "--workdir", "w", "--port", "0"] + extra
    with pytest.raises(_Parsed) as e:
        jax_cli.main(argv)
    ref = vars(e.value.args_ns)
    mine = vars(cli.build_parser().parse_args(argv))
    assert {k: mine[k] for k in BATCH_FLAGS} == \
        {k: ref[k] for k in BATCH_FLAGS}


def _cli(*argv):
    engine, server = cli.build_server(cli.build_parser().parse_args(
        ["--wire-dtype", "float32", "--device", "cpu", "--port", "0",
         "--max-batch", "4", *argv]))
    server.start_background()
    return engine, server


def _shutdown(engine, server):
    """``main``'s order: the scheduler and the ladder, then the server,
    then the engines."""
    srv = server.httpd
    if srv.batch_sched is not None:
        srv.batch_sched.stop()
    if srv.brownout is not None:
        srv.brownout.stop()
    server.shutdown()
    engine.stop()


def test_build_server_memory_only_and_brownout_freeze(tmp_path):
    """``--jobs-dir ''``: the tier in memory (no ledger); ``--brownout``
    wires the ladder into the scheduler, and a pinned L1 freezes it."""
    model = tz.port("lenet5", lenet_variables(0))
    write_step(str(tmp_path / "w"), 1, model)
    engine, server = _cli("-m", "lenet5", "--workdir", str(tmp_path / "w"),
                          "--jobs-dir", "", "--batch-shard-size", "3",
                          "--brownout")
    try:
        srv = server.httpd
        assert srv.jobs.root is None and srv.jobs.default_shard_size == 3
        assert srv.batch_sched.brownout is srv.brownout is not None
        status, _, _ = post(server.port, "/v1/brownout", {"force": 1})
        assert status == 200
        items = [{"pixels": im.tolist()} for im in images(6, seed=2)]
        status, view, _ = post(server.port, "/v1/jobs", {"items": items})
        assert status == 202 and view["n_shards"] == 2
        _wait(lambda: srv.batch_sched.stats()["frozen_deferred"] >= 3,
              "the freeze")
        assert get(server.port, f"/v1/jobs/{view['job_id']}")[1][
            "shards_done"] == 0
        assert engine.served == 0
        post(server.port, "/v1/brownout", {"force": None})
        _wait(lambda: get(server.port, f"/v1/jobs/{view['job_id']}")[1][
            "state"] == "done", "the drain after the release")
        status, stats = get(server.port, "/v1/stats")
        assert stats["batch"]["jobs"]["durable"] is False
        assert stats["batch"]["scheduler"]["frozen_deferred"] >= 3
        assert engine.served == 6
    finally:
        _shutdown(engine, server)


def test_plane_path_brownout_and_reload_follows_active(tmp_path):
    """``--models``: the scheduler resolves the model per shard, so a
    job after a hot reload runs on the new ACTIVE engine and answers as
    the new step; ``--brownout`` is wired on this path too."""
    workdir = str(tmp_path / "runs")
    v1 = lenet_variables(0)
    v2 = lenet_variables(5)
    write_step(f"{workdir}/lenet5", 1, tz.port("lenet5", v1))
    plane, server = _cli("--models", "lenet5", "--workdir", workdir,
                         "--jobs-dir", str(tmp_path / "jobs"), "--brownout",
                         "--canary-frac", "1.0", "--canary-min-requests",
                         "2", "--phase-timeout-s", "30")
    try:
        srv = server.httpd
        assert srv.batch_sched.brownout is srv.brownout is not None
        x = images(8, seed=9)
        items = [{"pixels": im.tolist()} for im in x]
        old = plane.active_engine("lenet5")
        _run_job(server.port, items)
        assert old.served == 8 and old.submitted == 8
        write_step(f"{workdir}/lenet5", 2, tz.port("lenet5", v2))
        status, out, _ = post(server.port, "/v1/models/lenet5/reload", {})
        assert status == 200 and out["status"] == "reloading", out

        def promoted():
            # the canary takes every interactive request; batch shards
            # go to the ACTIVE engine only
            post(server.port, "/v1/classify", items[0])
            return plane.active_engine("lenet5") is not old

        _wait(promoted, "the reload's promotion")
        new = plane.active_engine("lenet5")
        before, old_before = new.served, old.submitted
        _, (_, lines) = _run_job(server.port, items)
        assert new.served - before == 8 and old.submitted == old_before
        ref = np.asarray(jax.device_get(
            jax_lenet(v2).compile_bucket(8)(x)))
        for ln, row in zip(lines[:-1], ref):
            assert ln["top"][0]["class"] == int(row.argmax())
    finally:
        _shutdown(plane, server)


def _image(row):
    img = row["image"]
    return np.frombuffer(base64.b64decode(img["b64"]),
                         img["dtype"]).reshape(img["shape"])


def test_dcgan_int8_seed_job_matches_reference():
    """A 16-item job of seeds through the port's batch tier: each image
    equal to the port's bucket callable on the seed's latent and within
    one code of the JAX package's int8 serving model on it; the same
    rows against the latents of seed i + 1 fail."""
    jsm, psm = gan_pair("dcgan", "int8")
    assert psm.infer_dtype == "int8" and str(psm.wire_dtype) == "float32"
    srv, eng, store, sched = _stack("port", psm, shard_size=8)
    try:
        items = [{"seed": i} for i in range(16)]
        status, view, _ = post(srv.port, "/v1/jobs",
                               {"items": items, "model": psm.name})
        assert status == 202 and view["verb"] == "generate"
        _wait(lambda: store.status(view["job_id"])["state"] == "done",
              "the seed job")
        rows = [_image(r) for _, r in store.results_items(view["job_id"])]
    finally:
        _close((srv, eng, store, sched))

    def latents(seeds):
        return np.stack([np.random.default_rng(s).standard_normal(
            psm.input_shape).astype(np.float32) for s in seeds])

    z = latents(range(16))
    assert np.array_equal(z, np.stack([jsm.workload.decode(b, jsm)
                                       for b in items]))
    mine = psm.compile_bucket(16)(z).numpy()
    want = np.asarray(jax.device_get(jsm.compile_bucket(16)(z)))
    codes = np.abs(mine.astype(np.int16) - want.astype(np.int16))
    assert codes.max() <= 1
    got = np.stack(rows)
    assert got.shape == (16, 28, 28, 1) and got.dtype == np.uint8
    assert np.array_equal(got, mine)
    assert np.abs(got.astype(np.int16) - want.astype(np.int16)).max() <= 1
    wrong = np.asarray(jax.device_get(jsm.compile_bucket(16)(
        latents(range(1, 17)))))
    off = np.abs(got.astype(np.int16) - wrong.astype(np.int16)).reshape(
        16, -1).max(axis=1)
    assert (off > 1).sum() > 8
