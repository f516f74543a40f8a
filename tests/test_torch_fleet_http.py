"""The fleet and the deploy loop over HTTP on the CPU, against the JAX
package: ``/v1/deploy/{name}/history`` and ``/revert`` answer the
reference's status codes with and without a deploy pipeline,
``/v1/healthz`` stays 200 with one replica DEAD and turns 503 when all
are, the ``dvt_serve_replicas*`` and ``dvt_deploy_*`` series carry the
reference renderer's names for the same stats, and ``cli.serve --device
cpu --models ... --watch --min-replicas 1 --max-replicas 2`` boots, rolls
a new checkpoint out on its own and refuses the reference's conflicting
flag sets.

LeNet-5 at full width, float32, port checkpoints written as
``cli.train`` writes them; CPU replicas."""

import argparse
import copy
import re
import threading
import time

import numpy as np
import pytest
import torch

import _torch_zoo as tz
from _torch_serve import get, images, lenet_variables, port_lenet, post, \
    write_step
from deep_vision_tpu.cli import serve as jax_cli
from deep_vision_tpu.serve.http import render_serve_metrics as jax_render
from deep_vision_tpu_torch.cli import serve as cli
from deep_vision_tpu_torch.deploy import (
    AccuracyGate,
    CheckpointWatcher,
    DeploymentHistory,
    DeployPipeline,
    ReplicaAutoscaler,
)
from deep_vision_tpu_torch.serve.http import ServeServer, render_serve_metrics
from deep_vision_tpu_torch.serve.models import CanaryPolicy, ModelControlPlane
from deep_vision_tpu_torch.serve.models import WeightCache
from deep_vision_tpu_torch.serve.registry import (
    CheckpointServingModel,
    ModelRegistry,
)
from deep_vision_tpu_torch.serve.replicas import ReplicatedEngine

pytestmark = [pytest.mark.serve, pytest.mark.deploy]

CPU = torch.device("cpu")


def _clone(sm, step):
    new = CheckpointServingModel(sm.name, sm.cfg, copy.deepcopy(sm._model),
                                 device="cpu")
    new.restored_step = step
    new.params_digest = sm.params_digest
    return new


class _Clients:
    """Closed-loop HTTP clients; every status is kept."""

    def __init__(self, port, n=2):
        body = {"pixels": images(1)[0].tolist()}
        self.stop = threading.Event()
        self.statuses: list = []
        self.threads = [threading.Thread(target=self._run,
                                         args=(port, body), daemon=True)
                        for _ in range(n)]
        for t in self.threads:
            t.start()

    def _run(self, port, body):
        while not self.stop.is_set():
            self.statuses.append(post(port, "/v1/classify", body)[0])

    def finish(self):
        self.stop.set()
        for t in self.threads:
            t.join(60)
            assert not t.is_alive()


def _fleet_factory(model):
    return ReplicatedEngine(model, devices=[CPU] * 2, buckets=[4],
                            max_wait_ms=2, watchdog_interval_s=0.02)


@pytest.fixture()
def plane(tmp_path):
    reg = ModelRegistry()
    sm = reg.add(port_lenet(lenet_variables(0)))
    plane = ModelControlPlane(
        reg, _fleet_factory, cache=WeightCache(0),
        policy=CanaryPolicy(canary_frac=0.5, min_requests=3,
                            max_p99_ratio=None, phase_timeout_s=30.0))
    plane.deploy(sm, workdir=str(tmp_path / "lenet5"))
    yield reg, sm, plane
    plane.stop()


def _server(reg, plane, deploy=None):
    return ServeServer(reg, plane.active_engines(), port=0, plane=plane,
                       deploy=deploy).start_background()


def test_deploy_routes_need_a_pipeline(plane):
    reg, _, p = plane
    server = _server(reg, p)
    try:
        status, body = get(server.port, "/v1/deploy/lenet5/history")
        assert status == 503 and "--watch" in body["error"]
        status, body, _ = post(server.port, "/v1/deploy/lenet5/revert", {})
        assert status == 503
        status, body = get(server.port, "/v1/stats")
        assert status == 200 and "deploy" not in body
    finally:
        server.shutdown()


def test_deploy_routes_status_codes(plane):
    reg, sm, p = plane
    pipeline = DeployPipeline(p, history=DeploymentHistory())
    server = _server(reg, p, pipeline)
    port = server.port
    try:
        pipeline.history.record("lenet5", "candidate", step=1)
        pipeline.history.record("lenet5", "gate_passed", step=1)
        status, body = get(port, "/v1/deploy/lenet5/history")
        assert status == 200
        assert [e["outcome"] for e in body["entries"]] == \
            ["candidate", "gate_passed"]
        status, body = get(port, "/v1/deploy/lenet5/history?n=1")
        assert [e["outcome"] for e in body["entries"]] == ["gate_passed"]
        assert get(port, "/v1/deploy/lenet5/history?n=x")[0] == 400
        assert get(port, "/v1/deploy/nope/history")[0] == 404
        # nothing to revert to: 409 refused
        status, body, _ = post(port, "/v1/deploy/lenet5/revert", {})
        assert status == 409 and body["status"] == "refused"
        assert post(port, "/v1/deploy/nope/revert", {})[0] == 404
        clients = _Clients(port)
        try:
            out = p.reload("lenet5", wait=True, _loader=lambda: _clone(sm, 2))
            assert out["version"]["state"] == "active"
            status, body, _ = post(port, "/v1/deploy/lenet5/revert", {})
        finally:
            clients.finish()
        assert status == 200 and body["status"] == "reverted"
        assert body["restores"] == 1 and body["from_version"] == 2
        assert set(clients.statuses) == {200}
        status, body = get(port, "/v1/deploy/lenet5/history")
        assert body["entries"][-1]["outcome"] == "reverted"
        status, stats = get(port, "/v1/stats")
        assert stats["deploy"]["history"]["records"] == 3
        # a reload in flight: 409 in_progress
        gate = threading.Event()

        def slow():
            gate.wait(30)
            return _clone(sm, 3)

        try:
            assert p.reload("lenet5", _loader=slow)["status"] == "reloading"
            status, body, _ = post(port, "/v1/deploy/lenet5/revert", {})
            assert status == 409 and body["status"] == "in_progress"
        finally:
            gate.set()
            p._reloading["lenet5"].join(60)
    finally:
        server.shutdown()


def test_healthz_with_dead_replicas():
    reg = ModelRegistry()
    sm = reg.add(port_lenet(lenet_variables(0)))
    eng = ReplicatedEngine(sm, devices=[CPU] * 2, buckets=[4],
                           max_wait_ms=2, watchdog_interval_s=0.02).start()
    server = ServeServer(reg, {sm.name: eng}, port=0).start_background()
    body = {"pixels": images(1)[0].tolist()}
    try:
        assert get(server.port, "/v1/healthz")[0] == 200
        eng.replicas[0].health.force_dead("test kill")
        status, h = get(server.port, "/v1/healthz")
        assert status == 200
        rep = h["engines"]["lenet5"]
        assert rep["state"] == "degraded" and rep["can_serve"] is True
        assert rep["replicas"]["0"]["state"] == "dead"
        assert post(server.port, "/v1/classify", body)[0] == 200
        eng.replicas[1].health.force_dead("test kill")
        status, h = get(server.port, "/v1/healthz")
        assert status == 503 and h["status"] == "unhealthy"
        # the formed batch sheds: 429, not a hang
        assert post(server.port, "/v1/classify", body)[0] == 429
    finally:
        server.shutdown()
        eng.stop()


def test_many_clients_connecting_at_once_are_all_answered():
    """64 clients connect in the same instant (a fleet's burst): every
    one is answered 200.  The listen backlog is the reference edge's 128;
    socketserver's default of 5 reset most of such a burst."""
    from concurrent.futures import ThreadPoolExecutor

    from deep_vision_tpu_torch.serve.http import LISTEN_BACKLOG

    assert LISTEN_BACKLOG == 128
    reg = ModelRegistry()
    sm = reg.add(port_lenet(lenet_variables(0)))
    eng = ReplicatedEngine(sm, devices=[CPU] * 2, buckets=[8],
                           max_wait_ms=2).start()
    server = ServeServer(reg, {sm.name: eng}, port=0).start_background()
    gate = threading.Barrier(64)
    bodies = [{"pixels": x.tolist()} for x in images(64)]

    def one(body):
        gate.wait(30)
        return post(server.port, "/v1/classify", body)[0]

    try:
        with ThreadPoolExecutor(64) as pool:
            codes = list(pool.map(one, bodies))
    finally:
        server.shutdown()
        eng.stop()
    assert codes == [200] * 64


SERIES = re.compile(r"^(dvt_serve_replicas|dvt_serve_live_replicas|"
                    r"dvt_deploy_)\S*", re.M)


def _series(text):
    return {m.group(0).split("{")[0].split(" ")[0]
            for m in SERIES.finditer(text)}


def test_fleet_and_deploy_series_match_reference(plane):
    """The plane's stats with a replicated engine and a deploy pipeline
    (ledger, watcher, autoscaler) through both packages' renderers: the
    same dvt_serve_replicas* and dvt_deploy_* series and labels, and the
    same values.  Control: without the pipeline the deploy series
    vanish."""
    reg, sm, p = plane
    history = DeploymentHistory()
    watcher = CheckpointWatcher(p, history, gate=AccuracyGate()) \
        .watch("lenet5")
    watcher.poll_once("lenet5")
    scaler = ReplicaAutoscaler(lambda: p.active_engine("lenet5"),
                               name="lenet5", min_replicas=1,
                               max_replicas=3)
    scaler.tick()
    pipeline = DeployPipeline(p, history=history, watcher=watcher,
                              autoscalers={"lenet5": scaler})
    eng = p.active_engine("lenet5")
    eng.add_replica(CPU)
    eng.remove_replica(drain_deadline=5.0)
    history.record("lenet5", "scale_up", replica=2)
    stats = p.stats()
    stats["deploy"] = pipeline.stats()
    mine, ref = render_serve_metrics(stats), jax_render(stats)
    names = _series(mine)
    assert names == _series(ref)
    assert {"dvt_serve_replicas", "dvt_serve_live_replicas",
            "dvt_serve_replicas_added_total",
            "dvt_serve_replicas_removed_total",
            "dvt_deploy_history_records_total",
            "dvt_deploy_watcher_polls_total", "dvt_deploy_deploys_total",
            "dvt_deploy_gate_failures_total", "dvt_deploy_scale_ups_total",
            "dvt_deploy_scale_errors_total",
            "dvt_deploy_pressure_ms"} <= names
    want = [ln for ln in ref.splitlines() if SERIES.match(ln)]
    assert sorted(ln for ln in mine.splitlines() if SERIES.match(ln)) \
        == sorted(want)
    assert "dvt_serve_live_replicas{model=\"lenet5\"} 2" in mine
    stats.pop("deploy")
    assert not any(n.startswith("dvt_deploy_")
                   for n in _series(render_serve_metrics(stats)))


def _jax_args(**kw):
    base = dict(models=None, model="lenet5", stablehlo=None, buckets=None,
                workdir=None, watch=False, max_replicas=0, min_replicas=0,
                serve_devices=1)
    base.update(kw)
    return argparse.Namespace(**base)


@pytest.mark.parametrize("argv,jax_kw,match", [
    (["-m", "lenet5", "--watch"], {"watch": True}, "control plane"),
    (["-m", "lenet5", "--max-replicas", "2"], {"max_replicas": 2},
     "control plane"),
    (["--models", "lenet5", "--min-replicas", "2", "--serve-devices", "2"],
     {"models": "lenet5", "min_replicas": 2, "serve_devices": 2},
     "replica floor"),
    (["--models", "lenet5", "--min-replicas", "3", "--max-replicas", "2"],
     {"models": "lenet5", "min_replicas": 3, "max_replicas": 2},
     "--max-replicas 2 < --min-replicas 3"),
])
def test_cli_conflicts_raise_like_reference(tmp_path, argv, jax_kw, match):
    workdir = str(tmp_path)
    with pytest.raises(ValueError, match=match):
        jax_cli.build_server(_jax_args(workdir=workdir, **jax_kw))
    with pytest.raises(ValueError, match=match):
        cli.build_server(cli.build_parser().parse_args(
            argv + ["--workdir", workdir, "--device", "cpu",
                    "--port", "0"]))


def test_cli_serve_devices_beyond_the_machine(monkeypatch):
    """One card: --serve-devices 2 raises the reference's ValueError
    before any model work (two replicas on one card go through
    ReplicatedEngine(devices=[cuda:0, cuda:0]))."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="only 1 local device"):
        cli.build_server(cli.build_parser().parse_args(
            ["-m", "lenet5", "--serve-devices", "2", "--port", "0"]))


def test_cli_watch_and_autoscale_boot(tmp_path, capsys):
    """--models lenet5 --watch --min-replicas 1 --max-replicas 2 on the
    CPU: a replicated engine, the ledger under <workdir>/_deploy, a
    watcher that deploys a new step written under live clients, an
    autoscaler, and healthz/history over HTTP; --serve-devices 2 with
    --device cpu builds two CPU replicas."""
    workdir = str(tmp_path / "runs")
    write_step(f"{workdir}/lenet5", 1, tz.port("lenet5", lenet_variables(0)))
    args = cli.build_parser().parse_args(
        ["--models", "lenet5", "--workdir", workdir, "--device", "cpu",
         "--wire-dtype", "float32", "--port", "0", "--max-batch", "4",
         "--watch", "--watch-interval-s", "0.1", "--min-replicas", "1",
         "--max-replicas", "2", "--canary-frac", "0.5",
         "--canary-min-requests", "3", "--warmup"])
    p, server = cli.build_server(args)
    server.start_background()
    port = server.port
    try:
        eng = p.active_engine("lenet5")
        assert isinstance(eng, ReplicatedEngine) and eng.live_replicas() == 1
        deploy = server.httpd.deploy
        assert deploy.watcher is not None
        assert set(deploy.autoscalers) == {"lenet5"}
        assert deploy.history.root == f"{workdir}/_deploy"
        assert get(port, "/v1/healthz")[0] == 200
        clients = _Clients(port)
        try:
            write_step(f"{workdir}/lenet5", 2,
                       tz.port("lenet5", lenet_variables(0)))
            t_end = time.monotonic() + 60
            while deploy.watcher.stats()["deploys"] < 1 \
                    and time.monotonic() < t_end:
                time.sleep(0.05)
        finally:
            clients.finish()
        assert p.active_version("lenet5").model.restored_step == 2
        assert set(clients.statuses) == {200}
        status, body = get(port, "/v1/deploy/lenet5/history")
        assert [e["outcome"] for e in body["entries"]] == \
            ["candidate", "gate_passed", "promoted"]
        assert isinstance(p.active_engine("lenet5"), ReplicatedEngine)
        status, stats = get(port, "/v1/stats")
        assert stats["deploy"]["watcher"]["deploys"] == 1
        assert stats["deploy"]["autoscale"]["lenet5"]["max_replicas"] == 2
    finally:
        server.httpd.deploy.stop()
        server.shutdown()
        p.stop()
    engine, server = cli.build_server(cli.build_parser().parse_args(
        ["-m", "lenet5", "--device", "cpu", "--port", "0",
         "--serve-devices", "2", "--max-batch", "4"]))
    try:
        assert isinstance(engine, ReplicatedEngine)
        assert engine.devices == [CPU, CPU]
        assert isinstance(engine.infer(images(1)[0]), np.ndarray)
    finally:
        engine.stop()
        server.httpd.server_close()
