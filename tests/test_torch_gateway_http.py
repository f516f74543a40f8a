"""Real serving stacks behind the gateway on the CPU.

Two port LeNet-5 stacks (``device="cpu"``, the flax weights through
``convert.py``) sit behind the port's gateway, two reference stacks on
the same weights behind the reference's gateway; both packages' servers
and gateways run on their selector edges.  For the same payloads the
answers must agree within 1e-4·max|logit|.  One port backend is killed
mid-load (server and engine torn down, its sockets dropped) and no
admitted request is lost; two controls, the same kill with no retries
and a retry budget of 1 over a lone backend that dies, must lose
requests.  A drain mid-load counts every answer: each client sends a
fixed number of requests, and all of them answer 200."""

import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from _torch_serve import images, jax_lenet, lenet_variables, port_lenet

BOUND = 1e-4


@pytest.fixture(scope="module")
def models():
    variables = lenet_variables(3)
    return port_lenet(variables), jax_lenet(variables)


def _port_stack(sm, n):
    from deep_vision_tpu_torch.serve.engine import BatchingEngine
    from deep_vision_tpu_torch.serve.http import ServeServer
    from deep_vision_tpu_torch.serve.registry import ModelRegistry

    reg = ModelRegistry()
    reg.add(sm)
    engines = [BatchingEngine(sm, buckets=[1, 4], max_wait_ms=2).start()
               for _ in range(n)]
    servers = [ServeServer(reg, {sm.name: e}).start_background()
               for e in engines]
    return engines, servers


def _jax_stack(jsm, n):
    from deep_vision_tpu.serve.engine import BatchingEngine
    from deep_vision_tpu.serve.http import ServeServer
    from deep_vision_tpu.serve.registry import ModelRegistry

    reg = ModelRegistry()
    reg.add(jsm)
    engines = [BatchingEngine(jsm, buckets=[1, 4], max_wait_ms=2).start()
               for _ in range(n)]
    servers = [ServeServer(reg, {jsm.name: e}, port=0).start_background()
               for e in engines]
    return engines, servers


def _gateway(mod, servers, **kw):
    gw = mod.Gateway([f"127.0.0.1:{s.port}" for s in servers],
                     **kw).start()
    return gw, mod.GatewayServer(gw, port=0).start_background()


def _post(port, body, path="/v1/classify", timeout=30):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _logits(reply):
    return {t["class"]: t["logit"] for t in reply["top"]}


def _teardown(gw, gsrv, engines, servers, dead=()):
    gsrv.shutdown()
    gw.stop()
    for i, (eng, srv) in enumerate(zip(engines, servers)):
        if i not in dead:
            srv.shutdown()
            eng.stop()


def test_answers_through_both_gateways_agree(models):
    sm, jsm = models
    x = images(6, seed=11)
    answers = {}
    for name, stack, mod in (
            ("port", _port_stack, "deep_vision_tpu_torch.serve.gateway"),
            ("reference", _jax_stack, "deep_vision_tpu.serve.gateway")):
        import importlib

        gwmod = importlib.import_module(mod)
        engines, servers = stack(sm if name == "port" else jsm, 2)
        gw, gsrv = _gateway(gwmod, servers, probe_interval_s=0.05)
        try:
            replies = [_post(gsrv.port, {"pixels": im.tolist(),
                                         "top_k": 10}) for im in x]
            routed = {b: r["successes"] for b, r in
                      gw.healthz()[1]["backends"].items()}
        finally:
            _teardown(gw, gsrv, engines, servers)
        assert all(s == 200 for s, _ in replies), replies
        assert all(n > 0 for n in routed.values()), routed  # both routed
        answers[name] = [_logits(r) for _, r in replies]
    ref = np.asarray(jsm.compile_bucket(len(x))(x))
    bound = BOUND * np.abs(ref).max()
    for got, want, row in zip(answers["port"], answers["reference"], ref):
        assert sorted(got) == sorted(want) == list(range(10))
        np.testing.assert_allclose([got[c] for c in range(10)],
                                   [want[c] for c in range(10)],
                                   rtol=0, atol=bound)
        np.testing.assert_allclose([got[c] for c in range(10)], row,
                                   rtol=0, atol=bound)


def _kill_run(sm, n_backends, **gw_kw):
    """Closed-loop clients through the port gateway; backend 0 is torn
    down mid-load, then 4 sequential requests follow at once (an idle
    fleet round-robins, so at least one is routed to the dead backend
    before a probe can see it).  Returns (oks, errors, each backend's
    (routable, breaker), the backends' ports)."""
    from deep_vision_tpu_torch.serve import gateway as pgw

    engines, servers = _port_stack(sm, n_backends)
    gw, gsrv = _gateway(pgw, servers, request_timeout_s=30,
                        breaker_threshold=2, breaker_cooldown_s=30,
                        **gw_kw)
    body = {"pixels": np.zeros((32, 32, 1)).tolist()}
    oks, errors = [], []
    lock = threading.Lock()
    stop = threading.Event()

    def record(status, reply):
        with lock:
            if status == 200 and len(reply.get("top", [])) == 5:
                oks.append(status)
            else:
                errors.append((status, reply))

    def client():
        while not stop.is_set():
            try:
                record(*_post(gsrv.port, body))
            except Exception as e:  # noqa: BLE001 — a lost request
                with lock:
                    errors.append(repr(e))

    threads = [threading.Thread(target=client) for _ in range(3)]
    try:
        for t in threads:
            t.start()
        deadline = time.monotonic() + 30
        while len(oks) < 6 and not errors and time.monotonic() < deadline:
            time.sleep(0.01)
        # hard kill: the edge drops every open socket, like a SIGKILL
        servers[0].httpd.shutdown()
        servers[0].httpd.server_close()
        engines[0].stop(timeout=1)
        for _ in range(4):
            record(*_post(gsrv.port, body))
        time.sleep(0.5)
        stop.set()
        for t in threads:
            t.join(30)
        state = {b.name: (b.routable(), b.breaker) for b in gw.backends}
    finally:
        stop.set()
        _teardown(gw, gsrv, engines, servers, dead=(0,))
    return oks, errors, state, [s.port for s in servers]


def test_killed_backend_loses_no_request(models):
    sm, _ = models
    oks, errors, state, ports = _kill_run(sm, 2, probe_interval_s=0.05,
                                          retry_budget=3)
    assert errors == []
    assert len(oks) >= 10
    dead, live = (f"127.0.0.1:{p}" for p in ports)
    assert state[dead] == (False, "open")
    assert state[live] == (True, "closed")


@pytest.mark.parametrize("n_backends,retry_budget", [(2, 0), (1, 1)],
                         ids=["no-retries", "budget-1-lone-backend"])
def test_control_loses_requests(models, n_backends, retry_budget):
    """The zero-loss check can fail: with no retries a request routed
    to the dead backend is lost, and a budget of 1 cannot save a lone
    backend that dies."""
    sm, _ = models
    oks, errors, _, _ = _kill_run(sm, n_backends, probe_interval_s=10.0,
                                  retry_budget=retry_budget)
    assert len(errors) >= 1
    assert len(oks) >= 1


def test_drain_mid_load_answers_every_request(models):
    """POST /v1/drain on backend 0 while clients run: its healthz turns
    503 "draining" at once, the gateway routes away without a breaker
    penalty, and every one of the clients' fixed number of requests
    answers 200."""
    from deep_vision_tpu_torch.serve import gateway as pgw

    sm, _ = models
    engines, servers = _port_stack(sm, 2)
    gw, gsrv = _gateway(pgw, servers, probe_interval_s=0.05,
                        retry_budget=3)
    body = {"pixels": np.zeros((32, 32, 1)).tolist()}
    per_client, n_clients = 12, 3
    statuses, errors = [], []
    lock = threading.Lock()
    started = threading.Barrier(n_clients + 1)

    def client():
        started.wait(10)
        for _ in range(per_client):
            try:
                status, _ = _post(gsrv.port, body)
                with lock:
                    statuses.append(status)
            except Exception as e:  # noqa: BLE001 — a lost request
                with lock:
                    errors.append(repr(e))

    threads = [threading.Thread(target=client) for _ in range(n_clients)]
    try:
        for t in threads:
            t.start()
        started.wait(10)
        while len(statuses) < n_clients and not errors:
            time.sleep(0.005)
        status, reply = _post(servers[0].port, {"drain_deadline_s": 5},
                              path="/v1/drain")
        assert status == 200 and reply["status"] == "draining"
        with pytest.raises(urllib.error.HTTPError) as exc:
            urllib.request.urlopen(
                f"http://127.0.0.1:{servers[0].port}/v1/healthz",
                timeout=5)
        assert exc.value.code == 503
        assert json.loads(exc.value.read())["status"] == "draining"
        deadline = time.monotonic() + 5
        while gw.backends[0].routable() and time.monotonic() < deadline:
            time.sleep(0.01)
        assert gw.backends[0].unavailable == "draining"
        assert gw.backends[0].breaker == "closed"
        for t in threads:
            t.join(60)
    finally:
        _teardown(gw, gsrv, engines, servers)
    assert errors == []
    assert len(statuses) == per_client * n_clients
    assert all(s == 200 for s in statuses)
