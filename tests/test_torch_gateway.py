"""The port's gateway (``deep_vision_tpu_torch/serve/gateway.py`` and
``cli/gateway.py``) against the reference's on the CPU.

* The state machine: ``Backend`` of both packages goes through one
  scripted sequence of probes and outcomes with an explicit ``now``;
  every step's result, ``report(now)`` and retry tokens must be equal.
* Routing: both ``Gateway``s sit over the same in-process stub backends
  (the prober is not started: the script probes, so nothing races it)
  and take one scripted request sequence — round robin, failover past a
  failing backend, its breaker opening, 429 failover and pass-through
  with ``Retry-After``, rendezvous affinity and its failover; the picks,
  the proxied headers, ``counters()`` and the backend reports must be
  equal.
* Stats and metrics: over the same canned backend ``/v1/stats`` (engine
  and cascade blocks), ``Gateway.stats()`` with its time fields dropped
  and ``render_gateway_metrics`` (with an edge block) must be equal.
* The CLIs: ``cli.gateway``'s parser, and ``cli.serve``'s front-end
  flags, parse every argv to the reference's values.
"""

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import pytest

from deep_vision_tpu.serve import gateway as jgw
from deep_vision_tpu_torch.serve import gateway as pgw

PACKAGES = {"reference": jgw, "port": pgw}


# -- the state machine -----------------------------------------------------

MESH = {"lenet5": {"mesh_shape": None, "param_shard_bytes": 1000,
                   "hbm_headroom_bytes": 5}}

#: (method, args...) applied in order; ``now`` is the last float given
MACHINE = [
    ("report", 0.0),
    ("routable", 0.0),
    ("probe_ok", 0.1, ["lenet5"], MESH),
    ("serves", "lenet5"), ("serves", "other"), ("serves", None),
    ("begin",), ("done_success", 0.020),
    ("begin",), ("done_success", 0.040),
    ("begin",), ("done_failure", "boom 1", 0.2),
    ("try_retry",),
    ("begin",), ("done_failure", "boom 2", 0.3),
    ("begin",), ("done_failure", "boom 3", 0.4),
    ("routable", 0.5),
    ("routable", 0.9),
    ("routable", 1.45),
    ("begin",),
    ("routable", 1.46),
    ("done_failure", "trial failed", 1.5),
    ("routable", 1.6),
    ("probe_failure", "probe: ConnectionRefusedError", 1.7),
    ("probe_failure", "probe: ConnectionRefusedError", 1.8),
    ("probe_ok", 2.0, ["lenet5"], None),
    ("routable", 2.0),
    ("probe_ok", 2.9, None, None),
    ("routable", 2.9),
    ("probe_unavailable", "draining", 3.0),
    ("routable", 3.0),
    ("serves", "lenet5"),
    ("probe_ok", 3.25, ["lenet5", "lenet5_nano"], {}),
    ("routable", 3.25),
    ("begin",), ("done_shed",),
    *[("try_retry",)] * 12,
    ("begin",), ("done_success", 0.010),
    ("try_retry",),
    *[("begin",), ("done_success", 0.005)] * 11,
    ("try_retry",),
    ("begin",), ("done_failure", "boom 4", 4.0),
    ("begin",), ("done_failure", "boom 5", 4.1),
    ("begin",), ("done_failure", "boom 6", 4.2),
    ("begin",), ("done_failure", "boom 7", 4.3),
    ("begin",), ("done_failure", "boom 8", 4.4),
    ("begin",), ("done_failure", "boom 9", 4.5),
    ("routable", 9.0),
    ("begin",), ("done_success", 0.030),
    ("score",),
    ("report", 9.5),
]


def _run_machine(mod, kwargs):
    b = mod.Backend("http://127.0.0.1:8001/", **kwargs)
    now = 0.0
    trail = []
    for op, *args in MACHINE:
        fn = getattr(b, op)
        if op in ("report", "routable"):
            now = args[0]
            out = fn(now)
        elif op in ("done_failure", "probe_failure", "probe_unavailable"):
            now = args[-1]
            out = fn(*args)
        elif op == "probe_ok":
            now = args[0]
            out = fn(now, models=args[1], mesh=args[2])
        else:
            out = fn(*args)
        trail.append((op, out, b.report(now), b.retry_tokens_left()))
    return trail


@pytest.mark.parametrize("kwargs", [
    {},
    {"breaker_threshold": 2, "breaker_cooldown_s": 0.5,
     "degraded_after": 2, "dead_after": 4},
    {"breaker_threshold": 1, "breaker_cooldown_s": 3.0,
     "retry_ratio": 0.5, "retry_burst": 2.0, "ewma_alpha": 0.5},
], ids=["defaults", "tight", "one-strike"])
def test_backend_state_machine_equal_reference(kwargs):
    ref = _run_machine(jgw, kwargs)
    port = _run_machine(pgw, kwargs)
    for i, (r, p) in enumerate(zip(ref, port)):
        assert p == r, (i, MACHINE[i])
    assert len(port) == len(ref) == len(MACHINE)
    states = {rep["breaker"] for _, _, rep, _ in port}
    assert states == {"closed", "open", "half_open"}
    assert any(t < 1.0 for *_, t in port)  # the bucket ran dry


def test_backend_url_parsing_equal_reference():
    for url in ("http://127.0.0.1:8001/", "localhost:9000",
                "http://[::1]:8002"):
        b, jb = pgw.Backend(url), jgw.Backend(url)
        assert (b.host, b.port, b.name) == (jb.host, jb.port, jb.name)
    for bad in ("no-port", "http://host:", "host:port"):
        with pytest.raises(ValueError):
            pgw.Backend(bad)
        with pytest.raises(ValueError):
            jgw.Backend(bad)
    for mod in (pgw, jgw):
        with pytest.raises(ValueError):
            mod.Gateway(["127.0.0.1:1", "127.0.0.1:1"])
        with pytest.raises(ValueError):
            mod.Gateway([])
    assert (pgw.CLOSED, pgw.OPEN, pgw.HALF_OPEN) \
        == (jgw.CLOSED, jgw.OPEN, jgw.HALF_OPEN)
    assert pgw._PROXY_HEADERS == jgw._PROXY_HEADERS
    assert pgw.RETRY_BUDGET_HEADER == jgw.RETRY_BUDGET_HEADER


# -- stub backends ---------------------------------------------------------


def _engine_stats(served, bins):
    """One engine's /v1/stats entry with a latency histogram of ``bins``
    (count per bin index) on the reference's default edges."""
    from deep_vision_tpu_torch.core.metrics import LatencyHistogram

    h = LatencyHistogram()
    for i, n in bins.items():
        for _ in range(n):
            h.record(h.edges[i] * 1.01)
    return {"served": served, "submitted": served + 1,
            "latency_hist": h.state_dict(), "mesh_shape": None,
            "param_shard_bytes": 246824, "param_global_bytes": 246824,
            "mfu": {"flops_total": 1e9 * served, "compute_s": 0.5,
                    "batches": served // 2, "images": served,
                    "peak_flops_per_s": 1e12,
                    "flops_source": "counted"}}


def _cascade_stats(tag):
    from deep_vision_tpu_torch.core.metrics import LatencyHistogram

    h = LatencyHistogram()
    h.record(0.004)
    h.record(0.02 if tag == "a" else 0.03)
    return {"served": {"front": 5, "t1": 2, "big": 3},
            "escalations": 4, "escalated_lowconf": 3,
            "escalated_shed": 1, "samples": 2, "forced_big": 1,
            "hops": [{"hop": 0, "tier": "front", "token": "a",
                      "escalations": 3, "samples": 2, "sample_size": 40,
                      "calibrated": tag == "a"},
                     {"hop": 1, "tier": "t1", "token": "b",
                      "escalations": 1, "samples": 0, "sample_size": 9,
                      "calibrated": True}],
            "latency_hist": {"front": h.state_dict(), "big": None}}


CANNED = {
    # the flat shape: {model: engine stats} beside front-end blocks
    "a": {"lenet5": _engine_stats(40, {30: 3, 35: 9}),
          "kernels": {"serve_ingest": 7}},
    # the control plane's shape, with a cascade block
    "b": {"models": {"lenet5": {"engine": _engine_stats(22, {31: 4}),
                                "versions": []},
                     "lenet5_nano": {"engine": _engine_stats(5, {20: 5}),
                                     "versions": []}},
          "cache": {}, "plane": {}, "cascade": _cascade_stats("b")},
    # the same with an engine entry that has no histogram (skipped)
    "c": {"models": {"lenet5": {"engine": _engine_stats(3, {32: 2}),
                                "versions": []},
                     "lenet5_big": {"engine": {"served": 1}}},
          "cascade": _cascade_stats("a")},
}

class StubBackend:
    """A scriptable backend: the answer mode, healthz status and the
    canned /v1/stats are flipped by the test."""

    def __init__(self, tag: str):
        self.tag = tag
        self.mode = "ok"  # ok | fail | shed | busy
        self.healthz_status = 200
        self.requests = 0
        stub = self

        class H(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *a):
                pass

            def _reply(self, status, payload, headers=None):
                blob = json.dumps(payload).encode()
                self.send_response(status)
                self.send_header("Content-Type", "application/json")
                for k, v in (headers or {}).items():
                    self.send_header(k, str(v))
                self.send_header("Content-Length", str(len(blob)))
                self.end_headers()
                self.wfile.write(blob)

            def do_GET(self):
                if self.path == "/v1/healthz":
                    s = stub.healthz_status
                    self._reply(s, {"status": "ok" if s == 200
                                    else "draining",
                                    "models": ["lenet5"],
                                    "engines": {"lenet5": {
                                        "mesh_shape": None,
                                        "param_shard_bytes": 10,
                                        "hbm_headroom_bytes": None}}})
                else:
                    self._reply(200, CANNED[stub.tag])

            def do_POST(self):
                stub.requests += 1
                self.rfile.read(int(self.headers.get("Content-Length")
                                    or 0))
                if stub.mode == "fail":
                    self._reply(500, {"error": "injected"})
                elif stub.mode == "shed":
                    self._reply(429, {"error": "shed: queue_full"},
                                {"Retry-After": 2, "X-DVT-Cache": "miss"})
                elif stub.mode == "busy":
                    self._reply(409, {"status": "in_progress"})
                else:
                    self._reply(200, {"stub": stub.tag},
                                {"X-DVT-Tier": "front",
                                 "X-Other": "dropped"})

        self.httpd = ThreadingHTTPServer(("127.0.0.1", 0), H)
        self.httpd.daemon_threads = True
        self.url = f"127.0.0.1:{self.httpd.server_address[1]}"
        self._thread = threading.Thread(target=self.httpd.serve_forever,
                                        daemon=True)
        self._thread.start()

    def reset(self):
        self.mode, self.healthz_status, self.requests = "ok", 200, 0

    def close(self):
        self.httpd.shutdown()
        self.httpd.server_close()
        self._thread.join(5)


@pytest.fixture(scope="module")
def stubs():
    s = [StubBackend(t) for t in ("a", "b", "c")]
    yield s
    for stub in s:
        stub.close()


def _answer(out):
    status, headers, payload = out
    headers = {k: str(v) for k, v in headers.items()
               if k != "X-DVT-Request-Id"}
    return status, headers, json.loads(payload)


def _reports(gw):
    out = {}
    for b in gw.backends:
        r = b.report(0.0)
        r.pop("ewma_ms")
        r.pop("last_probe_age_s")
        out[b.name] = r
    return out


def _routing_script(mod, stubs):
    for s in stubs:
        s.reset()
    a, b, c = stubs
    gw = mod.Gateway([s.url for s in stubs], retry_budget=2,
                     breaker_threshold=2, breaker_cooldown_s=600,
                     backoff_ms=0.1, backoff_max_ms=0.2)
    trail = []
    try:
        gw._probe_all()

        def fwd(label, n, path="/v1/classify", body=b'{"x": 1}'):
            for _ in range(n):
                trail.append((label, _answer(gw.forward(path, body)),
                              gw.counters()))

        fwd("round robin", 6)
        b.mode = "fail"
        fwd("b fails", 5)
        gw._probe_all()  # b still answers its probe: stays open
        fwd("b open", 3)
        a.mode = "shed"
        fwd("a sheds", 3)
        c.mode = "shed"
        fwd("all shed", 2)
        c.healthz_status = 503
        gw._probe_all()
        fwd("c draining", 2)
        a.mode = c.mode = "busy"
        c.healthz_status = 200
        gw._probe_all()
        fwd("409 is final", 2, "/v1/models/lenet5/classify")
        fwd("unknown model", 1, "/v1/models/nope/classify")
        trail.append(("reports", _reports(gw), gw.routable_backends()))
    finally:
        gw.stop()
    return trail, [s.requests for s in stubs]


def _affinity_script(mod, stubs):
    for s in stubs:
        s.reset()
    gw = mod.Gateway([s.url for s in stubs], affinity=True,
                     retry_budget=2, breaker_threshold=1,
                     breaker_cooldown_s=600, backoff_ms=0.1,
                     backoff_max_ms=0.2)
    trail = []
    try:
        gw._probe_all()
        bodies = [json.dumps({"pixels": [i]}).encode() for i in range(8)]
        for _ in range(2):
            for body in bodies:
                trail.append(_answer(gw.forward("/v1/classify", body)))
        # the backend holding payload 0 fails: its keys move to their
        # next-highest backend, the others' keys stay
        home = trail[0][2]["stub"]
        next(s for s in stubs if s.tag == home).mode = "fail"
        for body in bodies:
            trail.append(_answer(gw.forward("/v1/classify", body)))
        trail.append(gw.counters())
        trail.append(_reports(gw))
    finally:
        gw.stop()
    return trail, [s.requests for s in stubs]


def test_routing_script_equal_reference(stubs):
    ref, ref_requests = _routing_script(jgw, stubs)
    port, port_requests = _routing_script(pgw, stubs)
    for r, p in zip(ref, port):
        assert p == r
    assert len(port) == len(ref)
    assert port_requests == ref_requests
    picks = [ans[2].get("stub") for label, ans, _ in port[:6]]
    assert sorted(picks) == ["a", "a", "b", "b", "c", "c"]
    status, headers, _ = port[18][1]  # "all shed": the 429 passes through
    assert status == 429 and headers["Retry-After"] == "2"
    assert "X-DVT-Retry-Budget" in headers
    counters = port[-2][2]
    assert counters["failovers"] > 0 and counters["breaker_opens"] >= 1
    reports = port[-1][1]
    assert reports[stubs[1].url]["breaker"] == "open"


def test_affinity_script_equal_reference(stubs):
    ref, ref_requests = _affinity_script(jgw, stubs)
    port, port_requests = _affinity_script(pgw, stubs)
    assert port == ref
    assert port_requests == ref_requests
    first, second = port[:8], port[8:16]
    assert [a[2] for a in first] == [a[2] for a in second]
    assert len({a[2]["stub"] for a in first}) > 1
    moved = port[16:24]
    home = first[0][2]["stub"]
    assert all(a[0] == 200 and a[2]["stub"] != home for a in moved)
    for before, after in zip(first, moved):
        if before[2]["stub"] != home:  # only the failed backend's keys move
            assert after[2] == before[2]


def _stats_script(mod, stubs):
    for s in stubs:
        s.reset()
    gw = mod.Gateway([s.url for s in stubs])
    try:
        gw._probe_all()
        stats = gw.stats()
        text = mod.render_gateway_metrics(gw, edge={
            "open_connections": 2, "keepalive_reuses": 9,
            "accepted": 4})
    finally:
        gw.stop()
    g = stats["gateway"]
    for key in ("latency", "latency_hist", "trace"):
        g.pop(key)
    for rep in g["backends"].values():
        rep.pop("ewma_ms")
        rep.pop("last_probe_age_s")
    return stats, text


def test_stats_and_metrics_equal_reference(stubs):
    ref_stats, ref_text = _stats_script(jgw, stubs)
    port_stats, port_text = _stats_script(pgw, stubs)
    assert port_stats == ref_stats
    assert port_text == ref_text
    g = port_stats["gateway"]
    assert g["backend_latency"]["count"] == 12 + 4 + 5 + 2
    assert sorted(g["models"]) == ["lenet5", "lenet5_nano"]
    assert g["cascade"]["served"] == {"front": 10, "t1": 4, "big": 6}
    assert g["mfu"]["serving_mfu"] is not None
    for name in ("dvt_gateway_open_connections 2",
                 "dvt_gateway_cascade_escalations_total 8",
                 "dvt_gateway_backend_latency_seconds_count 23"):
        assert name in port_text


# -- the CLIs --------------------------------------------------------------


class _Parsed(Exception):
    def __init__(self, args):
        super().__init__("parsed")
        self.args_ns = args


def _reference_args(monkeypatch, module, build_fn, argv):
    """The namespace the reference's ``main`` builds from ``argv``:
    its build function raises it back before anything starts."""
    import deep_vision_tpu.obs.log as jlog

    def capture(args):
        raise _Parsed(args)

    monkeypatch.setattr(module, build_fn, capture)
    monkeypatch.setattr(jlog, "configure_logging", lambda level: None)
    with pytest.raises(_Parsed) as e:
        module.main(argv)
    return vars(e.value.args_ns)


GATEWAY_ARGVS = [
    ["--backend", "127.0.0.1:8001"],
    ["--backend", "127.0.0.1:8001", "--backend", "h:8002", "--port", "0",
     "--host", "0.0.0.0", "--hedge", "--hedge-after-ms", "40",
     "--affinity", "--retry-budget", "1", "--retry-budget-ratio", "0.5",
     "--retry-budget-burst", "3", "--probe-interval-ms", "50",
     "--probe-timeout-s", "2", "--request-timeout-s", "9",
     "--backoff-ms", "1", "--backoff-max-ms", "5",
     "--breaker-threshold", "2", "--breaker-cooldown-s", "0.5",
     "--degraded-after", "2", "--dead-after", "3"],
    ["--backend", "a:1", "--thread-server", "--max-connections", "64",
     "--http-workers", "2", "--max-body-mb", "1.5",
     "--socket-timeout-s", "0", "--verbose", "--faults",
     "gateway:conn_reset:p=0.2", "--fault-seed", "7", "--log-level",
     "debug", "--trace-ring", "16", "--slow-trace-ms", "0",
     "--no-trace"],
]


@pytest.mark.parametrize("argv", GATEWAY_ARGVS, ids=["defaults", "routing",
                                                     "front-end"])
def test_gateway_parser_equal_reference(monkeypatch, argv):
    import deep_vision_tpu.cli.gateway as jcli
    from deep_vision_tpu_torch.cli import gateway as cli

    ref = _reference_args(monkeypatch, jcli, "build_gateway", argv)
    assert vars(cli.build_parser().parse_args(argv)) == ref


SERVE_FLAGS = ("host", "port", "thread_server", "max_connections",
               "http_workers", "verbose", "log_level", "socket_timeout_s",
               "max_body_mb")


@pytest.mark.parametrize("extra", [
    [],
    ["--host", "0.0.0.0", "--thread-server", "--max-connections", "8",
     "--http-workers", "3", "--verbose", "--log-level", "warning"],
], ids=["defaults", "set"])
def test_serve_front_end_flags_equal_reference(monkeypatch, extra):
    import deep_vision_tpu.cli.serve as jcli
    import deep_vision_tpu.core.compile_cache as jcc
    from deep_vision_tpu_torch.cli import serve as cli

    monkeypatch.setattr(jcc, "enable_compile_cache", lambda *a, **k: None)
    argv = ["-m", "lenet5", "--workdir", "w", "--port", "0"] + extra
    ref = _reference_args(monkeypatch, jcli, "build_server", argv)
    port = vars(cli.build_parser().parse_args(argv))
    assert {k: port[k] for k in SERVE_FLAGS} \
        == {k: ref[k] for k in SERVE_FLAGS}
    kw = cli._edge_kwargs(cli.build_parser().parse_args(argv))
    assert kw["edge"] is (not port["thread_server"])
    assert (kw["max_connections"], kw["http_workers"]) \
        == (port["max_connections"], port["http_workers"])
    with pytest.raises(SystemExit):
        cli.build_parser().parse_args(argv + ["--log-level", "loud"])


def test_build_gateway_wires_the_flags(stubs):
    """``build_gateway`` of both packages over the same argv: the same
    gateway knobs, the edge by default and the thread server on
    ``--thread-server``."""
    import deep_vision_tpu.cli.gateway as jcli
    from deep_vision_tpu_torch.cli import gateway as cli
    from deep_vision_tpu_torch.serve.edge import EdgeServer
    from deep_vision_tpu_torch.serve.faults import FaultPlane

    for s in stubs:
        s.reset()
    argv = ["--backend", stubs[0].url, "--backend", stubs[1].url,
            "--port", "0", "--retry-budget", "1", "--faults",
            "gateway:conn_reset:p=0.5", "--fault-seed", "3",
            "--http-workers", "2"]
    knobs = ("probe_interval_s", "probe_timeout_s", "request_timeout_s",
             "retry_budget", "backoff_ms", "backoff_max_ms", "hedge",
             "hedge_after_ms", "affinity", "retry_budget_ratio",
             "retry_budget_burst")
    built = []
    for mod in (jcli, cli):
        gw, server = mod.build_gateway(cli.build_parser().parse_args(argv))
        try:
            built.append(({k: getattr(gw, k) for k in knobs},
                          gw.faults.spec, gw.faults.seed,
                          server.httpd.stats()["workers"],
                          gw.routable_backends()))
        finally:
            server.httpd.server_close()
            gw.stop()
    assert built[0] == built[1]
    gw, server = cli.build_gateway(cli.build_parser().parse_args(argv))
    try:
        assert isinstance(server.httpd, EdgeServer)
        assert isinstance(gw.faults, FaultPlane)
    finally:
        server.httpd.server_close()
        gw.stop()
    gw, server = cli.build_gateway(cli.build_parser().parse_args(
        argv + ["--thread-server"]))
    try:
        assert not isinstance(server.httpd, EdgeServer)
    finally:
        server.httpd.server_close()
        gw.stop()


def test_gateway_loads_no_cuda_state():
    """The gateway process runs no device code: building and serving a
    gateway imports no ``torch`` (so no CUDA state can exist), and even
    with ``torch`` imported beside it, CUDA stays uninitialised."""
    import subprocess
    import sys

    code = (
        "import sys, json, urllib.request\n"
        "from deep_vision_tpu_torch.cli import gateway as cli\n"
        "gw, server = cli.build_gateway(cli.build_parser().parse_args(\n"
        "    ['--backend', '127.0.0.1:9', '--port', '0']))\n"
        "server.start_background()\n"
        "try:\n"
        "    urllib.request.urlopen(f'http://127.0.0.1:{server.port}'\n"
        "                           '/v1/stats', timeout=10).read()\n"
        "    req = urllib.request.Request(\n"
        "        f'http://127.0.0.1:{server.port}/v1/classify',\n"
        "        data=b'{\"pixels\": [0]}')\n"
        "    try:\n"
        "        urllib.request.urlopen(req, timeout=10)\n"
        "    except urllib.error.HTTPError as e:\n"
        "        assert e.code in (502, 503), e.code\n"
        "finally:\n"
        "    server.shutdown()\n"
        "    gw.stop()\n"
        "print(json.dumps({'torch': 'torch' in sys.modules}))\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-3000:]
    assert json.loads(r.stdout.strip().splitlines()[-1]) == {"torch": False}
    # in a process that has torch loaded (the CPU test run), the gateway
    # still leaves CUDA alone
    import torch

    from deep_vision_tpu_torch.cli import gateway as cli

    was = torch.cuda.is_initialized()
    gw, server = cli.build_gateway(cli.build_parser().parse_args(
        ["--backend", "127.0.0.1:9", "--port", "0"]))
    try:
        gw.stats()
    finally:
        server.httpd.server_close()
        gw.stop()
    assert torch.cuda.is_initialized() is was


def test_dropped_time_fields_are_present(stubs):
    """What the parity tests drop is really time: the fields are there
    and numeric on both packages."""
    for s in stubs:
        s.reset()
    for mod in PACKAGES.values():
        gw = mod.Gateway([stubs[0].url])
        try:
            gw._probe_all()
            gw.forward("/v1/classify", b'{"x": 1}')
            time.sleep(0.01)
            s = gw.stats(include_backend_stats=False)["gateway"]
            assert s["latency"]["count"] == 1
            rep = s["backends"][stubs[0].url]
            assert rep["ewma_ms"] > 0 and rep["last_probe_age_s"] >= 0
        finally:
            gw.stop()
