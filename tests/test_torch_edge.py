"""The port's selector edge (``deep_vision_tpu_torch/serve/edge.py``)
against the reference's (``deep_vision_tpu/serve/edge.py``) on the CPU.

The same raw byte scripts go over real sockets to both ``EdgeServer``s,
each over one echo handler; the bytes that come back must be equal once
the ``Date`` header is dropped, and so must ``stats()``.  The scripts
cover keep-alive reuse and pipelined order, 431 / 400 / 501 / 500, 413
without buffering the body, 408 on a stalled body and the silent close
of a slow loris, eviction at ``max_connections`` and accept pauses, and
a chunked stream with and without a mid-stream generator error.  Then
the port's ``_Handler`` runs under the edge shim with a real engine:
the 413 path, ``/v1/stats``'s ``edge`` block, and the ``/metrics``
renderers of both packages over the same ``edge`` block."""

import contextlib
import json
import socket
import threading
import time

import numpy as np
import pytest

from deep_vision_tpu.serve import edge as jedge
from deep_vision_tpu_torch.serve import edge as pedge


class _EchoHandler:
    """GET echoes the path, POST the body; ``/boom`` raises, ``/block``
    waits for the server's ``release`` event, ``/stream`` and
    ``/stream-bad`` hand the edge a chunked body (the second raises
    after its first piece).  Mixed into ``BaseHTTPRequestHandler`` below
    so both shims build it the same way."""

    protocol_version = "HTTP/1.1"

    def log_message(self, *a):
        pass

    def _reply(self, payload, status=200):
        blob = json.dumps(payload).encode()
        self.send_response(status)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(blob)))
        self.end_headers()
        self.wfile.write(blob)

    def _stream_reply(self, pieces, fail_after=None):
        self.send_response(200)
        self.send_header("Content-Type", "application/x-ndjson")
        self.send_header("Transfer-Encoding", "chunked")
        self.end_headers()

        def gen():
            for i, piece in enumerate(pieces):
                if fail_after is not None and i == fail_after:
                    raise RuntimeError("generator bug")
                yield piece

        self._stream = gen()

    def do_GET(self):
        if self.path == "/boom":
            raise RuntimeError("handler bug")
        if self.path == "/block":
            self.server.entered.set()
            self.server.release.wait(10)
        if self.path == "/stream":
            self._stream_reply([b'{"row": 0}\n', b"", b'{"row": 1}\n'])
            return
        if self.path == "/stream-bad":
            self._stream_reply([b'{"row": 0}\n', b'{"row": 1}\n'],
                               fail_after=1)
            return
        self._reply({"path": self.path})

    def do_POST(self):
        n = int(self.headers.get("Content-Length") or 0)
        cap = getattr(self.server, "max_body_bytes", None)
        if cap is not None and n > cap:
            # the handler's own 413, checked before reading the body
            self.close_connection = True
            self._reply({"error": f"body of {n} bytes"}, status=413)
            return
        self._reply({"echo": self.rfile.read(n).decode()})


def _handler():
    from http.server import BaseHTTPRequestHandler

    return type("EchoHandler", (_EchoHandler, BaseHTTPRequestHandler), {})


@contextlib.contextmanager
def _serving(mod, attrs=None, **kw):
    srv = mod.EdgeServer(("127.0.0.1", 0), _handler(), **kw)
    srv.entered, srv.release = threading.Event(), threading.Event()
    for k, v in (attrs or {}).items():
        setattr(srv, k, v)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    try:
        yield srv
    finally:
        srv.release.set()
        srv.shutdown()
        srv.server_close()
        t.join(5)


def _connect(srv):
    sock = socket.create_connection(("127.0.0.1", srv.server_address[1]))
    sock.settimeout(5)
    return sock


def _read_all(sock) -> bytes:
    """Everything the server sends until it closes (or resets)."""
    out = b""
    while True:
        try:
            data = sock.recv(65536)
        except (ConnectionResetError, TimeoutError):
            return out
        if not data:
            return out
        out += data


def _read_n(sock, n: int) -> bytes:
    """Exactly ``n`` framed, Content-Length responses off a keep-alive
    socket (the connection stays open)."""
    f = sock.makefile("rb")
    out = b""
    for _ in range(n):
        length = 0
        while True:
            line = f.readline()
            out += line
            if line in (b"", b"\r\n"):
                break
            k, _, v = line.partition(b":")
            if k.strip().lower() == b"content-length":
                length = int(v)
        out += f.read(length)
    f.close()
    return out


def _strip_date(blob: bytes) -> bytes:
    return b"".join(line for line in blob.splitlines(keepends=True)
                    if not line.startswith(b"Date: "))


def _settled_stats(srv, open_connections=0):
    """``stats()`` once the loop has closed what the client saw closed
    (the client can read EOF a moment before the loop's bookkeeping)."""
    deadline = time.monotonic() + 3
    while srv.stats()["open_connections"] != open_connections \
            and time.monotonic() < deadline:
        time.sleep(0.01)
    return srv.stats()


GET = b"GET %s HTTP/1.1\r\nHost: x\r\n\r\n"
GET_CLOSE = b"GET %s HTTP/1.1\r\nHost: x\r\nConnection: close\r\n\r\n"

#: name -> (server attributes, [(bytes to send, seconds to wait after)]);
#: the transcript is read to EOF, except for the loop-generated 4xx
#: answers (``ONE_RESPONSE``), after which the client reads one response
#: and hangs up: there the reference keeps the connection open until the
#: peer's next event (see ``test_stalled_body_closes_after_one_408``)
SCRIPTS = {
    "keepalive": ({}, [(GET % b"/a", 0.2), (GET % b"/b", 0.2),
                       (GET_CLOSE % b"/c", 0)]),
    "pipelined": ({}, [(GET % b"/first"
                        + b"POST /second HTTP/1.1\r\nHost: x\r\n"
                          b"Content-Length: 5\r\n\r\nhello"
                        + GET_CLOSE % b"/third", 0)]),
    "body_in_pieces": ({}, [(b"POST /p HTTP/1.1\r\nHost: x\r\n"
                             b"Content-Length: 11\r\n\r\nhello", 0.1),
                            (b" world" + GET_CLOSE % b"/after", 0)]),
    "http10_closes": ({}, [(b"GET /old HTTP/1.0\r\n\r\n", 0)]),
    "http09_line": ({}, [(b"GET /old\r\n\r\n", 0)]),
    "overlong_head_431": ({}, [(b"GET / HTTP/1.1\r\nX-Pad: "
                                + b"a" * (70 * 1024), 0)]),
    "malformed_line_400": ({}, [(b"ONE TWO THREE FOUR\r\n\r\n", 0)]),
    "unsupported_501": ({}, [(b"BREW /pot HTTP/1.1\r\nHost: x\r\n\r\n", 0)]),
    "handler_500": ({}, [(GET % b"/boom", 0)]),
    "oversize_413": ({"max_body_bytes": 1024},
                     [(b"POST /big HTTP/1.1\r\nHost: x\r\n"
                       b"Content-Length: 1000000000\r\n\r\n", 0)]),
    "stalled_body_408": ({"socket_timeout_s": 0.3},
                         [(b"POST /x HTTP/1.1\r\nHost: x\r\n"
                           b"Content-Length: 100\r\n\r\n{\"sta", 0)]),
    "slow_loris": ({"socket_timeout_s": 0.3}, [(b"GET /nev", 0)]),
    "idle_keepalive": ({"socket_timeout_s": 0.3}, [(GET % b"/a", 0)]),
    "stream": ({}, [(GET_CLOSE % b"/stream", 0)]),
    "stream_then_request": ({}, [(GET % b"/stream"
                                  + GET_CLOSE % b"/next", 0)]),
    "stream_error": ({}, [(GET % b"/stream-bad", 0)]),
}
ONE_RESPONSE = ("overlong_head_431", "malformed_line_400",
                "stalled_body_408")


def _run_script(mod, attrs, steps, one_response=False):
    with _serving(mod, attrs) as srv:
        sock = _connect(srv)
        try:
            for data, wait_s in steps:
                sock.sendall(data)
                if wait_s:
                    time.sleep(wait_s)
            blob = _read_n(sock, 1) if one_response else _read_all(sock)
        finally:
            sock.close()
        return _strip_date(blob), _settled_stats(srv)


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_script_bytes_and_stats_equal_reference(name):
    attrs, steps = SCRIPTS[name]
    one = name in ONE_RESPONSE
    ref_blob, ref_stats = _run_script(jedge, attrs, steps, one)
    port_blob, port_stats = _run_script(pedge, attrs, steps, one)
    assert port_blob == ref_blob
    assert port_stats == ref_stats
    # what each script is about, read off the shared transcript
    expect = {"keepalive": (b"HTTP/1.1 200", 3),
              "pipelined": (b"HTTP/1.1 200", 3),
              "overlong_head_431": (b"HTTP/1.1 431", 1),
              "malformed_line_400": (b"HTTP/1.1 400", 1),
              "unsupported_501": (b"HTTP/1.1 501", 1),
              "handler_500": (b"HTTP/1.1 500", 1),
              "oversize_413": (b"HTTP/1.1 413", 1),
              "stalled_body_408": (b"HTTP/1.1 408", 1)}.get(name)
    if expect is not None:
        assert port_blob.count(expect[0]) == expect[1], port_blob[:300]
    if name == "keepalive":
        assert port_stats["accepted"] == 1
        assert port_stats["keepalive_reuses"] == 2
    if name == "pipelined":
        bodies = [b'{"path": "/first"}', b'{"echo": "hello"}',
                  b'{"path": "/third"}']
        at = [port_blob.index(b) for b in bodies]
        assert at == sorted(at)  # answered in request order
    if name == "oversize_413":
        # answered from the headers alone: no body was ever sent
        assert port_stats["requests"] == 1
    if name in ("slow_loris", "idle_keepalive"):
        assert port_stats["closed_idle"] == 1
        assert port_stats["timeouts_408"] == 0
        if name == "slow_loris":
            assert port_blob == b""  # closed without a word
    if name == "stream":
        assert port_blob.endswith(b'b\r\n{"row": 1}\n\r\n0\r\n\r\n')
        assert port_stats["streams_started"] == 1
    if name == "stream_error":
        # a truncated chunked body: the first frame, no terminator
        assert port_blob.endswith(b'b\r\n{"row": 0}\n\r\n')
        assert port_stats["stream_errors"] == 1


def _linger(mod):
    """A stalled body answered 408, and the client neither reads on nor
    hangs up: the transcript up to the server's close."""
    attrs, steps, _ = SCRIPTS["stalled_body_408"] + (None,)
    with _serving(mod, attrs) as srv:
        sock = _connect(srv)
        try:
            sock.sendall(steps[0][0])
            sock.settimeout(1.5)
            blob = _read_all(sock)
        finally:
            sock.close()
        return _strip_date(blob), _settled_stats(srv)


def test_stalled_body_closes_after_one_408():
    """The port's one departure from the reference edge: a connection
    whose loop-generated 408 went out is closed at its next deadline.
    The reference keeps it and answers 408 again at every sweep."""
    ref_blob, ref_stats = _linger(jedge)
    port_blob, port_stats = _linger(pedge)
    assert ref_blob.count(b"HTTP/1.1 408") >= 2
    assert port_blob.count(b"HTTP/1.1 408") == 1
    assert ref_blob.startswith(port_blob)
    assert port_stats["timeouts_408"] == 1
    assert port_stats["open_connections"] == 0


def _evict(mod):
    """Ceiling 2: a third client displaces the oldest idle connection."""
    out = []
    with _serving(mod, max_connections=2) as srv:
        c1, c2 = _connect(srv), _connect(srv)
        try:
            c1.sendall(GET % b"/a")
            out.append(_read_n(c1, 1))
            time.sleep(0.05)
            c2.sendall(GET % b"/b")
            out.append(_read_n(c2, 1))
            c3 = _connect(srv)
            c3.sendall(GET_CLOSE % b"/c")
            out.append(_read_all(c3))
            out.append(_read_all(c1))  # evicted: EOF, no bytes
            c3.close()
        finally:
            c1.close()
            c2.close()
        stats = _settled_stats(srv, 0)
    return [_strip_date(b) for b in out], stats


def _pause(mod):
    """Ceiling 1 with a request in flight: accepting pauses, and the
    queued client is served once the slot frees."""
    with _serving(mod, max_connections=1) as srv:
        c1 = _connect(srv)
        c1.sendall(GET % b"/block")
        assert srv.entered.wait(5)
        c2 = _connect(srv)  # waits in the listen backlog
        c2.sendall(GET_CLOSE % b"/queued")
        deadline = time.monotonic() + 5
        while srv.stats()["accept_pauses"] < 1 \
                and time.monotonic() < deadline:
            time.sleep(0.01)
        paused = srv.stats()
        srv.release.set()
        first = _read_n(c1, 1)
        c1.close()  # the slot frees: accepting resumes
        second = _read_all(c2)
        c2.close()
        stats = _settled_stats(srv, 0)
    return [_strip_date(first), _strip_date(second)], paused, stats


def test_eviction_at_max_connections_equal_reference():
    ref_out, ref_stats = _evict(jedge)
    port_out, port_stats = _evict(pedge)
    assert port_out == ref_out
    assert port_stats == ref_stats
    assert port_out[3] == b"" and port_stats["evicted_idle"] == 1
    assert b'{"path": "/c"}' in port_out[2]


def test_accept_pauses_equal_reference():
    ref_out, ref_paused, ref_stats = _pause(jedge)
    port_out, port_paused, port_stats = _pause(pedge)
    assert port_out == ref_out
    assert port_paused == ref_paused
    assert port_stats == ref_stats
    assert port_paused["accept_paused"] is True
    assert port_paused["accepted"] == 1
    assert b'{"path": "/queued"}' in port_out[1]
    assert port_stats["accept_pauses"] == 1


def test_helpers_equal_reference():
    for data in (b"", b"x", b"a" * 300):
        assert pedge._chunk_frame(data) == jedge._chunk_frame(data)
    for status, reason, close in ((408, "Request Timeout", True),
                                  (200, "OK", False)):
        assert pedge._plain_response(status, reason, "HTTP/1.1",
                                     {"error": "e"}, close) \
            == jedge._plain_response(status, reason, "HTTP/1.1",
                                     {"error": "e"}, close)
    assert pedge.DEFAULT_MAX_CONNECTIONS == jedge.DEFAULT_MAX_CONNECTIONS


# -- the port's serving handler under the shim --------------------------------


@pytest.fixture(scope="module")
def lenet_server():
    from _torch_serve import lenet_variables, port_lenet
    from deep_vision_tpu_torch.serve.engine import BatchingEngine
    from deep_vision_tpu_torch.serve.http import ServeServer
    from deep_vision_tpu_torch.serve.registry import ModelRegistry

    sm = port_lenet(lenet_variables(0))
    reg = ModelRegistry()
    reg.add(sm)
    eng = BatchingEngine(sm, buckets=[1, 2], max_wait_ms=1).start()
    srv = ServeServer(reg, {sm.name: eng}, max_body_bytes=65536,
                      http_workers=3, max_connections=16)
    srv.start_background()
    try:
        yield srv, eng
    finally:
        srv.shutdown()
        eng.stop()


def test_serve_server_runs_on_the_edge_by_default(lenet_server):
    from deep_vision_tpu_torch.serve.http import ServeServer, _HTTPServer

    srv, eng = lenet_server
    assert isinstance(srv.httpd, pedge.EdgeServer)
    assert srv.httpd.stats()["workers"] == 3
    assert srv.httpd.max_connections == 16
    thread = ServeServer(srv.httpd.registry, srv.httpd.engines, edge=False)
    try:
        assert isinstance(thread.httpd, _HTTPServer)
        assert thread.httpd.request_queue_size == 128
    finally:
        thread.httpd.server_close()


def test_oversized_body_answers_413_from_the_handler(lenet_server):
    """The edge hands the handler an empty body; its Content-Length
    check answers 413 and closes before the payload is shipped."""
    srv, _ = lenet_server
    sock = socket.create_connection(("127.0.0.1", srv.port))
    sock.settimeout(5)
    try:
        sock.sendall(b"POST /v1/classify HTTP/1.1\r\nHost: x\r\n"
                     b"Content-Length: 1000000\r\n\r\n")
        blob = _read_all(sock)
    finally:
        sock.close()
    assert blob.startswith(b"HTTP/1.1 413")
    assert b"exceeds the 65536-byte cap" in blob


def test_keepalive_classify_and_edge_stats_block(lenet_server):
    """Several classify requests on one connection, then /v1/stats'
    ``edge`` block counts the reuses and /metrics carries the
    dvt_serve_edge_* series."""
    from http.client import HTTPConnection

    srv, _ = lenet_server
    before = srv.httpd.stats()
    conn = HTTPConnection("127.0.0.1", srv.port, timeout=30)
    body = json.dumps({"pixels": np.zeros((32, 32, 1)).tolist()})
    try:
        for _ in range(3):
            conn.request("POST", "/v1/classify", body,
                         {"Content-Type": "application/json"})
            r = conn.getresponse()
            assert r.status == 200
            assert len(json.loads(r.read())["top"]) == 5
        conn.request("GET", "/v1/stats")
        stats = json.loads(conn.getresponse().read())
        conn.request("GET", "/metrics")
        text = conn.getresponse().read().decode()
    finally:
        conn.close()
    edge = stats["edge"]
    assert edge["accepted"] == before["accepted"] + 1
    assert edge["keepalive_reuses"] == before["keepalive_reuses"] + 3
    assert "lenet5" in stats and "kernels" in stats
    assert "dvt_serve_open_connections" in text
    assert "dvt_serve_edge_keepalive_reuses_total" in text


EDGE_BLOCK = {"open_connections": 3, "max_connections": 1024,
              "accepted": 17, "evicted_idle": 2, "accept_pauses": 1,
              "accept_paused": False, "requests": 40,
              "keepalive_reuses": 23, "timeouts_408": 1, "closed_idle": 4,
              "overlong_heads": 0, "streams_started": 0,
              "stream_errors": 0, "workers": 8}


@pytest.mark.parametrize("extra", [
    {},
    {"response_cache": {"hits": 3, "misses": 5, "stale_hits": 0,
                        "evictions": 1, "insertions": 5, "bytes": 900,
                        "entries": 4, "insertions_by_tier": {}}},
    {"qos": {"premium": {"served": 4, "shed_quota": 0,
                         "shed_priority": 1, "cache_hits": 2,
                         "latency": {"p50_ms": 3.0, "p95_ms": 9.0,
                                     "p99_ms": 12.0}}}},
], ids=["edge", "edge+cache", "edge+qos"])
def test_metrics_renderers_equal_over_edge_block(extra):
    from deep_vision_tpu.serve.http import render_serve_metrics as jrender
    from deep_vision_tpu_torch.serve.http import render_serve_metrics

    stats = {"edge": dict(EDGE_BLOCK), **extra}
    text = render_serve_metrics(stats)
    assert text == jrender(stats)
    assert "dvt_serve_edge_accepted_total 17" in text
