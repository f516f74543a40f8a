"""Selector-based async HTTP edge shared by both serving tiers.

Port of ``deep_vision_tpu/serve/edge.py``: host code only, line for
line, with ``threading.Lock`` where the reference names its locks
through its sanitizer (the names stay in the comments).  One departure:
a connection whose loop-generated 408/400/431 has gone out is closed at
its next deadline, where the reference answers a stalled body 408 again
at every sweep (``_check_deadlines``).

The stdlib ``ThreadingHTTPServer`` front-ends spent one OS thread per
CONNECTION: a keep-alive client pinned a thread while idle, a thousand
open sockets meant a thousand stacks, and connection churn (accept +
thread spawn + teardown per request) capped offered load well below
what the engines behind them sustain.  ``EdgeServer`` replaces that
with one event-loop thread over ``selectors.DefaultSelector`` and
non-blocking sockets, plus a small worker pool that only ever holds a
thread for the duration of one REQUEST:

  keep-alive      HTTP/1.1 persistent connections with pipelined
                  request parsing — requests are parsed off the input
                  buffer as they complete and responses are delivered
                  strictly in request order per connection (ordered
                  response slots), so a burst of back-to-back POSTs on
                  one socket overlaps handler execution.
  bounded conns   ``max_connections`` caps concurrently open sockets.
                  At capacity the loop first evicts the oldest IDLE
                  connection (no buffered input, no request in flight);
                  with nothing idle it pauses accepting (the listener
                  leaves the selector — new clients queue in the TCP
                  backlog) and resumes as soon as a slot frees.
  deadlines       per-connection read/write deadlines preserve the
                  thread-server's slow-loris semantics byte for byte: a
                  connection that never sends a request line (or stalls
                  mid-headers, or sits idle between keep-alive
                  requests) is closed silently after
                  ``socket_timeout_s``; one that stalls MID-BODY after
                  delivering complete headers is answered 408 and
                  closed; a peer that stops reading while a response is
                  buffered is closed once the write stalls past the
                  same deadline.
  handler reuse   parsed requests run the UNCHANGED
                  ``BaseHTTPRequestHandler`` route classes
                  (``serve/http.py _Handler``, ``serve/gateway.py
                  _GatewayHandler``) against in-memory rfile/wfile
                  pairs — the routes, status lines, and headers move
                  over without behavior change, and the worker pool
                  bounds handler concurrency instead of the OS thread
                  count.

Oversized bodies are rejected without buffering: a Content-Length over
``max_body_bytes`` dispatches immediately with an EMPTY body and the
handler's own 413 path (which checks the header before reading rfile)
answers before the client has shipped the payload — same contract as
the threaded server, no attacker-sized allocation.

``stats()`` feeds ``dvt_serve_open_connections`` and the connection
counters (accepted / evicted / accept-pauses / keep-alive reuse) on
``/metrics``; ``tests/test_torch_edge.py`` holds the loop's bytes and
counters against the reference's over real sockets.
"""

from __future__ import annotations

import io
import json
import selectors
import socket
import threading
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from http.client import parse_headers

from deep_vision_tpu_torch.obs.log import event, get_logger

_log = get_logger("dvt.serve.edge")

DEFAULT_MAX_CONNECTIONS = 1024
_MAX_HEAD_BYTES = 64 * 1024
_RECV_CHUNK = 256 * 1024
_TICK_S = 0.05  # deadline-check granularity

_HEAD = "head"   # awaiting request line + headers
_BODY = "body"   # headers parsed, awaiting Content-Length bytes


class _Slot:
    """One request's ordered response slot on its connection.

    Buffered responses (``chunks is None``) fill ``data`` once and flip
    ``done``.  Streaming responses (HTTP/1.1 chunked transfer) set
    ``chunks`` to a deque the worker appends framed pieces to while the
    loop drains the head slot incrementally; ``done`` flips only after
    the terminating ``0\\r\\n\\r\\n`` frame (or, on a mid-stream handler
    error, without it — a truncated chunked body is how HTTP signals an
    incomplete response — with ``close`` set so the connection drops)."""

    __slots__ = ("done", "data", "close", "chunks")

    def __init__(self):
        self.done = False
        self.data = b""
        self.close = False
        self.chunks: deque | None = None


class _Conn:
    """Per-connection parse + write state, owned by the loop thread."""

    __slots__ = ("sock", "fd", "addr", "inbuf", "outbuf", "state",
                 "need", "method", "path", "version", "headers",
                 "body_parts", "pending", "requests", "last_activity",
                 "closing", "want_write")

    def __init__(self, sock, addr, now: float):
        self.sock = sock
        self.fd = sock.fileno()
        self.addr = addr
        self.inbuf = bytearray()
        self.outbuf = bytearray()
        self.state = _HEAD
        self.need = 0
        self.method = ""
        self.path = ""
        self.version = "HTTP/1.1"
        self.headers = None
        self.body_parts: list = []
        self.pending: deque = deque()  # _Slot, in request order
        self.requests = 0
        self.last_activity = now
        self.closing = False
        self.want_write = False

    def idle(self) -> bool:
        """Evictable: nothing buffered either way, no request in
        flight, between requests."""
        return (self.state == _HEAD and not self.inbuf
                and not self.outbuf and not self.pending)


class EdgeServer:
    """One selector event loop + worker pool behind a listening socket.

    Drop-in for the ``ThreadingHTTPServer`` slot in ``ServeServer`` /
    ``GatewayServer``: exposes ``server_address``, ``serve_forever()``,
    ``shutdown()``, ``server_close()`` and carries arbitrary context
    attributes (registry / engines / plane / gateway / ...) that the
    handler classes read via ``self.server.<attr>``.
    """

    def __init__(self, address: tuple, handler_cls, *,
                 max_connections: int = DEFAULT_MAX_CONNECTIONS,
                 workers: int = 8, name: str = "edge"):
        self.handler_cls = handler_cls
        self.max_connections = max(1, int(max_connections))
        self.name = name
        self._listener = socket.create_server(
            address, backlog=128, reuse_port=False)
        self._listener.setblocking(False)
        self.server_address = self._listener.getsockname()[:2]
        self._selector = selectors.DefaultSelector()
        self._selector.register(self._listener, selectors.EVENT_READ,
                                "accept")
        # loop wakeup: workers post completed responses then poke this
        self._wake_r, self._wake_w = socket.socketpair()
        self._wake_r.setblocking(False)
        self._wake_w.setblocking(False)
        self._selector.register(self._wake_r, selectors.EVENT_READ,
                                "wake")
        self._pool = ThreadPoolExecutor(
            max_workers=max(1, int(workers)),
            thread_name_prefix=f"{name}-worker")
        self._ready_lock = threading.Lock()  # serve.edge.EdgeServer._ready_lock
        self._ready: list = []  # guarded-by: _ready_lock
        self._conns: dict[int, _Conn] = {}  # loop thread only
        self._accept_paused = False
        self._stop_event = threading.Event()
        self._loop_done = threading.Event()
        self._closed = False
        # counters: loop-thread writes only; stats() reads are atomic
        # int loads, so no lock (same pattern as the engine's _forming)
        self.accepted = 0
        self.evicted_idle = 0
        self.accept_pauses = 0
        self.requests_handled = 0
        self.keepalive_reuses = 0
        self.timeouts_408 = 0
        self.closed_idle = 0
        self.overlong_heads = 0
        # streaming counters are WORKER-thread writes (unlike the loop
        # counters above), so they ride the existing response lock
        self.streams_started = 0  # guarded-by: _ready_lock
        self.stream_errors = 0  # guarded-by: _ready_lock
        self.draining = False  # handler context default; tiers override

    # -- lifecycle (ThreadingHTTPServer-compatible surface) ----------------

    def serve_forever(self):
        """Run the event loop until ``shutdown()``; blocks the caller
        (``ServeServer.start_background`` gives it a thread)."""
        try:
            while not self._stop_event.is_set():
                self._tick()
        finally:
            self._teardown()
            self._loop_done.set()

    def shutdown(self):
        """Stop the loop from another thread; open connections are
        closed abruptly (the SIGKILL shape chaos tests rely on)."""
        self._stop_event.set()
        self._wake()
        self._loop_done.wait(5.0)

    def server_close(self):
        if self._closed:
            return
        self._closed = True
        # if the loop never ran (shutdown before serve_forever), the
        # teardown here is the only close these sockets get
        if not self._loop_done.is_set():
            self._stop_event.set()
            try:
                self._listener.close()
            except OSError:
                pass
        self._pool.shutdown(wait=False)

    # -- the event loop ----------------------------------------------------

    def _tick(self):
        for key, _mask in self._selector.select(_TICK_S):
            if key.data == "accept":
                self._accept()
            elif key.data == "wake":
                self._drain_wake()
            else:
                self._io(key.data, _mask)
        self._flush_ready()
        self._check_deadlines()

    def _accept(self):
        # ONE accept per readiness event: the selector is level-
        # triggered, so a still-pending backlog re-reports the listener
        # next tick.  This keeps the capacity check honest — it only
        # runs when a connection really is waiting, so an idle victim
        # is never evicted for a phantom arrival.
        if len(self._conns) >= self.max_connections \
                and not self._evict_idle():
            self._pause_accept()
            return
        try:
            sock, addr = self._listener.accept()
        except (BlockingIOError, InterruptedError):
            return
        except OSError:
            return  # listener closed under us mid-shutdown
        sock.setblocking(False)
        try:
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        except OSError:
            pass
        conn = _Conn(sock, addr, time.monotonic())
        self._conns[conn.fd] = conn
        self._selector.register(sock, selectors.EVENT_READ, conn)
        self.accepted += 1

    def _evict_idle(self) -> bool:
        """Close the oldest idle connection to admit a new one."""
        victim = None
        for conn in self._conns.values():
            if not conn.idle():
                continue
            if victim is None or conn.last_activity \
                    < victim.last_activity:
                victim = conn
        if victim is None:
            return False
        self.evicted_idle += 1
        self._close_conn(victim)
        return True

    def _pause_accept(self):
        if not self._accept_paused:
            self._accept_paused = True
            self.accept_pauses += 1
            self._selector.unregister(self._listener)
            event(_log, "edge_accept_paused", edge=self.name,
                  open_connections=len(self._conns))

    def _resume_accept(self):
        if self._accept_paused \
                and len(self._conns) < self.max_connections:
            self._accept_paused = False
            self._selector.register(self._listener,
                                    selectors.EVENT_READ, "accept")
            event(_log, "edge_accept_resumed", edge=self.name,
                  open_connections=len(self._conns))

    def _drain_wake(self):
        try:
            while self._wake_r.recv(4096):
                pass
        except (BlockingIOError, OSError):
            pass

    def _wake(self):
        try:
            self._wake_w.send(b"\x00")
        except (BlockingIOError, OSError):
            pass  # wakeup already pending, or loop torn down

    def _io(self, conn: _Conn, mask: int):
        if conn.sock is None:
            return
        if mask & selectors.EVENT_READ:
            try:
                data = conn.sock.recv(_RECV_CHUNK)
            except (BlockingIOError, InterruptedError):
                data = None
            except OSError:
                self._close_conn(conn)
                return
            if data == b"":
                self._close_conn(conn)  # peer EOF
                return
            if data:
                conn.last_activity = time.monotonic()
                conn.inbuf += data
                if not self._parse(conn):
                    return  # connection closed during parse
        if mask & selectors.EVENT_WRITE and conn.sock is not None:
            self._write(conn)

    # -- HTTP/1.1 incremental parsing --------------------------------------

    def _parse(self, conn: _Conn) -> bool:
        """Consume as many complete requests from ``conn.inbuf`` as are
        buffered (pipelining).  Returns False when the connection was
        closed (parse error / oversized head)."""
        while conn.sock is not None and not conn.closing:
            if conn.state == _HEAD:
                end = conn.inbuf.find(b"\r\n\r\n")
                if end < 0:
                    if len(conn.inbuf) > _MAX_HEAD_BYTES:
                        self.overlong_heads += 1
                        self._respond_plain(
                            conn, 431, "Request Header Fields Too Large",
                            {"error": "request head exceeds "
                                      f"{_MAX_HEAD_BYTES} bytes"})
                        conn.closing = True
                        return True
                    return True  # need more bytes
                head = bytes(conn.inbuf[:end])
                del conn.inbuf[:end + 4]
                if not self._parse_head(conn, head):
                    return False
                if conn.state == _HEAD:
                    continue  # request had no body: dispatched already
            if conn.state == _BODY:
                take = min(conn.need, len(conn.inbuf))
                if take:
                    conn.body_parts.append(bytes(conn.inbuf[:take]))
                    del conn.inbuf[:take]
                    conn.need -= take
                if conn.need > 0:
                    return True  # body still streaming in
                body = b"".join(conn.body_parts)
                conn.body_parts = []
                conn.state = _HEAD
                self._dispatch(conn, body)
        return True

    def _parse_head(self, conn: _Conn, head: bytes) -> bool:
        """Request line + headers → either dispatch (no body / over-cap
        body) or switch to body accumulation.  Returns False when the
        connection was closed on a malformed request."""
        line, _, rest = head.partition(b"\r\n")
        parts = line.split()
        if len(parts) == 2:  # HTTP/0.9-style "GET /path"
            parts.append(b"HTTP/1.0")
        if len(parts) != 3:
            self._respond_plain(conn, 400, "Bad Request",
                                {"error": "malformed request line"})
            conn.closing = True
            return True
        try:
            conn.method = parts[0].decode("ascii")
            conn.path = parts[1].decode("iso-8859-1")
            conn.version = parts[2].decode("ascii")
            conn.headers = parse_headers(io.BytesIO(rest + b"\r\n"))
        except (UnicodeDecodeError, ValueError):
            self._respond_plain(conn, 400, "Bad Request",
                                {"error": "malformed request head"})
            conn.closing = True
            return True
        try:
            length = int(conn.headers.get("Content-Length") or 0)
        except ValueError:
            length = 0
        cap = getattr(self, "max_body_bytes", None)
        if cap is not None and length > cap:
            # dispatch NOW with an empty body: the handler's own 413
            # path checks Content-Length before reading rfile, so the
            # reply goes out before the client ships the payload and
            # nothing attacker-sized is ever buffered
            self._dispatch(conn, b"")
            return True
        if length > 0:
            conn.state = _BODY
            conn.need = length
            conn.body_parts = []
        else:
            self._dispatch(conn, b"")
        return True

    # -- request execution (worker pool) ------------------------------------

    def _dispatch(self, conn: _Conn, body: bytes):
        slot = _Slot()
        conn.pending.append(slot)
        conn.requests += 1
        self.requests_handled += 1
        if conn.requests > 1:
            self.keepalive_reuses += 1
        self._pool.submit(self._execute, conn, slot, conn.method,
                          conn.path, conn.version, conn.headers, body)

    def _execute(self, conn, slot, method, path, version, headers,
                 body):
        """Worker thread: run the handler shim, post the response back
        to the loop through the connection's ordered slot."""
        try:
            data, close, stream = self._handle(method, path, version,
                                               headers, body, conn.addr)
        except Exception as e:  # noqa: BLE001 — a handler bug must answer 500, not hang the slot
            data = _plain_response(
                500, "Internal Server Error", version,
                {"error": f"{type(e).__name__}: {e}"}, close=True)
            close = True
            stream = None
        if stream is None:
            slot.data = data
            slot.close = close
            slot.done = True
            with self._ready_lock:
                self._ready.append(conn)
            self._wake()
            return
        self._stream_slot(conn, slot, data, close, stream)

    def _stream_slot(self, conn, slot, head: bytes, close: bool, stream):
        """Worker thread: pump a chunked response through the slot one
        frame at a time — the loop flushes each frame as it lands, so a
        result set larger than any buffer bound streams in O(1) memory.
        Appends and the loop's poplefts hit opposite ends of the deque
        (atomic under the GIL — the same ordering contract buffered
        slots already rely on for ``data``/``done``)."""
        slot.chunks = deque((head,))
        with self._ready_lock:
            self.streams_started += 1
            self._ready.append(conn)
        self._wake()
        try:
            for piece in stream:
                if conn.sock is None:
                    break  # client went away: stop producing
                if not piece:
                    continue
                slot.chunks.append(_chunk_frame(piece))
                with self._ready_lock:
                    self._ready.append(conn)
                self._wake()
        except Exception:  # noqa: BLE001 — mid-stream generator bug: truncate the chunked body (the HTTP incomplete-response signal) and drop the connection
            with self._ready_lock:
                self.stream_errors += 1
            slot.close = True
            slot.done = True
            with self._ready_lock:
                self._ready.append(conn)
            self._wake()
            return
        finally:
            close_fn = getattr(stream, "close", None)
            if close_fn is not None:
                close_fn()
        slot.chunks.append(_CHUNK_END)
        slot.close = close
        slot.done = True
        with self._ready_lock:
            self._ready.append(conn)
        self._wake()

    def _handle(self, method, path, version, headers, body, addr
                ) -> tuple[bytes, bool]:
        """Run one parsed request through the unchanged
        ``BaseHTTPRequestHandler`` routes against BytesIO files.

        ``send_response``/``send_header``/``end_headers`` write the
        identical status line + header bytes the threaded server
        produced, so the routes move over without behavior change."""
        cls = self.handler_cls
        h = cls.__new__(cls)
        h.server = self
        h.client_address = addr
        h.command = method
        h.path = path
        h.request_version = "HTTP/1.1" if version >= "HTTP/1.1" \
            else version
        h.requestline = f"{method} {path} {version}"
        h.headers = headers
        h.rfile = io.BytesIO(body)
        h.wfile = io.BytesIO()
        # handlers test this to DEFER chunked bodies to the edge loop
        # (http._Handler._reply_stream) instead of writing them inline
        h._edge_stream = True
        conn_hdr = (headers.get("Connection") or "").lower()
        h.close_connection = (
            "close" in conn_hdr
            or (version < "HTTP/1.1"
                and "keep-alive" not in conn_hdr))
        fn = getattr(h, "do_" + method, None)
        if fn is None:
            return _plain_response(
                501, "Unsupported method", version,
                {"error": f"Unsupported method ({method!r})"},
                close=True), True, None
        fn()
        # a streaming route leaves head bytes in wfile and the body
        # generator on h._stream; buffered routes leave _stream unset
        return (h.wfile.getvalue(), bool(h.close_connection),
                getattr(h, "_stream", None))

    # -- loop-side response delivery ----------------------------------------

    def _flush_ready(self):
        with self._ready_lock:
            ready, self._ready = self._ready, []
        seen = set()
        for conn in ready:
            if conn.fd in seen:
                continue
            seen.add(conn.fd)
            if conn.sock is None:
                continue  # client went away; drop the response
            self._pump(conn)

    def _pump(self, conn: _Conn):
        """Move completed responses (in request order) into the output
        buffer, then write greedily.  A streaming head slot drains
        whatever frames its worker has produced so far even while not
        done — that's what makes chunked responses flow instead of
        buffering whole — but later slots still wait their turn."""
        while conn.pending:
            slot = conn.pending[0]
            # read done BEFORE draining chunks: the worker appends its
            # last frame before flipping done, so done-then-drain can
            # never strand a frame behind a popped slot
            done = slot.done
            if slot.chunks is not None:
                while slot.chunks:
                    conn.outbuf += slot.chunks.popleft()
            if not done:
                break  # head-of-line still executing/streaming
            if slot.chunks is None:
                conn.outbuf += slot.data
            conn.pending.popleft()
            if slot.close:
                conn.closing = True
                conn.pending.clear()
                break
        self._write(conn)

    def _write(self, conn: _Conn):
        if conn.sock is None:
            return
        while conn.outbuf:
            try:
                sent = conn.sock.send(conn.outbuf)
            except (BlockingIOError, InterruptedError):
                break
            except OSError:
                self._close_conn(conn)
                return
            if sent <= 0:
                break
            del conn.outbuf[:sent]
            conn.last_activity = time.monotonic()
        if conn.outbuf and not conn.want_write:
            conn.want_write = True
            self._selector.modify(
                conn.sock, selectors.EVENT_READ | selectors.EVENT_WRITE,
                conn)
        elif not conn.outbuf and conn.want_write:
            conn.want_write = False
            self._selector.modify(conn.sock, selectors.EVENT_READ, conn)
        if not conn.outbuf and conn.closing and not conn.pending:
            self._close_conn(conn)

    # -- deadlines -----------------------------------------------------------

    def _check_deadlines(self):
        timeout_s = getattr(self, "socket_timeout_s", None)
        if not timeout_s:
            return
        now = time.monotonic()
        for conn in list(self._conns.values()):
            if conn.sock is None:
                continue
            if now - conn.last_activity < timeout_s:
                continue
            if conn.outbuf:
                # write deadline: the peer stopped reading while a
                # response is buffered — drop the connection
                self._close_conn(conn)
            elif conn.closing and not conn.pending:
                # a loop-generated 408/400/431 went out a deadline ago
                # and the peer has not hung up: close now.  A departure
                # from the reference, which keeps such a connection and,
                # for a stalled body, answers 408 again at every sweep
                self._close_conn(conn)
            elif conn.pending:
                continue  # request executing in the pool: not a stall
            elif conn.state == _BODY:
                # complete headers, stalled body: answer 408 and close
                # (the threaded server's TimeoutError-in-do_POST path)
                self.timeouts_408 += 1
                self._respond_plain(
                    conn, 408, "Request Timeout",
                    {"error": "timed out reading request body"})
                conn.closing = True
            else:
                # no request line (slow-loris), stalled headers, or an
                # idle keep-alive connection: close silently — the
                # client sees EOF, exactly like the threaded server
                self.closed_idle += 1
                self._close_conn(conn)

    # -- plumbing ------------------------------------------------------------

    def _respond_plain(self, conn: _Conn, status: int, reason: str,
                       payload: dict):
        """Loop-generated response (no handler): 408/400/431 paths."""
        conn.outbuf += _plain_response(status, reason, "HTTP/1.1",
                                       payload, close=True)
        self._write(conn)

    def _close_conn(self, conn: _Conn):
        sock, conn.sock = conn.sock, None
        if sock is None:
            return
        try:
            self._selector.unregister(sock)
        except (KeyError, ValueError):
            pass
        try:
            sock.close()
        except OSError:
            pass
        self._conns.pop(conn.fd, None)
        conn.pending.clear()
        self._resume_accept()

    def _teardown(self):
        for conn in list(self._conns.values()):
            self._close_conn(conn)
        for sock in (self._listener, self._wake_r, self._wake_w):
            try:
                self._selector.unregister(sock)
            except (KeyError, ValueError):
                pass
            try:
                sock.close()
            except OSError:
                pass
        self._selector.close()
        self._pool.shutdown(wait=False)

    # -- observability -------------------------------------------------------

    def stats(self) -> dict:
        return {"open_connections": len(self._conns),
                "max_connections": self.max_connections,
                "accepted": self.accepted,
                "evicted_idle": self.evicted_idle,
                "accept_pauses": self.accept_pauses,
                "accept_paused": self._accept_paused,
                "requests": self.requests_handled,
                "keepalive_reuses": self.keepalive_reuses,
                "timeouts_408": self.timeouts_408,
                "closed_idle": self.closed_idle,
                "overlong_heads": self.overlong_heads,
                "streams_started": self.streams_started,
                "stream_errors": self.stream_errors,
                "workers": self._pool._max_workers}


#: chunked transfer terminator (RFC 9112 §7.1): zero-length chunk
_CHUNK_END = b"0\r\n\r\n"


def _chunk_frame(data: bytes) -> bytes:
    """One HTTP/1.1 chunked-transfer frame: hex length, CRLF, payload,
    CRLF."""
    return f"{len(data):x}\r\n".encode("ascii") + data + b"\r\n"


def _plain_response(status: int, reason: str, version: str,
                    payload: dict, close: bool = False) -> bytes:
    """A minimal loop-side HTTP/1.1 response (JSON body)."""
    blob = json.dumps(payload).encode()
    head = (f"HTTP/1.1 {status} {reason}\r\n"
            f"Content-Type: application/json\r\n"
            f"Content-Length: {len(blob)}\r\n")
    if close:
        head += "Connection: close\r\n"
    return head.encode("ascii") + b"\r\n" + blob
