"""Stdlib HTTP front-end for the batching engine (thread per request).

Port of the ``edge=False`` path of ``deep_vision_tpu/serve/http.py``.
Routes (JSON in, JSON out):

    GET  /v1/healthz   per-engine health (thread liveness, heartbeat
                       ages, the OK → DEGRADED → DEAD state); 503 when
                       any engine cannot serve
    GET  /v1/stats     per-model engine stats, plus ``kernels``: the
                       launch count of each hand-written kernel
    GET  /v1/models    ``describe()`` of every served model
    POST /v1/classify  {"pixels": [[...]], "model"?, "deadline_ms"?,
                        "top_k"?} → {"model", "top": [{class, prob,
                        logit}]}.  A shed answers 429 (with
                        ``Retry-After`` when the estimate is known), a
                        bad payload 400, ``image_b64`` 501 (no image
                        decoder on this server).  ``?debug=1`` attaches
                        the request's trace.
    POST /v1/detect    {"pixels", "model"?, "deadline_ms"?,
                        "score_threshold"?} → {"model", "num_detections",
                        "detections": [{box, score, class}]}, boxes
                        normalized xyxy; the same errors as classify.
    POST /v1/pose      {"pixels", "model"?, "deadline_ms"?} → {"model",
                        "space": "heatmap", "keypoints": [{x, y,
                        score}]}, in heatmap pixels; the same errors.
    POST /v1/generate  a latent-in model (DCGAN): {"seed"?: int (default
                        0) | "latent": [latent_dim floats], "model"?,
                        "deadline_ms"?}; an image-in model (CycleGAN):
                        {"pixels", ...} → {"model", "image": {"b64",
                        "shape", "dtype": "uint8"}}, the image's bytes
                        (HWC, 0-255) in base64; the same errors, and a
                        bad seed or latent answers 400.

A verb that is not the model's workload answers 400 and names the right
route; an unknown route answers 404 with the supported verbs.
"""

from __future__ import annotations

import json
import math
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs

import numpy as np

from deep_vision_tpu_torch.obs.trace import REQUEST_ID_HEADER, new_request_id
from deep_vision_tpu_torch.serve.admission import Shed
from deep_vision_tpu_torch.serve.workloads import WORKLOADS

#: request body cap (a 224×224×3 uint8 image is ~0.6 MB of JSON) and the
#: per-connection socket timeout
MAX_BODY_BYTES = 32 * 2**20
SOCKET_TIMEOUT_S = 30.0


class ServeError(Exception):
    def __init__(self, status: int, message: str,
                 headers: dict | None = None):
        super().__init__(message)
        self.status = status
        self.headers = headers


def decode_pixels(body: dict, model) -> np.ndarray:
    """Body → one (H, W, C) input in the model's WIRE dtype."""
    wire = np.dtype(model.wire_dtype)
    if "pixels" in body:
        try:
            x = np.asarray(body["pixels"], wire)
        except (ValueError, TypeError, OverflowError) as e:
            # ragged lists, non-numeric entries, or NaN/Inf → integer
            raise ServeError(400, f"bad pixels payload: {e}") from e
        if x.ndim == 2 and model.input_shape[-1] == 1:
            x = x[..., None]
        if x.shape != model.input_shape:
            raise ServeError(400, f"pixels shape {list(x.shape)} != model "
                                  f"input {list(model.input_shape)}")
        if wire.kind == "f" and not np.isfinite(x).all():
            raise ServeError(400, "pixels contain non-finite values "
                                  "(NaN/Inf)")
        return x
    if "image_b64" in body:
        raise ServeError(501, "image_b64 needs an image decoder on the "
                              "server; send preprocessed 'pixels'")
    raise ServeError(400, "body needs 'pixels' or 'image_b64'")


def kernel_launches() -> dict:
    """Launch count of each hand-written kernel in this process."""
    from deep_vision_tpu_torch.ops.ingest import serve_ingest

    return {"serve_ingest": serve_ingest.launches}


class _Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    _rid = None
    _span = None

    def setup(self):
        # a timeout mid-body raises TimeoutError in do_POST (answered 408)
        self.timeout = SOCKET_TIMEOUT_S
        super().setup()

    def log_message(self, fmt, *args):
        pass  # no per-request access log on stderr

    def _reply(self, status: int, payload: dict,
               headers: dict | None = None):
        blob = json.dumps(payload).encode()
        self.send_response(status)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(blob)))
        if self._rid is not None:
            self.send_header(REQUEST_ID_HEADER, self._rid)
        for k, v in (headers or {}).items():
            self.send_header(k, str(v))
        self.end_headers()
        self.wfile.write(blob)

    def _body(self) -> dict:
        length = int(self.headers.get("Content-Length") or 0)
        if length <= 0:
            raise ServeError(400, "empty body")
        cap = MAX_BODY_BYTES
        if length > cap:
            # reject BEFORE reading an attacker-sized body; the unread
            # body would desync keep-alive, so close the connection
            self.close_connection = True
            raise ServeError(413, f"body of {length} bytes exceeds the "
                                  f"{cap}-byte cap")
        try:
            body = json.loads(self.rfile.read(length))
        except json.JSONDecodeError as e:
            raise ServeError(400, f"bad JSON: {e}") from e
        if not isinstance(body, dict):
            raise ServeError(400, "body must be a JSON object")
        return body

    def _engine(self, body: dict):
        try:
            model = self.server.registry.get(body.get("model"))
        except KeyError as e:
            raise ServeError(404, e.args[0]) from e
        return model, self.server.engines[model.name]

    def _infer(self, verb: str, body: dict, debug: bool) -> dict:
        model, engine = self._engine(body)
        # the verb names the workload; the model's task must serve it,
        # checked before the request costs a batch slot
        if model.workload.verb != verb:
            raise ServeError(400, f"'{model.name}' is a {model.task} "
                                  f"model; use /v1/{model.workload.verb}")
        try:
            x = model.workload.decode(body, model)
        except ValueError as e:
            raise ServeError(400, str(e)) from e
        if x is None:
            x = decode_pixels(body, model)
        if self._span is not None:
            self._span.mark("decode")
        deadline_ms = body.get("deadline_ms", model.workload.slo.deadline_ms)
        try:
            deadline_ms = float(deadline_ms)
            params = {}
            if verb == "classify":
                params = {"top_k": int(body.get("top_k", 5))}
            elif verb == "detect" and "score_threshold" in body:
                params = {"score_threshold": float(body["score_threshold"])}
        except (TypeError, ValueError) as e:
            raise ServeError(400, f"bad request parameter: {e}") from e
        result = engine.infer(x, deadline_ms=deadline_ms, span=self._span)
        if isinstance(result, Shed):
            headers = None
            if result.retry_after_s:
                headers = {"Retry-After":
                           max(1, math.ceil(result.retry_after_s))}
            raise ServeError(429, f"shed: {result.reason} {result.detail}",
                             headers=headers)
        payload = model.workload.respond(model, params, result)
        if self._span is not None:
            self._span.mark("respond")
            if debug:
                payload["trace"] = self._span.to_dict()
        return payload

    def do_GET(self):
        path = self.path.partition("?")[0]
        engines = self.server.engines
        if path == "/v1/healthz":
            reports = {name: eng.health_report()
                       for name, eng in engines.items()}
            healthy = all(r["can_serve"] for r in reports.values())
            self._reply(200 if healthy else 503,
                        {"status": "ok" if healthy else "unhealthy",
                         "models": self.server.registry.names(),
                         "engines": reports})
        elif path == "/v1/stats":
            stats = {name: eng.stats() for name, eng in engines.items()}
            stats["kernels"] = kernel_launches()
            self._reply(200, stats)
        elif path == "/v1/models":
            reg = self.server.registry
            self._reply(200, {"models": {
                name: {"model": reg.get(name).describe()}
                for name in reg.names()}})
        else:
            self._reply(404, {"error": f"no route {self.path}"})

    def do_POST(self):
        path, _, query = self.path.partition("?")
        debug = parse_qs(query).get("debug", ["0"])[0] not in ("", "0")
        self._rid = self.headers.get(REQUEST_ID_HEADER) or new_request_id()
        tracer = self.server.tracer
        span = self._span = tracer.start(self._rid, origin="recv")
        try:
            verb = path[len("/v1/"):] if path.startswith("/v1/") else ""
            if verb not in WORKLOADS:
                self._body()  # consistent 400 on empty/oversized bodies
                self._reply(404, {"error": f"no route {self.path}",
                                  "supported_verbs": sorted(WORKLOADS)})
                return
            self._reply(200, self._infer(verb, self._body(), debug))
        except ServeError as e:
            self._reply(e.status, {"error": str(e)}, headers=e.headers)
        except TimeoutError:
            # client stalled mid-body: answer 408 and drop the connection
            self.close_connection = True
            self._reply(408, {"error": "timed out reading request body"})
        except Exception as e:  # noqa: BLE001 — surface, don't kill the handler thread
            self._reply(500, {"error": f"{type(e).__name__}: {e}"})
        finally:
            tracer.finish(span)
            self._span = None
            self._rid = None


class ServeServer:
    """HTTP front-end wired to a registry + one engine per model."""

    def __init__(self, registry, engines: dict, host: str = "127.0.0.1",
                 port: int = 0):
        self.httpd = ThreadingHTTPServer((host, port), _Handler)
        self.httpd.daemon_threads = True
        self.httpd.registry = registry
        self.httpd.engines = engines
        # handler spans land in the first engine's trace ring
        self.httpd.tracer = next(iter(engines.values())).tracer
        self._thread: threading.Thread | None = None

    @property
    def host(self) -> str:
        return self.httpd.server_address[0]

    @property
    def port(self) -> int:
        return self.httpd.server_address[1]

    def serve_forever(self):
        self.httpd.serve_forever()

    def start_background(self) -> "ServeServer":
        self._thread = threading.Thread(target=self.serve_forever,
                                        name="serve-http", daemon=True)
        self._thread.start()
        return self

    def shutdown(self):
        self.httpd.shutdown()
        self.httpd.server_close()
        if self._thread is not None:
            self._thread.join(5.0)
            self._thread = None
