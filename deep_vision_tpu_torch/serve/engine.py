"""Pipelined background-thread dynamic micro-batcher on one device.

Port of ``deep_vision_tpu/serve/engine.py`` (``power_of_two_buckets``,
``StagingPool``, ``BatchingEngine``).  Two stages:

  batcher thread   drains the queue up to ``max_batch``/``max_wait_ms``,
                   stages the batch into a REUSED host buffer for its
                   bucket (pinned memory when the model is on CUDA), and
                   on the engine's own CUDA stream queues the H2D copy,
                   the bucket's forward and ONE D2H copy of each output
                   leaf into pinned host memory, then records an event
                   and hands the in-flight record off;
  drainer thread   waits on each batch's event in dispatch order and
                   scatters the host rows to per-request futures.

An output is a tensor (classify logits), a nested tuple of tensors
(dense detection heads) or a dict (the detect epilogue's K rows); a
request's row has the same structure, each leaf sliced to its image.

A ``pipeline_depth``-bounded semaphore caps dispatched-but-undrained
batches, so batch N+1's formation, staging and H2D overlap batch N's
compute while memory stays bounded; a staging buffer goes back to its
pool only after its batch's event completed (the async H2D may read it
until then).  ``pipeline_depth=1`` completes each batch inline.  On the
CPU the forward is synchronous and the same pipeline runs without
streams or events.

Batches pad to a small set of power-of-two buckets; the bucket dict is
the cache of per-bucket callables (``compile_bucket``), and a miss is an
explicit, counted build.  Deadlines are checked at admission
(``admission.py``) and again at batch formation.  A batch that raises
fails its requests' futures and feeds the health state machine
(``health.py``).  The fault plane, watchdog restarts and bisect-retry of
the reference engine wait for a later slice.
"""

from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import Future

import numpy as np
import torch

from deep_vision_tpu_torch.core.metrics import (
    LatencyHistogram,
    ThroughputMeter,
)
from deep_vision_tpu_torch.obs.log import event, get_logger
from deep_vision_tpu_torch.obs.trace import Tracer
from deep_vision_tpu_torch.serve.admission import AdmissionController, Shed
from deep_vision_tpu_torch.serve.health import EngineHealth

_log = get_logger("dvt.serve.engine")


def map_leaves(fn, tree):
    """``tree`` (a tensor or array, or dicts, tuples and lists of them)
    with ``fn`` applied to every leaf, the structure kept."""
    if isinstance(tree, dict):
        return {k: map_leaves(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(map_leaves(fn, v) for v in tree)
    return fn(tree)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def power_of_two_buckets(max_batch: int) -> list[int]:
    """1, 2, 4, ... plus ``max_batch`` itself when it isn't a power of 2."""
    buckets, b = [], 1
    while b < max_batch:
        buckets.append(b)
        b *= 2
    buckets.append(max_batch)
    return buckets


class _Request:
    __slots__ = ("image", "deadline", "enqueued_at", "future", "span")

    def __init__(self, image, deadline, enqueued_at, future, span=None):
        self.image = image
        self.deadline = deadline
        self.enqueued_at = enqueued_at
        self.future = future
        # obs.trace.Span or None (tracing off)
        self.span = span


class _Inflight:
    """One dispatched batch awaiting its event + scatter."""

    __slots__ = ("requests", "bucket", "host", "buffer", "done",
                 "dispatched_at")

    def __init__(self, requests, bucket, host, buffer, done, dispatched_at):
        self.requests = requests
        self.bucket = bucket
        self.host = host        # output on the host (filled once `done`)
        self.buffer = buffer    # staging buffer, held until `done`
        self.done = done        # torch.cuda.Event, None on the CPU
        self.dispatched_at = dispatched_at


class StagingPool:
    """Per-bucket free-list of preallocated host batch buffers.

    A buffer is checked out at batch formation, held for the batch's
    whole device lifetime (the H2D copy reads it asynchronously), and
    returned after the drainer saw the batch complete — so steady state
    holds at most ``pipeline_depth + 1`` buffers per active bucket.
    Buffers carry the model's WIRE dtype and are pinned when ``pin``
    (the H2D copy of pinned memory is asynchronous)."""

    def __init__(self, input_shape: tuple, dtype=torch.float32,
                 pin: bool = False):
        self._input_shape = tuple(input_shape)
        self.dtype = dtype
        self.pin = bool(pin)
        self._free: dict[int, list[torch.Tensor]] = {}  # guarded-by: _lock
        self._lock = threading.Lock()
        self.allocated = 0  # guarded-by: _lock
        self.reused = 0  # guarded-by: _lock

    def acquire(self, bucket: int) -> torch.Tensor:
        with self._lock:
            free = self._free.setdefault(bucket, [])
            if free:
                self.reused += 1
                return free.pop()
            self.allocated += 1
        return torch.zeros((bucket, *self._input_shape), dtype=self.dtype,
                           pin_memory=self.pin)

    def release(self, bucket: int, buf: torch.Tensor):
        with self._lock:
            self._free.setdefault(bucket, []).append(buf)

    def stats(self) -> dict:
        with self._lock:
            return {"allocated": self.allocated, "reused": self.reused,
                    "dtype": str(self.dtype), "pinned": self.pin,
                    "pooled": {b: len(v) for b, v in self._free.items()}}


class BatchingEngine:
    """Pipelined dynamic batcher for one ServingModel.

    Use as a context manager or call ``start()``/``stop()``.  ``submit``
    returns a ``Future`` resolving to the output row (numpy) for that
    input, or a ``Shed``; ``infer`` is the blocking wrapper."""

    def __init__(self, model, *, max_batch: int = 32,
                 max_wait_ms: float = 5.0, buckets: list[int] | None = None,
                 admission: AdmissionController | None = None,
                 pipeline_depth: int = 2):
        self.model = model
        self.device = torch.device(model.device)
        self.buckets = sorted(buckets) if buckets else \
            power_of_two_buckets(max_batch)
        self.max_batch = self.buckets[-1]
        self.max_wait_s = max_wait_ms / 1e3
        self.pipeline_depth = max(1, int(pipeline_depth))
        self.admission = admission or AdmissionController(
            max_wait_ms=max_wait_ms)
        self.latency = LatencyHistogram()
        self.throughput = ThroughputMeter(warmup_steps=1)
        self.tracer = Tracer()
        self.wire_dtype = np.dtype(model.wire_dtype)
        on_cuda = self.device.type == "cuda"
        self.staging = StagingPool(model.input_shape, model.wire_torch_dtype,
                                   pin=on_cuda)
        # the engine's own stream: H2D, forward and D2H of a batch are
        # ordered on it; the drainer waits on each batch's event
        self._stream = torch.cuda.Stream(self.device) if on_cuda else None
        self.health = EngineHealth()
        self._queue: queue.Queue[_Request] = queue.Queue()
        self._executables: dict = {}
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._accepting = False
        self._thread: threading.Thread | None = None
        self._drainer: threading.Thread | None = None
        self._inflight_sem = threading.BoundedSemaphore(self.pipeline_depth)
        self._inflight_q: queue.Queue[_Inflight | None] = queue.Queue()
        self._inflight = 0  # guarded-by: _lock
        self._forming = 0  # requests the batcher holds but hasn't dispatched
        self.max_inflight = 0  # guarded-by: _lock
        self.submitted = 0  # guarded-by: _lock
        self.served = 0  # guarded-by: _lock
        self.batches = 0  # guarded-by: _lock
        self.compiles = 0  # guarded-by: _lock
        self.padded_images = 0  # guarded-by: _lock
        self.batch_failures = 0  # guarded-by: _lock
        self.shed_shutdown = 0  # guarded-by: _lock
        # bytes of staged wire-format batches copied to the device, and
        # of outputs copied back (one bulk copy per batch each way)
        self.h2d_bytes = 0  # guarded-by: _lock
        self.d2h_bytes = 0  # guarded-by: _lock
        self.d2h_bytes_by_bucket: dict[int, int] = {}  # guarded-by: _lock
        # host proxy of device idle: wall time with an EMPTY in-flight
        # window between the first dispatch and the last drain
        self._first_dispatch: float | None = None  # guarded-by: _lock
        self._last_done: float | None = None  # guarded-by: _lock
        self._idle_s = 0.0  # guarded-by: _lock

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> "BatchingEngine":
        if not self._accepting:
            self._stop.clear()
            self.health.revive()
            if self._stream is not None:
                # weights were written on the default stream
                self._stream.wait_stream(
                    torch.cuda.current_stream(self.device))
            self._thread = threading.Thread(
                target=self._loop, name=f"batcher-{self.model.name}",
                daemon=True)
            self._thread.start()
            if self.pipeline_depth > 1:
                self._drainer = threading.Thread(
                    target=self._drain_loop,
                    name=f"drainer-{self.model.name}", daemon=True)
                self._drainer.start()
            self._accepting = True
        return self

    def stop(self, timeout: float = 5.0,
             drain_deadline: float | None = None):
        """Stop the engine.  New submits fail fast immediately; with a
        ``drain_deadline`` (seconds) admitted work is finished first —
        whatever hasn't completed by the deadline sheds as shutdown."""
        was_running = self._accepting
        self._accepting = False
        if drain_deadline is not None and was_running:
            t_end = time.monotonic() + drain_deadline
            while time.monotonic() < t_end:
                with self._lock:
                    busy = self._inflight
                if busy == 0 and self._forming == 0 \
                        and self._queue.qsize() == 0:
                    break
                time.sleep(0.005)
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout)
            self._thread = None
        if self._drainer is not None:
            # the batcher has exited: every dispatched batch is already in
            # the drain queue, so the sentinel lands after the last one
            self._inflight_q.put(None)
            self._drainer.join(timeout)
            self._drainer = None
        while True:
            try:
                req = self._queue.get_nowait()
            except queue.Empty:
                break
            if not req.future.done():
                req.future.set_result(Shed("shutdown", "engine stopped"))

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()

    def warmup(self, buckets: list[int] | None = None):
        """Build and run every bucket once before traffic (the first
        CUDA call of a shape selects its convolution algorithms)."""
        for b in (buckets or self.buckets):
            self._compiled(b)(np.zeros((b, *self.model.input_shape),
                                       self.wire_dtype))
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- request path ------------------------------------------------------

    def submit(self, image, deadline_ms: float | None = None,
               span=None) -> Future:
        fut: Future = Future()
        # span ownership: a caller-provided span (HTTP front-end) is
        # marked here but finished by its creator; an engine-created
        # span seals itself on any terminal path via the done-callback
        if span is None and self.tracer.enabled:
            span = self.tracer.start()
            fut.add_done_callback(
                lambda _f, _s=span: self.tracer.finish(_s))
        if not self._accepting:
            with self._lock:
                self.submitted += 1
                self.shed_shutdown += 1
            if span is not None:
                span.note("shed", "shutdown")
            fut.set_result(Shed("shutdown", "engine is not accepting "
                                            "requests (stopped or not "
                                            "started)"))
            return fut
        now = time.monotonic()
        deadline = now + deadline_ms / 1e3 if deadline_ms is not None \
            else None
        with self._lock:
            self.submitted += 1
            inflight = self._inflight
        depth = self._queue.qsize()
        shed = self.admission.admit(
            depth, deadline, now,
            bucket=self._bucket_for(min(depth + 1, self.max_batch)),
            inflight=inflight)
        if shed is not None:
            if span is not None:
                span.note("shed", shed.reason)
            fut.set_result(shed)
            return fut
        self.admission.record_admit()
        if span is not None:
            span.mark("admit")
        self._queue.put(_Request(np.asarray(image, self.wire_dtype),
                                 deadline, now, fut, span))
        return fut

    def infer(self, image, deadline_ms: float | None = None,
              timeout: float | None = 30.0, span=None):
        return self.submit(image, deadline_ms, span=span).result(timeout)

    # -- batcher thread (stage + dispatch) ---------------------------------

    def _loop(self):
        while not self._stop.is_set():
            self.health.beat("batcher")
            try:
                first = self._queue.get(timeout=0.05)
            except queue.Empty:
                continue
            if first.span is not None:
                first.span.mark("queue_wait")
            # non-zero while requests are in hand but not yet in the
            # in-flight window, so stop(drain_deadline=...) can't slip
            # between queue drain and dispatch
            self._forming = 1
            try:
                batch = [first]
                drain_until = time.monotonic() + self.max_wait_s
                while len(batch) < self.max_batch:
                    remaining = drain_until - time.monotonic()
                    if remaining <= 0:
                        break
                    try:
                        req = self._queue.get(timeout=remaining)
                    except queue.Empty:
                        break
                    if req.span is not None:
                        req.span.mark("queue_wait")
                    batch.append(req)
                self._forming = len(batch)
                try:
                    self._dispatch(batch)
                except Exception as e:  # noqa: BLE001 — deliver the failure to waiters, keep the batcher alive
                    self._cohort_failed(batch, e)
            finally:
                self._forming = 0

    def _bucket_for(self, n: int) -> int:
        for b in self.buckets:
            if b >= n:
                return b
        return self.buckets[-1]

    def _compiled(self, bucket: int):
        fn = self._executables.get(bucket)
        if fn is None:
            fn = self.model.compile_bucket(bucket)
            self._executables[bucket] = fn
            with self._lock:
                self.compiles += 1
        return fn

    def _acquire_slot(self) -> bool:
        """Block until an in-flight slot frees (or the engine stops)."""
        while not self._stop.is_set():
            self.health.beat("batcher")
            if self._inflight_sem.acquire(timeout=0.05):
                return True
        return False

    def _dispatch(self, batch: list[_Request]):
        live = []
        for req in batch:
            expired = self.admission.expired(req.deadline)
            if expired is not None:
                if req.span is not None:
                    req.span.note("shed", "deadline expired in queue")
                req.future.set_result(expired)
            else:
                if req.span is not None:
                    req.span.mark("batch_form")
                live.append(req)
        if not live:
            return
        n = len(live)
        bucket = self._bucket_for(n)
        fn = self._compiled(bucket)  # build OUTSIDE the in-flight window
        if not self._acquire_slot():
            for req in live:
                req.future.set_result(Shed("shutdown", "engine stopped"))
            return
        buf = self.staging.acquire(bucket)
        try:
            staged = buf.numpy()
            for i, req in enumerate(live):
                staged[i] = req.image
            if n < bucket:
                staged[n:] = 0  # pooled buffers are reused: clear the pad
            for req in live:
                if req.span is not None:
                    req.span.mark("staging")
            t0 = time.monotonic()
            host, done = self._launch(fn, buf)
        except Exception as e:  # noqa: BLE001 — dispatch-side batch failure: free the slot, fail the cohort
            self.staging.release(bucket, buf)
            self._inflight_sem.release()
            self._cohort_failed(live, e)
            return
        for req in live:
            if req.span is not None:
                req.span.mark("h2d_dispatch")
        rec = _Inflight(live, bucket, host, buf, done, t0)
        with self._lock:
            self.h2d_bytes += buf.numel() * buf.element_size()
            if self._inflight == 0 and self._last_done is not None:
                self._idle_s += t0 - self._last_done
            if self._first_dispatch is None:
                self._first_dispatch = t0
            self._inflight += 1
            self.max_inflight = max(self.max_inflight, self._inflight)
        if self.pipeline_depth > 1:
            self._inflight_q.put(rec)
        else:
            self._finish(rec)

    def _launch(self, fn, buf: torch.Tensor):
        """Queue one batch: H2D, forward, one D2H per output leaf.  On
        CUDA everything is queued on the engine's stream and an event
        marks the end; on the CPU the forward runs to completion here."""
        if self._stream is None:
            return fn(buf), None

        def to_host(t):
            host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            return host.copy_(t, non_blocking=True)

        with torch.cuda.stream(self._stream), torch.inference_mode():
            x = buf.to(self.device, non_blocking=True)
            host = map_leaves(to_host, fn(x))
            done = torch.cuda.Event()
            done.record(self._stream)
        return host, done

    # -- drainer thread (wait + scatter) -----------------------------------

    def _drain_loop(self):
        while True:
            self.health.beat("drainer")
            try:
                rec = self._inflight_q.get(timeout=0.25)
            except queue.Empty:
                if self._stop.is_set():
                    return
                continue
            if rec is None:
                if self._stop.is_set():
                    return  # shutdown sentinel
                continue  # stale sentinel from a previous stop
            self._finish(rec)

    def _finish(self, rec: _Inflight):
        try:
            self._complete(rec)
        except Exception as e:  # noqa: BLE001 — completion failure fails the cohort, not the drainer
            self._cohort_failed(rec.requests, e)
        finally:
            self.staging.release(rec.bucket, rec.buffer)
            with self._lock:
                self._inflight -= 1
                self._last_done = time.monotonic()
            self._inflight_sem.release()

    def _complete(self, rec: _Inflight):
        if rec.done is not None:
            rec.done.synchronize()
        host = map_leaves(lambda t: t.numpy(), rec.host)
        nbytes = sum(a.nbytes for a in _leaves(host))
        t_done = time.monotonic()
        n = len(rec.requests)
        with self._lock:
            # device occupancy ≈ completion minus the later of dispatch
            # and the previous batch's completion
            busy_from = rec.dispatched_at if self._last_done is None \
                else max(rec.dispatched_at, self._last_done)
            self.batches += 1
            self.served += n
            self.padded_images += rec.bucket - n
            self.d2h_bytes += nbytes
            self.d2h_bytes_by_bucket[rec.bucket] = \
                self.d2h_bytes_by_bucket.get(rec.bucket, 0) + nbytes
        self.admission.observe_exec(t_done - busy_from, bucket=rec.bucket)
        self.throughput.update(n)
        for i, req in enumerate(rec.requests):
            self.latency.record(t_done - req.enqueued_at)
            if req.span is not None:
                # marked BEFORE resolving the future: the span's owner
                # takes over at resolve
                req.span.mark("compute_d2h")
            if not req.future.done():
                req.future.set_result(
                    map_leaves(lambda a, i=i: a[i].copy(), host))
        self.health.record_success(t_done)

    def _cohort_failed(self, requests: list[_Request], err: Exception):
        with self._lock:
            self.batch_failures += 1
        self.health.record_failure()
        event(_log, "batch_failure", model=self.model.name,
              cohort=len(requests), error=f"{type(err).__name__}: {err}")
        for r in requests:
            if r.future.done():
                continue
            if r.span is not None:
                r.span.note("batch_failure", type(err).__name__)
            r.future.set_exception(err)

    # -- observability -----------------------------------------------------

    def health_report(self) -> dict:
        now = time.monotonic()
        rep = self.health.report(now)
        t, d = self._thread, self._drainer
        rep["batcher_alive"] = bool(t is not None and t.is_alive())
        rep["drainer_alive"] = bool(d is not None and d.is_alive()) \
            if self.pipeline_depth > 1 else None
        rep["accepting"] = self._accepting
        # what /v1/healthz keys 503 on
        rep["can_serve"] = rep["state"] == "ok"
        rep["device"] = str(self.device)
        with self._lock:
            rep["inflight"] = self._inflight
            rep["batch_failures"] = self.batch_failures
            rep["shed_shutdown"] = self.shed_shutdown
            done = self._last_done
        rep["last_batch_age_s"] = round(now - done, 4) \
            if done is not None else None
        return rep

    def stats(self) -> dict:
        with self._lock:
            span = None
            if self._first_dispatch is not None and \
                    self._last_done is not None:
                span = self._last_done - self._first_dispatch
            out = {"model": self.model.name,
                   "device": str(self.device),
                   "submitted": self.submitted,
                   "served": self.served,
                   "batches": self.batches,
                   "compiles": self.compiles,
                   "padded_images": self.padded_images,
                   "queue_depth": self._queue.qsize(),
                   "buckets": list(self.buckets),
                   "compiled_buckets": sorted(self._executables),
                   "max_wait_ms": self.max_wait_s * 1e3,
                   "workload": self.model.workload.verb,
                   "wire_dtype": str(self.wire_dtype),
                   "infer_dtype": self.model.infer_dtype,
                   "weight_bytes": self.model.param_bytes(),
                   "pipeline": {
                       "depth": self.pipeline_depth,
                       "inflight": self._inflight,
                       "max_inflight": self.max_inflight,
                       "h2d_bytes": self.h2d_bytes,
                       "d2h_bytes": self.d2h_bytes,
                       "d2h_bytes_by_bucket": dict(
                           self.d2h_bytes_by_bucket),
                       # host proxy: share of the first-dispatch →
                       # last-drain span with an empty in-flight window
                       "device_idle_frac": (
                           round(self._idle_s / span, 4)
                           if span and span > 0 else None)}}
        out["pipeline"]["staging"] = self.staging.stats()
        out["latency"] = self.latency.percentiles()
        out["img_per_sec"] = self.throughput.images_per_sec
        out["admission"] = self.admission.stats()
        out["health"] = self.health_report()
        out["trace"] = self.tracer.summary()
        return out
