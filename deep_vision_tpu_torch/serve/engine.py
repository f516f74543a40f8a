"""Pipelined background-thread dynamic micro-batcher on one device.

Port of ``deep_vision_tpu/serve/engine.py`` (``power_of_two_buckets``,
``sharded_buckets``,
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
(``admission.py``) and again at batch formation.

Supervision, as in the reference engine:

  * both worker threads publish heartbeats (``health.py``); a watchdog
    thread restarts a dead batcher or drainer (bounded by
    ``restart_budget``, then sticky DEAD) and fast-fails the in-flight
    window when a batch's wall age exceeds ``exec_timeout`` =
    max(``exec_timeout_min_s``, ``exec_timeout_k`` × the bucket's exec
    EWMA).  The watchdog reads host clocks and ``Event.query()`` only:
    it never synchronizes with the device, so a hung batch cannot hang
    its supervisor;
  * a cohort that raises (or returns a non-finite output under
    validation) is bisect-retried: halves re-execute synchronously at
    the smaller bucket that fits them (bounded by ``retry_budget``, with
    exponential backoff) until the poisoned request is isolated and
    quarantined (a ``Quarantined`` result) and the innocent ones are
    served;
  * the deterministic fault plane (``faults.py``) injects at the
    ``batcher``, ``staging``, ``dispatch``, ``compute`` and ``d2h``
    stages (``decode`` is in ``http.py``);
  * ``submit`` outside ``start()``/``stop()`` fails fast with
    ``Shed("shutdown")``; ``stop(drain_deadline=)`` finishes admitted
    work first.

Replica mode (``serve/replicas.py``): with ``external_batcher=True`` no
batcher thread runs here; the ``ReplicatedEngine``'s router forms the
cohorts and hands each to ``dispatch_cohort``, so the router thread is
the one that launches on this engine's stream, and a ``rescue`` hook is
offered the still-pending requests of a fast-failed window before they
get their ``TimeoutError``.

CUDA specifics: every launch (pipelined or retry) enters the engine's
stream itself, so a thread the watchdog restarts queues its work on that
stream like the one it replaces (the current stream is per thread in
PyTorch); a thread killed mid-batch (``KillThread``) hands its in-flight
slot and its staging buffer back, the buffer only after the batch's
event completed.
"""

from __future__ import annotations

import queue
import threading
import time
from collections import deque
from concurrent.futures import Future, InvalidStateError

import numpy as np
import torch

from deep_vision_tpu_torch.core.metrics import (
    LatencyHistogram,
    ThroughputMeter,
)
from deep_vision_tpu_torch.obs.log import event, get_logger
from deep_vision_tpu_torch.obs.mfu import MfuMeter
from deep_vision_tpu_torch.obs.trace import Tracer
from deep_vision_tpu_torch.serve.admission import AdmissionController, Shed
from deep_vision_tpu_torch.serve.faults import (
    FaultPlane,
    InjectedFault,
    KillThread,
    Quarantined,
)
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


def device_hbm_headroom(device) -> int | None:
    """Free bytes on ``device`` (``torch.cuda.mem_get_info``), advertised
    through ``/v1/healthz``; None on the CPU (unknown, never zero)."""
    device = torch.device(device)
    if device.type != "cuda":
        return None
    free, _total = torch.cuda.mem_get_info(device)
    return int(free)


def power_of_two_buckets(max_batch: int) -> list[int]:
    """1, 2, 4, ... plus ``max_batch`` itself when it isn't a power of 2."""
    buckets, b = [], 1
    while b < max_batch:
        buckets.append(b)
        b *= 2
    buckets.append(max_batch)
    return buckets


def sharded_buckets(max_batch: int, num_devices: int) -> list[int]:
    """Bucket ladder for the sharded big-batch path (``--shard-batches``
    and mesh serving; pass the DATA-axis size, not the device count: a
    2×2 data×model mesh splits each batch 2 ways): every bucket a
    multiple of ``num_devices`` so the padded batch splits evenly over
    the mesh's data axis — n, 2n, 4n, ... max."""
    n = max(1, int(num_devices))
    top = max(1, max_batch // n)
    return [n * b for b in power_of_two_buckets(top)]


def _resolve(fut: Future, value=None, error: BaseException | None = None):
    """Resolve ``fut`` unless something else already did: a replica's
    late drain may race the rescue that re-homed its cohort."""
    if fut.done():
        return
    try:
        if error is not None:
            fut.set_exception(error)
        else:
            fut.set_result(value)
    except InvalidStateError:
        pass  # resolved between the check and the set


class _Request:
    __slots__ = ("image", "deadline", "enqueued_at", "future", "poison",
                 "span")

    def __init__(self, image, deadline, enqueued_at, future, poison=False,
                 span=None):
        self.image = image
        self.deadline = deadline
        self.enqueued_at = enqueued_at
        self.future = future
        self.poison = poison  # tagged by the fault plane's poison mode
        # obs.trace.Span or None (tracing off)
        self.span = span


class _Warm:
    """A warmup run of one bucket, queued so that the batcher thread
    makes the bucket's first CUDA calls itself: PyTorch's cuDNN and
    cuBLAS handles are per thread and their workspaces per stream, and a
    first call pays for them (a new engine's first batches, a reload
    candidate's canary p99)."""

    __slots__ = ("bucket", "future")

    def __init__(self, bucket: int):
        self.bucket = bucket
        self.future: Future = Future()


class _Inflight:
    """One dispatched batch awaiting its event + scatter."""

    __slots__ = ("requests", "bucket", "host", "buffer", "done",
                 "dispatched_at", "cancelled", "cancel")

    def __init__(self, requests, bucket, host, buffer, done, dispatched_at,
                 cancel=None):
        self.requests = requests
        self.bucket = bucket
        self.host = host        # output on the host (filled once `done`)
        self.buffer = buffer    # staging buffer, held until `done`
        self.done = done        # torch.cuda.Event, None on the CPU
        self.dispatched_at = dispatched_at
        self.cancelled = False  # the watchdog fast-failed this window
        self.cancel = cancel    # Event breaking injected hangs (faults on)


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
    input, a ``Shed`` or a ``Quarantined``; ``infer`` is the blocking
    wrapper.

    Supervision knobs (see the module docstring): ``watchdog_interval_s``
    (0 disables the watchdog), ``restart_budget``, ``exec_timeout_k``/
    ``exec_timeout_min_s``, ``retry_budget``/``singleton_retries``/
    ``retry_backoff_ms``/``retry_backoff_max_ms``, ``degraded_after``/
    ``dead_after`` and ``faults`` (the ``DVT_SERVE_FAULTS`` spec when
    None; disabled when that is unset).  ``validate_outputs`` (default:
    on exactly when the fault plane is) fails a batch whose float output
    holds a NaN into isolation; the control plane's tests turn it off so
    a bad candidate serves its NaNs to the canary gate."""

    def __init__(self, model, *, max_batch: int = 32,
                 max_wait_ms: float = 5.0, buckets: list[int] | None = None,
                 admission: AdmissionController | None = None,
                 pipeline_depth: int = 2,
                 faults: FaultPlane | None = None,
                 watchdog_interval_s: float = 0.05,
                 restart_budget: int = 3,
                 exec_timeout_k: float = 10.0,
                 exec_timeout_min_s: float = 2.0,
                 retry_budget: int = 16,
                 singleton_retries: int = 1,
                 retry_backoff_ms: float = 2.0,
                 retry_backoff_max_ms: float = 100.0,
                 degraded_after: int = 1, dead_after: int = 5,
                 external_batcher: bool = False,
                 rescue=None,
                 tracer: Tracer | None = None,
                 validate_outputs: bool | None = None):
        self.model = model
        self.device = torch.device(model.device)
        if getattr(model, "fixed_batch", None) is not None:
            # an exported archive serves exactly its traced batch; a
            # conflicting bucket list is an operator error, named here
            available = getattr(model, "bucket_sizes", [model.fixed_batch])
            if buckets and any(b not in available for b in buckets):
                raise ValueError(
                    f"model '{model.name}' was exported with bucket sizes "
                    f"{available}; requested buckets {sorted(buckets)} "
                    f"unavailable — re-export or serve from the checkpoint")
            buckets = buckets or list(available)
        self.buckets = sorted(buckets) if buckets else \
            power_of_two_buckets(max_batch)
        self.max_batch = self.buckets[-1]
        self.max_wait_s = max_wait_ms / 1e3
        self.pipeline_depth = max(1, int(pipeline_depth))
        self.admission = admission or AdmissionController(
            max_wait_ms=max_wait_ms)
        self.latency = LatencyHistogram()
        self.throughput = ThroughputMeter(warmup_steps=1)
        self.tracer = tracer or Tracer()
        self.mfu = MfuMeter()
        self.wire_dtype = np.dtype(model.wire_dtype)
        on_cuda = self.device.type == "cuda"
        self.staging = StagingPool(model.input_shape, model.wire_torch_dtype,
                                   pin=on_cuda)
        # the engine's own stream: H2D, forward and D2H of a batch are
        # ordered on it; the drainer waits on each batch's event
        self._stream = torch.cuda.Stream(self.device) if on_cuda else None
        self.faults = faults or FaultPlane.from_env()
        self.health = EngineHealth(degraded_after=degraded_after,
                                   dead_after=dead_after)
        self.watchdog_interval_s = watchdog_interval_s
        self.restart_budget = restart_budget
        self.exec_timeout_k = exec_timeout_k
        self.exec_timeout_min_s = exec_timeout_min_s
        self.retry_budget = retry_budget
        self.singleton_retries = singleton_retries
        self.retry_backoff_ms = retry_backoff_ms
        self.retry_backoff_max_ms = retry_backoff_max_ms
        self._validate = self.faults.enabled \
            if validate_outputs is None else bool(validate_outputs)
        # replica mode: the ReplicatedEngine owns the queue and batch
        # formation and feeds formed cohorts through dispatch_cohort();
        # no batcher thread runs here and the watchdog supervises only
        # the drainer
        self.external_batcher = bool(external_batcher)
        # rescue(requests, err) -> bool: offered the still-pending
        # requests of a fast-failed in-flight window BEFORE they get
        # their TimeoutError; True = another replica took them over
        self._rescue = rescue
        self._queue: queue.Queue[_Request] = queue.Queue()
        self._executables: dict = {}
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._accepting = False
        self._thread: threading.Thread | None = None
        self._drainer: threading.Thread | None = None
        self._watchdog: threading.Thread | None = None
        self._inflight_sem = threading.BoundedSemaphore(self.pipeline_depth)
        self._inflight_q: queue.Queue[_Inflight | None] = queue.Queue()
        self._inflight = 0  # guarded-by: _lock
        self._forming = 0  # requests the batcher holds but hasn't dispatched
        self._inflight_recs: list[_Inflight] = []  # guarded-by: _lock
        self.max_inflight = 0  # guarded-by: _lock
        self.submitted = 0  # guarded-by: _lock
        self.served = 0  # guarded-by: _lock
        self.batches = 0  # guarded-by: _lock
        self.compiles = 0  # guarded-by: _lock
        self.padded_images = 0  # guarded-by: _lock
        # bytes of staged wire-format batches copied to the device, and
        # of outputs copied back (one bulk copy per batch each way),
        # counted on the pipelined and the retry paths alike
        self.h2d_transfers = 0  # guarded-by: _lock
        self.h2d_bytes = 0  # guarded-by: _lock
        self.h2d_bytes_by_bucket: dict[int, int] = {}  # guarded-by: _lock
        self.d2h_bytes = 0  # guarded-by: _lock
        self.d2h_bytes_by_bucket: dict[int, int] = {}  # guarded-by: _lock
        # fault-tolerance accounting
        self.batch_failures = 0  # guarded-by: _lock
        self.retry_executions = 0  # guarded-by: _lock
        self.quarantined = 0  # guarded-by: _lock
        self.exec_timeouts = 0  # guarded-by: _lock
        self.shed_shutdown = 0  # guarded-by: _lock
        # wall seconds spent isolating failed cohorts (bisect-retry)
        self.retry_seconds = 0.0  # guarded-by: _lock
        # host proxy of device idle: wall time with an EMPTY in-flight
        # window between the first dispatch and the last drain
        self._first_dispatch: float | None = None  # guarded-by: _lock
        self._last_done: float | None = None  # guarded-by: _lock
        self._idle_s = 0.0  # guarded-by: _lock
        # rolling compute duty cycle: (t_done, busy_s) per executed batch
        self.occupancy_window_s = 10.0
        self._busy_events: deque = deque()  # guarded-by: _lock

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> "BatchingEngine":
        if not self._accepting:
            self._stop.clear()
            self.faults.cancel.clear()
            self.health.revive()
            if self._stream is not None:
                # weights were written on the default stream
                self._stream.wait_stream(
                    torch.cuda.current_stream(self.device))
            if not self.external_batcher:
                self._thread = threading.Thread(
                    target=self._loop, name=f"batcher-{self.model.name}",
                    daemon=True)
                self._thread.start()
            if self.pipeline_depth > 1:
                self._drainer = threading.Thread(
                    target=self._drain_loop,
                    name=f"drainer-{self.model.name}", daemon=True)
                self._drainer.start()
            if self.watchdog_interval_s > 0:
                self._watchdog = threading.Thread(
                    target=self._watchdog_loop,
                    name=f"watchdog-{self.model.name}", daemon=True)
                self._watchdog.start()
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
        self.faults.cancel.set()  # release any injected hang
        if self._watchdog is not None:
            self._watchdog.join(timeout)
            self._watchdog = None
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

    def warmup(self, buckets: list[int] | None = None,
               timeout: float = 600.0):
        """Build and run every bucket once before traffic (the first
        CUDA call of a shape selects its convolution algorithms).  They
        run on the batcher thread and stream (``_Warm``), where traffic
        will run, so the engine must be started.  A replica has no
        batcher thread: its router warms it (``ReplicatedEngine.warmup``)."""
        if not self._accepting:
            raise RuntimeError("warmup needs a started engine")
        if self.external_batcher:
            raise RuntimeError("a replica is warmed by the thread that "
                               "launches for it: ReplicatedEngine.warmup")
        warms = [_Warm(b) for b in buckets or self.buckets]
        for w in warms:
            self._queue.put(w)
        for w in warms:
            w.future.result(timeout)

    def run_warm(self, warm: _Warm):
        """Build bucket ``warm.bucket`` and run it once on zeros, on the
        engine's stream and the calling thread (the batcher's, or the
        router's for a replica); the outcome lands in ``warm.future``."""
        try:
            fn = self._compiled(warm.bucket)
            buf = self.staging.acquire(warm.bucket)
            try:
                buf.zero_()
                _, done = self._launch(fn, buf)
                if done is not None:
                    done.synchronize()
            finally:
                self.staging.release(warm.bucket, buf)
        except Exception as e:  # noqa: BLE001 — the caller of warmup gets it
            warm.future.set_exception(e)
        else:
            warm.future.set_result(None)

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
        poison = self.faults.mark_poison() if self.faults.enabled else False
        if span is not None:
            span.mark("admit")
        self._queue.put(_Request(np.asarray(image, self.wire_dtype),
                                 deadline, now, fut, poison, span))
        return fut

    def infer(self, image, deadline_ms: float | None = None,
              timeout: float | None = 30.0, span=None):
        return self.submit(image, deadline_ms, span=span).result(timeout)

    # -- batcher thread (stage + dispatch) ---------------------------------

    def _loop(self):
        try:
            while not self._stop.is_set():
                self.health.beat("batcher")
                if self.faults.enabled:
                    self.faults.inject("batcher", stop=self._stop)
                try:
                    first = self._queue.get(timeout=0.05)
                except queue.Empty:
                    continue
                if isinstance(first, _Warm):
                    self.run_warm(first)
                    continue
                if first.span is not None:
                    first.span.mark("queue_wait")
                # non-zero while requests are in hand but not yet in the
                # in-flight window, so stop(drain_deadline=...) can't slip
                # between queue drain and dispatch
                self._forming = 1
                warm = None
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
                        if isinstance(req, _Warm):
                            warm = req  # run after this batch
                            break
                        if req.span is not None:
                            req.span.mark("queue_wait")
                        batch.append(req)
                    self.dispatch_cohort(batch)
                finally:
                    self._forming = 0
                if warm is not None:
                    self.run_warm(warm)
        except KillThread:
            return  # injected death: the watchdog notices and restarts

    def dispatch_cohort(self, batch: list[_Request]):
        """Dispatch an already-formed cohort into this engine's pipeline.
        The batcher calls it after its queue drain; in replica mode the
        ``ReplicatedEngine``'s router calls it directly, and blocking
        here while this replica's in-flight window is full is the
        router's backpressure.  A failure is delivered to the cohort's
        futures, never raised (a failed batch must not kill the calling
        thread)."""
        self._forming = max(self._forming, len(batch))
        try:
            self._dispatch(batch)
        except Exception as e:  # noqa: BLE001 — deliver the failure to waiters, keep the caller alive
            self._fail_requests(batch, e)
            self.health.record_failure()
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
            # the registry attaches the bucket's counted FLOPs (or the
            # params lower bound): the serving-MFU numerator
            self.mfu.set_bucket_flops(
                bucket, getattr(fn, "cost_flops", None),
                getattr(fn, "flops_source", None))
        return fn

    def _acquire_slot(self) -> bool:
        """Block until an in-flight slot frees (or the engine stops)."""
        while not self._stop.is_set():
            self.health.beat("batcher")
            if self._inflight_sem.acquire(timeout=0.05):
                return True
        return False

    @staticmethod
    def _fill(buf: torch.Tensor, requests: list[_Request]):
        """Stage a cohort into a pooled buffer and zero the pad tail
        (buffers are reused, so old rows linger)."""
        staged = buf.numpy()
        for i, req in enumerate(requests):
            staged[i] = req.image
        if len(requests) < staged.shape[0]:
            staged[len(requests):] = 0

    def _count_h2d(self, bucket: int, buf: torch.Tensor):
        nbytes = buf.numel() * buf.element_size()
        with self._lock:
            self.h2d_transfers += 1
            self.h2d_bytes += nbytes
            self.h2d_bytes_by_bucket[bucket] = \
                self.h2d_bytes_by_bucket.get(bucket, 0) + nbytes

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
            if self.faults.enabled:
                self.faults.inject("staging", stop=self._stop)
            self._fill(buf, live)
            for req in live:
                if req.span is not None:
                    req.span.mark("staging")
            t0 = time.monotonic()
            if self.faults.enabled:
                self.faults.inject("dispatch", stop=self._stop)
                self.faults.inject("compute", stop=self._stop)
                if self.faults.cohort_poisoned(live):
                    raise InjectedFault(f"poisoned request in cohort of {n}")
            host, done = self._launch(fn, buf)
        except Exception as e:  # noqa: BLE001 — dispatch-side batch failure: free the slot, then isolate
            self._quiesce()
            self.staging.release(bucket, buf)
            self._inflight_sem.release()
            self._cohort_failed(live, e)
            return
        except KillThread:
            # hand the slot and the buffer back and fail the cohort
            # before the thread dies
            self._quiesce()
            self.staging.release(bucket, buf)
            self._inflight_sem.release()
            self._fail_requests(live, RuntimeError(
                "the batcher thread died while staging this batch"))
            raise
        for req in live:
            if req.span is not None:
                req.span.mark("h2d_dispatch")
        rec = _Inflight(live, bucket, host, buf, done, t0,
                        threading.Event() if self.faults.enabled else None)
        self._count_h2d(bucket, buf)
        with self._lock:
            if self._inflight == 0 and self._last_done is not None:
                self._idle_s += t0 - self._last_done
            if self._first_dispatch is None:
                self._first_dispatch = t0
            self._inflight += 1
            self.max_inflight = max(self.max_inflight, self._inflight)
            self._inflight_recs.append(rec)
        if self.pipeline_depth > 1:
            self._inflight_q.put(rec)
        else:
            self._finish(rec)

    def _quiesce(self):
        """After a launch that raised: wait for the engine's stream, so a
        staging buffer an async H2D may still read is not reused."""
        if self._stream is not None:
            self._stream.synchronize()

    def _launch(self, fn, buf: torch.Tensor):
        """Queue one batch: H2D, forward, one D2H per output leaf.  On
        CUDA everything is queued on the engine's stream (entered here,
        whichever thread calls) and an event marks the end; on the CPU
        the forward runs to completion here."""
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
        try:
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
        except KillThread:
            return  # injected death: the watchdog notices and restarts

    def _finish(self, rec: _Inflight):
        try:
            self._complete(rec)
        except Exception as e:  # noqa: BLE001 — completion failure fails the cohort, not the drainer
            self._cohort_failed(rec.requests, e)
        except KillThread:
            self._fail_requests(rec.requests, RuntimeError(
                "the drainer thread died while completing this batch"))
            raise
        finally:
            if rec.done is not None:
                # the async H2D may still read the staging buffer until
                # the batch's event completed (a thread killed before
                # waiting, or a cancelled window)
                rec.done.synchronize()
            self.staging.release(rec.bucket, rec.buffer)
            with self._lock:
                self._inflight -= 1
                if rec in self._inflight_recs:
                    self._inflight_recs.remove(rec)
                self._last_done = time.monotonic()
            self._inflight_sem.release()

    def _complete(self, rec: _Inflight):
        mode = None
        if self.faults.enabled:
            mode = self.faults.inject("d2h", stop=self._stop,
                                      cancel=rec.cancel)
        if rec.done is not None:
            rec.done.synchronize()
        host = map_leaves(lambda t: t.numpy(), rec.host)
        if mode == "nan":
            # only FLOAT leaves can hold a NaN
            host = map_leaves(lambda a: np.full_like(a, np.nan)
                              if a.dtype.kind == "f" else a, host)
        if self._validate:
            self._check_outputs(host)
        if rec.cancelled:
            return  # the watchdog already fast-failed these futures
        t_done = time.monotonic()
        with self._lock:
            # device occupancy ≈ completion minus the later of dispatch
            # and the previous batch's completion
            busy_from = rec.dispatched_at if self._last_done is None \
                else max(rec.dispatched_at, self._last_done)
            self._busy_events.append((t_done, t_done - busy_from))
            self._prune_busy_locked(t_done)
        self.admission.observe_exec(t_done - busy_from, bucket=rec.bucket)
        self._served(rec.requests, rec.bucket, host, t_done,
                     t_done - busy_from, "compute_d2h")

    def _served(self, requests: list[_Request], bucket: int, host,
                t_done: float, busy_s: float, stage: str):
        """Account one executed batch and resolve its futures with their
        rows."""
        n = len(requests)
        nbytes = sum(a.nbytes for a in _leaves(host))
        self.mfu.observe(bucket, n, busy_s)
        with self._lock:
            self.batches += 1
            self.served += n
            self.padded_images += bucket - n
            self.d2h_bytes += nbytes
            self.d2h_bytes_by_bucket[bucket] = \
                self.d2h_bytes_by_bucket.get(bucket, 0) + nbytes
        self.throughput.update(n)
        for i, req in enumerate(requests):
            self.latency.record(t_done - req.enqueued_at)
            if req.span is not None:
                # marked BEFORE resolving the future: the span's owner
                # takes over at resolve
                req.span.mark(stage)
            _resolve(req.future, map_leaves(lambda a, i=i: a[i].copy(),
                                            host))
        self.health.record_success(t_done)

    @staticmethod
    def _check_outputs(host):
        for a in _leaves(host):
            if a.dtype.kind == "f" and np.isnan(a).any():
                raise InjectedFault("NaN in model output")

    @staticmethod
    def _fail_requests(requests: list[_Request], err: BaseException):
        for r in requests:
            _resolve(r.future, error=err)

    # -- batch-failure isolation (bisect-retry) ----------------------------

    def _cohort_failed(self, requests: list[_Request], err: Exception):
        """A dispatched or drained cohort raised: record the failure,
        then bisect-retry to quarantine the poison request(s) and serve
        the innocent ones.  Runs synchronously in the failing thread,
        off the happy path, bounded by ``retry_budget``."""
        with self._lock:
            self.batch_failures += 1
        self.health.record_failure()
        pending = [r for r in requests if not r.future.done()]
        event(_log, "batch_failure", model=self.model.name,
              cohort=len(requests), pending=len(pending),
              error=f"{type(err).__name__}: {err}")
        if not pending:
            return
        for r in pending:
            if r.span is not None:
                r.span.note("batch_failure", type(err).__name__)
        t0 = time.monotonic()
        try:
            self._isolate(pending, err, [self.retry_budget])
        finally:
            with self._lock:
                self.retry_seconds += time.monotonic() - t0

    def _backoff(self, budget: list[int]):
        attempt = self.retry_budget - budget[0]
        delay_ms = min(self.retry_backoff_max_ms,
                       self.retry_backoff_ms * (2 ** max(0, attempt)))
        if delay_ms > 0:
            time.sleep(delay_ms / 1e3)

    def _isolate(self, cohort: list[_Request], err: Exception,
                 budget: list[int]):
        if self._stop.is_set():
            for r in cohort:
                if not r.future.done():
                    r.future.set_result(Shed("shutdown", "engine stopped"))
            return
        if len(cohort) == 1:
            # transient benefit of the doubt before quarantining
            for _ in range(self.singleton_retries):
                if budget[0] <= 0:
                    break
                self._backoff(budget)
                budget[0] -= 1
                try:
                    self._execute_subset(cohort)
                    return
                except Exception as e:  # noqa: BLE001 — keep isolating
                    err = e
            self._quarantine(cohort[0], err, exhausted=False)
            return
        mid = len(cohort) // 2
        for sub in (cohort[:mid], cohort[mid:]):
            if budget[0] <= 0:
                for r in sub:
                    self._quarantine(r, err, exhausted=True)
                continue
            self._backoff(budget)
            budget[0] -= 1
            try:
                self._execute_subset(sub)
            except Exception as e:  # noqa: BLE001 — keep bisecting
                self._isolate(sub, e, budget)

    def _quarantine(self, req: _Request, err: Exception, exhausted: bool):
        with self._lock:
            self.quarantined += 1
        reason = "retry_budget" if exhausted else "poison"
        if req.span is not None:
            req.span.note("quarantined", reason)
        event(_log, "quarantine", model=self.model.name, reason=reason,
              request_id=req.span.request_id if req.span else None,
              error=f"{type(err).__name__}: {err}")
        if not req.future.done():
            req.future.set_result(Quarantined(
                reason, f"{type(err).__name__}: {err}"))

    def _execute_subset(self, requests: list[_Request]):
        """Synchronous re-execution of a retry cohort at the smallest
        bucket that holds it, outside the pipeline window (retries can't
        wedge the happy path): its own pooled staging buffer, the
        engine's stream, and a wait on the batch's event."""
        with self._lock:
            self.retry_executions += 1
        n = len(requests)
        for req in requests:
            if req.span is not None:
                req.span.note("bisect_retry", f"cohort of {n}")
        bucket = self._bucket_for(n)
        fn = self._compiled(bucket)
        t0 = time.monotonic()
        buf = self.staging.acquire(bucket)
        try:
            self._fill(buf, requests)
            if self.faults.enabled:
                self.faults.inject("compute", stop=self._stop)
                if self.faults.cohort_poisoned(requests):
                    raise InjectedFault(
                        f"poisoned request in retry cohort of {n}")
            self._count_h2d(bucket, buf)
            host, done = self._launch(fn, buf)
            if done is not None:
                done.synchronize()
            host = map_leaves(lambda t: t.numpy(), host)
            if self._validate:
                self._check_outputs(host)
        except BaseException:
            self._quiesce()
            raise
        finally:
            self.staging.release(bucket, buf)
        t_done = time.monotonic()
        with self._lock:
            self._busy_events.append((t_done, t_done - t0))
            self._prune_busy_locked(t_done)
        # the retry ran synchronously: its wall time IS its occupancy
        self._served(requests, bucket, host, t_done, t_done - t0,
                     "retry_exec")

    # -- watchdog thread (supervision) -------------------------------------

    def _watchdog_loop(self):
        while not self._stop.is_set():
            time.sleep(self.watchdog_interval_s)
            if self._stop.is_set():
                return
            try:
                self._watchdog_tick(time.monotonic())
            except Exception as e:  # noqa: BLE001 — the supervisor never dies
                event(_log, "watchdog_error", model=self.model.name,
                      error=f"{type(e).__name__}: {e}")

    def exec_timeout_s(self, bucket: int) -> float:
        """A batch of ``bucket`` in flight longer than this is failed:
        max(``exec_timeout_min_s``, ``exec_timeout_k`` × its exec EWMA)."""
        ewma = self.admission.bucket_ewma_s(bucket)
        return self.exec_timeout_min_s if not ewma else \
            max(self.exec_timeout_min_s, self.exec_timeout_k * ewma)

    def _watchdog_tick(self, now: float):
        t = self._thread
        if not self.external_batcher and t is not None \
                and not t.is_alive():
            self._restart("batcher")
        d = self._drainer
        if self.pipeline_depth > 1 and d is not None and not d.is_alive():
            self._restart("drainer")
        # stuck batch: any in-flight batch older than its exec budget
        with self._lock:
            recs = [r for r in self._inflight_recs if not r.cancelled]
        for rec in recs:
            limit = self.exec_timeout_s(rec.bucket)
            if now - rec.dispatched_at > limit:
                self._fail_inflight_window(now - rec.dispatched_at, limit)
                break

    def _restart(self, which: str):
        if self._stop.is_set():
            return
        self.health.record_failure()
        if self.health.watchdog_restarts >= self.restart_budget:
            self.health.force_dead(
                f"{which} died and the restart budget "
                f"({self.restart_budget}) is exhausted")
            event(_log, "engine_dead", model=self.model.name, which=which,
                  restart_budget=self.restart_budget)
            return
        self.health.record_restart()
        event(_log, "watchdog_restart", model=self.model.name, which=which,
              restarts=self.health.watchdog_restarts,
              budget=self.restart_budget)
        thread = threading.Thread(
            target=self._loop if which == "batcher" else self._drain_loop,
            name=f"{which}-{self.model.name}", daemon=True)
        if which == "batcher":
            self._thread = thread
        else:
            self._drainer = thread
        thread.start()

    def _fail_inflight_window(self, age_s: float, limit_s: float):
        """A batch exceeded its exec timeout: fail every in-flight future
        fast so callers aren't parked behind a hung batch.  Nothing here
        waits on the device: the drainer's eventual result for a
        cancelled record is discarded (``rec.cancelled``), and injected
        hangs are released through each record's cancel event."""
        with self._lock:
            recs = [r for r in self._inflight_recs if not r.cancelled]
            for rec in recs:
                rec.cancelled = True
            self.exec_timeouts += 1
        if not recs:
            return
        self.health.record_failure()
        event(_log, "exec_timeout", model=self.model.name,
              age_ms=round(age_s * 1e3, 1), limit_ms=round(limit_s * 1e3, 1),
              windows=len(recs),
              device_done=[r.done.query() if r.done is not None else None
                           for r in recs])
        err = TimeoutError(
            f"in-flight batch exceeded exec timeout: age {age_s * 1e3:.0f}"
            f"ms > limit {limit_s * 1e3:.0f}ms; failing the window fast")
        for rec in recs:
            if rec.cancel is not None:
                rec.cancel.set()
            for r in rec.requests:
                if r.span is not None and not r.future.done():
                    r.span.note("exec_timeout", f"age {age_s * 1e3:.0f}ms")
            pending = [r for r in rec.requests if not r.future.done()]
            if pending and self._rescue is not None:
                # replica mode: offer the cohort to a healthy replica
                # before failing anyone (serve/replicas.py bisect-retries
                # it there); a rescue must never raise into the watchdog
                try:
                    if self._rescue(pending, err):
                        continue
                except Exception as e:  # noqa: BLE001 — rescue is best effort; deliver the timeout instead
                    event(_log, "rescue_failed", model=self.model.name,
                          error=f"{type(e).__name__}: {e}")
            self._fail_requests(pending, err)

    # -- observability -----------------------------------------------------

    def health_report(self) -> dict:
        now = time.monotonic()
        rep = self.health.report(now)
        t, d = self._thread, self._drainer
        # a replica has no batcher thread of its own
        rep["batcher_alive"] = None if self.external_batcher else \
            bool(t is not None and t.is_alive())
        rep["drainer_alive"] = bool(d is not None and d.is_alive()) \
            if self.pipeline_depth > 1 else None
        rep["accepting"] = self._accepting
        # what /v1/healthz keys 503 on
        rep["can_serve"] = rep["state"] == "ok"
        rep["device"] = str(self.device)
        rep["placement"] = self.model.placement_desc()
        # the mesh advertisement of the reference's report: the layout
        # of this engine's weights and one device's share of them
        rep["mesh_shape"] = self.model.mesh_shape()
        rep["param_shard_bytes"] = self.model.param_bytes()
        rep["hbm_headroom_bytes"] = device_hbm_headroom(self.device)
        with self._lock:
            rep["inflight"] = self._inflight
            rep["batch_failures"] = self.batch_failures
            rep["retry_executions"] = self.retry_executions
            rep["retry_seconds"] = round(self.retry_seconds, 6)
            rep["quarantined"] = self.quarantined
            rep["exec_timeouts"] = self.exec_timeouts
            rep["shed_shutdown"] = self.shed_shutdown
            done = self._last_done
        rep["last_batch_age_s"] = round(now - done, 4) \
            if done is not None else None
        if self.faults.enabled:
            rep["faults"] = self.faults.stats()
        return rep

    @property
    def queue_depth(self) -> int:
        """Requests awaiting batch formation right now (the QoS pressure
        signal)."""
        return self._queue.qsize()

    def _prune_busy_locked(self, now: float) -> None:
        horizon = now - self.occupancy_window_s
        while self._busy_events and self._busy_events[0][0] < horizon:
            self._busy_events.popleft()

    def _occupancy_locked(self, now: float) -> float:
        self._prune_busy_locked(now)
        busy = sum(dt for _, dt in self._busy_events)
        return min(1.0, max(0.0, busy / self.occupancy_window_s))

    def occupancy(self) -> float:
        """Fraction of the trailing ``occupancy_window_s`` spent in batch
        execution: the compute-stage duty cycle, the batchy-SLO
        autoscaler's pressure signal (a saturated batchy engine shows
        occupancy near 1 with an empty queue)."""
        with self._lock:
            return self._occupancy_locked(time.monotonic())

    def stats(self) -> dict:
        now = time.monotonic()
        weight_bytes = self.model.param_bytes()
        with self._lock:
            span = None
            if self._first_dispatch is not None and \
                    self._last_done is not None:
                span = self._last_done - self._first_dispatch
            out = {"model": self.model.name,
                   "version": getattr(self.model, "serve_version", None),
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
                   # the served weights' bytes on the device (int8
                   # models: the quantized size; a mesh view: one
                   # device's share, beside the whole model's)
                   "weight_hbm_bytes": weight_bytes,
                   "param_shard_bytes": weight_bytes,
                   "param_global_bytes": self.model.param_global_bytes(),
                   "mesh_shape": self.model.mesh_shape(),
                   "pipeline": {
                       "depth": self.pipeline_depth,
                       "inflight": self._inflight,
                       "max_inflight": self.max_inflight,
                       "h2d_transfers": self.h2d_transfers,
                       "h2d_bytes": self.h2d_bytes,
                       "h2d_bytes_by_bucket": dict(
                           self.h2d_bytes_by_bucket),
                       "d2h_bytes": self.d2h_bytes,
                       "d2h_bytes_by_bucket": dict(
                           self.d2h_bytes_by_bucket),
                       # host proxy: share of the first-dispatch →
                       # last-drain span with an empty in-flight window
                       "device_idle_frac": (
                           round(self._idle_s / span, 4)
                           if span and span > 0 else None),
                       "occupancy": round(self._occupancy_locked(now), 4)}}
        out["pipeline"]["staging"] = self.staging.stats()
        out["latency"] = self.latency.percentiles()
        out["latency_hist"] = self.latency.state_dict()
        out["img_per_sec"] = self.throughput.images_per_sec
        out["admission"] = self.admission.stats()
        out["health"] = self.health_report()
        out["mfu"] = self.mfu.report()
        out["trace"] = self.tracer.summary()
        return out
