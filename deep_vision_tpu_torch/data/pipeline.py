"""Staged train-input pipeline: pinned host staging + ``DevicePrefetcher``.

Port of ``deep_vision_tpu/data/pipeline.py``.  Per batch a producer
thread runs

    prep_wait → assemble → h2d → enqueue

``prep_wait`` is time blocked on the upstream loader, ``assemble`` copies
each host array into a pinned staging buffer, ``h2d`` issues a
``non_blocking`` copy to the device on a side stream and records an event
after it, and ``enqueue`` hands the device batch to a queue of ``depth``
batches.  The consumer's stream waits on that event before it uses the
batch, and ``record_stream`` tells the caching allocator the batch is in
use on the consumer's stream.  A pinned buffer goes back to the pool
with its copy's event and is not handed out again until that event has
completed.  On a CPU device the host arrays pass through as tensors, with
no staging.

The consumer records ``stall`` (time waiting on the queue) and ``step``
(time between dequeues), so ``input_stall_frac = stall / (stall + step)``
is the share of the epoch spent waiting on input.  ``close()`` stops the
producer, drains the queue and joins the thread, so an abandoned epoch
leaves neither a thread nor device batches behind.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterable

import numpy as np
import torch

from deep_vision_tpu_torch.obs.trace import Span

__all__ = ["PinnedStagingPool", "DevicePrefetcher"]

_END = object()


class PinnedStagingPool:
    """Per-(shape, dtype) free-list of pinned host buffers, each returned
    with the event of the copy that reads it."""

    def __init__(self):
        self._free: dict[tuple, list] = {}
        self._lock = threading.Lock()
        self.allocated = 0
        self.reused = 0

    def acquire(self, shape: tuple, dtype: torch.dtype) -> torch.Tensor:
        key = (tuple(shape), dtype)
        with self._lock:
            free = self._free.get(key)
            entry = free.pop() if free else None
            if entry is None:
                self.allocated += 1
            else:
                self.reused += 1
        if entry is None:
            return torch.empty(shape, dtype=dtype, pin_memory=True)
        buf, event = entry
        event.synchronize()  # its last copy to the device has finished
        return buf

    def release(self, buf: torch.Tensor, event) -> None:
        with self._lock:
            self._free.setdefault((tuple(buf.shape), buf.dtype),
                                  []).append((buf, event))

    def stats(self) -> dict:
        with self._lock:
            return {"allocated": self.allocated, "reused": self.reused}


class _EpochStream:
    """One epoch's staged batch stream (``DevicePrefetcher.iterate``).
    The producer thread owns ``_pspan``, the consumer ``_cspan``."""

    def __init__(self, device: torch.device, iterable: Iterable, depth: int,
                 pool: PinnedStagingPool):
        self.device = device
        self._pool = pool
        self._iterable = iterable
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._error: BaseException | None = None
        self._pspan = Span(request_id="producer", origin="start")
        self._cspan = Span(request_id="consumer", origin="start")
        self._first_get = True
        self._done = False
        self.batches = 0
        self.h2d_bytes = 0
        self._side = torch.cuda.Stream(device) \
            if device.type == "cuda" else None
        self._thread = threading.Thread(
            target=self._loop, daemon=True, name="dvt-prefetch")
        self._thread.start()

    # -- producer ------------------------------------------------------------

    def _offer(self, item) -> bool:
        """Bounded put that gives up once the epoch is closed."""
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.05)
                return True
            except queue.Full:
                continue
        return False

    def _transfer(self, batch: dict):
        """Host batch → (device batch, copy event or None)."""
        host = {k: np.ascontiguousarray(v) for k, v in batch.items()}
        self.h2d_bytes += sum(v.nbytes for v in host.values())
        if self._side is None:
            self._pspan.mark("assemble")
            return {k: torch.from_numpy(v) for k, v in host.items()}, None
        staged = {}
        for k, v in host.items():
            src = torch.from_numpy(v)
            buf = self._pool.acquire(src.shape, src.dtype)
            buf.copy_(src)
            staged[k] = buf
        self._pspan.mark("assemble")
        with torch.cuda.stream(self._side):
            dev = {k: v.to(self.device, non_blocking=True)
                   for k, v in staged.items()}
            event = torch.cuda.Event()
            event.record(self._side)
        for buf in staged.values():
            self._pool.release(buf, event)
        return dev, event

    def _loop(self):
        try:
            if self._side is not None and self.device.index is not None:
                # a thread starts on card 0: pin it to a rank's card
                # before it allocates pinned buffers or events (a bare
                # "cuda" is the current card, 0 in every thread)
                torch.cuda.set_device(self.device)
            it = iter(self._iterable)
            while not self._stop.is_set():
                try:
                    item = next(it)
                except StopIteration:
                    break
                self._pspan.mark("prep_wait")
                dev = self._transfer(item)
                self._pspan.mark("h2d")
                if not self._offer(dev):
                    return
                self._pspan.mark("enqueue")
        except BaseException as e:  # noqa: BLE001 — re-raised consumer-side
            self._error = e
        finally:
            self._offer(_END)

    # -- consumer ------------------------------------------------------------

    def __iter__(self):
        return self

    def __next__(self) -> dict:
        if self._done:
            raise StopIteration
        if not self._first_get:
            self._cspan.mark("step")
        self._first_get = False
        while True:
            try:
                item = self._q.get(timeout=0.1)
                break
            except queue.Empty:
                if self._stop.is_set():
                    self._done = True
                    raise StopIteration from None
        self._cspan.mark("stall")
        if item is _END:
            self._done = True
            self._thread.join(timeout=5.0)
            if self._error is not None:
                raise self._error
            raise StopIteration
        batch, event = item
        if event is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(event)
            for v in batch.values():
                v.record_stream(stream)
        self.batches += 1
        return batch

    def close(self):
        """Stop the producer, drop queued batches, join the thread.
        Idempotent; safe mid-epoch and after exhaustion."""
        self._stop.set()
        self._done = True
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=5.0)

    @property
    def alive(self) -> bool:
        return self._thread.is_alive()

    def stats(self) -> dict:
        """The epoch's input-goodput block (the trainer logs it)."""
        prod = self._pspan.to_dict()["stages"]
        cons = self._cspan.to_dict()["stages"]
        stall_ms = cons.get("stall", 0.0)
        step_ms = cons.get("step", 0.0)
        wall_ms = stall_ms + step_ms
        return {
            "batches": self.batches,
            "input_stall_frac": stall_ms / wall_ms if wall_ms > 0 else 0.0,
            "stall_ms": stall_ms,
            "step_ms": step_ms,
            "h2d_bytes": self.h2d_bytes,
            "h2d_bytes_per_step": self.h2d_bytes / max(1, self.batches),
            "producer_ms": dict(prod),
            "pool": self._pool.stats(),
        }


class DevicePrefetcher:
    """Staged, abandonable host→device prefetcher for the train loop.

    One instance persists across epochs (the pinned pool keeps its
    buffers); each ``iterate()`` runs one epoch through a fresh producer
    thread and a queue of at most ``depth`` device batches."""

    def __init__(self, device, depth: int = 2):
        self.device = torch.device(device)
        self.depth = max(1, int(depth))
        self.pool = PinnedStagingPool()
        self._epoch: _EpochStream | None = None

    def iterate(self, iterable: Iterable) -> _EpochStream:
        """Start (and return) one epoch's stream; closes the previous."""
        self.close()
        self._epoch = _EpochStream(self.device, iterable, self.depth,
                                   self.pool)
        return self._epoch

    def close(self):
        if self._epoch is not None:
            self._epoch.close()
            self._epoch = None

    def stats(self) -> dict:
        return self._epoch.stats() if self._epoch is not None else {}
