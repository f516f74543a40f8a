"""Content-addressed response cache for the serving front end.

Port of ``deep_vision_tpu/serve/cache.py`` (``payload_digest``,
``ResponseCache``).  Image traffic repeats: a popular image is answered
many times, and each answer is a pure function of (weights, dtypes,
payload).  The key is

    (route, model name, active-version params digest, wire dtype,
     infer dtype, blake2b(payload bytes))

so a hit is byte-identical to what the engine would recompute, and a
promote, rollback or hot reload invalidates on its own: the active
version's ``params_digest`` changes and every old key stops matching
(stale entries age out through the LRU).

Not cached: shed (429) and quarantine or error answers (transient
verdicts), debug-trace answers (the span is per request), and models
without a ``params_digest``.  The brownout slice's stale lookup and the
cascade slice's per-tier counters wait for those slices.

The store is a byte-bounded LRU (an ``OrderedDict`` under one leaf
lock) of already-serialized JSON bodies, so a hit skips decode, engine
and serialization at once.
"""

from __future__ import annotations

import hashlib
import threading
from collections import OrderedDict

DEFAULT_CACHE_BYTES = 64 * 2**20


def payload_digest(body: bytes) -> str:
    """blake2b hex digest (8 bytes) of the raw request payload: the
    content address, the same digest family as
    ``core.restore.params_digest``."""
    return hashlib.blake2b(body, digest_size=8).hexdigest()


class ResponseCache:
    """Byte-bounded LRU of serialized 200 answers."""

    def __init__(self, max_bytes: int = DEFAULT_CACHE_BYTES):
        self.max_bytes = max(0, int(max_bytes))
        self._lock = threading.Lock()
        self._store: OrderedDict[tuple, bytes] = OrderedDict()  # guarded-by: _lock
        self._bytes = 0  # guarded-by: _lock
        self.hits = 0  # guarded-by: _lock
        self.misses = 0  # guarded-by: _lock
        self.evictions = 0  # guarded-by: _lock
        self.insertions = 0  # guarded-by: _lock

    @staticmethod
    def key(route: str, model: str, version_digest: str,
            wire_dtype: str, infer_dtype: str, body_digest: str) -> tuple:
        """``route`` keeps /v1/classify and /v1/detect answers for the
        same payload apart."""
        return (route, model, version_digest, wire_dtype, infer_dtype,
                body_digest)

    def get(self, key: tuple) -> bytes | None:
        with self._lock:
            blob = self._store.get(key)
            if blob is None:
                self.misses += 1
                return None
            self._store.move_to_end(key)
            self.hits += 1
            return blob

    def put(self, key: tuple, blob: bytes):
        size = len(blob)
        if size > self.max_bytes:
            return  # larger than the whole budget: not cacheable
        with self._lock:
            old = self._store.pop(key, None)
            if old is not None:
                self._bytes -= len(old)
            self._store[key] = blob
            self._bytes += size
            self.insertions += 1
            while self._bytes > self.max_bytes:
                _, victim = self._store.popitem(last=False)
                self._bytes -= len(victim)
                self.evictions += 1

    def stats(self) -> dict:
        with self._lock:
            lookups = self.hits + self.misses
            return {"entries": len(self._store),
                    "bytes": self._bytes,
                    "max_bytes": self.max_bytes,
                    "hits": self.hits,
                    "misses": self.misses,
                    "hit_rate": self.hits / lookups if lookups else 0.0,
                    "evictions": self.evictions,
                    "insertions": self.insertions}
