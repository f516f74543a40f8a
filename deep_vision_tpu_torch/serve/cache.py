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
without a ``params_digest``.

Brownout L2 (serve/brownout.py) relaxes version purity on purpose:
``get_stale`` answers an exact miss with the newest cached entry for
the same (route, model, dtypes, payload) under ANY params version, a
stale but well-formed answer rather than a 429 when the engine is
saturated.  Only the HTTP layer at L2+ asks for it, and it marks such
an answer ``X-DVT-Degraded``; every other lookup keeps the exact-version
contract.  A cascaded model's inserts are counted by the tier that
produced the answer (``insertions_by_tier``); the key stays tier-free.

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
        # cascade provenance: inserts by the tier that produced the
        # answer ("front", "t1", "big"); counters only, the KEY stays
        # tier-free (keyed on the cascade's combined digest)
        self.insertions_by_tier: dict = {}  # guarded-by: _lock
        # version-free alias → the newest full key inserted for it (the
        # brownout L2 stale path), pruned with its entry on eviction
        self._stale: dict[tuple, tuple] = {}  # guarded-by: _lock
        self.stale_hits = 0  # guarded-by: _lock

    @staticmethod
    def key(route: str, model: str, version_digest: str,
            wire_dtype: str, infer_dtype: str, body_digest: str) -> tuple:
        """``route`` keeps /v1/classify and /v1/detect answers for the
        same payload apart."""
        return (route, model, version_digest, wire_dtype, infer_dtype,
                body_digest)

    @staticmethod
    def _alias(key: tuple) -> tuple:
        # the full key without the params digest (index 2)
        return key[:2] + key[3:]

    def get(self, key: tuple) -> bytes | None:
        with self._lock:
            blob = self._store.get(key)
            if blob is None:
                self.misses += 1
                return None
            self._store.move_to_end(key)
            self.hits += 1
            return blob

    def get_stale(self, key: tuple) -> bytes | None:
        """The brownout L2 fallback after an exact ``get`` miss: the
        newest entry for the same (route, model, dtypes, payload) under
        another params version, or None when no other version answered
        this payload.  The caller marks the answer degraded."""
        alias = self._alias(key)
        with self._lock:
            full = self._stale.get(alias)
            if full is None or full == key:
                return None
            blob = self._store.get(full)
            if blob is None:
                del self._stale[alias]  # the entry aged out of the LRU
                return None
            self._store.move_to_end(full)
            self.stale_hits += 1
            return blob

    def put(self, key: tuple, blob: bytes, tier: str | None = None):
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
            self._stale[self._alias(key)] = key
            if tier:
                self.insertions_by_tier[tier] = \
                    self.insertions_by_tier.get(tier, 0) + 1
            while self._bytes > self.max_bytes:
                vkey, victim = self._store.popitem(last=False)
                self._bytes -= len(victim)
                self.evictions += 1
                if self._stale.get(self._alias(vkey)) == vkey:
                    del self._stale[self._alias(vkey)]

    def clear(self):
        with self._lock:
            self._store.clear()
            self._stale.clear()
            self._bytes = 0

    def stats(self) -> dict:
        with self._lock:
            lookups = self.hits + self.misses
            return {"entries": len(self._store),
                    "bytes": self._bytes,
                    "max_bytes": self.max_bytes,
                    "hits": self.hits,
                    "stale_hits": self.stale_hits,
                    "misses": self.misses,
                    "hit_rate": self.hits / lookups if lookups else 0.0,
                    "evictions": self.evictions,
                    "insertions": self.insertions,
                    "insertions_by_tier": dict(self.insertions_by_tier)}
