"""Serving metrics: latency quantiles and throughput.

Copies of ``LatencyHistogram`` and ``ThroughputMeter`` from
``deep_vision_tpu/core/metrics.py``.
"""

from __future__ import annotations

import time


class LatencyHistogram:
    """Latency quantiles over fixed log-spaced bins (serving p50/p95/p99).

    Fixed bin edges (not reservoir sampling) keep ``record`` O(log bins),
    memory constant, and — because every instance built with the same
    bounds shares the same edges.
    Quantiles are read from the cumulative counts and reported as the
    geometric midpoint of the containing bin, so the error is bounded by
    the bin ratio (~12% with the default 20 bins/decade).
    """

    def __init__(self, lo: float = 1e-4, hi: float = 1e3,
                 bins_per_decade: int = 20):
        import math

        decades = math.log10(hi / lo)
        n = max(1, int(round(decades * bins_per_decade)))
        ratio = (hi / lo) ** (1.0 / n)
        # edges[0]=lo .. edges[n]=hi; +2 overflow bins for <lo and >=hi
        self.edges = [lo * ratio ** i for i in range(n + 1)]
        self.counts = [0] * (n + 2)
        self.total = 0
        self.sum = 0.0

    def record(self, seconds: float):
        import bisect

        self.counts[bisect.bisect_right(self.edges, seconds)] += 1
        self.total += 1
        self.sum += seconds

    def quantile(self, q: float) -> float:
        """q in [0,1] → latency seconds (geometric bin midpoint)."""
        if self.total == 0:
            return 0.0
        rank = max(1, int(q * self.total + 0.999999))
        seen = 0
        for i, c in enumerate(self.counts):
            seen += c
            if seen >= rank:
                if i == 0:                       # underflow: below lo
                    return self.edges[0]
                if i > len(self.edges) - 1:      # overflow: above hi
                    return self.edges[-1]
                return (self.edges[i - 1] * self.edges[i]) ** 0.5
        return self.edges[-1]

    @property
    def mean(self) -> float:
        return self.sum / self.total if self.total else 0.0

    def percentiles(self) -> dict:
        """The serving dashboard tuple, in milliseconds."""
        return {"p50_ms": self.quantile(0.50) * 1e3,
                "p95_ms": self.quantile(0.95) * 1e3,
                "p99_ms": self.quantile(0.99) * 1e3,
                "mean_ms": self.mean * 1e3,
                "count": self.total}


class ThroughputMeter:
    """Images/sec with warmup exclusion — the reference printed this per-100
    batches (YOLO/tensorflow/train.py:217-223)."""

    def __init__(self, warmup_steps: int = 2):
        self.warmup_steps = warmup_steps
        self.reset()

    def reset(self):
        self._n = 0
        self._images = 0
        self._start = None

    def update(self, batch_size: int):
        self._n += 1
        if self._n == self.warmup_steps:
            self._start = time.perf_counter()
        elif self._n > self.warmup_steps:
            self._images += batch_size

    @property
    def images_per_sec(self) -> float:
        if self._start is None or self._images == 0:
            return 0.0
        return self._images / (time.perf_counter() - self._start)
