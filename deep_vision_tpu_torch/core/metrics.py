"""Metrics: the training logger, latency quantiles, throughput, step
timing and the Prometheus text renderer.

Copies of ``MetricLogger`` (``metrics.jsonl`` and TensorBoard event
files, ``core/tboard.py``), ``LatencyHistogram``, ``PromText`` and
``ThroughputMeter`` from ``deep_vision_tpu/core/metrics.py``, plus
``StepTimer``.
"""

from __future__ import annotations

import json
import os
import time
from typing import Mapping


class MetricLogger:
    """Named scalar series kept in memory (``history``, checkpointed so a
    resumed run continues them), appended to ``workdir/metrics.jsonl``
    as one JSON object per value and, with ``tensorboard`` (the
    default), written as TensorBoard scalars under
    ``workdir/tensorboard`` (the event file is made at the first log, so
    a logger that never logs leaves none).  With ``writer`` False (a
    data-parallel rank other than 0) it keeps the history, so plateau
    and best-checkpoint decisions agree on every rank, and writes no
    file: rank 0 writes them once."""

    def __init__(self, workdir: str | None = None,
                 filename: str = "metrics.jsonl", tensorboard: bool = True,
                 writer: bool = True):
        self.history: dict[str, dict[str, list]] = {}
        self._path = None
        self._tb = None
        self._tb_dir = None
        if workdir is not None and writer:
            os.makedirs(workdir, exist_ok=True)
            self._path = os.path.join(workdir, filename)
            if tensorboard:
                self._tb_dir = os.path.join(workdir, "tensorboard")

    def _tb_writer(self):
        if self._tb is None and self._tb_dir is not None:
            from deep_vision_tpu_torch.core.tboard import TFEventWriter

            self._tb = TFEventWriter(self._tb_dir)
        return self._tb

    def _record(self, name: str, step: int, value: float):
        series = self.history.setdefault(name, {"steps": [], "values": []})
        series["steps"].append(int(step))
        series["values"].append(float(value))
        if self._path:
            with open(self._path, "a") as f:
                f.write(json.dumps({"name": name, "step": int(step),
                                    "value": float(value),
                                    "time": time.time()}) + "\n")

    def log(self, name: str, step: int, value: float):
        self._record(name, step, value)
        tb = self._tb_writer()
        if tb is not None:
            tb.scalar(name, value, step)
            tb.flush()

    def log_dict(self, step: int, metrics: Mapping[str, float]):
        for k, v in metrics.items():
            self._record(k, step, v)
        tb = self._tb_writer()
        if tb is not None and metrics:
            tb.scalars(metrics, step)  # one event and one flush
            tb.flush()

    def log_input_block(self, step: int, stats: dict):
        """The trainer's per-epoch input block from ``DevicePrefetcher``
        stats: stall fraction, H2D bytes per step and the producer's
        per-batch stage times."""
        n = max(1, int(stats.get("batches", 0)))
        prod = stats.get("producer_ms", {})
        self.log_dict(step, {
            "input_stall_frac": float(stats.get("input_stall_frac", 0.0)),
            "input_h2d_bytes_per_step":
                float(stats.get("h2d_bytes_per_step", 0.0)),
            "input_prep_wait_ms": float(prod.get("prep_wait", 0.0)) / n,
            "input_assemble_ms": float(prod.get("assemble", 0.0)) / n,
            "input_h2d_ms": float(prod.get("h2d", 0.0)) / n,
        })

    def latest(self, name: str) -> float | None:
        s = self.history.get(name)
        return s["values"][-1] if s and s["values"] else None

    def state_dict(self) -> dict:
        return self.history

    def load_state_dict(self, d: dict):
        self.history = {k: {"steps": list(v["steps"]),
                            "values": list(v["values"])}
                        for k, v in d.items()}


class StepTimer:
    """Per-step times of a training loop.  On CUDA an event is recorded on
    the current stream after each step, so the interval between two
    events is the step's time on the device's clock (idle gaps included,
    since the host may launch slower than the device runs); on the CPU it
    reads the host clock.  ``mean_ms`` averages the steps after the first
    ``warmup``."""

    def __init__(self, device, warmup: int = 1):
        import torch

        self._cuda = torch.device(device).type == "cuda"
        self.warmup = warmup
        self._marks: list = []

    def mark(self):
        import torch

        if self._cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self._marks.append(ev)
        else:
            self._marks.append(time.perf_counter())

    def step_ms(self) -> list[float]:
        """Milliseconds of every step after the first mark (syncs once)."""
        if len(self._marks) < 2:
            return []
        if self._cuda:
            self._marks[-1].synchronize()
            return [a.elapsed_time(b)
                    for a, b in zip(self._marks, self._marks[1:])]
        return [(b - a) * 1e3 for a, b in zip(self._marks, self._marks[1:])]

    def mean_ms(self) -> float | None:
        steady = self.step_ms()[self.warmup:]
        return sum(steady) / len(steady) if steady else None


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

    def state_dict(self) -> dict:
        return {"edges": list(self.edges), "counts": list(self.counts),
                "total": self.total, "sum": self.sum}

    def load_state_dict(self, d: dict):
        self.edges = list(d["edges"])
        self.counts = list(d["counts"])
        self.total = int(d["total"])
        self.sum = float(d["sum"])

    def merge(self, d: dict) -> "LatencyHistogram":
        """Sum another histogram's ``state_dict`` into this one (a
        replicated engine's fleet latency)."""
        if list(d["edges"]) != self.edges:
            raise ValueError("cannot merge histograms with different bins")
        self.counts = [a + b for a, b in zip(self.counts, d["counts"])]
        self.total += int(d["total"])
        self.sum += float(d["sum"])
        return self


def _prom_num(v) -> str:
    """Prometheus sample/edge value formatting: integers stay integral,
    floats use repr (deterministic, full precision: bucket ``le`` labels
    must be byte-identical across scrapes or the series forks)."""
    if isinstance(v, bool):
        return "1" if v else "0"
    if isinstance(v, int):
        return str(v)
    f = float(v)
    return str(int(f)) if f.is_integer() and abs(f) < 1e15 else repr(f)


def _prom_escape(v: str) -> str:
    return v.replace("\\", r"\\").replace('"', r'\"').replace("\n", r"\n")


class PromText:
    """Prometheus text-exposition (format 0.0.4) renderer, stdlib only.

    The serving ``/metrics`` endpoint feeds the engines' stats dicts
    through this: the dicts stay the source of truth, this renders a
    snapshot.  ``histogram`` renders a ``LatencyHistogram.state_dict`` as
    cumulative ``le`` buckets (``counts[0]``, the underflow bin, folds
    into the first edge; ``+Inf`` is the total), plus ``_sum`` and
    ``_count``, every edge always emitted so the bucket series stay
    stable across scrapes."""

    def __init__(self):
        self._lines: list[str] = []
        self._typed: set[str] = set()

    def _meta(self, name: str, typ: str, help_: str):
        if name in self._typed:
            return
        self._typed.add(name)
        if help_:
            self._lines.append(f"# HELP {name} {help_}")
        self._lines.append(f"# TYPE {name} {typ}")

    @staticmethod
    def _labels(labels: dict | None) -> str:
        if not labels:
            return ""
        inner = ",".join(f'{k}="{_prom_escape(str(v))}"'
                         for k, v in sorted(labels.items()))
        return "{" + inner + "}"

    def sample(self, name: str, value, labels: dict | None = None, *,
               typ: str = "gauge", help: str = ""):
        """One sample line; a ``None`` value is skipped (an unknown gauge
        is absent, never a fabricated 0)."""
        if value is None:
            return
        self._meta(name, typ, help)
        self._lines.append(f"{name}{self._labels(labels)} "
                           f"{_prom_num(value)}")

    def counter(self, name: str, value, labels: dict | None = None,
                help: str = ""):
        self.sample(name, value, labels, typ="counter", help=help)

    def gauge(self, name: str, value, labels: dict | None = None,
              help: str = ""):
        self.sample(name, value, labels, typ="gauge", help=help)

    def histogram(self, name: str, state: dict,
                  labels: dict | None = None, help: str = ""):
        """Cumulative buckets from a ``LatencyHistogram.state_dict``
        (``le`` in seconds)."""
        self._meta(name, "histogram", help)
        labels = dict(labels or {})
        edges, counts = state["edges"], state["counts"]
        cum = 0
        for i, edge in enumerate(edges):
            cum += counts[i]
            self._lines.append(
                f"{name}_bucket"
                f"{self._labels({**labels, 'le': _prom_num(edge)})} {cum}")
        total = int(state["total"])
        self._lines.append(
            f"{name}_bucket{self._labels({**labels, 'le': '+Inf'})} "
            f"{total}")
        self._lines.append(f"{name}_sum{self._labels(labels)} "
                           f"{_prom_num(float(state['sum']))}")
        self._lines.append(f"{name}_count{self._labels(labels)} {total}")

    def render(self) -> str:
        return "\n".join(self._lines) + "\n"


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
