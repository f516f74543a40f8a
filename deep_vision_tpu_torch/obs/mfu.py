"""Serving MFU: counted FLOPs over measured compute-stage seconds.

Port of ``deep_vision_tpu/obs/mfu.py``.  A serving model's FLOPs are
counted once, when the registry builds its first bucket, by
``torch.utils.flop_counter.FlopCounterMode`` over one forward of one
image (``bucket_flops``; source ``flop_counter``), and each bucket's
count is that times its batch.  It counts
convolutions and matrix products as 2 × multiply-adds and nothing
elementwise, where the reference reads XLA's cost analysis
(``compiled_flops``), which also counts elementwise work; the test of
this module writes down the ratio of the two on one bucket.  When the
count fails, ``2 × parameters × batch`` stands in, labelled
``params_lower_bound``.  The engine feeds the measured per-batch
compute seconds (completion minus the later of dispatch and the previous
batch's completion: device occupancy under pipelining, not queue wait).

    serving_mfu = Σ(batches_b × flops_b) / Σ compute_s / peak_flops

The peak comes from ``PEAK_BF16_TFLOPS``, keyed by
``torch.cuda.get_device_name()``.  On a device not in the table, or the
CPU, ``mfu`` is None unless the caller passes ``peak=``: there is no
fallback figure.
"""

from __future__ import annotations

import threading

#: dense bf16 tensor-core peak TFLOP/s by CUDA device name.  H100 SXM5
#: (the 80 GB HBM3 part): 989 TFLOP/s, NVIDIA H100 Tensor Core GPU data
#: sheet, dense (without sparsity), at its 700 W power limit
PEAK_BF16_TFLOPS = {
    "NVIDIA H100 80GB HBM3": 989.0,
}


def peak_flops_per_s(device_name: str | None = None) -> float | None:
    """Peak bf16 FLOP/s of the CUDA device named ``device_name`` (the
    current device when None), or None when it is not in the table or
    there is no CUDA device."""
    if device_name is None:
        import torch

        if not torch.cuda.is_available():
            return None
        device_name = torch.cuda.get_device_name()
    for name, tflops in PEAK_BF16_TFLOPS.items():
        if device_name.startswith(name):
            return tflops * 1e12
    return None


def bucket_flops(fn, *args) -> float | None:
    """FLOPs of one call ``fn(*args)`` by ``FlopCounterMode`` (None when
    it counts nothing)."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    counter = FlopCounterMode(display=False)
    with counter, torch.inference_mode():
        fn(*args)
    return float(counter.get_total_flops()) or None


def params_flops_lower_bound(model, batch: int) -> float:
    """The fallback: 2 × parameter count × batch (one multiply-add per
    weight per image: exact for dense layers, a lower bound for
    convolutions, which reuse each weight spatially).  Counts the float
    and the int8 tensors of the ``state_dict``: a quantized model keeps
    its conv and dense weights as int8 codes, and each still does one
    multiply-add per image."""
    import torch

    n = sum(t.numel() for t in model.state_dict().values()
            if t.is_floating_point() or t.dtype == torch.int8)
    return 2.0 * n * batch


def round_mfu(mfu: float | None) -> float | None:
    """6 SIGNIFICANT digits, not 6 decimals: a tiny MFU must survive
    reporting instead of rounding to 0."""
    return float(f"{mfu:.6g}") if mfu is not None else None


class MfuMeter:
    """Accumulates (bucket flops × batches) and compute seconds.

    Thread-safe under its own lock: ``observe`` is called from the
    drainer and from the synchronous retry path.  The peak resolves
    lazily on the first report (None where the device has none)."""

    def __init__(self, peak: float | None = None):
        self._lock = threading.Lock()
        self._peak = peak
        self._peak_resolved = peak is not None
        self._bucket_flops: dict[int, float | None] = {}  # guarded-by: _lock
        self._source: str | None = None  # guarded-by: _lock
        self.batches = 0  # guarded-by: _lock
        self.images = 0  # guarded-by: _lock
        self.compute_s = 0.0  # guarded-by: _lock
        self.flops = 0.0  # guarded-by: _lock
        self.unknown_flops_batches = 0  # guarded-by: _lock
        # bucket → [batches, compute seconds]: the per-bucket MFU
        self._by_bucket: dict[int, list] = {}  # guarded-by: _lock

    def set_bucket_flops(self, bucket: int, flops: float | None,
                         source: str | None = None):
        with self._lock:
            self._bucket_flops[int(bucket)] = flops
            if source is not None:
                self._source = source

    def observe(self, bucket: int, images: int, compute_s: float):
        """One executed batch: its bucket, live image count and measured
        compute-stage seconds."""
        with self._lock:
            self.batches += 1
            self.images += int(images)
            self.compute_s += max(0.0, float(compute_s))
            agg = self._by_bucket.setdefault(int(bucket), [0, 0.0])
            agg[0] += 1
            agg[1] += max(0.0, float(compute_s))
            f = self._bucket_flops.get(int(bucket))
            if f:
                self.flops += f
            else:
                self.unknown_flops_batches += 1

    def peak(self) -> float | None:
        if not self._peak_resolved:
            self._peak = peak_flops_per_s()
            self._peak_resolved = True
        return self._peak

    def mfu(self) -> float | None:
        peak = self.peak()
        with self._lock:
            if self.compute_s <= 0 or self.flops <= 0 or not peak:
                return None
            return self.flops / self.compute_s / peak

    def report(self) -> dict:
        """The reference's report, plus ``mfu_by_bucket``: each bucket's
        own FLOPs over its own compute seconds."""
        mfu = self.mfu()
        peak = self.peak()
        with self._lock:
            by_bucket = {
                str(b): round_mfu(n * self._bucket_flops[b] / secs / peak)
                for b, (n, secs) in sorted(self._by_bucket.items())
                if peak and secs > 0 and self._bucket_flops.get(b)}
            return {"serving_mfu": round_mfu(mfu),
                    "mfu_by_bucket": by_bucket,
                    "flops_total": self.flops,
                    "compute_s": round(self.compute_s, 6),
                    "batches": self.batches,
                    "images": self.images,
                    "unknown_flops_batches": self.unknown_flops_batches,
                    "peak_flops_per_s": self._peak,
                    "flops_source": self._source,
                    "flops_by_bucket": {
                        str(b): f for b, f in
                        sorted(self._bucket_flops.items())}}

    @staticmethod
    def merged_report(meters: list["MfuMeter"]) -> dict:
        """One view over several meters of the same process (the same
        peak): FLOPs and compute seconds sum; MFU recomputes from the
        sums."""
        flops = sum(m.flops for m in meters)
        secs = sum(m.compute_s for m in meters)
        peak = meters[0].peak() if meters else peak_flops_per_s()
        mfu = flops / secs / peak if secs > 0 and flops > 0 and peak \
            else None
        by_bucket: dict[str, float | None] = {}
        for m in meters:
            for b, f in m._bucket_flops.items():
                by_bucket.setdefault(str(b), f)
        return {"serving_mfu": round_mfu(mfu),
                "flops_total": flops,
                "compute_s": round(secs, 6),
                "batches": sum(m.batches for m in meters),
                "images": sum(m.images for m in meters),
                "unknown_flops_batches": sum(m.unknown_flops_batches
                                             for m in meters),
                "peak_flops_per_s": peak,
                "flops_source": next((m._source for m in meters
                                      if m._source), None),
                "flops_by_bucket": dict(sorted(by_bucket.items()))}
