"""Where a serving bucket's time goes: ``torch.profiler`` over a few
forwards of one bucket callable, device time summed by kernel.

    python -m deep_vision_tpu_torch.obs.profile -m resnet50 \\
        --infer-dtype int8 --bucket 32 [--weights w.npz] [--device cuda]

Prints one JSON object: the bucket's wall time per forward (host clock
around synchronised calls), the device busy time per forward (the sum
of its kernels' durations) and its share of the wall time, and the
kernels with the most device time,
grouped into ``conv`` (cuDNN/cuBLAS convolution and GEMM kernels,
cuBLAS's ``nvjet_*`` included),
``serve_ingest`` and ``other`` (elementwise, pooling, reductions).
Where the profiler records no device time, those fields are null.
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from deep_vision_tpu_torch.core.device import (
    configure_precision,
    resolve_device,
)

CONV_MARKERS = ("conv", "gemm", "xmma", "cudnn", "cutlass", "sm90_",
                "implicit", "nvjet")


def kernel_group(name: str) -> str:
    low = name.lower()
    if "serve_ingest" in low:
        return "serve_ingest"
    if any(m in low for m in CONV_MARKERS):
        return "conv"
    return "other"


def profile_bucket(sm, bucket: int, iters: int = 5, top: int = 12) -> dict:
    """Profile ``iters`` forwards of ``sm``'s ``bucket`` callable."""
    from torch.profiler import ProfilerActivity, profile

    on_cuda = sm.device.type == "cuda"

    def sync():
        if on_cuda:
            torch.cuda.synchronize(sm.device)

    fn = sm.compile_bucket(bucket)
    gen = torch.Generator().manual_seed(0)
    x = torch.randint(0, 256, (bucket, *sm.input_shape), generator=gen,
                      dtype=torch.uint8).to(sm.device)
    for _ in range(2):
        fn(x)
    sync()
    activities = [ProfilerActivity.CPU] + \
        ([ProfilerActivity.CUDA] if on_cuda else [])
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            fn(x)
        sync()
        wall_ms = (time.perf_counter() - t0) * 1e3 / iters
    groups: dict[str, float] = {}
    kernels = []
    for e in prof.key_averages():
        # kernel rows only: the operator rows above them carry the same
        # device time again
        if e.device_type == torch.autograd.DeviceType.CPU:
            continue
        dev_us = e.self_device_time_total
        if dev_us <= 0:
            continue
        g = kernel_group(e.key)
        groups[g] = groups.get(g, 0.0) + dev_us / 1e3 / iters
        kernels.append((dev_us / 1e3 / iters, e.count // iters, e.key))
    kernels.sort(reverse=True)
    busy = sum(groups.values()) if groups else None
    return {"bucket": bucket, "device": str(sm.device),
            "wall_ms_per_forward": wall_ms,
            "device_busy_ms_per_forward": busy,
            "device_busy_share": busy / wall_ms if busy else None,
            "device_ms_by_group": groups or None,
            "top_kernels": [{"ms": ms, "launches": n, "name": name[:120]}
                            for ms, n, name in kernels[:top]]}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("-m", "--model", required=True)
    p.add_argument("--weights", default=None)
    p.add_argument("--infer-dtype", choices=("float32", "bfloat16", "int8"),
                   default="int8")
    p.add_argument("--bucket", type=int, default=32)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    from deep_vision_tpu_torch.serve.registry import ModelRegistry

    device = resolve_device(args.device)
    configure_precision()
    sm = ModelRegistry().load_checkpoint(args.model, args.weights,
                                         wire_dtype="uint8",
                                         infer_dtype=args.infer_dtype,
                                         device=device)
    print(json.dumps(profile_bucket(sm, args.bucket)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
