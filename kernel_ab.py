#!/usr/bin/env python3
"""Time variants of one kernel's CUDA source against each other on one
NVIDIA GPU.

    python3 kernel_ab.py KERNEL LABEL=PATH[@NAME=VALUE,...] ...

``KERNEL`` is ``best_iou_max`` or ``serve_ingest``.  Each ``PATH`` is a
source with the C interface of ``deep_vision_tpu_torch/csrc/KERNEL.cu``
(for example the parent commit's file, unpacked with ``git archive``
into a directory that ``.gitignore`` lists); each ``NAME=VALUE`` sets its
``constexpr int NAME`` (``best_iou_max.cu@kDivideOnce=0`` is the design
without the single division).  The variants are built in parallel with
the package's nvcc flags, held against the plain version on the first
input sets of every case (``best_iou_max`` bit for bit, a NaN matching
any NaN, on the edge set and a timed set; ``serve_ingest`` int8 equal,
float32 within 1e-6), and timed with ``chip_smoke.device_ms`` in turns
(every variant, then every variant in reverse): ``best_iou_max`` at the
yolov3_coco loss shapes and shares of ``chip_smoke.py`` and at the YOLOv3
run's share at every scale, ``serve_ingest`` at the int8 serving buckets
1, 8, 32 and float32 at 32.  One JSON line a case, then ``{"ab": ...}``
and the card's name and power limit.
"""

from __future__ import annotations

import ctypes
import json
import math
import os
import re
import subprocess
import sys

import chip_smoke as cs


def sources(specs: list[str]) -> dict[str, str]:
    """``LABEL=PATH[@NAME=VALUE,...]`` → {label: source text}."""
    out = {}
    for spec in specs:
        label, _, rest = spec.partition("=")
        path, _, sets = rest.partition("@")
        cs.check(bool(label and path), f"bad variant '{spec}': LABEL=PATH")
        with open(os.path.join(cs.REPO, path)) as f:
            text = f.read()
        for item in filter(None, sets.split(",")):
            name, _, value = item.partition("=")
            text, hits = re.subn(rf"(constexpr int {name} = )[^;]+;",
                                 rf"\g<1>{value};", text)
            cs.check(hits == 1, f"{path} has no 'constexpr int {name}'")
        out[label] = text
    return out


def bind(kernel: str, lib: ctypes.CDLL) -> ctypes.CDLL:
    fn = getattr(lib, f"dvt_{kernel}")
    fn.argtypes = {
        "best_iou_max": [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3
        + [ctypes.c_void_p],
        "serve_ingest": [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                         ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                         ctypes.c_float, ctypes.c_int, ctypes.c_int,
                         ctypes.c_void_p]}[kernel]
    fn.restype = ctypes.c_int
    return lib


def build(kernel: str, texts: dict[str, str],
          out_dir: str) -> dict[str, ctypes.CDLL]:
    from deep_vision_tpu_torch.ops import _build

    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for label, text in texts.items():
        src = os.path.join(out_dir, f"{kernel}-{label}.cu")
        with open(src, "w") as f:
            f.write(text)
        procs[label] = subprocess.Popen(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", src[:-3] + ".so",
             src], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)
    libs = {}
    for label, proc in procs.items():
        log, _ = proc.communicate()
        cs.check(proc.returncode == 0, f"nvcc failed on {label}:\n{log}")
        libs[label] = bind(kernel, ctypes.CDLL(
            os.path.join(out_dir, f"{kernel}-{label}.so")))
    return libs


def iou_call(lib: ctypes.CDLL):
    import torch

    def call(inputs):
        pred, gt, mask = inputs
        b, n, _ = pred.shape
        out = torch.empty((b, n), device=pred.device)
        err = lib.dvt_best_iou_max(
            pred.data_ptr(), gt.data_ptr(), mask.data_ptr(), out.data_ptr(),
            b, n, gt.shape[1], torch.cuda.current_stream().cuda_stream)
        cs.check(err == 0, f"best_iou_max launch failed ({err})")
        return out
    return call


def iou_cases():
    """(name, timed input sets, the sets to check, plain, same, call)
    per case; ``call(lib)`` is the variant's function of one input set."""
    import torch

    from deep_vision_tpu_torch.ops.best_iou import best_iou_max_plain

    gen = torch.Generator(device="cuda").manual_seed(3)
    for shape, name, unmasked, near_tie in cs.IOU_CASES + [
            (shape, "run_share", 0.02, False) for shape in cs.IOU_SHAPES[1:]]:
        b, n, m = shape
        n_sets = max(2, min(16, math.ceil(100e6 / (b * (n + m) * 20))))
        sets = [cs.iou_inputs(shape, gen, edge=(k == 0), unmasked=unmasked,
                              near_tie=near_tie) for k in range(n_sets + 1)]
        yield (f"{shape} {name} {unmasked}", sets[1:], sets[:2],
               lambda p: best_iou_max_plain(*p),
               lambda got, want: cs.iou_differing(got, want) == 0, iou_call)


def ingest_call(quantize: bool):
    import torch

    from deep_vision_tpu_torch.ops.ingest import ingest_norm_constants

    mean, std = ingest_norm_constants("imagenet", 3)
    mean_c = (ctypes.c_float * 3)(*mean.tolist())
    std_c = (ctypes.c_float * 3)(*std.tolist())
    scale = cs.act_scale_for("imagenet", 3)

    def make(lib: ctypes.CDLL):
        def call(x):
            out = torch.empty(x.shape, device=x.device, dtype=torch.int8
                              if quantize else torch.float32)
            err = lib.dvt_serve_ingest(
                x.data_ptr(), out.data_ptr(), x.numel(), 3,
                ctypes.cast(mean_c, ctypes.c_void_p),
                ctypes.cast(std_c, ctypes.c_void_p), scale, int(quantize),
                1, torch.cuda.current_stream().cuda_stream)
            cs.check(err == 0, f"serve_ingest launch failed ({err})")
            return out
        return call
    return make


def ingest_cases():
    import torch

    from deep_vision_tpu_torch.ops.ingest import serve_ingest_plain

    gen = torch.Generator(device="cuda").manual_seed(4)
    scale = cs.act_scale_for("imagenet", 3)
    for b, quantize in ((32, True), (8, True), (1, True), (32, False)):
        shape = (b, 224, 224, 3)
        n_bufs = max(2, min(64, math.ceil(100e6 / math.prod(shape))))
        xs = [torch.randint(0, 256, shape, dtype=torch.uint8, device="cuda",
                            generator=gen) for _ in range(n_bufs)]
        yield (f"{shape} {'int8' if quantize else 'float32'}", xs, xs[:1],
               lambda x, q=quantize: serve_ingest_plain(x, "imagenet",
                                                        scale, q),
               lambda got, want: torch.equal(got, want)
               if got.dtype == torch.int8
               else float((got - want).abs().max()) <= 1e-6,
               ingest_call(quantize))


def main(args: list[str]) -> int:
    import torch

    cs.check(len(args) >= 2 and args[0] in ("best_iou_max", "serve_ingest")
             and torch.cuda.is_available(),
             "usage on a GPU: kernel_ab.py best_iou_max|serve_ingest "
             "LABEL=PATH[@NAME=VALUE,...] ...")
    from deep_vision_tpu_torch.core.device import configure_precision
    from deep_vision_tpu_torch.ops import _build

    configure_precision()
    kernel, specs = args[0], args[1:]
    libs = build(kernel, sources(specs), os.path.join(_build.BUILD_DIR, "ab"))
    cases = iou_cases() if kernel == "best_iou_max" else ingest_cases()
    rows = []
    for name, timed, checked, plain, same, make in cases:
        call = {label: make(lib) for label, lib in libs.items()}
        for inputs in checked:
            want = plain(inputs)
            for label in libs:
                cs.check(same(call[label](inputs), want),
                         f"{label} differs from plain at {name}")
        times = {label: [] for label in libs}
        for label in list(libs) + list(libs)[::-1]:
            times[label].append(cs.device_ms(call[label], timed) * 1e3)
        rows.append({"case": name, "us": times})
        print(json.dumps(rows[-1]), flush=True)
        del timed, checked
    print(json.dumps({"ab": {"kernel": kernel, "variants": specs,
                             "cases": rows}}), flush=True)
    print(cs.card(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
