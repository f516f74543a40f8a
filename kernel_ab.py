#!/usr/bin/env python3
"""Time variants of one kernel's CUDA source against each other on one
NVIDIA GPU.

    python3 kernel_ab.py KERNEL LABEL=PATH[@NAME=VALUE,...] ...

``KERNEL`` is ``best_iou_max``, ``serve_ingest`` or ``train_ingest``.
Each ``PATH`` is a source of ``deep_vision_tpu_torch/csrc/KERNEL.cu``
(for example the parent commit's file, unpacked with ``git archive``
into a directory that ``.gitignore`` lists), bound by its own C
signature, so sources whose ``dvt_KERNEL`` takes other parameters run
side by side; each ``NAME=VALUE`` sets its ``constexpr int NAME``
(``best_iou_max.cu@kDivideOnce=0`` is the design without the single
division).
The variants are built in parallel with the package's nvcc flags, held
against the plain version on the first input sets of every case
(``best_iou_max`` bit for bit, a NaN matching any NaN, on the edge set
and a timed set; ``serve_ingest`` int8 equal, float32 within 1e-6;
``train_ingest`` bit for bit on two sets), and timed with
``chip_smoke.device_ms`` in turns (every variant, then every variant in
reverse): ``best_iou_max`` at the yolov3_coco loss shapes and shares of
``chip_smoke.py`` and at the YOLOv3 run's share at every scale,
``serve_ingest`` at the int8 serving buckets 1, 8, 32 and float32 at 32,
``train_ingest`` at ``chip_smoke.py``'s ``TRAIN_SHAPES`` and
``ZOO_TRAIN_SHAPES``.  One JSON line a case, then ``{"ab": ...}`` and the
card's name and power limit.
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


#: the C parameter types of the kernels' interfaces, const and spaces
#: dropped
CTYPES = {"int": ctypes.c_int, "longlong": ctypes.c_longlong,
          "unsignedlonglong": ctypes.c_ulonglong, "float": ctypes.c_float}


def signature(kernel: str, text: str) -> list[tuple[str, type]]:
    """``dvt_KERNEL``'s parameters in the source ``text``: (name, ctypes
    type) in order, a pointer as ``c_void_p``."""
    found = re.search(rf"\bint dvt_{kernel}\(([^)]*)\)", text)
    cs.check(found is not None, f"no 'int dvt_{kernel}(' in the source")
    params = []
    for decl in found.group(1).split(","):
        name = re.search(r"(\w+)\s*$", decl).group(1)
        kind = re.sub(r"const|\s", "", decl[:decl.rindex(name)])
        cs.check("*" in kind or kind in CTYPES,
                 f"dvt_{kernel}: unknown parameter type in '{decl.strip()}'")
        params.append((name, ctypes.c_void_p if "*" in kind
                       else CTYPES[kind]))
    return params


def bind(kernel: str, lib: ctypes.CDLL, text: str) -> ctypes.CDLL:
    """Set ``dvt_KERNEL``'s argument types from its source's signature;
    the parameters' names go to ``lib.params``."""
    params = signature(kernel, text)
    fn = getattr(lib, f"dvt_{kernel}")
    fn.argtypes = [t for _, t in params]
    fn.restype = ctypes.c_int
    lib.params = [n for n, _ in params]
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
            os.path.join(out_dir, f"{kernel}-{label}.so")), texts[label])
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


def train_call(lib: ctypes.CDLL):
    """The variant's ``train_ingest`` on an (x, factors) pair, its
    arguments passed by the names of its own C parameters."""
    import torch

    from deep_vision_tpu_torch.ops.ingest import ingest_norm_constants
    from deep_vision_tpu_torch.ops.train_ingest import (
        division_magic,
        tiled_path,
    )

    mean, std = ingest_norm_constants("imagenet", 3)
    mean_c = (ctypes.c_float * 3)(*mean.tolist())
    std_c = (ctypes.c_float * 3)(*std.tolist())

    def call(inputs):
        x, factors = inputs
        out = torch.empty(x.shape, device=x.device, dtype=torch.float32)
        b, pixels = x.shape[0], x.shape[1] * x.shape[2]
        magic, shift = division_magic(pixels, b * pixels)
        aligned = x.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0
        values = {
            "x": x.data_ptr(), "factors": factors.data_ptr(),
            "out": out.data_ptr(), "batch": b, "pixels": pixels,
            "mean": ctypes.cast(mean_c, ctypes.c_void_p),
            "stdv": ctypes.cast(std_c, ctypes.c_void_p),
            # the per-image design's 16-byte path: whole images of
            # 16-byte multiples
            "vectorized": int(aligned and pixels * 3 % 16 == 0),
            "tiled": int(tiled_path(x.data_ptr(), out.data_ptr(), pixels)),
            "magic": magic, "shift": shift,
            "stream": torch.cuda.current_stream().cuda_stream}
        err = lib.dvt_train_ingest(*(values[n] for n in lib.params))
        cs.check(err == 0, f"train_ingest launch failed ({err})")
        return out
    return call


def train_cases():
    import torch

    from deep_vision_tpu_torch.ops.train_ingest import (
        train_ingest_factors,
        train_ingest_plain,
    )

    gen = torch.Generator(device="cuda").manual_seed(5)
    for shape in cs.TRAIN_SHAPES + cs.ZOO_TRAIN_SHAPES:
        n_sets = max(2, min(128, math.ceil(100e6 / (5 * math.prod(shape)))))
        sets = []
        for _ in range(n_sets):
            x = torch.randint(0, 256, shape, dtype=torch.uint8,
                              device="cuda", generator=gen)
            sets.append((x, train_ingest_factors(x, gen)))
        yield (f"{shape}", sets, sets[:2],
               lambda p: train_ingest_plain(*p), torch.equal, train_call)


def main(args: list[str]) -> int:
    import torch

    cases = {"best_iou_max": iou_cases, "serve_ingest": ingest_cases,
             "train_ingest": train_cases}
    cs.check(len(args) >= 2 and args[0] in cases
             and torch.cuda.is_available(),
             "usage on a GPU: kernel_ab.py best_iou_max|serve_ingest|"
             "train_ingest LABEL=PATH[@NAME=VALUE,...] ...")
    from deep_vision_tpu_torch.core.device import configure_precision
    from deep_vision_tpu_torch.ops import _build

    configure_precision()
    kernel, specs = args[0], args[1:]
    libs = build(kernel, sources(specs), os.path.join(_build.BUILD_DIR, "ab"))
    rows = []
    for name, timed, checked, plain, same, make in cases[kernel]():
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
