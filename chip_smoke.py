#!/usr/bin/env python3
"""Drive the PyTorch port (deep_vision_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which must pass:

1. build    — compile every CUDA source of the port (one nvcc each, in
              parallel) and print the seconds it took;
2. kernels  — hold ``serve_ingest`` against its plain PyTorch version on
              the card at the ResNet-50 bucket shapes (B, 224, 224, 3)
              for B in {1, 8, 32}, at (3, 17, 23, 3) and at
              (4, 32, 32, 1) mnist, int8 and float32 outputs: int8 must
              be bit-identical, float32 within 1e-6 (both divide with
              IEEE rounding; the tolerance only covers a compiler
              contracting differently).  Device times come from CUDA
              events around replays of a CUDA graph of one call per
              input buffer (the buffers together exceed the 50 MB L2),
              so host overhead drops out; the eager per-call time of the
              wrapper is printed beside them;
3. serving  — boot ``cli/serve.py``'s server for ``resnet50`` at full
              width (224×224×3, 1000 classes), ``--wire-dtype uint8
              --infer-dtype int8 --warmup``, with seeded weights (non-zero
              BatchNorm scales) loaded through ``--weights``; POST 32
              ``/v1/classify`` requests, most of them concurrent, with
              the kernel's launch count set to 0 just before and read
              just after; every answer must be 200 with a top-5 that
              matches a direct call of the same model with the PLAIN
              ingest within the bf16 bound (3e-2·max|ref|), and top-1
              equal on every row whose direct top-1 margin exceeds that
              bound (most rows must: the seeded noise images are screened
              by the direct call for such a margin, since random weights
              leave most of them nearly tied); the same answers held
              against an ingest without the ImageNet mean/std must fail
              that check.
              Then the eager forward time of every bucket on the card,
              and one float32-infer request (the serve_normalize path);
4. train kernel — hold ``train_ingest`` against its plain PyTorch
              version on the card at (B, 224, 224, 3) for B in
              {256, 32, 1} and at (3, 17, 23, 3), with seeded factors:
              the outputs must be bit-identical.  Kernel device, eager
              call, plain, library and bound times as for serve_ingest;
5. training — write seeded raw-payload dvrec shards (train 1024, val
              256 images, stored at 256×256×3, labels from 1000 classes)
              and call ``cli/train.py``'s ``main`` in process for
              ``resnet50`` at full width (224×224×3, 1000 classes, bf16,
              batch 256) for 2 epochs, then again with ``--resume
              --epochs 3``.  ``train_ingest`` must launch once per train
              step, every logged loss be finite, ``bad_steps`` stay 0, a
              checkpoint exist per epoch, and the resumed run start at
              epoch 3, step 8, with the saved checkpoint's parameters,
              buffers and momentum.  Prints the steady-state step ms (CUDA
              events), img/s, peak device memory and final top-1/top-5;
6. step check — one float32 train step (TF32 off) of full-width
              ResNet-50 on 8 seeded images with the same weights and
              factors, on the card (through the kernel) and on the CPU
              (through the plain version), from seeded weights whose last
              BN scale in every block is 1e-2 (at the trainer's zero a
              residual branch gets no gradient), so that every branch's
              update must be mostly gradient; the loss within 1e-4
              relative, the parameters' updates within 1e-3 and the
              running statistics' within 1e-4 in L2, and each tensor's
              within 5e-2 in L2 (``compare_steps`` says why); the same
              comparison with two images' factors swapped on the card's
              side must fail;
7. card     — print ``nvidia-smi --query-gpu=name,power.limit``.

Before the last line it prints ``{"kernels": [...]}`` (one entry per
ported kernel: launches on its own path, max error, kernel / plain /
library times at the path's main shape, and the bound), and last
``{"ok": true, "device": {...}}``.  Any failure exits non-zero with no
result line; so does a machine without CUDA or a directory without the
package.
"""

from __future__ import annotations

import concurrent.futures
import json
import math
import os
import subprocess
import sys
import tempfile
import time
import urllib.request

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
#: published H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s and
#: float32 (non-tensor-core) operations/s
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
#: float32 operations per element of the ingest: /255, −mean, /std,
#: /act_scale, round, clamp (two compares)
INGEST_OPS = {True: 7, False: 3}
#: float32 operations per element of train_ingest: /255, ·fb, −m, ·fc,
#: +m, the gray (5 per pixel, 5/3 per element), −gray, ·fs, +gray, clamp
#: (two compares), −mean, /std
TRAIN_INGEST_OPS = 13 + 5 / 3
TRAIN_SHAPES = [(256, 224, 224, 3), (32, 224, 224, 3), (1, 224, 224, 3),
                (3, 17, 23, 3)]
N_TRAIN, N_VAL, STORED, BATCH = 1024, 256, 256, 256
EPOCHS, RESUME_EPOCHS, WORKERS = 2, 3, 4
STEP_CHECK_BATCH = 8
#: the step check's last BN scale of every block: at the trainer's zero no
#: gradient reaches a residual branch, and with every scale near 1 a 1e-7
#: change of the weights moves the update by up to 10% (ReLU gates flip)
STEP_CHECK_LAST_SCALE = 1e-2
BF16_BOUND = 3e-2
MODEL = "resnet50"
BUCKETS = (1, 2, 4, 8, 16, 32)
N_SEQ, N_CONC = 8, 24


def log(msg: str) -> None:
    print(f"[chip_smoke] {msg}", flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SystemExit(f"[chip_smoke] FAIL: {msg}")


def act_scale_for(kind: str, channels: int) -> float:
    """The ingest scale the port's calibration prices for ``kind`` on
    uniform uint8 data: absmax of the normalized 0..255 range / 127."""
    import torch

    from deep_vision_tpu_torch.ops.preprocess import serve_normalize

    x = torch.arange(256, dtype=torch.uint8).repeat_interleave(
        channels).view(1, 1, 256, channels)
    return float(serve_normalize(x, kind).abs().max()) / 127.0


def call_ms(fn, inputs, iters: int = 200, warmup: int = 10) -> float:
    """Mean milliseconds per EAGER call (CUDA events around back-to-back
    calls, cycling ``inputs``): includes the host's launch overhead
    whenever the host launches slower than the device runs."""
    import torch

    for i in range(warmup):
        fn(inputs[i % len(inputs)])
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for i in range(iters):
        fn(inputs[i % len(inputs)])
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, inputs, reps: int = 20) -> float:
    """Mean DEVICE milliseconds per call: one call per input captured in
    a CUDA graph, the graph replayed ``reps`` times between two events,
    so host overhead and launch gaps drop out."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm up off the capture
        for x in inputs[:3]:
            fn(x)
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for x in inputs:
            fn(x)
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / (reps * len(inputs))
    del graph
    return ms


def phase_build() -> float:
    from deep_vision_tpu_torch.ops import _build

    t0 = time.monotonic()
    names = _build.build_all()
    secs = time.monotonic() - t0
    log(f"build: {names} in {secs:.2f} s")
    return secs


def phase_kernels() -> list[dict]:
    """serve_ingest vs its plain version at the serving shapes."""
    import torch

    from deep_vision_tpu_torch.ops.ingest import (
        ingest_norm_constants,
        serve_ingest,
        serve_ingest_plain,
    )

    gen = torch.Generator(device="cuda").manual_seed(0)
    cases = [("imagenet", (b, 224, 224, 3)) for b in (1, 8, 32)] + [
        ("imagenet", (3, 17, 23, 3)), ("mnist", (4, 32, 32, 1))]
    rows = []
    for kind, shape in cases:
        scale = act_scale_for(kind, shape[-1])
        mean, std = ingest_norm_constants(kind, shape[-1])
        mean_t = torch.tensor(mean, device="cuda")
        std_t = torch.tensor(std, device="cuda")
        numel = math.prod(shape)
        n_bufs = max(2, min(64, math.ceil(100e6 / numel)))
        xs = [torch.randint(0, 256, shape, dtype=torch.uint8, device="cuda",
                            generator=gen) for _ in range(n_bufs)]
        for quantize in (True, False):
            got = serve_ingest(xs[0], kind, scale, quantize)
            want = serve_ingest_plain(xs[0], kind, scale, quantize)
            torch.cuda.synchronize()
            err = float((got.float() - want.float()).abs().max())
            if quantize:
                check(torch.equal(got, want),
                      f"serve_ingest int8 differs from plain at {shape} "
                      f"{kind}: max err {err}")
            else:
                check(err <= 1e-6, f"serve_ingest f32 differs from plain "
                                   f"at {shape} {kind}: {err}")

            def library(x, q=quantize):
                y = (x.float() / 255 - mean_t) / std_t
                return (y / scale).round().clamp(-127, 127).to(torch.int8) \
                    if q else y

            out_bytes = numel * (1 if quantize else 4)
            bound_bytes = (numel + out_bytes) / HBM_BYTES_PER_S * 1e3
            bound_ops = numel * INGEST_OPS[quantize] / F32_OPS_PER_S * 1e3

            def kernel(x, q=quantize):
                return serve_ingest(x, kind, scale, q)

            def plain(x, q=quantize):
                return serve_ingest_plain(x, kind, scale, q)

            row = {"kind": kind, "shape": list(shape),
                   "out": "int8" if quantize else "float32",
                   "max_abs_err": err,
                   "ms": device_ms(kernel, xs),
                   "call_ms": call_ms(kernel, xs),
                   "plain_ms": device_ms(plain, xs),
                   "library_ms": device_ms(library, xs),
                   "bound_ms": max(bound_bytes, bound_ops),
                   "bound_by": "bytes" if bound_bytes >= bound_ops
                   else "operations"}
            rows.append(row)
            log(f"serve_ingest {kind} {shape} {row['out']}: device "
                f"{row['ms'] * 1e3:.2f} us (eager call "
                f"{row['call_ms'] * 1e3:.2f}, plain "
                f"{row['plain_ms'] * 1e3:.2f}, library "
                f"{row['library_ms'] * 1e3:.2f}, bound "
                f"{row['bound_ms'] * 1e3:.2f} us), max err {err}")
    empty = torch.empty((0, 224, 224, 3), dtype=torch.uint8, device="cuda")
    before = serve_ingest.launches
    out = serve_ingest(empty, "imagenet", 1.0)
    check(out.shape == empty.shape and out.dtype == torch.int8
          and serve_ingest.launches == before,
          "an empty batch must return an empty int8 batch and launch nothing")
    log(f"kernel launches while checking: {serve_ingest.launches}")
    return rows


def seeded_weights(path: str, seed: int = 0) -> None:
    """ResNet-50 weights in the reference's flax layout, written as the
    ``--weights`` npz a user would pass: He/LeCun init from the seed,
    then NON-ZERO BatchNorm scales (the reference init zeroes the last
    one of each block, which would hide the residual branches) and
    positive running variances."""
    import torch

    from deep_vision_tpu_torch import convert
    from deep_vision_tpu_torch.models.common import BatchNorm2d
    from deep_vision_tpu_torch.models.resnet import ResNet50

    gen = torch.Generator().manual_seed(seed)
    model = ResNet50().reset_parameters(gen)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, BatchNorm2d):
                m.weight.uniform_(0.5, 1.0, generator=gen)
                m.bias.normal_(0.0, 0.1, generator=gen)
                m.running_mean.normal_(0.0, 0.1, generator=gen)
                m.running_var.uniform_(0.5, 1.5, generator=gen)
        model.fc.bias.normal_(0.0, 0.1, generator=gen)
    convert.save_npz(path, convert.import_torch_resnet(model.state_dict(),
                                                        MODEL))


def post(port: int, body: bytes) -> tuple[int, dict, float]:
    """POST one pre-encoded JSON body (encoding stays out of the clock)."""
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/v1/classify", data=body,
        headers={"Content-Type": "application/json"})
    t0 = time.monotonic()
    with urllib.request.urlopen(req, timeout=300) as r:
        return r.status, json.loads(r.read()), time.monotonic() - t0


def boot(weights: str, infer_dtype: str, buckets, warmup: bool):
    from deep_vision_tpu_torch.cli import serve as cli

    argv = ["-m", MODEL, "--weights", weights, "--wire-dtype", "uint8",
            "--infer-dtype", infer_dtype, "--port", "0",
            "--max-batch", str(max(buckets)),
            "--buckets", ",".join(map(str, buckets)), "--device", "cuda"]
    engine, server = cli.build_server(cli.build_parser().parse_args(
        argv + (["--warmup"] if warmup else [])))
    server.start_background()
    return engine, server


def direct_logits(sm, images: np.ndarray, kind: str | None = None
                  ) -> np.ndarray:
    """The served model called directly, with the PLAIN ingest of
    ``kind`` (by default the model's own preprocess kind)."""
    import torch

    from deep_vision_tpu_torch.ops.ingest import serve_ingest_plain
    from deep_vision_tpu_torch.ops.preprocess import serve_normalize

    kind = kind or sm.preprocess_kind
    x = torch.from_numpy(images).to(sm.device)
    with torch.inference_mode():
        if sm.infer_dtype == "int8":
            s = float(sm.quant.act_scale)
            xf = serve_ingest_plain(x, kind, s).float() * s
        else:
            xf = serve_normalize(x, kind)
        out = sm._model(xf).float().cpu().numpy()
    return out


def decided_images(sm, n: int) -> tuple[np.ndarray, int]:
    """The first ``n`` of 1024 seeded uint8 noise images whose top-1
    the direct plain-ingest call decides: its top-1 margin (top logit
    minus the runner-up) exceeds the bf16 bound.  With random weights
    most noise images put their top two logits a few bf16 steps apart,
    where a served batch's rounding may swap them.  Screened by the
    direct call only, never by the served path; returns the images and
    the number screened."""
    pool = 1024
    rng = np.random.RandomState(1)
    cands = rng.randint(0, 256, (pool, *sm.input_shape), np.uint8)
    ref = np.concatenate([direct_logits(sm, cands[i:i + 64])
                          for i in range(0, pool, 64)])
    top2 = np.sort(ref, axis=-1)[:, -2:]
    keep = np.flatnonzero(top2[:, 1] - top2[:, 0]
                          > BF16_BOUND * float(np.abs(ref).max()))
    check(len(keep) >= n, f"only {len(keep)} of {pool} images have a "
                          f"top-1 margin above the bf16 bound")
    return cands[keep[:n]], int(keep[n - 1]) + 1


def bucket_forward_ms(sm, buckets, iters: int = 10) -> dict:
    """Eager per-bucket forward time (ingest kernel + ResNet + float32
    logits) from CUDA events, on random uint8 input already on the
    card: the device side of one batch without HTTP or staging."""
    import torch

    out = {}
    for b in buckets:
        fn = sm.compile_bucket(b)
        x = torch.randint(0, 256, (b, *sm.input_shape), dtype=torch.uint8,
                          device=sm.device)
        out[str(b)] = call_ms(fn, [x], iters=iters, warmup=2)
    return out


def compare_answers(replies, ref: np.ndarray) -> dict:
    """Hold served top-5 answers against direct logits ``ref``.

    Every served logit must lie within the bf16 bound of the direct
    call's logit for the same class.  Top-1 must be equal on the rows
    whose direct top-1 margin (top logit minus the runner-up) exceeds
    that bound: below it, bf16 rounding that differs with the batch a
    request landed in may legitimately swap two nearly tied classes.
    Returns the numbers and a list of faults (empty when all hold)."""
    bound = BF16_BOUND * float(np.abs(ref).max())
    top2 = np.sort(ref[:len(replies)], axis=-1)[:, -2:]
    margins = top2[:, 1] - top2[:, 0]
    faults, worst, decisive = [], 0.0, 0
    for i, (status, body, _) in enumerate(replies):
        if status != 200:
            faults.append(f"request {i}: HTTP {status} {body}")
            continue
        top = body["top"]
        if len(top) != 5:
            faults.append(f"request {i}: {len(top)} classes, not 5")
            continue
        logits = np.array([t["logit"] for t in top])
        if not np.isfinite(logits).all():
            faults.append(f"request {i}: non-finite logits")
            continue
        classes = [t["class"] for t in top]
        err = float(np.abs(logits - ref[i][classes]).max())
        worst = max(worst, err)
        if err > bound:
            faults.append(f"request {i}: logit err {err} > bound {bound}")
        if margins[i] > bound:
            decisive += 1
            if classes[0] != int(ref[i].argmax()):
                faults.append(f"request {i}: top-1 {classes[0]} != direct "
                              f"{int(ref[i].argmax())} (margin "
                              f"{float(margins[i])})")
    return {"max_abs_err": worst, "bound": bound,
            "top1_decisive_rows": decisive, "rows": len(replies),
            "min_top1_margin": float(margins.min()),
            "median_top1_margin": float(np.median(margins)),
            "faults": faults}


def phase_serving() -> dict:
    """Serve ResNet-50 int8 over HTTP on the card and check the answers
    (8 sequential requests, then 24 concurrent); returns the numbers."""
    from deep_vision_tpu_torch.ops.ingest import serve_ingest

    os.makedirs(os.path.join(REPO, "_scratch"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(REPO, "_scratch")) \
            as tmp:
        weights = os.path.join(tmp, "weights.npz")
        seeded_weights(weights)
        t0 = time.monotonic()
        engine, server = boot(weights, "int8", BUCKETS, True)
        log(f"serving {MODEL} int8: boot + warmup "
            f"{time.monotonic() - t0:.1f} s, buckets {engine.buckets}")
        sm = engine.model
        imgs, screened = decided_images(sm, N_SEQ + N_CONC)
        log(f"{len(imgs)} images with a decided top-1 among the first "
            f"{screened} seeded noise images")
        bodies = [json.dumps({"pixels": im.tolist(), "top_k": 5}).encode()
                  for im in imgs]
        try:
            serve_ingest.launches = 0
            replies = [post(server.port, b) for b in bodies[:N_SEQ]]
            t1 = time.monotonic()
            with concurrent.futures.ThreadPoolExecutor(N_CONC) as pool:
                replies += list(pool.map(lambda b: post(server.port, b),
                                         bodies[N_SEQ:]))
            conc_s = time.monotonic() - t1
            launches = serve_ingest.launches
            stats = engine.stats()
        finally:
            server.shutdown()
            engine.stop(drain_deadline=10.0)
        check(launches > 0, "serve_ingest was never launched while serving")
        forward_ms = bucket_forward_ms(sm, BUCKETS)
        agree = compare_answers(replies, direct_logits(sm, imgs))
        log(f"int8 answers vs direct plain-ingest call: {json.dumps(agree)}")
        check(not agree["faults"], f"int8 answers: {agree['faults']}")
        check(2 * agree["top1_decisive_rows"] > len(replies),
              f"top-1 decides only {agree['top1_decisive_rows']} of "
              f"{len(replies)} rows (margin above the bound)")
        # the gate has power: the same answers held against a direct call
        # whose ingest skips the ImageNet mean/std must fail it
        wrong = compare_answers(replies, direct_logits(sm, imgs, "unit"))
        log(f"control, answers vs an ingest without mean/std: "
            f"{len(wrong['faults'])} faults, max logit err "
            f"{wrong['max_abs_err']}")
        check(bool(wrong["faults"]),
              "the answer check passed against a wrong ingest")
        lat = sorted(r[2] for r in replies)
        out = {"launches": launches, "requests": len(replies),
               "batches": stats["batches"],
               "compiled_buckets": stats["compiled_buckets"],
               "client_p50_ms": lat[len(lat) // 2] * 1e3,
               "concurrent_img_per_s": N_CONC / conc_s,
               "engine_latency_ms": stats["latency"],
               "engine_exec_ewma_ms": stats["admission"][
                   "exec_ewma_ms_by_bucket"],
               "device_idle_frac_host_proxy": stats["pipeline"][
                   "device_idle_frac"],
               "forward_ms_by_bucket": forward_ms,
               "logit_max_abs_err": agree["max_abs_err"],
               "logit_bound": agree["bound"],
               "top1_decisive_rows": agree["top1_decisive_rows"],
               "images_screened": screened,
               "min_top1_margin": agree["min_top1_margin"],
               "control_faults": len(wrong["faults"])}
        check(stats["batches"] < len(replies),
              "concurrent requests were never batched together")
        log(f"int8 serving: {json.dumps(out)}")
        del sm, engine, server
        # the serve_normalize path: one float32-infer request
        engine, server = boot(weights, "float32", (1,), False)
        try:
            f32 = [post(server.port, bodies[0])]
        finally:
            server.shutdown()
            engine.stop(drain_deadline=10.0)
        out["float32_infer"] = compare_answers(
            f32, direct_logits(engine.model, imgs[:1]))
        log(f"float32-infer request: {json.dumps(out['float32_infer'])}")
        check(not out["float32_infer"]["faults"],
              f"float32 answers: {out['float32_infer']['faults']}")
    return out

def phase_train_kernels() -> list[dict]:
    """train_ingest vs its plain version at the training shapes."""
    import torch

    from deep_vision_tpu_torch.ops.ingest import ingest_norm_constants
    from deep_vision_tpu_torch.ops.train_ingest import (
        GRAY,
        train_ingest,
        train_ingest_factors,
        train_ingest_plain,
    )

    gen = torch.Generator(device="cuda").manual_seed(1)
    mean, std = ingest_norm_constants("imagenet", 3)
    shift = torch.tensor(-mean / std, device="cuda")
    inv_std = torch.tensor(1.0 / std, device="cuda")
    gray_col = torch.tensor(GRAY, device="cuda").view(3, 1)

    def library(p):
        """Fewest-ops PyTorch expression of the same function."""
        x, f = p
        fb, fc, fs, m = f.t().reshape(4, -1, 1, 1, 1).unbind(0)
        y = torch.addcmul(m * (1 - fc), x.float(), fb * fc / 255)
        y = torch.lerp(y @ gray_col, y, fs).clamp_(0, 1)
        return torch.addcmul(shift, y, inv_std)

    def kernel(p):
        return train_ingest(*p)

    def plain(p):
        return train_ingest_plain(*p)

    rows = []
    for shape in TRAIN_SHAPES:
        numel = math.prod(shape)
        n_bufs = max(2, min(128, math.ceil(100e6 / (5 * numel))))
        pairs = []
        for _ in range(n_bufs):
            x = torch.randint(0, 256, shape, dtype=torch.uint8,
                              device="cuda", generator=gen)
            pairs.append((x, train_ingest_factors(x, gen)))
        got, want = kernel(pairs[0]), plain(pairs[0])
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        check(torch.equal(got, want),
              f"train_ingest differs from plain at {shape}: max err {err}")
        lib_err = float((library(pairs[0]) - want).abs().max())
        check(lib_err < 1e-4, f"the library expression is not the same "
                              f"function at {shape}: {lib_err}")
        bytes_moved = numel + 16 * shape[0] + 4 * numel
        bound_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
        bound_ops = numel * TRAIN_INGEST_OPS / F32_OPS_PER_S * 1e3
        row = {"shape": list(shape), "max_abs_err": err,
               "ms": device_ms(kernel, pairs),
               "call_ms": call_ms(kernel, pairs),
               "plain_ms": device_ms(plain, pairs),
               "library_ms": device_ms(library, pairs),
               "library_max_abs_err": lib_err,
               "bound_ms": max(bound_bytes, bound_ops),
               "bound_by": "bytes" if bound_bytes >= bound_ops
               else "operations"}
        rows.append(row)
        log(f"train_ingest {shape}: device {row['ms'] * 1e3:.2f} us "
            f"(eager call {row['call_ms'] * 1e3:.2f}, plain "
            f"{row['plain_ms'] * 1e3:.2f}, library "
            f"{row['library_ms'] * 1e3:.2f}, bound "
            f"{row['bound_ms'] * 1e3:.2f} us), max err {err}")
        del pairs
    empty = torch.empty((0, 224, 224, 3), dtype=torch.uint8, device="cuda")
    before = train_ingest.launches
    out = train_ingest(empty, torch.empty((0, 4), device="cuda"))
    check(out.shape == empty.shape and train_ingest.launches == before,
          "an empty batch must return an empty batch and launch nothing")
    return rows


def write_records(root: str) -> None:
    """Seeded raw-payload dvrec shards (``prepare_data --store raw``),
    stored at the loader's resize so no resize is needed."""
    from deep_vision_tpu_torch.data.records import RecordWriter, shard_name

    rng = np.random.default_rng(3)
    for split, n, shards in (("train", N_TRAIN, 4), ("val", N_VAL, 1)):
        labels = rng.integers(0, 1000, n)
        for i in range(shards):
            with RecordWriter(shard_name(root, split, i, shards)) as w:
                for j in range(i, n, shards):
                    img = rng.integers(0, 256, (STORED, STORED, 3),
                                       dtype=np.uint8)
                    w.write({"label": int(labels[j]), "enc": "raw",
                             "shape": [STORED, STORED, 3]}, img.tobytes())


def state_digest(model_sd: dict, momentum: dict) -> str:
    """One hash over parameters, buffers and momentum."""
    import hashlib

    import torch

    h = hashlib.blake2b(digest_size=8)
    for part in (model_sd, momentum):
        for key in sorted(part):
            a = part[key].detach().cpu().contiguous()
            h.update(key.encode())
            h.update(a.reshape(-1).view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def phase_training() -> dict:
    """cli.train end to end for resnet50 at full width on the card."""
    import torch

    from deep_vision_tpu_torch.cli import train as cli
    from deep_vision_tpu_torch.core.checkpoint import Checkpointer
    from deep_vision_tpu_torch.core.trainer import Trainer
    from deep_vision_tpu_torch.ops.train_ingest import train_ingest

    os.makedirs(os.path.join(REPO, "_scratch"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(REPO, "_scratch")) \
            as tmp:
        data, work = os.path.join(tmp, "data"), os.path.join(tmp, "work")
        t0 = time.monotonic()
        write_records(data)
        log(f"training: wrote {N_TRAIN}+{N_VAL} raw records in "
            f"{time.monotonic() - t0:.1f} s")
        argv = ["-m", MODEL, "--data-format", "records", "--data-root", data,
                "--workdir", work, "--num-workers", str(WORKERS),
                "--device", "cuda"]
        steps = N_TRAIN // BATCH
        torch.cuda.reset_peak_memory_stats()
        train_ingest.launches = 0
        t0 = time.monotonic()
        check(cli.main(argv + ["--epochs", str(EPOCHS)]) == 0,
              "cli.train failed")
        first_s = time.monotonic() - t0
        first = train_ingest.launches
        check(first == EPOCHS * steps,
              f"train_ingest launched {first} times in {EPOCHS * steps} "
              f"train steps")
        ckpts = Checkpointer(os.path.join(work, "checkpoints"))
        check(ckpts.all_steps() == [steps * e for e in range(1, EPOCHS + 1)],
              f"checkpoints {ckpts.all_steps()}, not one per epoch")
        saved = ckpts.load(EPOCHS * steps)["state"]
        want_digest = state_digest(saved["model"],
                                   saved["optimizer"]["momentum"])
        resumed = {}
        original = Trainer.maybe_resume

        def spy(self, state):
            state = original(self, state)
            resumed.update(
                step=state.step, epoch=self.start_epoch,
                digest=state_digest(state.model.state_dict(),
                                    state.opt.state_dict()["momentum"]))
            return state

        Trainer.maybe_resume = spy
        try:
            t0 = time.monotonic()
            check(cli.main(argv + ["--resume", "--epochs",
                                   str(RESUME_EPOCHS)]) == 0,
                  "cli.train --resume failed")
            resume_s = time.monotonic() - t0
        finally:
            Trainer.maybe_resume = original
        launches = train_ingest.launches
        peak = torch.cuda.max_memory_allocated()
        check(launches - first == (RESUME_EPOCHS - EPOCHS) * steps,
              f"the resumed run launched train_ingest {launches - first} "
              f"times in {(RESUME_EPOCHS - EPOCHS) * steps} steps")
        check(resumed == {"step": EPOCHS * steps, "epoch": EPOCHS + 1,
                          "digest": want_digest},
              f"resume restored {resumed}, not step {EPOCHS * steps} "
              f"epoch {EPOCHS + 1} digest {want_digest}")
        check(ckpts.all_steps() == [steps * e
                                    for e in range(1, RESUME_EPOCHS + 1)],
              f"checkpoints after resume: {ckpts.all_steps()}")
        series: dict[str, list] = {}
        with open(os.path.join(work, "metrics.jsonl")) as f:
            for line in f:
                d = json.loads(line)
                series.setdefault(d["name"], []).append((d["step"],
                                                         d["value"]))
        losses = series.get("train_loss", [])
        check(bool(losses), "no train loss was logged")
        check(all(math.isfinite(v) for _, v in losses),
              f"non-finite train loss: {losses}")
        check(all(v == 0 for _, v in series["train_bad_steps"]),
              f"bad steps: {series['train_bad_steps']}")
        step_ms = [v for _, v in series["train_step_ms"]]
        out = {"train_ingest_launches": launches,
               "train_steps": RESUME_EPOCHS * steps,
               "first_run_s": first_s, "resumed_run_s": resume_s,
               "step_ms_by_epoch": step_ms,
               "img_per_s_by_epoch": [BATCH * 1e3 / v for v in step_ms],
               "peak_memory_bytes": peak,
               "losses": losses,
               "input_stall_frac": [v for _, v in
                                    series.get("input_stall_frac", [])],
               "final_val_top1": series["val_top1"][-1][1],
               "final_val_top5": series["val_top5"][-1][1],
               "checkpoints": ckpts.all_steps(),
               "resumed": resumed}
        log(f"training: {json.dumps(out)}")
    return out


def one_step(device: str, model_sd: dict, images, factors, workdir: str
             ) -> tuple[float, dict, dict]:
    """One float32 train step of full-width ResNet-50 on ``device``:
    (loss, state_dict before, state_dict after), both on the CPU."""
    import torch

    from deep_vision_tpu_torch.core.config import get_config
    from deep_vision_tpu_torch.core.trainer import Trainer
    from deep_vision_tpu_torch.models.resnet import ResNet50
    from deep_vision_tpu_torch.ops.train_ingest import train_ingest
    from deep_vision_tpu_torch.tasks.classification import (
        ClassificationTask,
    )

    cfg = get_config(MODEL)
    cfg.batch_size = STEP_CHECK_BATCH
    model = ResNet50(dtype=torch.float32)
    model.load_state_dict(model_sd)
    f = factors.to(device)

    def preprocess(batch, generator, train):
        return {**batch, "image": train_ingest(batch["image"], f)}

    trainer = Trainer(cfg, model, ClassificationTask(1000), workdir=workdir,
                      preprocess_fn=preprocess, device=device)
    state = trainer.state_for(model)
    before = {k: v.detach().cpu().clone()
              for k, v in model.state_dict().items()}
    batch = {"image": images, "label": np.arange(STEP_CHECK_BATCH,
                                                 dtype=np.int32) * 97}
    state, m = trainer.train_step(state, batch)
    after = {k: v.detach().cpu().clone()
             for k, v in state.model.state_dict().items()}
    check(int(m["bad_steps"]) == 0, f"the {device} step was skipped")
    return float(m["loss"]), before, after


def update_errors(got, want) -> dict:
    """One step's updates (running statistics included) against another's:
    per tensor, ``max`` = max|Δgot − Δwant| / max|Δwant| and ``l2`` =
    ‖Δgot − Δwant‖ / ‖Δwant‖; and ``params`` / ``stats``, one L2 ratio
    over all parameters and over all running statistics (apart, since the
    statistics' updates are the larger and would hide the parameters')."""
    (_, gb, ga), (_, wb, wa) = got, want
    out = {"max": {}, "l2": {}}
    sums = {"params": [0.0, 0.0], "stats": [0.0, 0.0]}
    for k in wa:
        if k.endswith("num_batches_tracked"):
            continue
        dw, dg = wa[k] - wb[k], ga[k] - gb[k]
        err, ref = float((dg - dw).norm()), float(dw.norm())
        out["max"][k] = float((dg - dw).abs().max()) / max(
            float(dw.abs().max()), 1e-30)
        out["l2"][k] = err / max(ref, 1e-30)
        part = sums["stats" if k.endswith(("running_mean", "running_var"))
                    else "params"]
        part[0] += err ** 2
        part[1] += ref ** 2
    for part, (num, den) in sums.items():
        out[part] = (num / max(den, 1e-30)) ** 0.5
    return out


def compare_steps(got, want) -> list[str]:
    """Faults of step ``got`` against step ``want``: the loss beyond 1e-4
    relative, the parameters' updates beyond 1e-3 or the running
    statistics' beyond 1e-4 in L2, or one tensor's update beyond 5e-2 in
    L2.  A ReLU gate near zero flips under rounding, so single elements
    may differ by much more: on the H100 host, moving the CPU's own
    weights by 1e-7 (relative; ``floor`` in the output) moved its
    parameters' update 1.1e-4 in L2, one tensor 1.3e-2 in L2 and one
    element 0.12·max|Δ| of its tensor, the running statistics 3.8e-7; the
    card against the CPU read 8.4e-5, 6.0e-3, 4.9e-2·max|Δ| and 4.1e-7;
    the swapped-factor control 0.36 on the parameters."""
    faults = []
    if abs(got[0] - want[0]) > 1e-4 * abs(want[0]):
        faults.append(f"loss {got[0]} vs {want[0]}")
    errs = update_errors(got, want)
    if errs["params"] > 1e-3:
        faults.append(f"parameter updates {errs['params']:.3e} in L2")
    if errs["stats"] > 1e-4:
        faults.append(f"running statistics {errs['stats']:.3e} in L2")
    faults += [f"{k}: {e:.3e} in L2" for k, e in errs["l2"].items()
               if e > 5e-2]
    return faults


def branch_grad_share(step, decay: float) -> float:
    """The least share of a residual branch conv's update that is not
    weight decay: min ‖Δ + decay·p‖ / ‖Δ‖ over the blocks' convs."""
    _, before, after = step
    return min(float((after[k] - before[k] + decay * before[k]).norm()
                     / (after[k] - before[k]).norm())
               for k in after if k.startswith("layer") and ".conv" in k)


def phase_step_check() -> dict:
    """float32 step on the card (kernel) vs on the CPU (plain version)."""
    import torch

    from deep_vision_tpu_torch.core.config import get_config
    from deep_vision_tpu_torch.models.resnet import ResNet50
    from deep_vision_tpu_torch.ops.train_ingest import train_ingest_factors

    model = ResNet50().reset_parameters(torch.Generator().manual_seed(5))
    for stage in model.stages():
        for block in stage:
            torch.nn.init.constant_(getattr(block, f"bn{block.convs}").weight,
                                    STEP_CHECK_LAST_SCALE)
    sd = model.state_dict()
    images = np.random.default_rng(4).integers(
        0, 256, (STEP_CHECK_BATCH, 224, 224, 3), dtype=np.uint8)
    factors = train_ingest_factors(torch.from_numpy(images),
                                   torch.Generator().manual_seed(6))
    swapped = factors.clone()
    swapped[[0, 1]] = factors[[1, 0]]
    # the CPU's own step from weights moved by 1e-7 (relative): how far
    # rounding alone moves an update (the floor under the bounds)
    gen = torch.Generator().manual_seed(9)
    moved = {k: v * (1 + 1e-7 * torch.randn(v.shape, generator=gen))
             if v.is_floating_point() else v for k, v in sd.items()}
    with tempfile.TemporaryDirectory(dir=os.path.join(REPO, "_scratch")) \
            as tmp:
        t0 = time.monotonic()
        cpu = one_step("cpu", sd, images, factors, os.path.join(tmp, "c"))
        cpu_s = time.monotonic() - t0
        floor = update_errors(one_step("cpu", moved, images, factors,
                                       os.path.join(tmp, "m")), cpu)
        gpu = one_step("cuda", sd, images, factors, os.path.join(tmp, "g"))
        control = one_step("cuda", sd, images, swapped,
                           os.path.join(tmp, "s"))
    opt = get_config(MODEL).optimizer
    share = branch_grad_share(cpu, opt.learning_rate * opt.weight_decay)
    faults = compare_steps(gpu, cpu)
    control_faults = compare_steps(control, cpu)
    errs = update_errors(gpu, cpu)
    out = {"loss_cuda": gpu[0], "loss_cpu": cpu[0],
           "branch_grad_share_min": share,
           "params_l2_update_err": errs["params"],
           "stats_l2_update_err": errs["stats"],
           "worst_tensor_l2_update_err": max(errs["l2"].values()),
           "worst_rel_elem_update_err": max(errs["max"].values()),
           "tensors_above_1e-2_elem": sorted(k for k, e in errs["max"].items()
                                             if e > 1e-2),
           "floor": {"params_l2": floor["params"],
                     "stats_l2": floor["stats"],
                     "worst_tensor_l2": max(floor["l2"].values()),
                     "worst_rel_elem": max(floor["max"].values())},
           "faults": faults, "control_faults": len(control_faults),
           "control_first_faults": control_faults[:3], "cpu_step_s": cpu_s}
    log(f"step check: {json.dumps(out)}")
    check(share >= 0.5, f"a residual branch's update is mostly weight "
                        f"decay (gradient share {share:.3f}): the check "
                        f"would not hold its backward")
    check(not faults, f"the card's float32 step disagrees with the CPU's: "
                      f"{faults[:5]}")
    check(bool(control_faults),
          "the step check passed with two images' factors swapped")
    return out


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()


def main() -> int:
    try:
        import torch
    except ImportError:
        log("FAIL: torch is not installed")
        return 2
    if not torch.cuda.is_available():
        log("FAIL: torch.cuda.is_available() is false; this script needs "
            "an NVIDIA GPU")
        return 2
    if not os.path.isdir(os.path.join(REPO, "deep_vision_tpu_torch")):
        log(f"FAIL: no deep_vision_tpu_torch package beside {__file__}; "
            f"run it from a checkout of the repository")
        return 2
    sys.path.insert(0, REPO)
    from deep_vision_tpu_torch.core.device import configure_precision

    configure_precision()  # float32 comparisons without TF32
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"cuda {torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    build_s = phase_build()
    rows = phase_kernels()
    train_rows = phase_train_kernels()
    serving = phase_serving()
    training = phase_training()
    step_check = phase_step_check()
    main_row = next(r for r in rows if r["shape"] == [32, 224, 224, 3]
                    and r["out"] == "int8")
    kernels = [{"name": "serve_ingest", "route": "cuda",
                "source": "deep_vision_tpu_torch/csrc/serve_ingest.cu",
                "replaces": "deep_vision_tpu/ops/pallas_ops.py:77",
                "launches": serving["launches"],
                "max_abs_err": max(r["max_abs_err"] for r in rows),
                "ms": main_row["ms"], "plain_ms": main_row["plain_ms"],
                "bound_ms": main_row["bound_ms"],
                "bound_by": main_row["bound_by"],
                "library_ms": main_row["library_ms"],
                "shape": main_row["shape"], "build_s": build_s}]
    train_row = train_rows[0]
    kernels.append({
        "name": "train_ingest", "route": "cuda",
        "source": "deep_vision_tpu_torch/csrc/train_ingest.cu",
        "replaces": "deep_vision_tpu/ops/pallas_ops.py:202",
        "launches": training["train_ingest_launches"],
        "max_abs_err": max(r["max_abs_err"] for r in train_rows),
        "ms": train_row["ms"], "plain_ms": train_row["plain_ms"],
        "bound_ms": train_row["bound_ms"], "bound_by": train_row["bound_by"],
        "library_ms": train_row["library_ms"], "shape": train_row["shape"],
        "build_s": build_s})
    print(json.dumps({"kernel_checks": rows}), flush=True)
    print(json.dumps({"train_kernel_checks": train_rows}), flush=True)
    print(json.dumps({"serving": serving}), flush=True)
    print(json.dumps({"training": training}), flush=True)
    print(json.dumps({"step_check": step_check}), flush=True)
    print(card(), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
