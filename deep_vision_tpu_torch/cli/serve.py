"""Dynamic-batching inference server on one GPU.

    python -m deep_vision_tpu_torch.cli.serve -m resnet50 \\
        [--weights w.npz] --wire-dtype uint8 --infer-dtype int8 \\
        --port 8000 --max-batch 32 [--buckets 1,8,32] --warmup \\
        [--device cuda]
    python -m deep_vision_tpu_torch.cli.serve -m yolov3_coco \\
        [--weights w.npz] --wire-dtype uint8 --infer-dtype int8 \\
        [--detect-decode device] [--detect-topk 100] \\
        [--detect-score-threshold 0.05] [--detect-iou-threshold 0.5] \\
        [--detect-soft-nms off] [--detect-soft-sigma 0.5] \\
        [--detect-max-per-class 0]
    python -m deep_vision_tpu_torch.cli.serve -m hourglass104 \\
        [--weights w.npz] --wire-dtype uint8 --infer-dtype int8
    python -m deep_vision_tpu_torch.cli.serve -m dcgan [--weights w.npz]
    python -m deep_vision_tpu_torch.cli.serve -m cyclegan \\
        [--weights w.npz] --wire-dtype uint8 [--infer-dtype int8]

A classifier answers ``POST /v1/classify``; a detection model
(``yolov3_*``, ``centernet*``) answers ``POST /v1/detect``; a pose model
(``hourglass*``) answers ``POST /v1/pose {"pixels"}`` with its keypoints
in heatmap pixels; a GAN generator answers ``POST /v1/generate`` with a
uint8 image in base64: ``dcgan`` from ``{"seed": N}`` or ``{"latent":
[100 floats]}`` (its wire is float32 whatever ``--wire-dtype`` says),
``cyclegan`` from ``{"pixels"}`` (the other domain's image).

``--weights`` is an ``.npz`` of the reference's flax variables tree
(keys joined by ``/``, see ``convert.py``); without it the model is a
seeded random init.  Port of ``deep_vision_tpu/cli/serve.py``
(``build_server``, ``main``) for one model on one device.
"""

from __future__ import annotations

import argparse

from deep_vision_tpu_torch.core.device import (
    configure_precision,
    resolve_device,
)

#: batch drain window and admission bound (the reference's defaults)
MAX_WAIT_MS = 5.0
MAX_QUEUE = 256


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="deep_vision_tpu_torch dynamic-batching inference "
                    "server")
    p.add_argument("-m", "--model", required=True,
                   help="config name, e.g. resnet50")
    p.add_argument("--weights", default=None,
                   help=".npz of the flax variables tree (keys joined by "
                        "'/'); omitted = seeded random init")
    p.add_argument("--wire-dtype", choices=("uint8", "float32"),
                   default="uint8",
                   help="client wire format: uint8 = raw 0-255 pixels "
                        "normalized on the device; float32 = "
                        "host-normalized pixels")
    p.add_argument("--infer-dtype", choices=("float32", "bfloat16", "int8"),
                   default="float32",
                   help="compute dtype; int8 quantizes the weights at load "
                        "and, on the uint8 wire, runs the serve_ingest "
                        "CUDA kernel")
    p.add_argument("--port", type=int, default=8000,
                   help="0 = pick a free port")
    p.add_argument("--max-batch", type=int, default=32)
    p.add_argument("--buckets", default=None,
                   help="comma-separated batch buckets (default: powers of "
                        "two up to --max-batch)")
    p.add_argument("--warmup", action="store_true",
                   help="build and run every bucket before taking traffic")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu")
    # -- detect decode: detection models only --
    p.add_argument("--detect-decode", choices=("device", "host"),
                   default="device",
                   help="where detection models decode: 'device' "
                        "(default) runs decode → score floor → top-k → "
                        "class-wise NMS inside the bucket callables, so "
                        "the D2H copy moves K fixed-size boxes per image; "
                        "'host' copies the dense head outputs and "
                        "decodes per request (the baseline)")
    p.add_argument("--detect-topk", type=int, default=100,
                   help="max detections per image in the device decode "
                        "(the K of the fixed-size output; D2H bytes per "
                        "image = K·28)")
    p.add_argument("--detect-score-threshold", type=float, default=0.05,
                   help="score FLOOR of the detect decode: per-request "
                        "'score_threshold' values above it trim the "
                        "answer, values below it clamp to it (boxes "
                        "under the floor never survived NMS)")
    p.add_argument("--detect-iou-threshold", type=float, default=0.5,
                   help="IoU threshold of the class-wise NMS (YOLO; "
                        "CenterNet's peak decode has no NMS)")
    p.add_argument("--detect-soft-nms", choices=("off", "gaussian",
                                                 "linear"),
                   default="off",
                   help="suppression rule of the NMS: 'off' (default) "
                        "is hard greedy NMS; 'gaussian' / 'linear' "
                        "switch to Soft-NMS score decay (Bodla et al. "
                        "2017): overlapping boxes survive with decayed "
                        "scores instead of dying at the IoU threshold")
    p.add_argument("--detect-soft-sigma", type=float, default=0.5,
                   help="gaussian Soft-NMS decay width "
                        "exp(-iou²/sigma); ignored for 'off'/'linear'")
    p.add_argument("--detect-max-per-class", type=int, default=0,
                   help="cap detections per class in the decode output "
                        "(0 = uncapped): stops one dense class from "
                        "taking all K rows")
    return p


def build_server(args):
    """argparse namespace → (engine, ServeServer), the engine started
    (and warmed up with ``--warmup``)."""
    from deep_vision_tpu_torch.serve.admission import AdmissionController
    from deep_vision_tpu_torch.serve.engine import BatchingEngine
    from deep_vision_tpu_torch.serve.http import ServeServer
    from deep_vision_tpu_torch.serve.registry import ModelRegistry

    device = resolve_device(args.device)
    configure_precision()
    registry = ModelRegistry()
    sm = registry.load_checkpoint(args.model, args.weights,
                                  wire_dtype=args.wire_dtype,
                                  infer_dtype=args.infer_dtype,
                                  device=device,
                                  detect_decode=args.detect_decode,
                                  detect_topk=args.detect_topk,
                                  detect_score_threshold=(
                                      args.detect_score_threshold),
                                  detect_iou_threshold=(
                                      args.detect_iou_threshold),
                                  detect_soft_nms=args.detect_soft_nms,
                                  detect_soft_sigma=args.detect_soft_sigma,
                                  detect_max_per_class=(
                                      args.detect_max_per_class))
    buckets = [int(b) for b in args.buckets.split(",")] if args.buckets \
        else None
    engine = BatchingEngine(
        sm, max_batch=args.max_batch, max_wait_ms=MAX_WAIT_MS,
        buckets=buckets,
        admission=AdmissionController(
            max_queue=sm.workload.slo.bound_queue(MAX_QUEUE),
            max_wait_ms=MAX_WAIT_MS))
    engine.start()
    if args.warmup:
        print(f"[serve] warming {engine.buckets} ...", flush=True)
        engine.warmup()
    server = ServeServer(registry, {sm.name: engine}, port=args.port)
    return engine, server


def main(argv=None):
    args = build_parser().parse_args(argv)
    engine, server = build_server(args)
    sm = engine.model
    print(f"[serve] {sm.name} on {sm.device}: wire={sm.wire_dtype} "
          f"infer={sm.infer_dtype} buckets={engine.buckets} — "
          f"http://{server.host}:{server.port}/v1/{sm.workload.verb}",
          flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        print("[serve] shutting down")
    finally:
        server.shutdown()
        engine.stop(drain_deadline=10.0)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
