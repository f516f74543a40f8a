"""Dynamic-batching inference server on one GPU.

    python -m deep_vision_tpu_torch.cli.serve -m resnet50 \\
        [--weights w.npz] --wire-dtype uint8 --infer-dtype int8 \\
        --port 8000 --max-batch 32 [--buckets 1,8,32] --warmup \\
        [--device cuda]

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
                                  device=device)
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
          f"http://{server.host}:{server.port}/v1/classify", flush=True)
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
