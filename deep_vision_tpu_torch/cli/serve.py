"""Dynamic-batching inference server on one GPU.

    python -m deep_vision_tpu_torch.cli.serve -m resnet50 \\
        [--workdir runs/r50 | --weights w.npz] --wire-dtype uint8 \\
        --infer-dtype int8 --port 8000 --max-batch 32 [--buckets 1,8,32] \\
        --warmup [--device cuda] [--faults 'compute:poison:nth=5' \\
        --fault-seed 0] [--response-cache-mb 64] [--qos SPEC]
    python -m deep_vision_tpu_torch.cli.serve \\
        --models resnet50,yolov3_coco --workdir runs --hbm-budget-mb 80 \\
        --canary-frac 0.25 --shadow-frac 0.5 --wire-dtype uint8 \\
        --infer-dtype int8 --warmup
    python -m deep_vision_tpu_torch.cli.serve -m resnet50 \\
        --serve-devices 0 --wire-dtype uint8 --infer-dtype int8 --warmup
    python -m deep_vision_tpu_torch.cli.serve --models resnet50 \\
        --workdir runs --watch --watch-interval-s 2 --gate-dir holdout \\
        --min-replicas 1 --max-replicas 4 --wire-dtype uint8 \\
        --infer-dtype int8 --warmup
    python -m deep_vision_tpu_torch.cli.serve -m yolov3_coco \\
        [--weights w.npz] --wire-dtype uint8 --infer-dtype int8 \\
        [--detect-decode device] [--detect-topk 100] \\
        [--detect-score-threshold 0.05] [--detect-iou-threshold 0.5] \\
        [--detect-soft-nms off] [--detect-soft-sigma 0.5] \\
        [--detect-max-per-class 0]
    python -m deep_vision_tpu_torch.cli.serve \\
        --models resnet34,resnet50,resnet152 \\
        --cascade resnet34:resnet50:resnet152 --cascade-quant-front \\
        --workdir runs --wire-dtype uint8 --infer-dtype bfloat16 --warmup \\
        [--brownout] [--qos SPEC] [--response-cache-mb 64]
    python -m deep_vision_tpu_torch.cli.serve -m hourglass104 \\
        [--weights w.npz] --wire-dtype uint8 --infer-dtype int8
    python -m deep_vision_tpu_torch.cli.serve -m dcgan [--weights w.npz]
    python -m deep_vision_tpu_torch.cli.serve -m cyclegan \\
        [--weights w.npz] --wire-dtype uint8 [--infer-dtype int8]
    python -m deep_vision_tpu_torch.cli.serve -m resnet50 \\
        --stablehlo model.pt2 --workdir runs/r50 [--warmup]
    python -m deep_vision_tpu_torch.cli.serve -m resnet50 \\
        --wire-dtype uint8 --infer-dtype int8 --warmup --jobs-dir jobs \\
        [--batch-shard-size 0] [--batch-max-depth 0] \\
        [--batch-pressure-ms 10] [--batch-cache-shards 64]

A classifier answers ``POST /v1/classify``; a detection model
(``yolov3_*``, ``centernet*``) answers ``POST /v1/detect``; a pose model
(``hourglass*``) answers ``POST /v1/pose {"pixels"}`` with its keypoints
in heatmap pixels; a GAN generator answers ``POST /v1/generate`` with a
uint8 image in base64: ``dcgan`` from ``{"seed": N}`` or ``{"latent":
[100 floats]}`` (its wire is float32 whatever ``--wire-dtype`` says),
``cyclegan`` from ``{"pixels"}`` (the other domain's image).

``--workdir`` serves what ``cli.train`` wrote there: the newest complete
checkpoint, falling back past a torn one (``core/restore.py``).
``--stablehlo A`` (the reference's flag name, kept so scripts carry
over) serves the ``torch.export`` archive ``A`` of ``cli.infer export``
instead of the model code, at its one traced batch, on the float32 wire
and in float32 (``--infer-dtype bfloat16``/``int8`` is refused), with
the weights of ``--workdir`` or ``--weights``.
``--weights`` is an ``.npz`` of the reference's flax variables tree
(keys joined by ``/``, see ``convert.py``); with neither the model is a
seeded random init.  ``--models a,b`` serves several models from
``<workdir>/<name>`` through the model control plane
(``serve/models.py``): a weight cache over device bytes
(``--hbm-budget-mb``), and ``POST /v1/models/<name>/reload`` rolls a new
checkpoint out through shadow and canary phases without a restart.
Every engine runs under the fault plane's supervision (watchdog
restarts, exec-timeout fast-fail, bisect-retry; ``--faults`` injects).

``--serve-devices N`` replicates each engine over the first N local
GPUs behind one queue (0 = all; ``serve/replicas.py``); with ``--device
cpu`` it builds N CPU replicas.  Two replicas on ONE card are built
through the API (``ReplicatedEngine(devices=[cuda:0, cuda:0])`` or
``add_replica(device="cuda:0")``): asking for more devices than the
machine has is an error, never a silent reuse.  With ``--models``,
``--watch`` polls each ``<workdir>/<name>`` for new checkpoints, gates
them on held-out data (``--gate-dir``) and rolls passing ones out
through shadow and canary; ``--min-replicas``/``--max-replicas`` put an
autoscaler on each model's replica count; both keep an append-only
ledger under ``<workdir>/_deploy`` (``GET /v1/deploy/<name>/history``,
``POST /v1/deploy/<name>/revert``).

``--cascade t0:...:big`` (with ``--models``) routes requests addressed
to the big model through the cheaper tiers first, each answering when
its calibrated confidence threshold says it agrees with the big model
(``serve/cascade.py``; ``X-DVT-Tier`` names the answering tier).
``--brownout`` arms the overload ladder (``serve/brownout.py``): L1
pauses calibration samples, shadow duplication and slow-trace logging,
L2 serves degraded cascade answers and stale cache hits (marked
``X-DVT-Degraded``), L3 sheds every QoS class but premium; ``POST
/v1/brownout {"force": n}`` pins it.

``--jobs-dir D`` turns the offline batch tier on (``serve/jobs.py``,
``serve/batch_sched.py``): ``POST /v1/jobs {"items": [...]}`` takes a
manifest of request bodies, a scheduler drains it a shard (one engine
cohort) at a time whenever the interactive queue is in a trough (and
not at all at brownout L1+), every finished shard is appended to
``D/<job>.jsonl``, a restarted server resumes each unfinished job at
its first missing shard, and ``GET /v1/jobs/<id>/results`` streams the
results as chunked NDJSON (``--jobs-dir ''``: the tier in memory
only).

The front end is the selector event loop of ``serve/edge.py``
(keep-alive, pipelining, at most ``--max-connections`` open sockets,
``--http-workers`` handler threads); ``--thread-server`` keeps the
thread-per-request server.  Several of these processes go behind one
endpoint with ``cli.gateway``.

Port of ``deep_vision_tpu/cli/serve.py`` (``build_server``,
``_build_plane_server``, ``main``); the mesh flags wait for their
slice.
"""

from __future__ import annotations

import argparse

from deep_vision_tpu_torch.core.device import (
    configure_precision,
    resolve_device,
)

def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="deep_vision_tpu_torch dynamic-batching inference "
                    "server")
    p.add_argument("-m", "--model", default=None,
                   help="config name, e.g. resnet50")
    p.add_argument("--models", default=None,
                   help="comma-separated config names served together "
                        "through the model control plane, each from "
                        "<--workdir>/<name>")
    src = p.add_mutually_exclusive_group()
    src.add_argument("--workdir", default=None,
                     help="training workdir: serve its newest complete "
                          "checkpoint (with --models: the parent of one "
                          "workdir per model)")
    src.add_argument("--weights", default=None,
                     help=".npz of the flax variables tree (keys joined "
                          "by '/'); with neither, a seeded random init")
    p.add_argument("--stablehlo", default=None,
                   help="serve this cli.infer export archive (.pt2) "
                        "instead of the model code, with the weights of "
                        "--workdir or --weights (fixed batch = export "
                        "batch; float32 wire and compute)")
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
    p.add_argument("--calib-batches", type=int, default=2,
                   help="int8: calibration batches")
    p.add_argument("--calib-dir", default=None,
                   help="int8: held-out calibration images (.npy/.npz); "
                        "omitted = deterministic synthetic batches")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8000,
                   help="0 = pick a free port")
    p.add_argument("--max-batch", type=int, default=32)
    p.add_argument("--max-wait-ms", type=float, default=5.0,
                   help="batch drain window")
    p.add_argument("--buckets", default=None,
                   help="comma-separated batch buckets (default: powers of "
                        "two up to --max-batch)")
    p.add_argument("--max-queue", type=int, default=256,
                   help="admission queue bound (capped by the workload's "
                        "SLO class)")
    p.add_argument("--pipeline-depth", type=int, default=2,
                   help="dispatched-but-undrained batches (1 = "
                        "synchronous)")
    p.add_argument("--warmup", action="store_true",
                   help="build and run every bucket before taking traffic")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu")
    p.add_argument("--serve-devices", type=int, default=1,
                   help="replicate the engine over this many local GPUs "
                        "behind one queue (0 = all; default 1 = one "
                        "engine); each replica holds its own copy of the "
                        "weights, batches route to the least-loaded one")
    # -- fault plane and supervision --
    p.add_argument("--faults", default=None,
                   help="fault-injection spec stage:mode[:k=v]...[;...], "
                        "e.g. 'compute:poison:nth=5' (default: the "
                        "DVT_SERVE_FAULTS environment variable)")
    p.add_argument("--fault-seed", type=int, default=0)
    p.add_argument("--watchdog-interval-ms", type=float, default=50.0,
                   help="watchdog period (0 disables it)")
    p.add_argument("--restart-budget", type=int, default=3,
                   help="thread restarts before the engine is sticky DEAD")
    p.add_argument("--exec-timeout-k", type=float, default=10.0,
                   help="a batch in flight longer than k × its bucket's "
                        "exec EWMA is failed fast")
    p.add_argument("--exec-timeout-min-s", type=float, default=2.0,
                   help="the exec timeout's floor")
    p.add_argument("--retry-budget", type=int, default=16,
                   help="bisect-retry executions per failed cohort")
    p.add_argument("--degraded-after", type=int, default=1,
                   help="consecutive batch failures before DEGRADED")
    p.add_argument("--dead-after", type=int, default=5,
                   help="consecutive batch failures before DEAD")
    # -- model control plane (--models) --
    p.add_argument("--hbm-budget-mb", type=float, default=0.0,
                   help="weight-cache budget in MiB of device memory "
                        "(0 = unbounded)")
    p.add_argument("--canary-frac", type=float, default=0.1,
                   help="share of live traffic a reload's candidate takes")
    p.add_argument("--canary-min-requests", type=int, default=20,
                   help="canary answers needed before promotion")
    p.add_argument("--canary-max-error-rate", type=float, default=0.0,
                   help="canary error-rate gate")
    p.add_argument("--canary-max-p99-ratio", type=float, default=3.0,
                   help="canary p99 over the active's p99 gate")
    p.add_argument("--shadow-frac", type=float, default=0.0,
                   help="share of live requests duplicated onto the "
                        "candidate before its canary (0 = no shadow)")
    p.add_argument("--phase-timeout-s", type=float, default=30.0,
                   help="a shadow or canary phase that cannot fill its "
                        "quota within this rolls back")
    # -- continuous deploy pipeline (--models) --
    p.add_argument("--watch", action="store_true",
                   help="watch each model's <workdir>/<name> for new "
                        "checkpoints (debounced across two polls), gate "
                        "them on held-out data and roll passing ones "
                        "through shadow/canary/promote (--models only)")
    p.add_argument("--watch-interval-s", type=float, default=2.0,
                   help="checkpoint-fingerprint poll interval")
    p.add_argument("--gate-dir", default=None,
                   help="held-out set of the deploy accuracy gate: uint8 "
                        "*.npy images (HWC or NHWC) and an optional "
                        "labels.txt (one int per image); without labels "
                        "the gate scores top-1 agreement with the active "
                        "version; default: deterministic synthetic "
                        "batches (NaN screen and agreement only)")
    p.add_argument("--gate-min-agreement", type=float, default=0.8,
                   help="label-free gate: least candidate-vs-active top-1 "
                        "agreement to deploy")
    p.add_argument("--min-replicas", type=int, default=0,
                   help="boot each model's engine with this many "
                        "replicas, the autoscaler's floor (0 = use "
                        "--serve-devices; --models only)")
    p.add_argument("--max-replicas", type=int, default=0,
                   help="autoscale replicas up to this ceiling on queue "
                        "pressure and back down to --min-replicas when "
                        "idle (0 disables autoscaling; --models only)")
    p.add_argument("--drain-deadline", type=float, default=5.0,
                   help="seconds admitted work may take to finish at "
                        "shutdown")
    # -- front end --
    p.add_argument("--thread-server", action="store_true",
                   help="serve with the original thread-per-request "
                        "ThreadingHTTPServer instead of the selector "
                        "event loop (no keep-alive pooling, no "
                        "connection bound)")
    p.add_argument("--max-connections", type=int, default=1024,
                   help="edge loop: open-connection ceiling — at "
                        "capacity the oldest fully-idle keep-alive "
                        "connection is evicted, else accepting pauses "
                        "until a slot frees")
    p.add_argument("--http-workers", type=int, default=8,
                   help="edge loop: worker threads running handler "
                        "logic off the event loop")
    p.add_argument("--verbose", action="store_true",
                   help="per-request HTTP access logs")
    p.add_argument("--log-level", default="info",
                   choices=("debug", "info", "warning", "error"),
                   help="structured-log threshold for the dvt.serve.* "
                        "loggers (one JSON line per event on stderr)")
    p.add_argument("--max-body-mb", type=float, default=32.0,
                   help="request body cap (413 beyond it)")
    p.add_argument("--socket-timeout-s", type=float, default=30.0,
                   help="per-connection socket timeout (0 = none)")
    p.add_argument("--qos", default=None,
                   help="per-tenant QoS classes keyed by the X-DVT-Tenant "
                        "header, e.g. 'premium:rate=0,shed_at=1.0;"
                        "best_effort:rate=50,burst=10,shed_at=0.5;"
                        "default=best_effort'")
    p.add_argument("--response-cache-mb", type=float, default=0.0,
                   help="content-addressed response cache size (0 = off)")
    p.add_argument("--trace-ring", type=int, default=256,
                   help="finished request traces kept for /v1/traces")
    p.add_argument("--slow-trace-ms", type=float, default=250.0,
                   help="log one line for each request slower than this")
    p.add_argument("--no-trace", action="store_true",
                   help="turn request tracing off")
    # -- confidence-routed cascade (--models) --
    p.add_argument("--cascade", default=None,
                   help="'t0:t1:...:big': route classify/detect requests "
                        "addressed to the BIG model through the cheaper "
                        "tiers first, escalating past each hop whose "
                        "confidence is below its threshold, calibrated "
                        "from live tier-vs-big dual runs; every name must "
                        "be in --models and share one verb (an "
                        "uncalibrated hop escalates through: fully "
                        "uncalibrated = all-big)")
    p.add_argument("--cascade-min-agreement", type=float, default=0.98,
                   help="calibration target: the smallest confidence "
                        "whose measured tier-vs-big agreement (at and "
                        "above it) still clears this")
    p.add_argument("--cascade-sample-period", type=int, default=10,
                   help="every N-th request reaching a hop dual-runs its "
                        "tier and the big tier (the big answer is "
                        "returned)")
    p.add_argument("--cascade-min-sample", type=int, default=200,
                   help="calibration samples a hop needs before any "
                        "request may stop at it")
    p.add_argument("--cascade-topk", type=int, default=5,
                   help="K of the cheap tiers' fused top-K confidence "
                        "epilogue (bounds top_k in their answers)")
    p.add_argument("--cascade-quant-front", action="store_true",
                   help="serve tier 0 with int8 weights: quantized at "
                        "boot, calibrated on --calib-dir, else on the "
                        "--gate-dir holdout, else on synthetic batches")
    p.add_argument("--cascade-per-class", action="store_true",
                   help="calibrate a per-class threshold axis at every "
                        "hop")
    p.add_argument("--cascade-class-min-sample", type=int, default=50,
                   help="dual-run samples one class needs before its own "
                        "threshold applies (below it: the pooled one)")
    # -- offline batch tier --
    p.add_argument("--jobs-dir", default=None,
                   help="enable the offline batch-inference tier "
                        "(POST /v1/jobs) and checkpoint job progress "
                        "as append-only JSONL under this directory — "
                        "a restarted server resumes unfinished jobs "
                        "from their last durable shard ('' = enabled "
                        "but memory-only, no restart durability)")
    p.add_argument("--batch-shard-size", type=int, default=0,
                   help="images per batch job shard — the durability "
                        "AND scheduling unit (0 = --max-batch, one "
                        "engine cohort; the worst interference any "
                        "interactive request can see)")
    p.add_argument("--batch-interval-ms", type=float, default=20.0,
                   help="batch scheduler poll pacing while deferred "
                        "behind interactive load")
    p.add_argument("--batch-max-depth", type=int, default=0,
                   help="max interactive queue depth at which a batch "
                        "shard may still be submitted (default 0: any "
                        "waiting interactive request parks the batch "
                        "tier)")
    p.add_argument("--batch-pressure-ms", type=float, default=10.0,
                   help="interactive pressure ceiling (queue_depth x "
                        "exec EWMA, ms) for the trough check; above "
                        "it batch work defers")
    p.add_argument("--batch-cache-shards", type=int, default=64,
                   help="per-job completed-shard payloads kept in "
                        "memory; with --jobs-dir the rest spill to the "
                        "JSONL ledger (LRU) and GET /v1/jobs/<id>/"
                        "results streams them back from disk (0 = "
                        "unbounded; memory-only stores never evict)")
    # -- overload brownout --
    p.add_argument("--brownout", action="store_true",
                   help="arm the brownout ladder: a controller polls "
                        "queue pressure, engine occupancy and shed rate "
                        "and steps L0→L3 (L1 sheds optional work: "
                        "cascade samples, shadow duplication, slow-trace "
                        "lines; L2 degrades quality: below-threshold "
                        "cascade answers and stale cache hits, marked "
                        "X-DVT-Degraded; L3 sheds every QoS class but "
                        "premium)")
    p.add_argument("--brownout-interval-ms", type=float, default=250.0,
                   help="ladder evaluation tick")
    p.add_argument("--brownout-l1-ms", type=float, default=50.0,
                   help="queue pressure (depth × exec EWMA, ms) that "
                        "votes for L1")
    p.add_argument("--brownout-l2-ms", type=float, default=150.0,
                   help="queue pressure that votes for L2")
    p.add_argument("--brownout-l3-ms", type=float, default=400.0,
                   help="queue pressure that votes for L3")
    p.add_argument("--brownout-occupancy", type=float, default=0.97,
                   help="engine occupancy at or above this votes for L1")
    p.add_argument("--brownout-shed-rate", type=float, default=0.10,
                   help="shed share of a tick at or above this votes for "
                        "L1")
    p.add_argument("--brownout-up-window", type=int, default=2,
                   help="hot ticks in a row before the ladder engages "
                        "(straight to the target level)")
    p.add_argument("--brownout-down-window", type=int, default=8,
                   help="cool ticks in a row before the ladder releases "
                        "ONE level")
    p.add_argument("--brownout-cooldown-s", type=float, default=2.0,
                   help="least dwell after a transition before a release")
    p.add_argument("--brownout-force", type=int, default=-1,
                   help="pin the ladder at this level at boot (0..3; -1 = "
                        "the signals decide; live: POST /v1/brownout "
                        "{\"force\": N|null})")
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


def _detect_knobs(args) -> dict:
    return {"detect_decode": args.detect_decode,
            "detect_topk": args.detect_topk,
            "detect_score_threshold": args.detect_score_threshold,
            "detect_iou_threshold": args.detect_iou_threshold,
            "detect_soft_nms": args.detect_soft_nms,
            "detect_soft_sigma": args.detect_soft_sigma,
            "detect_max_per_class": args.detect_max_per_class}


def _engine_kwargs(args) -> dict:
    """The engine settings every model (and every reloaded version)
    shares: batching, supervision, faults and the trace ring."""
    from deep_vision_tpu_torch.obs.trace import Tracer
    from deep_vision_tpu_torch.serve.faults import FaultPlane

    return dict(
        max_batch=args.max_batch, max_wait_ms=args.max_wait_ms,
        buckets=[int(b) for b in args.buckets.split(",")]
        if args.buckets else None,
        pipeline_depth=args.pipeline_depth,
        # None → the engine reads DVT_SERVE_FAULTS
        faults=FaultPlane(args.faults, args.fault_seed)
        if args.faults else None,
        watchdog_interval_s=args.watchdog_interval_ms / 1e3,
        restart_budget=args.restart_budget,
        exec_timeout_k=args.exec_timeout_k,
        exec_timeout_min_s=args.exec_timeout_min_s,
        retry_budget=args.retry_budget,
        degraded_after=args.degraded_after, dead_after=args.dead_after,
        tracer=Tracer(ring=args.trace_ring, slow_ms=args.slow_trace_ms,
                      enabled=not args.no_trace))


def _replica_devices(device, n: int) -> list:
    """``n`` replica devices: the first ``n`` local GPUs (0 = all), or
    ``n`` CPU replicas on the CPU."""
    from deep_vision_tpu_torch.serve.replicas import local_devices

    if device.type == "cpu":
        return [device] * max(1, n)
    return local_devices(n or None)


def _brownout(args, engines_provider, tracer):
    """``--brownout`` → a started BrownoutController, or None.  It polls
    ``engines_provider()`` each tick (so a hot reload's new engine is
    seen), and suppresses ``tracer``'s slow-request lines at L1+; the
    caller wires it into the plane and the cascade."""
    if not args.brownout:
        return None
    from deep_vision_tpu_torch.serve.brownout import BrownoutController

    bc = BrownoutController(
        engines_provider, interval_s=args.brownout_interval_ms / 1e3,
        l1_pressure_ms=args.brownout_l1_ms,
        l2_pressure_ms=args.brownout_l2_ms,
        l3_pressure_ms=args.brownout_l3_ms,
        occupancy_high=args.brownout_occupancy,
        shed_rate_high=args.brownout_shed_rate,
        up_window=args.brownout_up_window,
        down_window=args.brownout_down_window,
        cooldown_s=args.brownout_cooldown_s)
    if args.brownout_force >= 0:
        bc.force(args.brownout_force)
    tracer.suppress_slow = lambda: bc.at_least(1)
    return bc.start()


def _batch_tier(args, resolve):
    """``--jobs-dir`` → (JobStore, started BatchScheduler), or (None,
    None).  ``resolve(model_name) -> (model, engine)`` is the routing
    closure of the build path (the engines dict, or the control plane);
    the scheduler fails a job for good when it raises KeyError.  The
    shard size defaults to ``--max-batch``: one shard is one full
    cohort, the unit the trough check reasons about."""
    if args.jobs_dir is None:
        return None, None
    from deep_vision_tpu_torch.serve.batch_sched import BatchScheduler
    from deep_vision_tpu_torch.serve.jobs import JobStore

    store = JobStore(args.jobs_dir or None,
                     shard_size=args.batch_shard_size or args.max_batch,
                     max_cached_shards=args.batch_cache_shards)
    # 0 for the interval or the pressure means the default, as in the
    # reference
    sched = BatchScheduler(
        store, resolve, interval_s=(args.batch_interval_ms or 20.0) / 1e3,
        max_interactive_depth=args.batch_max_depth,
        pressure_high_ms=args.batch_pressure_ms or 10.0)
    return store, sched.start()


def _cascade_spec(args, names: list):
    """``--cascade`` → a CascadeSpec, checked before any checkpoint is
    restored: every tier served, one workload verb, and a verb with a
    cascade rule (classify and detect)."""
    from deep_vision_tpu_torch.core.config import get_config
    from deep_vision_tpu_torch.serve.cascade import CascadeSpec
    from deep_vision_tpu_torch.serve.workloads import workload_for_task

    spec = CascadeSpec.parse(
        args.cascade, min_agreement=args.cascade_min_agreement,
        sample_period=args.cascade_sample_period,
        min_sample=args.cascade_min_sample, topk=args.cascade_topk,
        per_class=args.cascade_per_class,
        class_min_sample=args.cascade_class_min_sample)
    for tier in spec.tiers:
        if tier not in names:
            raise ValueError(f"--cascade tier '{tier}' is not served; "
                             f"--models must include every cascade tier "
                             f"(got {names})")
    verbs = {t: workload_for_task(get_config(t).task).verb
             for t in spec.tiers}
    if len(set(verbs.values())) > 1:
        raise ValueError(f"--cascade tiers must share one workload verb, "
                         f"got {verbs}")
    if workload_for_task(get_config(spec.big).task).cascade_rule() is None:
        raise ValueError(f"--cascade: the '{verbs[spec.big]}' workload "
                         f"has no cascade rule (classify and detect "
                         f"cascade)")
    return spec


def _edge_kwargs(args) -> dict:
    """The ServeServer front-end wiring shared by both build paths: the
    selector edge by default (``--thread-server`` restores the
    thread-per-request server), and the response cache and tenant QoS
    only when asked for."""
    from deep_vision_tpu_torch.serve.admission import TenantQoS
    from deep_vision_tpu_torch.serve.cache import ResponseCache

    return dict(
        edge=not args.thread_server,
        max_connections=args.max_connections,
        http_workers=args.http_workers,
        response_cache=ResponseCache(int(args.response_cache_mb * 2**20))
        if args.response_cache_mb > 0 else None,
        qos=TenantQoS.parse(args.qos) if args.qos else None)


def _server(args, registry, engines: dict, tracer, plane=None,
            deploy=None, cascade=None, brownout=None, jobs=None,
            batch_sched=None):
    from deep_vision_tpu_torch.serve.http import ServeServer

    return ServeServer(
        registry, engines, host=args.host, port=args.port,
        verbose=args.verbose,
        max_body_bytes=int(args.max_body_mb * 2**20),
        socket_timeout_s=args.socket_timeout_s
        if args.socket_timeout_s > 0 else None,
        tracer=tracer, plane=plane, deploy=deploy, cascade=cascade,
        brownout=brownout, jobs=jobs, batch_sched=batch_sched,
        **_edge_kwargs(args))


def build_server(args):
    """argparse namespace → (engine, ServeServer), the engine started
    (and warmed up with ``--warmup``); with ``--models``, (the model
    control plane, ServeServer)."""
    from deep_vision_tpu_torch.serve.admission import AdmissionController
    from deep_vision_tpu_torch.serve.engine import BatchingEngine
    from deep_vision_tpu_torch.serve.registry import ModelRegistry
    from deep_vision_tpu_torch.serve.replicas import ReplicatedEngine

    if bool(args.model) == bool(args.models):
        raise ValueError("give one of -m/--model and --models")
    device = resolve_device(args.device)
    configure_precision()
    registry = ModelRegistry()
    if args.models:
        if args.stablehlo:
            raise ValueError("--stablehlo serves one exported archive; "
                             "multi-model serving (--models) is "
                             "checkpoint-path only")
        return _build_plane_server(args, registry, device)
    if args.watch or args.max_replicas:
        raise ValueError("--watch / --max-replicas need the model control "
                         "plane (--models ...): the deploy pipeline rolls "
                         "candidates through its version table")
    if args.cascade:
        raise ValueError("--cascade routes across the model control "
                         "plane; use --models front,big")
    # fail on a device count the machine lacks before any model work
    devices = _replica_devices(device, args.serve_devices) \
        if args.serve_devices != 1 else None
    if args.stablehlo:
        # the archive was traced at float32 on host-normalized input: the
        # wire knob does not apply (describe() shows the real wire); a
        # non-float32 --infer-dtype is refused by the registry with the
        # one "f32-wire/f32-compute only" error
        sm = registry.load_exported(args.model, args.stablehlo,
                                    workdir=args.workdir,
                                    weights=args.weights,
                                    infer_dtype=args.infer_dtype,
                                    device=device)
        for knob, value in _detect_knobs(args).items():
            setattr(sm, knob, value)
    else:
        sm = registry.load_checkpoint(args.model, args.weights,
                                      wire_dtype=args.wire_dtype,
                                      infer_dtype=args.infer_dtype,
                                      calib_batches=args.calib_batches,
                                      calib_dir=args.calib_dir,
                                      device=device, workdir=args.workdir,
                                      **_detect_knobs(args))
    kwargs = _engine_kwargs(args)
    admission = AdmissionController(
        max_queue=sm.workload.slo.bound_queue(args.max_queue),
        max_wait_ms=args.max_wait_ms)
    if devices is not None and len(devices) > 1:
        engine = ReplicatedEngine(sm, devices=devices, admission=admission,
                                  **kwargs)
    else:
        engine = BatchingEngine(sm, admission=admission, **kwargs)
    engine.start()
    if args.warmup:
        print(f"[serve] warming {engine.buckets} ...", flush=True)
        engine.warmup()
    engines = {sm.name: engine}

    def resolve(name):
        return registry.get(name), engines[name]  # KeyError: job fails

    jobs, batch_sched = _batch_tier(args, resolve)
    brownout = _brownout(args, lambda: engines.values(), kwargs["tracer"])
    if brownout is not None and batch_sched is not None:
        batch_sched.brownout = brownout  # L1+: freeze the batch tier
    return engine, _server(args, registry, engines, kwargs["tracer"],
                           brownout=brownout, jobs=jobs,
                           batch_sched=batch_sched)


def _build_plane_server(args, registry, device):
    """``--models a,b`` → (ModelControlPlane, ServeServer): each model
    restores from ``<workdir>/<name>``, every engine (a reloaded
    version's too) comes from one factory, and one admission controller
    per model name carries its exec EWMAs over a reload.  ``--watch``
    and ``--max-replicas`` add the deploy pipeline."""
    import os

    from deep_vision_tpu_torch.serve.admission import AdmissionController
    from deep_vision_tpu_torch.serve.engine import BatchingEngine
    from deep_vision_tpu_torch.serve.models import (
        CanaryPolicy,
        ModelControlPlane,
        WeightCache,
    )
    from deep_vision_tpu_torch.serve.replicas import ReplicatedEngine

    names = [s.strip() for s in args.models.split(",") if s.strip()]
    if not names:
        raise ValueError("--models needs at least one config name")
    if args.weights:
        raise ValueError("--models serves workdirs (<--workdir>/<name>); "
                         "--weights names one model's npz")
    if not args.workdir:
        raise ValueError("--models needs --workdir (one subdirectory per "
                         "model)")
    spec = _cascade_spec(args, names) if args.cascade else None
    min_replicas, max_replicas = args.min_replicas, args.max_replicas
    if max_replicas and not min_replicas:
        min_replicas = 1
    if max_replicas and max_replicas < min_replicas:
        raise ValueError(f"--max-replicas {max_replicas} < "
                         f"--min-replicas {min_replicas}")
    if min_replicas:
        if args.serve_devices != 1:
            raise ValueError("--min-replicas and --serve-devices both set "
                             "the replica floor; use one")
        # the autoscaler needs the elastic engine even at one replica
        devices = _replica_devices(device, min_replicas)
    else:
        devices = _replica_devices(device, args.serve_devices) \
            if args.serve_devices != 1 else None
    replicated = devices is not None and (len(devices) > 1
                                          or max_replicas > 1)
    kwargs = _engine_kwargs(args)
    admissions: dict = {}

    def admission_for(name: str) -> AdmissionController:
        adm = admissions.get(name)
        if adm is None:
            adm = admissions[name] = AdmissionController(
                max_queue=registry.get(name).workload.slo.bound_queue(
                    args.max_queue),
                max_wait_ms=args.max_wait_ms, name=name)
        return adm

    def engine_factory(model):
        if replicated:
            return ReplicatedEngine(model, devices=devices,
                                    admission=admission_for(model.name),
                                    **kwargs)
        return BatchingEngine(model, admission=admission_for(model.name),
                              **kwargs)

    plane = ModelControlPlane(
        registry, engine_factory,
        cache=WeightCache(int(args.hbm_budget_mb * 2**20)),
        policy=CanaryPolicy(canary_frac=args.canary_frac,
                            min_requests=args.canary_min_requests,
                            max_error_rate=args.canary_max_error_rate,
                            max_p99_ratio=args.canary_max_p99_ratio,
                            shadow_frac=args.shadow_frac,
                            phase_timeout_s=args.phase_timeout_s))
    for name in names:
        workdir = os.path.join(args.workdir, name)
        # every NON-FINAL cascade tier fuses the confidence epilogue (a
        # classify tier; detect rows already carry the signal); the big
        # tier keeps its dense rows, so an escalated answer is exactly a
        # big-only answer
        cascade_topk = spec.topk if spec is not None \
            and name in spec.tiers and name != spec.big else 0
        infer_dtype, calib_dir = args.infer_dtype, args.calib_dir
        if spec is not None and args.cascade_quant_front \
                and name == spec.front:
            # tier 0 int8-resident, calibrated on --calib-dir, else the
            # --gate-dir holdout, else synthetic batches
            infer_dtype, calib_dir = "int8", calib_dir or args.gate_dir
        sm = registry.load_checkpoint(
            name, wire_dtype=args.wire_dtype, infer_dtype=infer_dtype,
            calib_batches=args.calib_batches, calib_dir=calib_dir,
            device=device, workdir=workdir, cascade_topk=cascade_topk,
            **_detect_knobs(args))
        plane.deploy(sm, workdir=workdir)
    cascade = None
    if spec is not None:
        from deep_vision_tpu_torch.serve.cascade import CascadeRouter

        # built after the boot deploys (its listener needs only later
        # swaps); the ledger restores a restarted server's calibration
        cascade = CascadeRouter(plane, spec, root=os.path.join(
            args.workdir, "_cascade"))
    if args.warmup:
        for name, eng in plane.active_engines().items():
            print(f"[serve] warming {name} {eng.buckets} ...", flush=True)
        plane.warmup()
    pipeline = None
    if args.watch or max_replicas > min_replicas:
        pipeline = _deploy_pipeline(args, plane, names, min_replicas,
                                    max_replicas)
        pipeline.start()

    def resolve(name):
        # resolved per shard: after a hot reload the NEXT shard runs on
        # the new ACTIVE engine (KeyError: the job fails)
        model = plane.resolve(name)
        return model, plane.active_engine(model.name)

    jobs, batch_sched = _batch_tier(args, resolve)
    brownout = _brownout(args, lambda: plane.active_engines().values(),
                         kwargs["tracer"])
    if brownout is not None:
        plane.brownout = brownout  # L1+: pause shadow duplication
        if cascade is not None:
            cascade.brownout = brownout  # L1 sample pause, L2 degrade
        if batch_sched is not None:
            batch_sched.brownout = brownout  # L1+: freeze the batch tier
    return plane, _server(args, registry, plane.active_engines(),
                          kwargs["tracer"], plane=plane, deploy=pipeline,
                          cascade=cascade, brownout=brownout, jobs=jobs,
                          batch_sched=batch_sched)


def _deploy_pipeline(args, plane, names, min_replicas: int,
                     max_replicas: int):
    """The ledger under ``<workdir>/_deploy``, with ``--watch``'s
    checkpoint watcher and accuracy gate and, when ``--max-replicas``
    exceeds the floor, one autoscaler a model."""
    import os

    from deep_vision_tpu_torch.deploy import (
        AccuracyGate,
        CheckpointWatcher,
        DeploymentHistory,
        DeployPipeline,
        ReplicaAutoscaler,
    )

    history = DeploymentHistory(os.path.join(args.workdir, "_deploy"))
    watcher = None
    if args.watch:
        watcher = CheckpointWatcher(
            plane, history, interval_s=args.watch_interval_s,
            gate=AccuracyGate(gate_dir=args.gate_dir,
                              min_agreement=args.gate_min_agreement))
        for name in names:
            watcher.watch(name)
    autoscalers = {}
    if max_replicas > min_replicas:
        for name in names:
            # resolved per tick: a hot reload swaps the active engine
            autoscalers[name] = ReplicaAutoscaler(
                lambda name=name: plane.active_engine(name), name=name,
                min_replicas=min_replicas, max_replicas=max_replicas,
                history=history)
    return DeployPipeline(plane, history=history, watcher=watcher,
                          autoscalers=autoscalers or None)


def main(argv=None):
    p = build_parser()
    args = p.parse_args(argv)
    if bool(args.model) == bool(args.models):
        p.error("give one of -m/--model and --models")
    if args.cascade and not args.models:
        p.error("--cascade routes across the multi-model plane; use "
                "--models front,big")
    from deep_vision_tpu_torch.obs.log import configure_logging

    configure_logging(args.log_level)
    engine, server = build_server(args)
    sm = engine.model
    served = args.models or sm.name
    print(f"[serve] {served} on {sm.device}: wire={sm.wire_dtype} "
          f"infer={sm.infer_dtype} buckets={engine.buckets} — "
          f"http://{server.host}:{server.port}/v1/{sm.workload.verb}",
          flush=True)
    if args.models:
        print(f"[serve] model control plane (hbm_budget="
              f"{args.hbm_budget_mb or 'unbounded'}"
              f"{'MiB' if args.hbm_budget_mb else ''}, canary_frac="
              f"{args.canary_frac}, shadow_frac={args.shadow_frac}) — "
              f"reload: curl -XPOST http://{server.host}:{server.port}"
              f"/v1/models/<name>/reload", flush=True)
    deploy = server.httpd.deploy
    if deploy is not None:
        bits = []
        if deploy.watcher is not None:
            bits.append(f"watch every {args.watch_interval_s}s, gate="
                        f"{args.gate_dir or 'synthetic'}")
        if deploy.autoscalers:
            bits.append(f"autoscale {args.min_replicas or 1}.."
                        f"{args.max_replicas} replicas")
        print(f"[serve] deploy pipeline: {'; '.join(bits)} — history: "
              f"curl http://{server.host}:{server.port}"
              f"/v1/deploy/<name>/history", flush=True)
    engines = engine.active_engines() if args.models else {sm.name: engine}
    for name, eng in engines.items():
        if hasattr(eng, "replicas"):
            print(f"[serve] {name}: {len(eng.replicas)} replicas on "
                  + ", ".join(r.model.placement_desc()
                              for r in eng.replicas), flush=True)
    cascade = server.httpd.cascade
    if cascade is not None:
        sp = cascade.spec
        print(f"[serve] cascade: {' -> '.join(sp.tiers)}: requests for "
              f"'{sp.big}' answer from the cheapest confident tier "
              f"(min_agreement={sp.min_agreement}, sample_period="
              f"{sp.sample_period}, min_sample={sp.min_sample}"
              + (", per_class" if sp.per_class else "")
              + (f", {sp.front} int8" if args.cascade_quant_front else "")
              + ")", flush=True)
    brownout = server.httpd.brownout
    if brownout is not None:
        print(f"[serve] brownout ladder armed: L1@{args.brownout_l1_ms:g}ms "
              f"L2@{args.brownout_l2_ms:g}ms L3@{args.brownout_l3_ms:g}ms "
              f"queue pressure — pin: curl -XPOST http://{server.host}:"
              f"{server.port}/v1/brownout -d '{{\"force\": 2}}'",
              flush=True)
    jobs = server.httpd.jobs
    if jobs is not None:
        print(f"[serve] batch tier: POST http://{server.host}:"
              f"{server.port}/v1/jobs (jobs_dir="
              f"{jobs.root or 'memory-only'}, shard_size="
              f"{jobs.default_shard_size}, max_depth={args.batch_max_depth}"
              f", pressure={args.batch_pressure_ms}ms)", flush=True)
    if engine.faults.enabled:
        print(f"[serve] FAULT INJECTION ACTIVE: '{engine.faults.spec}' "
              f"(seed {engine.faults.seed})", flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        print("[serve] shutting down")
    finally:
        if deploy is not None:
            # the watcher and autoscalers stop BEFORE the engines drain:
            # no scale action or rollout races the shutdown
            deploy.stop()
        batch_sched = server.httpd.batch_sched
        if batch_sched is not None:
            # likewise the batch scheduler: no shard submit races the
            # engines' stop; a shard in flight past this point sheds
            # and re-runs from the JSONL checkpoint on the next boot
            batch_sched.stop()
        if brownout is not None:
            brownout.stop()
        server.shutdown()
        engine.stop(drain_deadline=args.drain_deadline)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
