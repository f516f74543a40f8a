"""HTTP front-end for the batching engines.

Port of ``deep_vision_tpu/serve/http.py``.  The front end is the
selector event loop of ``serve/edge.py`` by default (HTTP/1.1
keep-alive, pipelining, bounded connections, slow-loris deadlines);
``edge=False`` keeps the thread-per-request ``ThreadingHTTPServer``.
The routes below run unchanged on either.  Routes (JSON in, JSON out):

    GET  /v1/healthz   per-engine health (thread liveness, heartbeat
                       ages, last-batch age, failures, retries,
                       quarantines, watchdog restarts, the OK →
                       DEGRADED → DEAD state; a replicated engine's
                       per-replica reports); 503 while any engine
                       cannot serve (a replicated engine: only when
                       every replica is DEAD), and while draining; 200
                       again after recovery
    GET  /v1/stats     per-model engine stats (or the control plane's
                       ``{"models", "cache", "plane"}`` shape, with
                       ``deploy`` when a deploy pipeline runs), the
                       ``edge`` block (the selector loop's connection
                       counters) on the default front end, the
                       ``response_cache``, ``qos``, ``cascade``,
                       ``brownout`` and ``batch`` blocks when those are
                       on, and
                       ``kernels``: the launch count of each
                       hand-written kernel
    GET  /metrics      Prometheus text (format 0.0.4) of the same stats
    GET  /v1/traces    the newest finished request traces (``?n=``) and
                       the tracer's summary
    GET  /v1/deploy/{name}/history
                       the append-only deployment ledger of one model
                       (deploy/history.py), ``?n=`` caps the tail; 503
                       without a deploy pipeline, 404 for an unknown
                       model
    POST /v1/deploy/{name}/revert
                       one-command rollback to the previous promoted
                       version, recorded in the ledger: 200 reverted,
                       409 refused or a lifecycle in flight, 500 when
                       the reverted version fails to boot, 503 without
                       a deploy pipeline
    GET  /v1/models    ``describe()`` of every served model, or the
                       plane's version table; a cascade member's entry
                       carries a ``cascade`` block (chain, hop role,
                       where its threshold came from)
    GET  /v1/brownout  the brownout ladder's stats (503 without
                       ``--brownout``)
    GET  /v1/jobs      every batch job's status view, oldest first
    GET  /v1/jobs/{id} one job's status (state, shards and images done)
    GET  /v1/jobs/{id}/results
                       chunked NDJSON: one ``{"index", ...answer}`` line
                       an item of the completed shard prefix, in
                       manifest order, then a ``{"status": ...}`` line;
                       the jobs routes answer 503 without ``--jobs-dir``
                       and 404 for an unknown job or sub-route
    POST /v1/jobs      {"items": [request bodies], "model"?,
                        "shard_size"?}: a bulk job for the batch tier
                       (serve/jobs.py, serve/batch_sched.py), answered
                       202 with its handle; 400 for bad ``items`` or
                       ``shard_size``
    POST /v1/brownout  {"force": 0..3 | null}: pin the ladder at a level,
                       or hand it back to the signals; answers the stats
    POST /v1/classify | /v1/detect | /v1/pose | /v1/generate
                       {"pixels" | "image_b64", "model"?,
                        "deadline_ms"?, ...}: the workload's answer
                       (serve/workloads.py).  A shed answers 429 (with
                       ``Retry-After`` when the estimate is known), a
                       quarantined request 500, a batch failed at its
                       exec timeout 504, a bad payload 400,
                       ``image_b64`` 501 when PIL is missing.
                       ``?debug=1`` attaches the request's trace
    POST /v1/models/{name}/classify | /detect | /pose | /generate
                       the same with the model named in the path (a body
                       "model" must agree, else 400)
    POST /v1/models/{name}/reload | /promote | /rollback
                       the plane's lifecycle (503 without a plane; 409
                       when refused or in progress): reload {"force"?,
                       "wait"?} starts the load → shadow → canary walk
    POST /v1/drain     healthz flips to 503 "draining" at once, then
                       every engine finishes its admitted work
                       (``stop(drain_deadline=)``, body
                       {"drain_deadline_s"?: 10}) before the 200 reply

A verb that is not the model's workload answers 400 and names the right
route; an unknown route answers 404 with the supported verbs.
Bodies over ``max_body_bytes`` answer 413 before any buffer
is allocated (the edge dispatches such a request at once with an empty
body, and the handler's own Content-Length check answers it); a client
that stalls mid-body gets 408.  Two optional
front-end services hook the inference path: a content-addressed
response cache (``serve/cache.py``) and per-tenant QoS (the
``X-DVT-Tenant`` header, ``serve/admission.py TenantQoS``): the quota
is checked before the cache, the queue-pressure knee on cache misses
only.  With a cascade (serve/cascade.py) a request addressed to the big
tier's name goes through the router, its answer carries ``X-DVT-Tier``,
and its cache key holds the combined digest of every tier.  With the
brownout ladder (serve/brownout.py), L2 lets a cache miss answer from a
retired version's entry and the cascade serve below a hop's threshold,
both marked ``X-DVT-Degraded: 1``, and L3 floors the QoS queue pressure
so that every class but premium sheds.
"""

from __future__ import annotations

import base64
import io
import json
import math
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs

import numpy as np

from deep_vision_tpu_torch.obs.trace import REQUEST_ID_HEADER, new_request_id
from deep_vision_tpu_torch.serve.admission import TENANT_HEADER, Shed
from deep_vision_tpu_torch.serve.cache import ResponseCache, payload_digest
from deep_vision_tpu_torch.serve.cascade import base_tier as cascade_base_tier
from deep_vision_tpu_torch.serve.cascade import is_degraded as cascade_degraded
from deep_vision_tpu_torch.serve.edge import (
    _CHUNK_END,
    DEFAULT_MAX_CONNECTIONS,
    EdgeServer,
    _chunk_frame,
)
from deep_vision_tpu_torch.serve.faults import Quarantined
from deep_vision_tpu_torch.serve.workloads import LIFECYCLE_VERBS, WORKLOADS

#: request body cap (a 224×224×3 uint8 image is ~0.6 MB of JSON) and the
#: per-connection socket timeout
DEFAULT_MAX_BODY_BYTES = 32 * 2**20
SOCKET_TIMEOUT_S = 30.0
#: the listening socket's accept backlog (the reference edge's): the
#: socketserver default of 5 resets clients beyond it when dozens connect
#: at once
LISTEN_BACKLOG = 128
#: the cascade tier that produced a cascaded answer ("front", "t1", ...,
#: "big"), on every cascaded 200
TIER_HEADER = "X-DVT-Tier"
#: "1" on an answer the brownout ladder degraded on purpose: a cascade
#: tier's answer below its threshold, or a stale response-cache hit (L2)
DEGRADED_HEADER = "X-DVT-Degraded"


class ServeError(Exception):
    def __init__(self, status: int, message: str,
                 headers: dict | None = None):
        super().__init__(message)
        self.status = status
        self.headers = headers


def decode_pixels(body: dict, model) -> np.ndarray:
    """Body → one (H, W, C) input in the model's WIRE dtype.

    ``pixels`` decode straight to the wire dtype.  ``image_b64`` is an
    encoded image decoded with PIL and resized in integer space as the
    reference does: MNIST geometry for one channel (resize to size−4,
    pad 2), ``eval_transform_u8`` for classifiers, a square resize
    otherwise; a float32 wire then normalizes on the host like the
    reference.  Without PIL it answers 501."""
    wire = np.dtype(model.wire_dtype)
    if "pixels" in body:
        try:
            x = np.asarray(body["pixels"], wire)
        except (ValueError, TypeError, OverflowError) as e:
            # ragged lists, non-numeric entries, or NaN/Inf → integer
            raise ServeError(400, f"bad pixels payload: {e}") from e
        if x.ndim == 2 and model.input_shape[-1] == 1:
            x = x[..., None]
        if x.shape != model.input_shape:
            raise ServeError(400, f"pixels shape {list(x.shape)} != model "
                                  f"input {list(model.input_shape)}")
        if wire.kind == "f" and not np.isfinite(x).all():
            raise ServeError(400, "pixels contain non-finite values "
                                  "(NaN/Inf)")
        return x
    if "image_b64" in body:
        try:
            from PIL import Image
        except ImportError as e:
            raise ServeError(501, "image_b64 needs PIL on the server; "
                                  "send preprocessed 'pixels'") from e
        try:
            img = Image.open(io.BytesIO(base64.b64decode(
                body["image_b64"])))
            img.load()
        except (ValueError, TypeError, OSError) as e:
            raise ServeError(400, f"bad image_b64 payload: {e}") from e
        return _decode_image(img, model, wire)
    raise ServeError(400, "body needs 'pixels' or 'image_b64'")


def _decode_image(img, model, wire: np.dtype) -> np.ndarray:
    size = model.input_shape[0]
    if model.input_shape[-1] == 1:
        # grayscale models (LeNet): MNIST geometry in uint8
        arr = np.asarray(img.convert("L").resize((size - 4, size - 4)))
        u8 = np.pad(arr, 2)[:size, :size, None]
        if wire.kind == "u":
            return u8  # the device prologue scales and standardizes
        from deep_vision_tpu_torch.data.mnist import preprocess

        return preprocess(arr[None])[0][:size, :size]
    arr = np.asarray(img.convert("RGB"))
    if model.task == "classification":
        from deep_vision_tpu_torch.data.transforms import (
            eval_transform,
            eval_transform_u8,
            imagenet_resize_for,
        )

        if wire.kind == "u":
            return np.ascontiguousarray(eval_transform_u8(
                arr, size, imagenet_resize_for(size)))
        return eval_transform(arr, size, imagenet_resize_for(size))
    from deep_vision_tpu_torch.data.transforms import resize_bilinear

    u8 = resize_bilinear(arr, size, size)
    if wire.kind == "u":
        return np.asarray(u8, np.uint8)
    if str(model.task).startswith("gan_"):
        return u8.astype(np.float32) / 127.5 - 1.0
    return u8.astype(np.float32) / 255.0


def kernel_launches() -> dict:
    """Launch count of each hand-written kernel in this process."""
    from deep_vision_tpu_torch.ops.ingest import serve_ingest

    return {"serve_ingest": serve_ingest.launches}


def render_serve_metrics(stats: dict) -> str:
    """Serve stats → Prometheus text, both shapes: ``{model: engine
    stats}`` or the plane's ``{"models": {name: {"engine", "versions"}},
    "cache", "plane"}`` (which adds ``dvt_serve_model_up`` per version
    and the ``dvt_serve_weight_cache_*`` series).  The stats dicts stay
    the single source of truth."""
    from deep_vision_tpu_torch.core.metrics import PromText

    p = PromText()
    _render_front_metrics(p, stats)
    if isinstance(stats.get("batch"), dict):
        _render_batch_metrics(p, stats["batch"])
    if isinstance(stats.get("cascade"), dict):
        _render_cascade_metrics(p, stats["cascade"])
    if isinstance(stats.get("brownout"), dict):
        _render_brownout_metrics(p, stats["brownout"])
    if not isinstance(stats.get("models"), dict):
        for name, s in stats.items():
            if name not in _FRONT_BLOCKS:
                _render_engine_metrics(p, name, s)
        return p.render()
    for name, entry in stats["models"].items():
        if isinstance(entry.get("engine"), dict):
            _render_engine_metrics(p, name, entry["engine"])
        for v in entry.get("versions", []):
            p.gauge("dvt_serve_model_up",
                    1 if v.get("state") in ("active", "canary",
                                            "shadow") else 0,
                    {"model": name, "version": str(v.get("version")),
                     "state": str(v.get("state"))},
                    help="1 while this model version takes traffic")
    cache = stats.get("cache")
    if isinstance(cache, dict):
        p.gauge("dvt_serve_weight_cache_budget_bytes",
                cache.get("budget_bytes"), {},
                help="Device byte budget (0 = unbounded)")
        p.gauge("dvt_serve_weight_cache_resident_bytes",
                cache.get("resident_bytes"), {},
                help="Bytes of model weights resident on device")
        p.counter("dvt_serve_weight_cache_hits_total", cache.get("hits"),
                  {}, help="Batch launches finding weights resident")
        p.counter("dvt_serve_weight_cache_misses_total",
                  cache.get("misses"), {},
                  help="Launches that had to re-admit weights")
        p.counter("dvt_serve_weight_cache_evictions_total",
                  cache.get("evictions"), {},
                  help="LRU evictions (weights spilled to host)")
        p.counter("dvt_serve_weight_cache_admits_total",
                  cache.get("admits"), {},
                  help="Host→device weight re-admissions")
        p.counter("dvt_serve_weight_cache_spilled_bytes_total",
                  cache.get("spilled_bytes_total"), {},
                  help="Bytes D2H-copied at first eviction")
        for mname, ent in (cache.get("models") or {}).items():
            p.gauge("dvt_serve_weight_cache_resident",
                    1 if ent.get("resident") else 0, {"model": mname},
                    help="1 while this model's weights are on device")
    plane = stats.get("plane")
    if isinstance(plane, dict):
        p.counter("dvt_serve_reloads_total", plane.get("reloads"), {},
                  help="Reload lifecycles started")
        p.counter("dvt_serve_promotions_total", plane.get("promotions"),
                  {}, help="Versions auto- or operator-promoted")
        p.counter("dvt_serve_rollbacks_total", plane.get("rollbacks"), {},
                  help="Versions rolled back by gates or operator")
        p.counter("dvt_serve_reload_resubmitted_total",
                  plane.get("resubmitted"), {},
                  help="Requests transparently resubmitted across a "
                       "version swap")
        p.counter("dvt_serve_reverts_total", plane.get("reverts"), {},
                  help="One-command reverts to a prior promoted version")
    dep = stats.get("deploy")
    if isinstance(dep, dict):
        _render_deploy_metrics(p, dep)
    return p.render()


#: front-end stats blocks beside the per-model entries
_FRONT_BLOCKS = ("edge", "response_cache", "qos", "kernels", "cascade",
                 "brownout", "batch")


def _render_deploy_metrics(p, dep: dict) -> None:
    """The dvt_deploy_* series from ``DeployPipeline.stats()``."""
    hist = dep.get("history") or {}
    p.counter("dvt_deploy_history_records_total", hist.get("records"),
              {}, help="Deployment-ledger records appended")
    p.counter("dvt_deploy_history_write_errors_total",
              hist.get("write_errors"), {},
              help="Ledger appends that failed to reach disk")
    w = dep.get("watcher")
    if isinstance(w, dict):
        p.counter("dvt_deploy_watcher_polls_total", w.get("polls"), {},
                  help="Checkpoint-fingerprint polls")
        p.counter("dvt_deploy_watcher_debounces_total",
                  w.get("debounces"), {},
                  help="Candidates held one interval for stability")
        p.counter("dvt_deploy_deploys_total", w.get("deploys"), {},
                  help="Watcher-initiated rollouts that promoted")
        p.counter("dvt_deploy_gate_failures_total",
                  w.get("gate_failures"), {},
                  help="Candidates refused by the accuracy gate")
    for mname, a in (dep.get("autoscale") or {}).items():
        lab = {"model": mname}
        p.counter("dvt_deploy_scale_ups_total", a.get("scale_ups"),
                  lab, help="Autoscaler replica additions")
        p.counter("dvt_deploy_scale_downs_total", a.get("scale_downs"),
                  lab, help="Autoscaler replica drains")
        p.counter("dvt_deploy_scale_errors_total",
                  a.get("scale_errors"), lab,
                  help="Scale actions that raised (cooldown consumed)")
        p.gauge("dvt_deploy_pressure_ms", a.get("pressure_ms"), lab,
                help="queue_depth × exec EWMA — the scale-up signal")
        if a.get("occupancy") is not None:
            p.gauge("dvt_deploy_occupancy", a.get("occupancy"), lab,
                    help="Engine compute occupancy — the batchy-SLO "
                         "scale-up signal (queue depth misses "
                         "throughput saturation)")


def _render_front_metrics(p, stats: dict) -> None:
    """The front end's series: the selector edge's connection counters,
    the response cache, per-tenant-class QoS and the kernel launches."""
    edge = stats.get("edge")
    if isinstance(edge, dict):
        p.gauge("dvt_serve_open_connections",
                edge.get("open_connections"), {},
                help="Sockets currently open on the serving edge")
        p.gauge("dvt_serve_max_connections",
                edge.get("max_connections"), {},
                help="Connection cap (--max-connections)")
        p.counter("dvt_serve_edge_accepted_total", edge.get("accepted"),
                  {}, help="Connections accepted")
        p.counter("dvt_serve_edge_requests_total", edge.get("requests"),
                  {}, help="Requests parsed off edge connections")
        p.counter("dvt_serve_edge_keepalive_reuses_total",
                  edge.get("keepalive_reuses"), {},
                  help="Requests after the first on one connection")
        p.counter("dvt_serve_edge_evicted_idle_total",
                  edge.get("evicted_idle"), {},
                  help="Idle connections evicted to admit new ones")
        p.counter("dvt_serve_edge_accept_pauses_total",
                  edge.get("accept_pauses"), {},
                  help="Times the listener paused at the connection cap")
        p.counter("dvt_serve_edge_timeouts_408_total",
                  edge.get("timeouts_408"), {},
                  help="Stalled-body connections answered 408")
        p.counter("dvt_serve_edge_closed_idle_total",
                  edge.get("closed_idle"), {},
                  help="Idle/slow-loris connections closed silently")
    rcache = stats.get("response_cache")
    if isinstance(rcache, dict):
        p.counter("dvt_serve_cache_hits_total", rcache.get("hits"), {},
                  help="Inference answers served from the response cache")
        p.counter("dvt_serve_cache_misses_total", rcache.get("misses"),
                  {}, help="Cacheable lookups that missed")
        p.counter("dvt_serve_cache_stale_hits_total",
                  rcache.get("stale_hits"), {},
                  help="Brownout-L2 answers served from a retired "
                       "params version (marked X-DVT-Degraded)")
        p.counter("dvt_serve_cache_evictions_total",
                  rcache.get("evictions"), {},
                  help="LRU evictions from the response cache")
        p.counter("dvt_serve_cache_insertions_total",
                  rcache.get("insertions"), {},
                  help="Responses inserted into the cache")
        for tier, n in sorted(
                (rcache.get("insertions_by_tier") or {}).items()):
            p.counter("dvt_serve_cache_tier_insertions_total", n,
                      {"tier": str(tier)},
                      help="Cache inserts by the cascade tier that "
                           "produced the answer (the key itself stays "
                           "tier-agnostic)")
        p.gauge("dvt_serve_cache_bytes", rcache.get("bytes"), {},
                help="Bytes of cached serialized responses")
        p.gauge("dvt_serve_cache_entries", rcache.get("entries"), {},
                help="Entries in the response cache")
    qos = stats.get("qos")
    if isinstance(qos, dict):
        for cls, q in qos.items():
            lab = {"class": cls}
            p.counter("dvt_serve_tenant_served_total", q.get("served"),
                      lab, help="Requests served per tenant class")
            p.counter("dvt_serve_tenant_shed_total", q.get("shed_quota"),
                      {**lab, "reason": "quota"},
                      help="Requests shed by tenant QoS")
            p.counter("dvt_serve_tenant_shed_total",
                      q.get("shed_priority"),
                      {**lab, "reason": "priority"})
            p.counter("dvt_serve_tenant_cache_hits_total",
                      q.get("cache_hits"), lab,
                      help="Cache hits per tenant class")
            lat = q.get("latency") or {}
            for k in ("p50_ms", "p95_ms", "p99_ms"):
                p.gauge("dvt_serve_tenant_latency_seconds",
                        (lat.get(k) or 0.0) / 1e3,
                        {**lab, "quantile": k[1:-3]},
                        help="Per-class request latency quantiles")
    for kernel, n in (stats.get("kernels") or {}).items():
        p.counter("dvt_serve_kernel_launches_total", n, {"kernel": kernel},
                  help="Launches of each hand-written CUDA kernel")


def _render_batch_metrics(p, batch: dict) -> None:
    """The offline batch tier's dvt_batch_* series from the reserved
    ``batch`` stats block (the job store, the trough-filling scheduler
    and the occupancy-weighted MFU)."""
    jobs = batch.get("jobs") or {}
    sched = batch.get("scheduler") or {}
    p.counter("dvt_batch_jobs_submitted_total", jobs.get("submitted"),
              {}, help="Bulk jobs accepted via POST /v1/jobs")
    p.counter("dvt_batch_images_total", jobs.get("images_done"), {},
              help="Images with durable batch results (end-to-end "
                   "goodput; replayed checkpoint shards count once)")
    p.counter("dvt_batch_jobs_resumed_total", jobs.get("resumed"), {},
              help="Unfinished jobs resumed from the JSONL checkpoint "
                   "at boot")
    p.counter("dvt_batch_checkpoint_write_errors_total",
              jobs.get("write_errors"), {},
              help="Job-ledger appends that failed to reach disk")
    for state, n in (jobs.get("states") or {}).items():
        p.gauge("dvt_batch_jobs", n, {"state": state},
                help="Jobs by lifecycle state")
    p.counter("dvt_batch_shards_total", sched.get("shards_done"), {},
              help="Shards drained to a durable record this process")
    p.counter("dvt_batch_shards_shed_total", sched.get("shards_shed"),
              {}, help="Whole-shard retries after an engine shed")
    p.counter("dvt_batch_deferred_total", sched.get("deferred"), {},
              help="Trough checks that parked batch work behind "
                   "interactive pressure")
    p.counter("dvt_batch_frozen_deferred_total",
              sched.get("frozen_deferred"), {},
              help="Cohort admissions frozen outright at brownout L1+")
    p.gauge("dvt_batch_occupancy", sched.get("occupancy"), {},
            help="Fraction of the trailing window batch shards kept "
                 "an engine busy (the trough-filling duty cycle)")
    for mname, v in (batch.get("mfu_occupancy_weighted") or {}).items():
        p.gauge("dvt_batch_mfu_weighted", v, {"model": mname},
                help="serving MFU x engine compute occupancy — the "
                     "sustained-throughput MFU a saturating bulk job "
                     "should drive toward the interactive peak")


def _render_cascade_metrics(p, cas: dict) -> None:
    """The dvt_cascade_* series from the reserved ``cascade`` stats
    block (serve/cascade.py ``CascadeRouter.stats()``)."""
    lab = {"front": str(cas.get("front")), "big": str(cas.get("big"))}
    p.counter("dvt_cascade_escalations_total", cas.get("escalations"),
              lab, help="Requests a cheap tier escalated down the "
                        "chain (low confidence, tier errors, and "
                        "deadline-exhausted escalations)")
    for tier, n in sorted((cas.get("served") or {}).items()):
        p.counter("dvt_cascade_requests_total", n,
                  {**lab, "tier": tier},
                  help="Cascade requests answered, by the tier that "
                       "produced the answer")
    p.gauge("dvt_cascade_escalation_rate", cas.get("escalation_rate"),
            lab, help="Of requests the cheap tiers judged, the "
                      "fraction escalated — the live "
                      "cascade-economics gauge")
    # per-HOP threshold/agreement/calibrated series: each hop
    # calibrates tier-i-vs-big independently, so one scalar cannot
    # describe an N-tier chain
    for hop in (cas.get("hops") or []):
        hlab = {**lab, "hop": str(hop.get("hop")),
                "tier": str(hop.get("tier"))}
        p.gauge("dvt_cascade_threshold", hop.get("threshold"), hlab,
                help="Calibrated confidence threshold per hop (absent "
                     "while uncalibrated — fail-closed, that hop "
                     "escalates through)")
        cls_thr = hop.get("class_thresholds") or {}
        # None entries are fail-closed classes (measured-bad) — they
        # have no threshold value to chart
        vals = sorted(v for v in cls_thr.values() if v is not None)
        if vals:
            mid = vals[len(vals) // 2]
            p.gauge("dvt_cascade_class_threshold_min", vals[0], hlab,
                    help="Smallest per-class calibrated threshold at "
                         "this hop (per-class axis active)")
            p.gauge("dvt_cascade_class_threshold_median", mid, hlab,
                    help="Median per-class calibrated threshold at "
                         "this hop")
            p.gauge("dvt_cascade_class_threshold_max", vals[-1], hlab,
                    help="Largest per-class calibrated threshold at "
                         "this hop")
            p.gauge("dvt_cascade_class_thresholds", len(vals), hlab,
                    help="Classes with their own calibrated threshold "
                         "at this hop")
        p.gauge("dvt_cascade_hop_agreement", hop.get("agreement"),
                hlab, help="Tier-vs-big agreement over this hop's "
                           "live calibration sample")
        p.counter("dvt_cascade_hop_escalations_total",
                  hop.get("escalations"), hlab,
                  help="Requests this hop escalated onward")
    p.gauge("dvt_cascade_calibrated",
            1 if cas.get("calibrated") else 0, lab,
            help="1 while hop 0 holds a calibrated threshold")
    p.gauge("dvt_cascade_agreement", cas.get("agreement"), lab,
            help="Hop-0 tier-vs-big agreement over the live "
                 "calibration sample")
    p.counter("dvt_cascade_calibration_samples_total",
              cas.get("samples"), lab,
              help="Dual-run calibration samples taken")
    p.counter("dvt_cascade_forced_big_total", cas.get("forced_big"),
              lab, help="Requests routed straight to the big tier for "
                        "always-big QoS tenants")
    p.counter("dvt_cascade_recalibrations_total", cas.get("resets"),
              lab, help="Calibration drops after a tier version swap")
    p.counter("dvt_cascade_samples_paused_total",
              cas.get("samples_paused"), lab,
              help="Dual-run calibration samples skipped at brownout "
                   "L1+ (optional work shed first)")
    p.counter("dvt_cascade_degraded_served_total",
              cas.get("degraded_served"), lab,
              help="Sub-threshold front answers forced at brownout L2 "
                   "(marked X-DVT-Degraded)")
    p.gauge("dvt_cascade_restored",
            1 if cas.get("restored") else 0, lab,
            help="1 when this boot's calibration was restored from "
                 "the persisted ledger")
    p.counter("dvt_cascade_ledger_write_errors_total",
              cas.get("ledger_write_errors"), lab,
              help="Calibration-ledger appends that failed to reach "
                   "disk")
    for tier, hist in (cas.get("latency_hist") or {}).items():
        if hist:
            p.histogram("dvt_cascade_latency_seconds", hist,
                        {**lab, "tier": tier},
                        help="End-to-end cascade request latency by "
                             "answering tier (escalations land in "
                             "'big' and include the front attempt)")


def _render_brownout_metrics(p, bo: dict) -> None:
    """The dvt_brownout_* series from the reserved ``brownout`` stats
    block (serve/brownout.py ``BrownoutController.stats()``)."""
    p.gauge("dvt_brownout_level", bo.get("level"), {},
            help="Degradation ladder level: 0 normal, 1 shed-optional, "
                 "2 degrade-quality, 3 hard-shed")
    p.gauge("dvt_brownout_forced",
            -1 if bo.get("forced") is None else bo.get("forced"), {},
            help="Operator-pinned level (-1 = signals in control)")
    p.counter("dvt_brownout_transitions_total",
              bo.get("transitions_up"), {"direction": "up"},
              help="Edge-triggered ladder level changes")
    p.counter("dvt_brownout_transitions_total",
              bo.get("transitions_down"), {"direction": "down"})
    for lvl, n in sorted((bo.get("level_entries") or {}).items()):
        p.counter("dvt_brownout_level_entries_total", n,
                  {"level": str(lvl)},
                  help="Times the ladder entered each level going up")
    sig = bo.get("signals") or {}
    p.gauge("dvt_brownout_pressure_ms", sig.get("pressure_ms"), {},
            help="Max queue_depth x bucket exec EWMA across engines — "
                 "the engage signal")
    p.gauge("dvt_brownout_occupancy", sig.get("occupancy"), {},
            help="Max engine compute duty cycle at the last tick")
    p.gauge("dvt_brownout_shed_rate", sig.get("shed_rate"), {},
            help="Admission sheds / offered over the last tick window")
    p.counter("dvt_brownout_ticks_total", bo.get("ticks"), {},
              help="Ladder decisions taken")
    p.counter("dvt_brownout_signal_errors_total",
              bo.get("signal_errors"), {},
              help="Engine signal reads that raised mid-teardown")


def _render_engine_metrics(p, name: str, s: dict) -> None:
    """One engine's dvt_serve_* series (both shapes)."""
    lab = {"model": name}
    p.gauge("dvt_serve_weight_hbm_bytes", s.get("weight_hbm_bytes"), lab,
            help="Byte footprint of the served weights on the device "
                 "(int8 models report the quantized size)")
    p.gauge("dvt_serve_param_shard_bytes", s.get("param_shard_bytes"), lab,
            help="PER-CHIP addressable weight bytes (a mesh view prices "
                 "one chip's shard, not the global logical size)")
    mesh = s.get("mesh_shape")
    if isinstance(mesh, dict):
        for axis, size in mesh.items():
            p.gauge("dvt_serve_mesh_shape", size,
                    {**lab, "axis": str(axis)},
                    help="Serving mesh axis sizes (data/model); absent "
                         "off-mesh")
    p.counter("dvt_serve_requests_submitted_total", s["submitted"], lab,
              help="Requests entering submit (incl. shed)")
    p.counter("dvt_serve_requests_served_total", s["served"], lab,
              help="Requests served a model output")
    p.counter("dvt_serve_batches_total", s["batches"], lab,
              help="Executed batches (incl. retry executions)")
    p.counter("dvt_serve_compiles_total", s["compiles"], lab,
              help="Bucket callables built")
    p.counter("dvt_serve_padded_images_total", s["padded_images"], lab,
              help="Pad rows executed beyond live requests")
    p.gauge("dvt_serve_queue_depth", s["queue_depth"], lab,
            help="Requests queued awaiting batch formation")
    routing = s.get("routing")
    if isinstance(routing, dict):
        p.gauge("dvt_serve_replicas", routing.get("replicas"), lab,
                help="Replica slots ever provisioned (append-only)")
        p.gauge("dvt_serve_live_replicas", routing.get("live_replicas"),
                lab, help="Non-retired replicas (the elastic capacity)")
        p.counter("dvt_serve_replicas_added_total",
                  routing.get("replicas_added"), lab,
                  help="Scale-up replica additions")
        p.counter("dvt_serve_replicas_removed_total",
                  routing.get("replicas_removed"), lab,
                  help="Scale-down replica retirements")
    adm = s.get("admission", {})
    h = s.get("health", {})
    p.counter("dvt_serve_shed_total", adm.get("shed_queue_full"),
              {**lab, "reason": "queue_full"},
              help="Requests shed at admission or formation")
    p.counter("dvt_serve_shed_total", adm.get("shed_deadline"),
              {**lab, "reason": "deadline"})
    p.counter("dvt_serve_shed_total", h.get("shed_shutdown"),
              {**lab, "reason": "shutdown"})
    p.counter("dvt_serve_batch_failures_total", h.get("batch_failures"),
              lab, help="Dispatched/drained cohorts that raised")
    p.counter("dvt_serve_retry_executions_total",
              h.get("retry_executions"), lab,
              help="Bisect-retry sub-cohort executions")
    p.counter("dvt_serve_quarantined_total", h.get("quarantined"), lab,
              help="Requests isolated as poison")
    p.counter("dvt_serve_exec_timeouts_total", h.get("exec_timeouts"),
              lab, help="In-flight windows fast-failed by the watchdog")
    p.counter("dvt_serve_watchdog_restarts_total",
              h.get("watchdog_restarts"), lab,
              help="Worker-thread restarts by supervision")
    p.gauge("dvt_serve_up", 1 if h.get("can_serve") else 0, lab,
            help="1 while this engine can serve (healthz 200)")
    pipe = s.get("pipeline", {})
    p.gauge("dvt_serve_inflight", pipe.get("inflight"), lab,
            help="Dispatched-but-undrained batches")
    p.gauge("dvt_serve_occupancy", pipe.get("occupancy"), lab,
            help="Compute duty cycle over the trailing window")
    p.counter("dvt_serve_h2d_transfers_total", pipe.get("h2d_transfers"),
              lab, help="Staged-batch host-to-device transfers")
    p.counter("dvt_serve_h2d_bytes_total", pipe.get("h2d_bytes"), lab,
              help="Wire-format bytes shipped to the device")
    wl = s.get("workload")
    p.counter("dvt_serve_d2h_bytes_total", pipe.get("d2h_bytes"),
              {**lab, "workload": wl} if wl else lab,
              help="Output bytes copied back to the host")
    for b, ms in (adm.get("exec_ewma_ms_by_bucket") or {}).items():
        p.gauge("dvt_serve_exec_ewma_seconds", ms / 1e3,
                {**lab, "bucket": b}, help="Per-bucket batch execution EWMA")
    p.gauge("dvt_serve_img_per_sec", s.get("img_per_sec"), lab,
            help="Served images per second (post-warmup)")
    if "latency_hist" in s:
        p.histogram("dvt_serve_request_latency_seconds", s["latency_hist"],
                    lab, help="Submit-to-result latency")
    mfu = s.get("mfu") or {}
    p.gauge("dvt_serve_mfu", mfu.get("serving_mfu"), lab,
            help="Model FLOPs utilization of the compute stage (counted "
                 "FLOPs / measured compute time / peak)")
    p.counter("dvt_serve_compute_seconds_total", mfu.get("compute_s"), lab,
              help="Measured device-occupancy seconds")
    p.counter("dvt_serve_flops_total", mfu.get("flops_total"), lab,
              help="Counted FLOPs executed")
    tr = s.get("trace") or {}
    p.counter("dvt_serve_traces_started_total", tr.get("started"), lab,
              help="Spans started")
    p.counter("dvt_serve_traces_finished_total", tr.get("finished"), lab,
              help="Spans sealed into the ring")
    p.counter("dvt_serve_slow_traces_total", tr.get("slow_sampled"), lab,
              help="Traces over the slow-request threshold")
    p.counter("dvt_serve_slow_suppressed_total",
              tr.get("slow_suppressed"), lab,
              help="Slow-trace emissions dropped at brownout L1+ "
                   "(ring and stage sums still record)")
    for stage, secs in (tr.get("stage_s_total") or {}).items():
        p.counter("dvt_serve_stage_seconds_total", secs,
                  {**lab, "stage": stage},
                  help="Cumulative per-stage span time")


class _Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    _rid = None
    _span = None
    _cache_hit = False
    _tier = None  # the cascade tier that answered ("front", ..., "big")
    _degraded = False  # True when the brownout ladder degraded the answer
    # chunked replies: the edge's shim sets _edge_stream, and
    # _reply_stream then parks the body generator on _stream for the
    # event loop to pump (serve/edge.py); without it the frames are
    # written inline
    _edge_stream = False
    _stream = None

    def setup(self):
        # thread server only (the edge's shim never calls setup(), and
        # applies the same deadlines in its loop): a timeout on the
        # request line closes the connection; one mid-body raises
        # TimeoutError in do_POST (answered 408)
        self.timeout = self.server.socket_timeout_s
        super().setup()

    def log_message(self, fmt, *args):
        # per-request access log on stderr only with --verbose
        if self.server.verbose:
            super().log_message(fmt, *args)

    def _reply(self, status: int, payload: dict,
               headers: dict | None = None):
        self._reply_raw(status, json.dumps(payload).encode(),
                        "application/json", headers)

    def _reply_raw(self, status: int, blob: bytes, ctype: str,
                   headers: dict | None = None):
        self.send_response(status)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(blob)))
        if self._rid is not None:
            self.send_header(REQUEST_ID_HEADER, self._rid)
        for k, v in (headers or {}).items():
            self.send_header(k, str(v))
        self.end_headers()
        self.wfile.write(blob)

    def _reply_stream(self, status: int, chunks):
        """A chunked NDJSON reply of the byte pieces ``chunks`` yields.
        Under the edge the generator goes to the event loop, which
        frames and flushes each piece as the worker produces it, so a
        result set larger than any buffer streams in O(1) memory; under
        the thread server the same frames are written to the socket
        here."""
        self.send_response(status)
        self.send_header("Content-Type", "application/x-ndjson")
        self.send_header("Transfer-Encoding", "chunked")
        if self._rid is not None:
            self.send_header(REQUEST_ID_HEADER, self._rid)
        self.end_headers()
        if self._edge_stream:
            self._stream = chunks
            return
        for piece in chunks:
            if piece:
                self.wfile.write(_chunk_frame(piece))
        self.wfile.write(_CHUNK_END)

    def _body(self) -> dict:
        return self._parse(self._read_body())

    def _read_body(self) -> bytes:
        length = int(self.headers.get("Content-Length") or 0)
        if length <= 0:
            raise ServeError(400, "empty body")
        cap = self.server.max_body_bytes
        if length > cap:
            # reject BEFORE reading an attacker-sized body; the unread
            # body would desync keep-alive, so close the connection
            self.close_connection = True
            raise ServeError(413, f"body of {length} bytes exceeds the "
                                  f"{cap}-byte cap")
        return self.rfile.read(length)

    @staticmethod
    def _parse(raw: bytes) -> dict:
        try:
            body = json.loads(raw)
        except json.JSONDecodeError as e:
            raise ServeError(400, f"bad JSON: {e}") from e
        if not isinstance(body, dict):
            raise ServeError(400, "body must be a JSON object")
        return body

    def _optional_body(self) -> dict:
        length = int(self.headers.get("Content-Length") or 0)
        return self._body() if length > 0 else {}

    def _engine(self, name: str | None):
        """The target model and its engine; the plane's routing table
        answers when one is wired.  A miss answers 404 with
        ``KeyError.args[0]``."""
        plane = self.server.plane
        try:
            if plane is not None:
                model = plane.resolve(name)
                return model, plane.active_engine(model.name)
            model = self.server.registry.get(name)
        except KeyError as e:
            raise ServeError(404, e.args[0]) from e
        return model, self.server.engines[model.name]

    @staticmethod
    def _shed_429(shed: Shed) -> ServeError:
        headers = None
        if shed.retry_after_s:
            headers = {"Retry-After": max(1, math.ceil(shed.retry_after_s))}
        return ServeError(429, f"shed: {shed.reason} {shed.detail}",
                          headers=headers)

    def _infer_row(self, model, engine, body: dict):
        """decode → engine (or the plane's routing) → one row."""
        wl = model.workload
        if engine.faults.enabled:
            engine.faults.inject("decode")
        try:
            x = wl.decode(body, model)
        except ValueError as e:
            raise ServeError(400, str(e)) from e
        if x is None:
            x = decode_pixels(body, model)
        if self._span is not None:
            self._span.mark("decode")
        try:
            deadline_ms = float(body.get("deadline_ms",
                                         wl.slo.deadline_ms))
        except (TypeError, ValueError) as e:
            raise ServeError(400, f"bad deadline_ms: {e}") from e
        plane = self.server.plane
        cascade = self.server.cascade
        try:
            if cascade is not None and plane is not None \
                    and cascade.serves(model.name):
                # the cheapest confident tier answers; an escalation
                # keeps what is left of the ORIGINAL deadline, and an
                # always-big tenant skips the cheap tiers
                qos = self.server.qos
                force_big = qos is not None and qos.class_of(
                    self.headers.get(TENANT_HEADER) or "").always_big
                self._tier, result = cascade.infer(
                    x, deadline_ms=deadline_ms, span=self._span,
                    force_big=bool(force_big))
                if cascade_degraded(self._tier):
                    # brownout L2 served a tier below its threshold: the
                    # header names the tier, the marker the caveat
                    self._tier = cascade_base_tier(self._tier)
                    self._degraded = True
            elif plane is not None:
                # canary/shadow splits and cross-version resubmission
                # happen behind this call
                result = plane.infer(model.name, x, deadline_ms=deadline_ms,
                                     span=self._span)
            else:
                result = engine.infer(x, deadline_ms=deadline_ms,
                                      span=self._span)
        except TimeoutError as e:
            # a batch the watchdog failed at its exec timeout (or a wait
            # past the handler's own limit): the server, not the client,
            # timed out
            raise ServeError(504, f"{type(e).__name__}: {e}") from e
        if isinstance(result, Shed):
            raise self._shed_429(result)
        if isinstance(result, Quarantined):
            raise ServeError(
                500, f"quarantined: {result.reason} {result.detail}")
        return result

    def _infer_route(self, verb: str, path_model: str | None,
                     debug: bool) -> bytes:
        """The inference POST path → the serialized 200 body.  Order:
        tenant quota (before the cache, so a hot payload cannot make
        quotas unenforceable) → response-cache lookup (at brownout L2 an
        exact miss may answer from a retired version's entry) →
        queue-pressure shedding (misses only; floored at L3) → engine or
        cascade → cache insert (200s only, and not while a canary may
        have answered).

        The path form (``/v1/models/<name>/<verb>``) parses its JSON body
        only once the request is admitted: the cache key is the raw
        bytes' digest and the tenant is a header, so a hit or a shed
        costs no parse of a pixel body, interpreter time that a herd of
        shed clients would otherwise take from the admitted requests.
        ``/v1/<verb>`` names its model in the body and parses first.  A departure from the reference, which parses
        before the quota: a shed malformed body answers 429, not 400."""
        span = self._span
        qos = self.server.qos
        bo = self.server.brownout
        raw = self._read_body()
        tenant = ""
        t0 = time.monotonic()
        if qos is not None:
            tenant = self.headers.get(TENANT_HEADER) or ""
            shed = qos.check_quota(tenant)
            if shed is not None:
                raise self._shed_429(shed)
        body = self._parse(raw) if path_model is None else None
        model, engine = self._engine(
            path_model if body is None else body.get("model"))
        # the verb names the workload; the model's task must serve it,
        # checked before the request costs a cache entry or a batch slot
        if model.workload.verb != verb:
            raise ServeError(400, f"'{model.name}' is a {model.task} "
                                  f"model; use /v1/{model.workload.verb}")
        wl = model.workload
        cache = self.server.response_cache
        cascade = self.server.cascade
        if cascade is not None and not cascade.serves(model.name):
            cascade = None
        # a cascaded model keys on the COMBINED digest of every tier: a
        # hit is tier-free (any tier's answer meets the contract) and a
        # reload of any tier invalidates
        digest = cascade.params_digest() if cascade is not None \
            else model.params_digest
        key = None
        if cache is not None and not debug and digest:
            key = ResponseCache.key(f"/v1/{verb}", model.name, digest,
                                    str(model.wire_dtype), model.infer_dtype,
                                    payload_digest(raw))
            blob = cache.get(key)
            if blob is None and bo is not None and bo.at_least(2):
                # brownout L2: a miss may still have an answer under a
                # PRIOR params version, stale but well-formed
                blob = cache.get_stale(key)
                if blob is not None:
                    self._degraded = True
            if blob is not None:
                self._cache_hit = True
                if span is not None:
                    span.mark("cache_hit")
                if qos is not None:
                    qos.record_served(tenant, time.monotonic() - t0,
                                      cache_hit=True)
                return blob
        if qos is not None:
            shed = qos.check_pressure(
                tenant, engine.queue_depth, engine.admission.max_queue,
                floor=bo.qos_pressure_floor() if bo is not None else 0.0)
            if shed is not None:
                raise self._shed_429(shed)
        if body is None:
            body = self._parse(raw)
            # the PATH name wins; a body "model" must agree with it
            name = body.get("model")
            if name is not None and name != path_model:
                raise ServeError(400, f"body model '{name}' contradicts "
                                      f"path model '{path_model}'")
        try:
            params = {}
            if verb == "classify":
                params = {"top_k": int(body.get("top_k", 5))}
            elif verb == "detect" and "score_threshold" in body:
                params = {"score_threshold": float(body["score_threshold"])}
        except (TypeError, ValueError) as e:
            raise ServeError(400, f"bad request parameter: {e}") from e
        payload = wl.respond(model, params,
                             self._infer_row(model, engine, body))
        if span is not None:
            span.mark("respond")
            if debug:
                payload["trace"] = span.to_dict()
        blob = json.dumps(payload).encode()
        plane = self.server.plane
        # during a canary window this answer may be the candidate's (of
        # any tier, for a cascade): filed under the active digest it
        # would poison the cache
        paused = cascade.canary_active() if cascade is not None else (
            plane is not None and plane.canary_active(model.name))
        if key is not None and wl.cacheable(len(blob)) and not paused:
            cache.put(key, blob, tier=self._tier)
        if qos is not None:
            qos.record_served(tenant, time.monotonic() - t0)
        return blob

    def _stats(self) -> dict:
        srv = self.server
        if srv.plane is not None:
            stats = srv.plane.stats()
            if srv.deploy is not None:
                stats["deploy"] = srv.deploy.stats()
        else:
            stats = {name: eng.stats() for name, eng in srv.engines.items()}
        edge_stats = getattr(srv, "stats", None)
        if callable(edge_stats):
            stats["edge"] = edge_stats()
        if srv.response_cache is not None:
            stats["response_cache"] = srv.response_cache.stats()
        if srv.qos is not None:
            stats["qos"] = srv.qos.stats()
        if srv.brownout is not None:
            stats["brownout"] = srv.brownout.stats()
        self._add_batch_block(stats)
        if srv.cascade is not None:
            stats["cascade"] = srv.cascade.stats()
        stats["kernels"] = kernel_launches()
        return stats

    def _add_batch_block(self, stats: dict) -> None:
        """The batch tier's reserved ``batch`` block, when it is on: the
        job store's and the scheduler's stats, and per model the serving
        MFU times the engine's occupancy (the sustained-throughput MFU a
        saturating bulk job should push toward the interactive MFU)."""
        store = self.server.jobs
        if store is None:
            return
        from deep_vision_tpu_torch.obs.mfu import round_mfu

        sched = self.server.batch_sched
        block = {"jobs": store.stats(),
                 "scheduler": sched.stats() if sched is not None
                 else None}
        models = stats.get("models")
        if isinstance(models, dict):
            eng_stats = {n: e.get("engine") for n, e in models.items()}
        else:
            eng_stats = {n: s for n, s in stats.items()
                         if isinstance(s, dict) and "pipeline" in s}
        weighted = {}
        for name, s in eng_stats.items():
            if not isinstance(s, dict):
                continue
            mfu = (s.get("mfu") or {}).get("serving_mfu")
            occ = (s.get("pipeline") or {}).get("occupancy")
            if mfu is not None and occ is not None:
                weighted[name] = round_mfu(mfu * occ)
        block["mfu_occupancy_weighted"] = weighted
        stats["batch"] = block

    def _job_results_ndjson(self, job_id: str):
        """The results stream's body: one JSON line an item of the
        contiguous completed shard prefix, in manifest order, then a
        ``{"status": ...}`` line that tells "all delivered" from
        "drained so far"."""
        store = self.server.jobs
        for idx, item in store.results_items(job_id):
            yield json.dumps({"index": idx, **item}).encode() + b"\n"
        yield json.dumps({"status": store.status(job_id)}).encode() \
            + b"\n"

    def _jobs_get(self, path: str) -> None:
        store = self.server.jobs
        if store is None:
            self._reply(503, {"error": "batch jobs are not enabled "
                                       "(cli.serve --jobs-dir ...)"})
            return
        parts = path.split("/")
        if len(parts) == 3:  # /v1/jobs
            self._reply(200, {"jobs": store.jobs()})
            return
        try:
            status = store.status(parts[3])
        except KeyError:
            self._reply(404, {"error": f"no job '{parts[3]}'"})
            return
        if len(parts) == 4:  # /v1/jobs/<id>
            self._reply(200, status)
        elif len(parts) == 5 and parts[4] == "results":
            self._reply_stream(200, self._job_results_ndjson(parts[3]))
        else:
            self._reply(404, {"error": f"no route {self.path}"})

    def _jobs_post(self) -> tuple:
        """POST /v1/jobs → (status, payload): check the manifest, resolve
        the model as an interactive body would, persist the job and kick
        the scheduler.  202: the reply is the job's handle; its results
        come from the trough-filling drain."""
        store = self.server.jobs
        if store is None:
            return 503, {"error": "batch jobs are not enabled "
                                  "(cli.serve --jobs-dir ...)"}
        body = self._body()
        items = body.get("items")
        if not isinstance(items, list) or not items:
            raise ServeError(
                400, "manifest 'items' must be a non-empty list of "
                     "request bodies")
        shard_size = body.get("shard_size")
        if shard_size is not None:
            try:
                shard_size = int(shard_size)
            except (TypeError, ValueError) as e:
                raise ServeError(
                    400, f"bad shard_size: {body['shard_size']!r}") from e
            if shard_size <= 0:
                raise ServeError(400, "shard_size must be >= 1")
        model, _ = self._engine(body.get("model"))
        view = store.submit(model.name, model.workload.verb, items,
                            shard_size)
        sched = self.server.batch_sched
        if sched is not None:
            sched.kick()
        return 202, view

    def _models_with_cascade(self, models: dict) -> dict:
        """/v1/models entries, a cascade member's with the router's
        ``cascade`` block (chain, hop role, threshold source)."""
        cascade = self.server.cascade
        if cascade is not None:
            for name, entry in models.items():
                block = cascade.describe_member(name)
                if block is not None:
                    entry["cascade"] = block
        return models

    def do_GET(self):
        path, _, query = self.path.partition("?")
        srv = self.server
        if path == "/v1/healthz":
            if srv.draining:
                # draining outranks engine health: traffic must move
                # away BEFORE the engines finish their in-flight work
                self._reply(503, {"status": "draining",
                                  "models": srv.registry.names()})
                return
            engines = srv.plane.active_engines() \
                if srv.plane is not None else srv.engines
            reports = {name: eng.health_report()
                       for name, eng in engines.items()}
            healthy = all(r["can_serve"] for r in reports.values())
            self._reply(200 if healthy else 503,
                        {"status": "ok" if healthy else "unhealthy",
                         "models": srv.registry.names(),
                         "engines": reports})
        elif path == "/v1/stats":
            self._reply(200, self._stats())
        elif path == "/metrics":
            self._reply_raw(200, render_serve_metrics(self._stats()).encode(),
                            "text/plain; version=0.0.4; charset=utf-8")
        elif path == "/v1/models":
            if srv.plane is not None:
                self._reply(200, {"models": self._models_with_cascade(
                    srv.plane.models())})
                return
            self._reply(200, {"models": self._models_with_cascade({
                name: {"model": srv.registry.get(name).describe()}
                for name in srv.registry.names()})})
        elif path == "/v1/brownout":
            if srv.brownout is None:
                self._reply(503, {"error": "brownout controller is not "
                                           "enabled (cli.serve "
                                           "--brownout)"})
                return
            self._reply(200, srv.brownout.stats())
        elif path == "/v1/jobs" or path.startswith("/v1/jobs/"):
            self._jobs_get(path)
        elif path == "/v1/traces":
            try:
                n = int(parse_qs(query).get("n", ["32"])[0])
            except ValueError:
                self._reply(400, {"error": "n must be an integer"})
                return
            self._reply(200, {"traces": srv.tracer.recent(n),
                              "summary": srv.tracer.summary()})
        else:
            parts = path.split("/")
            if len(parts) == 5 and parts[1] == "v1" \
                    and parts[2] == "deploy" and parts[4] == "history":
                self._reply(*self._deploy_history(parts[3],
                                                  parse_qs(query)))
                return
            self._reply(404, {"error": f"no route {self.path}"})

    def do_POST(self):
        path, _, query = self.path.partition("?")
        debug = parse_qs(query).get("debug", ["0"])[0] not in ("", "0")
        self._rid = self.headers.get(REQUEST_ID_HEADER) or new_request_id()
        tracer = self.server.tracer
        span = self._span = tracer.start(self._rid, origin="recv")
        self._cache_hit = False
        try:
            if path == "/v1/drain":
                self._reply(200, self._drain())
                return
            if path == "/v1/jobs":
                self._reply(*self._jobs_post())
                return
            if path == "/v1/brownout":
                self._reply(*self._brownout_post())
                return
            self._tier = None
            self._degraded = False
            path_model, verb = None, None
            parts = path.split("/")
            if len(parts) == 5 and parts[1] == "v1" \
                    and parts[2] == "models":
                path_model, verb = parts[3], parts[4]
                if verb in LIFECYCLE_VERBS:
                    self._reply(*self._lifecycle(path_model, verb))
                    return
            elif len(parts) == 5 and parts[1] == "v1" \
                    and parts[2] == "deploy" and parts[4] == "revert":
                self._reply(*self._deploy_revert(parts[3]))
                return
            elif len(parts) == 3 and parts[1] == "v1":
                verb = parts[2]
            if verb not in WORKLOADS:
                self._body()  # consistent 400/413 on empty/oversized bodies
                self._reply(404, {"error": f"no route {self.path}",
                                  "supported_verbs": sorted(WORKLOADS)})
                return
            blob = self._infer_route(verb, path_model, debug)
            headers = {}
            if self._cache_hit:
                headers["X-DVT-Cache"] = "hit"
            if self._tier is not None:
                headers[TIER_HEADER] = self._tier
            if self._degraded:
                headers[DEGRADED_HEADER] = "1"
            self._reply_raw(200, blob, "application/json", headers or None)
        except ServeError as e:
            self._reply(e.status, {"error": str(e)}, headers=e.headers)
        except TimeoutError:
            # client stalled mid-body: answer 408 and drop the connection
            self.close_connection = True
            self._reply(408, {"error": "timed out reading request body"})
        except Exception as e:  # noqa: BLE001 — surface, don't kill the handler thread
            self._reply(500, {"error": f"{type(e).__name__}: {e}"})
        finally:
            tracer.finish(span)
            self._span = None
            self._rid = None

    def _drain(self) -> dict:
        """Flip healthz to draining, then finish admitted work.  The
        flag flips BEFORE any engine stops, so probes see 503 while
        in-flight requests complete; a second drain is a no-op reply."""
        try:
            deadline = float(self._optional_body().get("drain_deadline_s",
                                                       10.0))
        except (TypeError, ValueError) as e:
            raise ServeError(400, f"bad drain_deadline_s: {e}") from e
        srv = self.server
        with srv.drain_lock:
            already = srv.draining
            srv.draining = True
            if not already:
                if srv.plane is not None:
                    # every version, and any reload worker in flight
                    srv.plane.stop(drain_deadline=deadline)
                else:
                    for eng in srv.engines.values():
                        eng.stop(drain_deadline=deadline)
        return {"status": "draining", "already_draining": already,
                "drain_deadline_s": deadline}

    def _brownout_post(self) -> tuple:
        """POST /v1/brownout → (status, payload): the operator override.
        {"force": 0..3} pins the ladder at a level, {"force": null} hands
        it back to the signals; the reply is the controller's stats."""
        bo = self.server.brownout
        if bo is None:
            return 503, {"error": "brownout controller is not enabled "
                                  "(cli.serve --brownout)"}
        body = self._body()
        if "force" not in body:
            raise ServeError(400, "body needs 'force': 0..3 to pin the "
                                  "ladder, null to release")
        force = body["force"]
        if force is not None:
            try:
                force = int(force)
            except (TypeError, ValueError) as e:
                raise ServeError(
                    400, f"bad force level: {body['force']!r}") from e
        bo.force(force)
        return 200, bo.stats()

    def _lifecycle(self, name: str, verb: str) -> tuple:
        """POST /v1/models/<name>/reload|promote|rollback → (status,
        payload); these need the control plane."""
        plane = self.server.plane
        if plane is None:
            return 503, {"error": f"/v1/models/{name}/{verb} needs the "
                                  f"model control plane (cli.serve "
                                  f"--models ...)"}
        body = self._optional_body()
        try:
            if verb == "reload":
                out = plane.reload(name, force=bool(body.get("force", False)),
                                   wait=bool(body.get("wait", False)))
            elif verb == "promote":
                out = plane.promote(name)
            else:
                out = plane.rollback(name)
        except KeyError as e:
            return 404, {"error": e.args[0]}
        return (409 if out.get("status") in ("refused", "in_progress")
                else 200), out

    def _deploy_history(self, name: str, params: dict) -> tuple:
        """GET /v1/deploy/<name>/history → (status, payload): the ledger
        tail of one model, 503 without a deploy pipeline."""
        deploy = self.server.deploy
        if deploy is None:
            return 503, {"error": f"/v1/deploy/{name}/history needs the "
                                  f"deploy pipeline (cli.serve --watch "
                                  f"or --max-replicas)"}
        try:
            n = int(params.get("n", ["0"])[0]) or None
        except ValueError:
            return 400, {"error": "n must be an integer"}
        try:
            entries = deploy.entries(name, n)
        except KeyError as e:
            return 404, {"error": e.args[0]}
        return 200, {"model": name, "entries": entries}

    def _deploy_revert(self, name: str) -> tuple:
        """POST /v1/deploy/<name>/revert → (status, payload): reverted
        200, a lifecycle in flight or nothing to revert to 409, a boot
        failure 500."""
        deploy = self.server.deploy
        if deploy is None:
            return 503, {"error": f"/v1/deploy/{name}/revert needs the "
                                  f"deploy pipeline (cli.serve --watch "
                                  f"or --max-replicas)"}
        self._optional_body()  # drain: revert takes no parameters
        try:
            out = deploy.revert(name)
        except KeyError as e:
            return 404, {"error": e.args[0]}
        status = out.get("status")
        if status in ("refused", "in_progress"):
            return 409, out
        return (500 if status == "failed" else 200), out


class _HTTPServer(ThreadingHTTPServer):
    daemon_threads = True
    request_queue_size = LISTEN_BACKLOG


class ServeServer:
    """HTTP front-end wired to a registry + one engine per model, or to
    the model control plane (``plane``; ``engines`` is then the plane's
    boot-time active engines, used only for the tracer) and, with it,
    the deploy pipeline (``deploy``: ledger, watcher, autoscalers) and
    the cascade router (``cascade``).  ``brownout`` is the ladder the
    request path probes (stale cache hits, the L3 QoS floor).  ``jobs``
    and ``batch_sched`` are the offline batch tier behind ``/v1/jobs``
    (the job store and the scheduler a submit kicks); None turns it off.

    ``edge=True`` (default) runs the selector event loop of
    ``serve/edge.py`` with ``http_workers`` handler threads and at most
    ``max_connections`` open sockets; ``edge=False`` keeps the
    thread-per-request ``ThreadingHTTPServer``.  Both listen with a
    backlog of ``LISTEN_BACKLOG`` and carry the same context
    attributes, so ``self.httpd`` is the one handle either way."""

    def __init__(self, registry, engines: dict, host: str = "127.0.0.1",
                 port: int = 0,
                 max_body_bytes: int = DEFAULT_MAX_BODY_BYTES,
                 socket_timeout_s: float | None = SOCKET_TIMEOUT_S,
                 tracer=None, plane=None, response_cache=None, qos=None,
                 deploy=None, cascade=None, brownout=None,
                 jobs=None, batch_sched=None, edge: bool = True,
                 max_connections: int = DEFAULT_MAX_CONNECTIONS,
                 http_workers: int = 8, verbose: bool = False):
        if edge:
            self.httpd = EdgeServer((host, port), _Handler,
                                    max_connections=max_connections,
                                    workers=http_workers, name="serve")
        else:
            self.httpd = _HTTPServer((host, port), _Handler)
        self.httpd.registry = registry
        self.httpd.engines = engines
        self.httpd.verbose = verbose
        self.httpd.plane = plane
        self.httpd.deploy = deploy
        self.httpd.cascade = cascade
        self.httpd.brownout = brownout
        self.httpd.jobs = jobs
        self.httpd.batch_sched = batch_sched
        self.httpd.max_body_bytes = int(max_body_bytes)
        self.httpd.socket_timeout_s = socket_timeout_s
        self.httpd.response_cache = response_cache
        self.httpd.qos = qos
        self.httpd.draining = False
        self.httpd.drain_lock = threading.Lock()
        # handler spans land in the engines' shared trace ring
        self.httpd.tracer = tracer or next(iter(engines.values())).tracer
        self._thread: threading.Thread | None = None

    @property
    def host(self) -> str:
        return self.httpd.server_address[0]

    @property
    def port(self) -> int:
        return self.httpd.server_address[1]

    def serve_forever(self):
        self.httpd.serve_forever()

    def start_background(self) -> "ServeServer":
        self._thread = threading.Thread(target=self.serve_forever,
                                        name="serve-http", daemon=True)
        self._thread.start()
        return self

    def shutdown(self):
        self.httpd.shutdown()
        self.httpd.server_close()
        if self._thread is not None:
            self._thread.join(5.0)
            self._thread = None
