"""Gateway CLI — one endpoint over N backend serve processes.

    # two backends on one card (each a full cli.serve process) ...
    python -m deep_vision_tpu_torch.cli.serve -m resnet50 \\
        --workdir runs/r50 --wire-dtype uint8 --infer-dtype int8 \\
        --warmup --port 8001 &
    python -m deep_vision_tpu_torch.cli.serve -m resnet50 \\
        --workdir runs/r50 --wire-dtype uint8 --infer-dtype int8 \\
        --warmup --port 8002 &

    # ... behind one gateway: health-routed, retrying, failing over
    python -m deep_vision_tpu_torch.cli.gateway --port 8000 \\
        --backend 127.0.0.1:8001 --backend 127.0.0.1:8002

    # tail hedging: duplicate slow requests to a second backend
    python -m deep_vision_tpu_torch.cli.gateway --port 8000 \\
        --backend 127.0.0.1:8001 --backend 127.0.0.1:8002 --hedge

Clients talk to the gateway exactly like a single backend —
``/v1/classify``, ``/v1/detect``, ``/v1/healthz``, ``/v1/stats`` — and
survive any single backend dying (SIGKILL included).  Zero-downtime
restarts: POST ``/v1/drain`` on a backend, wait for the gateway to stop
routing there, restart it, repeat.  The gateway process runs no device
code: it never imports ``torch`` and never touches CUDA.

Port of ``deep_vision_tpu/cli/gateway.py`` (``build_gateway``, the
parser as ``build_parser``, ``main``).
"""

from __future__ import annotations

import argparse


def build_gateway(args):
    """argparse namespace → (Gateway, GatewayServer), the gateway
    started; ``chip_smoke.py`` boots its gateways through this so they
    run the production wiring."""
    from deep_vision_tpu_torch.obs.trace import Tracer
    from deep_vision_tpu_torch.serve.faults import FaultPlane
    from deep_vision_tpu_torch.serve.gateway import Gateway, GatewayServer

    tracer = Tracer(ring=getattr(args, "trace_ring", 256),
                    slow_ms=getattr(args, "slow_trace_ms", 250.0),
                    enabled=not getattr(args, "no_trace", False))
    fault_spec = getattr(args, "faults", None)
    faults = FaultPlane(fault_spec, getattr(args, "fault_seed", 0)) \
        if fault_spec else None
    gw = Gateway(
        list(args.backend),
        tracer=tracer,
        probe_interval_s=getattr(args, "probe_interval_ms", 250.0) / 1e3,
        probe_timeout_s=getattr(args, "probe_timeout_s", 1.0),
        request_timeout_s=getattr(args, "request_timeout_s", 30.0),
        retry_budget=getattr(args, "retry_budget", 3),
        backoff_ms=getattr(args, "backoff_ms", 10.0),
        backoff_max_ms=getattr(args, "backoff_max_ms", 250.0),
        breaker_threshold=getattr(args, "breaker_threshold", 3),
        breaker_cooldown_s=getattr(args, "breaker_cooldown_s", 1.0),
        degraded_after=getattr(args, "degraded_after", 1),
        dead_after=getattr(args, "dead_after", 5),
        hedge=getattr(args, "hedge", False),
        hedge_after_ms=getattr(args, "hedge_after_ms", None),
        affinity=getattr(args, "affinity", False),
        retry_budget_ratio=getattr(args, "retry_budget_ratio", 0.1),
        retry_budget_burst=getattr(args, "retry_budget_burst", 10.0),
        faults=faults)
    gw.start()
    socket_timeout_s = getattr(args, "socket_timeout_s", 30.0)
    server = GatewayServer(
        gw, host=args.host, port=args.port,
        verbose=getattr(args, "verbose", False),
        max_body_bytes=int(getattr(args, "max_body_mb", 32) * 2**20),
        socket_timeout_s=socket_timeout_s if socket_timeout_s > 0
        else None,
        edge=not getattr(args, "thread_server", False),
        max_connections=int(getattr(args, "max_connections", 1024)),
        http_workers=int(getattr(args, "http_workers", 8)))
    return gw, server


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="deep_vision_tpu serving gateway: health-routed "
                    "failover over backend serve processes")
    p.add_argument("--backend", action="append", required=True,
                   help="backend address host:port; repeat per backend")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8000,
                   help="0 = pick a free port")
    p.add_argument("--probe-interval-ms", type=float, default=250.0,
                   help="active /v1/healthz probe period per backend — "
                        "also bounds how long a dead backend keeps "
                        "receiving first-attempt traffic")
    p.add_argument("--probe-timeout-s", type=float, default=1.0)
    p.add_argument("--request-timeout-s", type=float, default=30.0,
                   help="per-attempt backend timeout; a timeout counts "
                        "as a failure and the request fails over")
    p.add_argument("--retry-budget", type=int, default=3,
                   help="extra attempts per request after the first "
                        "(connect error / timeout / 5xx → retry on a "
                        "different backend when one is routable)")
    p.add_argument("--retry-budget-ratio", type=float, default=0.1,
                   help="per-backend retry BUDGET refill: each real "
                        "success adds this many retry tokens (capped "
                        "at --retry-budget-burst), each retried "
                        "attempt spends one — bounds the steady-state "
                        "retry RATIO, so a dying fleet sees at most "
                        "~ratio extra load instead of a retry storm "
                        "multiplying it (--retry-budget still caps "
                        "attempts per request)")
    p.add_argument("--retry-budget-burst", type=float, default=10.0,
                   help="retry-token bucket depth per backend (also "
                        "the boot balance, so cold-start blips can "
                        "retry before any success has refilled)")
    p.add_argument("--backoff-ms", type=float, default=10.0,
                   help="base retry backoff; doubles per attempt with "
                        "full jitter, capped at --backoff-max-ms")
    p.add_argument("--backoff-max-ms", type=float, default=250.0)
    p.add_argument("--breaker-threshold", type=int, default=3,
                   help="consecutive failures (probe or request) that "
                        "open a backend's circuit breaker")
    p.add_argument("--breaker-cooldown-s", type=float, default=1.0,
                   help="OPEN → HALF_OPEN delay; the next probe or one "
                        "trial request then decides close vs re-open")
    p.add_argument("--degraded-after", type=int, default=1,
                   help="consecutive failures before a backend reports "
                        "DEGRADED in /v1/stats")
    p.add_argument("--dead-after", type=int, default=5,
                   help="consecutive failures before DEAD")
    p.add_argument("--hedge", action="store_true",
                   help="tail hedging: duplicate a request to a second "
                        "backend once the primary is slower than the "
                        "gateway's observed p99; first answer wins")
    p.add_argument("--hedge-after-ms", type=float, default=None,
                   help="fixed hedge delay instead of the learned p99")
    p.add_argument("--affinity", action="store_true",
                   help="rendezvous-hash backend choice on the payload "
                        "digest: identical payloads land on the same "
                        "healthy backend, maximizing its response-cache "
                        "hit rate; failover falls to the next-highest "
                        "hash")
    p.add_argument("--thread-server", action="store_true",
                   help="serve clients with the thread-per-request "
                        "baseline instead of the selector event loop")
    p.add_argument("--max-connections", type=int, default=1024,
                   help="edge loop: open client-connection ceiling")
    p.add_argument("--http-workers", type=int, default=8,
                   help="edge loop: worker threads forwarding requests")
    p.add_argument("--max-body-mb", type=float, default=32.0)
    p.add_argument("--socket-timeout-s", type=float, default=30.0,
                   help="per-connection client socket timeout (0 "
                        "disables); same slow-loris guard as the "
                        "backends")
    p.add_argument("--verbose", action="store_true")
    # -- chaos: the fault plane's gateway stage --
    p.add_argument("--faults", default=None,
                   help="deterministic gateway-hop fault spec, e.g. "
                        "'gateway:conn_reset:p=0.3' or "
                        "'gateway:blackhole:hang_s=2:times=1' — "
                        "injects NETWORK failures (conn_reset / "
                        "slow_drip / blackhole) into the gateway's "
                        "per-attempt backend calls so the breaker and "
                        "retry budget exercise their tested paths")
    p.add_argument("--fault-seed", type=int, default=0,
                   help="seed for probabilistic (p=) fault firing")
    # -- observability --
    p.add_argument("--log-level", default="info",
                   choices=("debug", "info", "warning", "error"),
                   help="structured-log threshold for the dvt.serve.* "
                        "loggers (one JSON line per event on stderr)")
    p.add_argument("--trace-ring", type=int, default=256,
                   help="per-request spans kept in memory for "
                        "GET /v1/traces")
    p.add_argument("--slow-trace-ms", type=float, default=250.0,
                   help="requests slower than this emit their full span "
                        "as a slow_request log line; 0 disables")
    p.add_argument("--no-trace", action="store_true",
                   help="disable per-request span collection")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)

    from deep_vision_tpu_torch.obs.log import configure_logging

    configure_logging(args.log_level)
    gw, server = build_gateway(args)
    ok, health = gw.healthz()
    print(f"[gateway] listening on http://{server.host}:{server.port} "
          f"-> {len(gw.backends)} backend(s), "
          f"routable now: {health['routable'] or 'NONE'}")
    print(f"[gateway] retry_budget={gw.retry_budget} "
          f"retry_ratio={gw.retry_budget_ratio:g}"
          f"(burst {gw.retry_budget_burst:g}) "
          f"probe_interval={gw.probe_interval_s * 1e3:.0f}ms "
          f"breaker={gw.backends[0].breaker_threshold}"
          f"/{gw.backends[0].breaker_cooldown_s}s "
          f"hedge={'on' if gw.hedge else 'off'}")
    if gw.faults is not None and gw.faults.enabled:
        print(f"[gateway] FAULT INJECTION ACTIVE: '{gw.faults.spec}' "
              f"(seed {gw.faults.seed})")
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        print("[gateway] shutting down")
    finally:
        server.shutdown()
        gw.stop()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
