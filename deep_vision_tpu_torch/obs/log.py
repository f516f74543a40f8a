"""Structured logging for the serving stack: one JSON line per event.

Copy of ``deep_vision_tpu/obs/log.py``.  Stdlib ``logging`` under the
``dvt.serve.*`` namespaces — no handler or format is installed at import
time, so library use stays silent (the default root WARNING level makes
every INFO ``event`` a cheap ``isEnabledFor`` no-op) until a caller
configures the ``dvt`` logger.  The CLIs (``cli.serve`` /
``cli.gateway``) opt in via ``--log-level`` → ``configure_logging``,
which attaches one stderr handler to the ``dvt`` root.

``event(logger, name, **fields)`` renders ``{"ts": ..., "event": name,
"logger": ..., **fields}`` as a single JSON line — the same shape the
slow-request trace sampler emits, so one ``jq`` pipeline reads both.
"""

from __future__ import annotations

import json
import logging
import time

_ROOT = "dvt"


def get_logger(name: str) -> logging.Logger:
    """A namespaced serving logger, e.g. ``get_logger("dvt.serve.engine")``."""
    return logging.getLogger(name)


def configure_logging(level: str = "info") -> logging.Logger:
    """Attach one stderr handler to the ``dvt`` root at ``level``.

    Idempotent: a second call only adjusts the level.  The root stops
    propagating so configured CLIs don't double-print through the
    global root logger.
    """
    root = logging.getLogger(_ROOT)
    root.setLevel(getattr(logging, level.upper(), logging.INFO))
    if not root.handlers:
        handler = logging.StreamHandler()
        handler.setFormatter(logging.Formatter("%(message)s"))
        root.addHandler(handler)
        root.propagate = False
    return root


def event(logger: logging.Logger, name: str, level: int = logging.INFO,
          **fields):
    """Emit one structured JSON line (skipped entirely when the level is
    off — the guard is the only cost on the unconfigured path)."""
    if not logger.isEnabledFor(level):
        return
    rec = {"ts": round(time.time(), 6), "event": name,
           "logger": logger.name}
    rec.update(fields)
    logger.log(level, json.dumps(rec, default=str))
