"""Structured logging for the serving stack: one JSON line per event.

Copy of ``deep_vision_tpu/obs/log.py``.  Stdlib ``logging`` under the
``dvt.serve.*`` namespaces — no handler or format is installed at import
time, so library use stays silent (the default root WARNING level makes
every INFO ``event`` a cheap ``isEnabledFor`` no-op) until a caller
configures the ``dvt`` logger.

``event(logger, name, **fields)`` renders ``{"ts": ..., "event": name,
"logger": ..., **fields}`` as a single JSON line — the same shape the
slow-request trace sampler emits, so one ``jq`` pipeline reads both.
"""

from __future__ import annotations

import json
import logging
import time


def get_logger(name: str) -> logging.Logger:
    """A namespaced serving logger, e.g. ``get_logger("dvt.serve.engine")``."""
    return logging.getLogger(name)


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
