"""Append-only deployment ledger: every rollout decision, durable.

Port of ``deep_vision_tpu/deploy/history.py``: stdlib only, and the
on-disk format is the reference's, line for line, so either package
reads the other's ledger.

One JSONL file per model name under ``root`` (``<workdir>/_deploy`` in
production; ``root=None`` keeps the ledger in memory for tests).  Each
line is one immutable record — a candidate sighting, a gate verdict, a
promote/rollback/failure, a revert — carrying the checkpoint
fingerprint (step/dir/mtime), params digest, gate metrics, and a
wall-clock timestamp.  Records are appended, never rewritten: the file
IS the audit trail ``GET /v1/deploy/{name}/history`` serves, and the
map ``POST /v1/deploy/{name}/revert`` consults reads the live plane
table, not this file — the ledger observes, it never decides.

Crash-safety is line-granular: a torn tail line (killed mid-append) is
skipped on reload, everything before it survives.  The in-memory view
keeps the newest ``retain`` records per model; the file keeps them all.
"""

from __future__ import annotations

import glob
import json
import os
import threading
import time

from deep_vision_tpu_torch.obs.log import event, get_logger

_log = get_logger("dvt.deploy.history")


class DeploymentHistory:
    def __init__(self, root: str | None = None, retain: int = 256):
        self.root = root
        self.retain = int(retain)
        # name → newest-last list of record dicts
        self._entries: dict[str, list[dict]] = {}  # guarded-by: _lock
        self._lock = threading.Lock()
        self.records = 0  # guarded-by: _lock
        self.write_errors = 0  # guarded-by: _lock
        if root is not None:
            os.makedirs(root, exist_ok=True)
            self._load()

    def _path(self, name: str) -> str:
        safe = "".join(c if c.isalnum() or c in "-_." else "_"
                       for c in name)
        return os.path.join(self.root, f"{safe}.jsonl")

    def _load(self):
        for p in sorted(glob.glob(os.path.join(self.root, "*.jsonl"))):
            loaded = []
            try:
                with open(p, encoding="utf-8") as f:
                    for line in f:
                        line = line.strip()
                        if not line:
                            continue
                        try:
                            loaded.append(json.loads(line))
                        except ValueError:
                            continue  # torn tail line from a crash
            except OSError:
                continue
            if not loaded:
                continue
            name = loaded[-1].get("model") or \
                os.path.splitext(os.path.basename(p))[0]
            with self._lock:
                lst = self._entries.setdefault(name, [])
                lst.extend(loaded)
                del lst[:-self.retain]

    def record(self, name: str, outcome: str, **fields) -> dict:
        """Append one immutable record (``outcome`` ∈ candidate /
        gate_passed / gate_failed / promoted / rolled_back / failed /
        reverted / revert_failed / scale_up / scale_down)."""
        entry = {"ts": round(time.time(), 3), "model": name,
                 "outcome": outcome}
        entry.update(fields)
        with self._lock:
            self.records += 1
            lst = self._entries.setdefault(name, [])
            lst.append(entry)
            del lst[:-self.retain]
        if self.root is not None:
            try:
                with open(self._path(name), "a", encoding="utf-8") as f:
                    f.write(json.dumps(entry, default=str) + "\n")
            except OSError as e:
                with self._lock:
                    self.write_errors += 1
                event(_log, "history_write_failed", model=name,
                      error=f"{type(e).__name__}: {e}")
        event(_log, "deployment", **entry)
        return entry

    def entries(self, name: str, n: int | None = None) -> list[dict]:
        """Newest-last records for ``name`` (the retained window; pass
        ``n`` for just the tail)."""
        with self._lock:
            lst = list(self._entries.get(name, []))
        return lst[-n:] if n else lst

    def names(self) -> list[str]:
        with self._lock:
            return sorted(self._entries)

    def last_outcome(self, name: str) -> str | None:
        with self._lock:
            lst = self._entries.get(name)
            return lst[-1]["outcome"] if lst else None

    def stats(self) -> dict:
        with self._lock:
            per = {name: {"records": len(lst),
                          "last_outcome": lst[-1]["outcome"] if lst
                          else None}
                   for name, lst in sorted(self._entries.items())}
            return {"records": self.records,
                    "write_errors": self.write_errors,
                    "root": self.root, "models": per}
