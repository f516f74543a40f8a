"""Offline batch-inference jobs: manifests in, durable results out.

Port of ``deep_vision_tpu/serve/jobs.py`` (``Job``, ``JobStore``).  A
*job* is a manifest of N inference items (images, latents, seeds)
POSTed to ``/v1/jobs`` and drained through the serving engines by
``serve/batch_sched.py``, strictly below every interactive tenant.  This
module owns the job ledger: the in-memory job table the scheduler and
the HTTP handlers read, and its append-only JSONL checkpoint on disk,
one file per job:

  {"kind": "job",    "job": id, "model": ..., "verb": ..., ...}
  {"kind": "shard",  "job": id, "index": 3, "results": [...], ...}
  {"kind": "done",   "job": id, ...}
  {"kind": "failed", "job": id, "reason": ..., ...}

The records and their field names are the reference's byte for byte, so
a ledger written by either package replays in the other.

Progress is checkpointed at *shard* granularity: a shard record is the
durability unit.  On restart the store replays every job file, skipping
torn tails (a half-written line from a crash mid-append parses as
garbage and is dropped; every complete line before it survives), and
the scheduler resumes each unfinished job from its first missing shard.
A shard whose record reached the disk is never re-executed and its
results are never produced twice; a shard whose record was torn re-runs
in full, so results land exactly once in the durable log either way.

The ledger is also the result store: in memory each job keeps only a
bounded LRU cache of completed shard payloads (``max_cached_shards``),
and ``GET /v1/jobs/<id>/results`` streams evicted shards back from the
JSONL file by byte offset, so a million-image job's results never have
to fit in RAM.

Lock order: ``JobStore._lock`` is a leaf.  File appends happen OUTSIDE
it (one slow disk must not stall status polls), and no engine or
scheduler lock is ever taken under it.
"""

from __future__ import annotations

import collections
import json
import math
import os
import threading
import time

from deep_vision_tpu_torch.obs.log import event, get_logger

_log = get_logger("dvt.serve.jobs")


class Job:
    """One bulk job: an immutable manifest plus mutable shard progress.

    ``manifest`` is frozen at submit time and never mutated, so the
    scheduler may slice it without the store lock; the mutable fields
    are guarded by the owning store's ``_lock``.

    ``shards_done`` is the authoritative completion state (what the
    scheduler and status views read); ``results`` is only a bounded
    payload CACHE over the durable JSONL ledger — on a durable store
    the store evicts least-recently-read shards past its
    ``max_cached_shards`` cap and the results endpoint re-reads them
    from disk (``JobStore.results_items``)."""

    __slots__ = ("job_id", "model", "verb", "manifest", "shard_size",
                 "n_shards", "shards_done", "results", "pinned",
                 "images_done", "done", "error", "created_ts")

    def __init__(self, job_id: str, model: str, verb: str,
                 manifest: list, shard_size: int,
                 created_ts: float | None = None):
        self.job_id = job_id
        self.model = model
        self.verb = verb
        self.manifest = list(manifest)
        self.shard_size = max(1, int(shard_size))
        self.n_shards = max(1, math.ceil(len(self.manifest)
                                         / self.shard_size))
        self.shards_done: set[int] = set()  # guarded-by: JobStore._lock
        # payload cache, insertion/access-ordered for LRU eviction
        self.results: collections.OrderedDict[int, list] = \
            collections.OrderedDict()  # guarded-by: JobStore._lock
        # shards whose ledger append FAILED: memory is their only copy,
        # so eviction must never touch them
        self.pinned: set[int] = set()  # guarded-by: JobStore._lock
        self.images_done = 0  # guarded-by: JobStore._lock
        self.done = False  # guarded-by: JobStore._lock
        self.error: str | None = None  # guarded-by: JobStore._lock
        self.created_ts = created_ts if created_ts is not None \
            else time.time()

    def shard_range(self, index: int) -> tuple[int, int]:
        """[lo, hi) manifest slice for shard ``index``."""
        lo = index * self.shard_size
        return lo, min(len(self.manifest), lo + self.shard_size)

    def _state(self) -> str:
        if self.error:
            return "failed"
        if self.done:
            return "done"
        return "running" if self.shards_done else "pending"

    def _status_locked(self) -> dict:
        out = {"job_id": self.job_id, "model": self.model,
               "verb": self.verb, "state": self._state(),
               "n_items": len(self.manifest),
               "shard_size": self.shard_size,
               "n_shards": self.n_shards,
               "shards_done": len(self.shards_done),
               "images_done": self.images_done,
               "created_ts": round(self.created_ts, 3)}
        if self.error:
            out["error"] = self.error
        return out


class JobStore:
    """Job table + append-only JSONL checkpoint (one file per job).

    ``root=None`` runs memory-only (tests, servers started without
    ``--jobs-dir``): same API, no durability.  With a root, every job
    submitted, every completed shard, and every terminal transition
    appends one JSON line to ``<root>/<job_id>.jsonl``; construction
    replays existing files so a restarted server picks unfinished jobs
    back up at their first missing shard."""

    def __init__(self, root: str | None = None, *, shard_size: int = 32,
                 max_cached_shards: int = 64):
        self.root = root
        self.default_shard_size = max(1, int(shard_size))
        # per-job in-memory payload cache bound: with a durable root,
        # completed shard payloads past this count spill to the JSONL
        # ledger (LRU) and /v1/jobs/<id>/results streams them back from
        # disk; 0 = unbounded.  Memory-only stores never evict — memory
        # is the only copy
        self.max_cached_shards = max(0, int(max_cached_shards))
        self._lock = threading.Lock()
        self._jobs: dict[str, Job] = {}  # guarded-by: _lock
        self._order: list[str] = []  # FIFO scheduling order, guarded-by: _lock
        self.submitted = 0  # guarded-by: _lock
        self.resumed = 0  # jobs replayed unfinished, guarded-by: _lock
        self.replayed_shards = 0  # guarded-by: _lock
        self.spilled_shards = 0  # payloads evicted to disk, guarded-by: _lock
        self.write_errors = 0  # guarded-by: _lock
        self.torn_lines = 0  # guarded-by: _lock
        if root:
            os.makedirs(root, exist_ok=True)
            self._load()

    # -- durability ---------------------------------------------------------

    def _path(self, job_id: str) -> str:
        safe = "".join(c if c.isalnum() or c in "-_." else "_"
                       for c in job_id)
        return os.path.join(self.root, f"{safe}.jsonl")

    def _append(self, job_id: str, record: dict) -> bool:
        # called OUTSIDE self._lock — one slow disk must not stall the
        # scheduler or a status poll; memory is already updated, and a
        # lost append only means the shard re-runs after a restart.
        # Returns whether the record is durable (False pins the shard's
        # payload in memory — eviction must not drop the only copy)
        if not self.root:
            return True
        line = json.dumps(record, default=str) + "\n"
        try:
            with open(self._path(job_id), "a", encoding="utf-8") as f:
                f.write(line)
            return True
        except OSError as e:
            with self._lock:
                self.write_errors += 1
            event(_log, "job_write_error", job=job_id, error=str(e))
            return False

    def _load(self) -> None:
        loaded: list[Job] = []
        torn = replayed = 0
        for fname in sorted(os.listdir(self.root)):
            if not fname.endswith(".jsonl"):
                continue
            path = os.path.join(self.root, fname)
            try:
                with open(path, encoding="utf-8") as f:
                    lines = f.readlines()
                if lines and not lines[-1].endswith("\n"):
                    # torn tail repair: terminate the half-written line
                    # now, or the NEXT append would concatenate onto the
                    # garbage and be swallowed with it
                    with open(path, "a", encoding="utf-8") as f:
                        f.write("\n")
            except OSError:
                continue
            job: Job | None = None
            for raw in lines:
                raw = raw.strip()
                if not raw:
                    continue
                try:
                    rec = json.loads(raw)
                except ValueError:
                    # torn tail (or mid-file corruption): skip the line,
                    # keep every complete record around it
                    torn += 1
                    continue
                kind = rec.get("kind")
                if kind == "job" and job is None:
                    try:
                        job = Job(rec["job"], rec["model"], rec["verb"],
                                  rec["manifest"], rec["shard_size"],
                                  created_ts=float(rec.get("ts", 0.0)))
                    except (KeyError, TypeError, ValueError):
                        break  # unusable header → skip the file
                elif kind == "shard" and job is not None:
                    idx = rec.get("index")
                    res = rec.get("results")
                    if isinstance(idx, int) and isinstance(res, list) \
                            and 0 <= idx < job.n_shards \
                            and idx not in job.shards_done:
                        # completion state only: the payload already
                        # lives in this very ledger, so replay leaves
                        # the cache cold and results_items streams the
                        # rows back from disk on demand
                        job.shards_done.add(idx)
                        job.images_done += int(rec.get("images",
                                                       len(res)))
                        replayed += 1
                elif kind == "done" and job is not None:
                    job.done = True
                elif kind == "failed" and job is not None:
                    job.error = str(rec.get("reason", "failed"))
                    job.done = True
            if job is not None:
                loaded.append(job)
        loaded.sort(key=lambda j: (j.created_ts, j.job_id))
        resumed: list[Job] = []
        with self._lock:
            self.torn_lines += torn
            self.replayed_shards += replayed
            for job in loaded:
                self._jobs[job.job_id] = job
                self._order.append(job.job_id)
                if not job.done:
                    self.resumed += 1
                    resumed.append(job)
        for job in resumed:
            event(_log, "job_resumed", job=job.job_id,
                  model=job.model, shards_done=len(job.shards_done),
                  n_shards=job.n_shards)

    # -- job API ------------------------------------------------------------

    def submit(self, model: str, verb: str, manifest: list,
               shard_size: int | None = None) -> dict:
        """Register a new job; returns its status view (the HTTP job
        handle).  The job record is durable before this returns."""
        if not manifest:
            raise ValueError("empty manifest")
        job_id = "job-" + os.urandom(8).hex()
        job = Job(job_id, model, verb, manifest,
                  shard_size or self.default_shard_size)
        with self._lock:
            self._jobs[job_id] = job
            self._order.append(job_id)
            self.submitted += 1
            view = job._status_locked()
        self._append(job_id, {"kind": "job", "job": job_id,
                              "model": model, "verb": verb,
                              "shard_size": job.shard_size,
                              "n_items": len(job.manifest),
                              "manifest": job.manifest,
                              "ts": job.created_ts})
        event(_log, "job_submitted", job=job_id, model=model, verb=verb,
              n_items=len(job.manifest), n_shards=job.n_shards)
        return view

    def status(self, job_id: str) -> dict:
        with self._lock:
            return self._jobs[job_id]._status_locked()

    def jobs(self) -> list[dict]:
        with self._lock:
            return [self._jobs[jid]._status_locked()
                    for jid in self._order]

    def get(self, job_id: str) -> Job:
        with self._lock:
            return self._jobs[job_id]

    # -- scheduler API ------------------------------------------------------

    def next_shard(self) -> tuple[Job, int] | None:
        """FIFO: the lowest missing shard of the oldest unfinished job.
        Lowest-first keeps shard completion in index order, which is
        what lets the results endpoint stream the completed prefix."""
        with self._lock:
            for jid in self._order:
                job = self._jobs[jid]
                if job.done:
                    continue
                for i in range(job.n_shards):
                    if i not in job.shards_done:
                        return job, i
        return None

    def record_shard(self, job_id: str, index: int, results: list,
                     images: int) -> bool:
        """Commit one completed shard: memory under the lock, the JSONL
        record outside it.  Returns False (and writes nothing) if the
        shard is already recorded — the exactly-once guard for a
        replayed or double-run shard."""
        with self._lock:
            job = self._jobs[job_id]
            if index in job.shards_done or job.done:
                return False
            job.shards_done.add(index)
            job.results[index] = list(results)
            job.images_done += int(images)
            finished = len(job.shards_done) == job.n_shards
        durable = self._append(job_id, {"kind": "shard", "job": job_id,
                                        "index": index,
                                        "images": int(images),
                                        "results": list(results),
                                        "ts": time.time()})
        with self._lock:
            if not durable:
                job.pinned.add(index)
            self._evict_locked(job)
        if finished:
            with self._lock:
                job.done = True
            self._append(job_id, {"kind": "done", "job": job_id,
                                  "ts": time.time()})
            event(_log, "job_done", job=job_id,
                  images=job.images_done, n_shards=job.n_shards)
        return True

    def fail(self, job_id: str, reason: str) -> None:
        """Terminal failure (unknown model, engine gone): the job stops
        scheduling and reports ``failed`` with the reason."""
        with self._lock:
            job = self._jobs[job_id]
            if job.done:
                return
            job.error = reason
            job.done = True
        self._append(job_id, {"kind": "failed", "job": job_id,
                              "reason": reason, "ts": time.time()})
        event(_log, "job_failed", job=job_id, reason=reason)

    def _evict_locked(self, job: Job) -> None:
        # guarded-by: _lock.  Spill least-recently-read payloads past
        # the cache bound; only shards with a durable ledger record are
        # eligible (memory-only stores and pinned shards keep theirs)
        cap = self.max_cached_shards
        if not self.root or cap <= 0:
            return
        for i in list(job.results):
            if len(job.results) <= cap:
                break
            if i in job.pinned:
                continue
            del job.results[i]
            self.spilled_shards += 1

    def _shard_offsets(self, job_id: str, wanted: set) -> dict:
        """One pass over the job's ledger → byte offset of each wanted
        shard record, so streaming re-reads spilled payloads with one
        seek apiece instead of holding the whole file in memory."""
        offsets: dict[int, int] = {}
        if not self.root or not wanted:
            return offsets
        try:
            # manual tell/readline loop: line iteration disables tell()
            with open(self._path(job_id), encoding="utf-8") as f:
                pos = f.tell()
                line = f.readline()
                while line:
                    if '"shard"' in line:
                        try:
                            rec = json.loads(line)
                        except ValueError:
                            rec = None
                        if isinstance(rec, dict) \
                                and rec.get("kind") == "shard":
                            idx = rec.get("index")
                            if idx in wanted and idx not in offsets:
                                offsets[idx] = pos
                    pos = f.tell()
                    line = f.readline()
        except OSError:
            return {}
        return offsets

    def _read_shard(self, job_id: str, offset: int) -> list | None:
        try:
            with open(self._path(job_id), encoding="utf-8") as f:
                f.seek(offset)
                rec = json.loads(f.readline())
            res = rec.get("results")
            return res if isinstance(res, list) else None
        except (OSError, ValueError, AttributeError):
            return None

    def results_items(self, job_id: str):
        """Completed results in manifest order — the contiguous shard
        prefix only, so a partially-drained job streams a stable,
        in-order, never-repeated prefix.  Yields ``(global_index,
        result_dict)``.

        Cached shards stream from memory (refreshing their LRU slot);
        spilled shards stream back from the JSONL ledger via a one-pass
        byte-offset index + per-shard seek, so a bulk job's full result
        set never has to fit in memory at once."""
        with self._lock:
            job = self._jobs[job_id]
            contiguous = 0
            while contiguous in job.shards_done:
                contiguous += 1
            cached: dict[int, list] = {}
            for i in list(job.results):
                if i < contiguous:
                    cached[i] = job.results[i]
                    job.results.move_to_end(i)  # reading = recent use
        missing = set(range(contiguous)) - set(cached)
        offsets = self._shard_offsets(job_id, missing)
        idx = 0
        for i in range(contiguous):
            shard = cached.get(i)
            if shard is None:
                off = offsets.get(i)
                shard = self._read_shard(job_id, off) \
                    if off is not None else None
            if shard is None:
                # spilled payload unreadable (ledger pruned/corrupt):
                # end the stable prefix here rather than renumber the
                # rows after a gap
                event(_log, "job_results_gap", job=job_id, shard=i)
                break
            for item in shard:
                yield idx, item
                idx += 1

    def stats(self) -> dict:
        with self._lock:
            states = {"pending": 0, "running": 0, "done": 0, "failed": 0}
            images = 0
            for job in self._jobs.values():
                states[job._state()] += 1
                images += job.images_done
            return {"jobs_total": len(self._jobs),
                    "submitted": self.submitted,
                    "resumed": self.resumed,
                    "replayed_shards": self.replayed_shards,
                    "spilled_shards": self.spilled_shards,
                    "cached_shards": sum(len(j.results)
                                         for j in self._jobs.values()),
                    "images_done": images,
                    "write_errors": self.write_errors,
                    "torn_lines": self.torn_lines,
                    "states": states,
                    "durable": bool(self.root)}
