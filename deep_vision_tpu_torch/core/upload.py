"""Artifact upload: sync run artifacts (checkpoints) off-host.

A copy of ``deep_vision_tpu/core/upload.py``: every trainer mirrors its
checkpoint directories to a destination URI after each save
(``cli.train --upload <uri>``), and the Trainer restores them from
there onto a fresh, empty workdir before it looks for a checkpoint (the
preemption path):

- ``/path`` or ``file:///path`` — local/NFS mirror (works everywhere,
  including air-gapped CI);
- ``gs://bucket/prefix`` — Google Cloud Storage, via the
  ``google.cloud.storage`` client if installed, else the ``gsutil`` CLI
  (both gated: this repo adds no cloud dependencies).

Sync is one-way and incremental by (size, mtime), rsync-style, so calling
it after every checkpoint is cheap.
"""

from __future__ import annotations

import os
import shutil
import subprocess


def _iter_files(src_dir: str):
    for root, _, files in os.walk(src_dir):
        for f in files:
            full = os.path.join(root, f)
            yield full, os.path.relpath(full, src_dir)


def _sync_local(src_dir: str, dest_dir: str) -> int:
    n = 0
    keep = set()
    for full, rel in _iter_files(src_dir):
        keep.add(rel)
        dest = os.path.join(dest_dir, rel)
        st = os.stat(full)
        if os.path.exists(dest):
            dst = os.stat(dest)
            if dst.st_size == st.st_size and dst.st_mtime >= st.st_mtime:
                continue
        os.makedirs(os.path.dirname(dest), exist_ok=True)
        shutil.copy2(full, dest)
        n += 1
    # true mirror: drop files pruned locally (max_to_keep rotation),
    # so the destination doesn't accumulate every checkpoint ever written.
    # Guard: an empty src means a fresh run that has written nothing yet —
    # never let it wipe a backup it hasn't superseded.
    if keep:
        for full, rel in list(_iter_files(dest_dir)):
            if rel not in keep:
                os.remove(full)
        for root, dirs, files in os.walk(dest_dir, topdown=False):
            if not dirs and not files and root != dest_dir:
                os.rmdir(root)
    return n


def _sync_gcs(src_dir: str, uri: str) -> int:
    try:
        from google.cloud import storage  # type: ignore
    except ImportError:
        # fall back to the gsutil CLI if present (-d: true mirror,
        # deletes remotely what max_to_keep pruned locally)
        if shutil.which("gsutil"):
            subprocess.run(["gsutil", "-m", "rsync", "-r", "-d",
                            src_dir, uri], check=True)
            return -1  # count unknown
        raise RuntimeError(
            "gs:// upload needs google-cloud-storage or gsutil; neither "
            "is available — use a file:// destination or install one")
    bucket_name, _, prefix = uri[len("gs://"):].partition("/")
    bucket = storage.Client().bucket(bucket_name)
    # incremental: list what's already there once, skip same-size blobs
    # (a same-size edit of a checkpoint file is rare; it re-uploads at
    # the next run).
    # prefix listed with a trailing '/': bare "run/checkpoints" would also
    # match the SIBLING "run/checkpoints_best/..." blobs and the mirror
    # loop below would delete them
    existing = {b.name: b.size
                for b in bucket.list_blobs(
                    prefix=prefix + "/" if prefix else None)}
    n = 0
    keep = set()
    for full, rel in _iter_files(src_dir):
        name = os.path.join(prefix, rel) if prefix else rel
        keep.add(name)
        if existing.get(name) == os.path.getsize(full):
            continue
        bucket.blob(name).upload_from_filename(full)
        n += 1
    if keep:  # mirror semantics + fresh-run guard (see _sync_local)
        for name in existing:
            if name not in keep:
                bucket.blob(name).delete()
    return n


def _restore_gcs(uri: str, local_dir: str) -> int:
    try:
        from google.cloud import storage  # type: ignore
    except ImportError:
        if shutil.which("gsutil"):
            os.makedirs(local_dir, exist_ok=True)  # rsync needs the target
            subprocess.run(["gsutil", "-m", "rsync", "-r", uri, local_dir],
                           check=True)
            return -1
        raise RuntimeError(
            "gs:// restore needs google-cloud-storage or gsutil; neither "
            "is available")
    bucket_name, _, prefix = uri[len("gs://"):].partition("/")
    bucket = storage.Client().bucket(bucket_name)
    n = 0
    # trailing '/' so "run/checkpoints" doesn't also pull the sibling
    # "run/checkpoints_best/..." blobs into this tree (see _sync_gcs)
    for blob in bucket.list_blobs(prefix=prefix + "/" if prefix else None):
        rel = blob.name[len(prefix):].lstrip("/") if prefix else blob.name
        if not rel:
            continue
        dest = os.path.join(local_dir, rel)
        os.makedirs(os.path.dirname(dest), exist_ok=True)
        blob.download_to_filename(dest)
        n += 1
    return n


def restore_dir(dest_uri: str, local_dir: str) -> int:
    """Pull a previously mirrored tree back into ``local_dir`` (the inverse
    of :func:`sync_dir`) — the preemption-recovery path: a fresh VM with an
    empty workdir re-hydrates its checkpoints from the upload URI before
    resuming.  Returns files copied (-1 if unknown); 0 if the mirror is
    empty or absent."""
    if dest_uri.startswith("gs://"):
        return _restore_gcs(dest_uri, local_dir)
    src = dest_uri[len("file://"):] if dest_uri.startswith("file://") \
        else dest_uri
    if not os.path.isdir(src):
        return 0
    os.makedirs(local_dir, exist_ok=True)
    return _sync_local(src, local_dir)


def sync_dir(src_dir: str, dest_uri: str) -> int:
    """Mirror ``src_dir`` under ``dest_uri``; returns files copied
    (-1 if the backend doesn't report)."""
    if dest_uri.startswith("gs://"):
        return _sync_gcs(src_dir, dest_uri)
    dest = dest_uri[len("file://"):] if dest_uri.startswith("file://") \
        else dest_uri
    os.makedirs(dest, exist_ok=True)
    return _sync_local(src_dir, dest)


class ArtifactUploader:
    """Post-checkpoint hook: mirrors the workdir's checkpoint dirs to a
    destination URI.  Failures are reported but never kill training —
    losing an upload must not lose the run."""

    def __init__(self, dest_uri: str):
        self.dest_uri = dest_uri.rstrip("/")

    def sync(self, src_dir: str, tag: str):
        try:
            n = sync_dir(src_dir, f"{self.dest_uri}/{tag}")
            print(f"[upload] {tag}: {n if n >= 0 else '?'} file(s) → "
                  f"{self.dest_uri}/{tag}", flush=True)
        except Exception as e:  # noqa: BLE001 — deliberately broad
            print(f"[upload] FAILED for {tag}: {e}", flush=True)

    def restore(self, local_dir: str, tag: str) -> int:
        """Re-hydrate ``local_dir`` from the mirror (preemption recovery:
        the VM died, the local disk is gone, the mirror is the only copy).
        Failures are reported, not fatal — a missing mirror just means a
        genuinely fresh run."""
        try:
            n = restore_dir(f"{self.dest_uri}/{tag}", local_dir)
            if n:
                print(f"[upload] restored {n if n >= 0 else '?'} file(s) "
                      f"← {self.dest_uri}/{tag}", flush=True)
            return n
        except Exception as e:  # noqa: BLE001 — deliberately broad
            print(f"[upload] restore FAILED for {tag}: {e}", flush=True)
            return 0
