"""Build the package's CUDA sources with ``nvcc`` and load them with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C interface and compiles on its
own into ``_build/<name>-<hash>.so`` (the hash covers the source and the
flags, so an edited kernel rebuilds).  The first call that needs a
kernel builds it; ``build_all`` starts one ``nvcc`` per source at once,
for callers that want every kernel ready up front.  Nothing here runs at
import time: machines without ``nvcc`` import the package freely.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading

PACKAGE_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PACKAGE_DIR, "csrc")
BUILD_DIR = os.path.join(PACKAGE_DIR, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_build_lock = threading.Lock()


def sources() -> list[str]:
    """Kernel names: one per ``csrc/*.cu``."""
    return sorted(f[:-3] for f in os.listdir(CSRC_DIR) if f.endswith(".cu"))


def nvcc_path() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (set CUDA_HOME or put nvcc on PATH)")


def library_path(name: str) -> str:
    with open(os.path.join(CSRC_DIR, f"{name}.cu"), "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"{name}-{digest.hexdigest()[:16]}.so")


def _start(name: str):
    """Start ``nvcc`` for ``name`` into a temp file; None if already built."""
    out = library_path(name)
    if os.path.exists(out):
        return None
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp,
           os.path.join(CSRC_DIR, f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish(name: str, started) -> None:
    if started is None:
        return
    proc, tmp, out = started
    log, _ = proc.communicate()
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed to build {name}.cu "
                           f"(exit {proc.returncode}):\n{log}")
    os.replace(tmp, out)  # atomic: a reader never sees a partial .so


def build_all() -> list[str]:
    """Build every kernel source, one ``nvcc`` each, all in parallel."""
    with _build_lock:
        names = sources()
        started = [(n, _start(n)) for n in names]
        for n, s in started:
            _finish(n, s)
    return names


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """The built library for ``csrc/<name>.cu`` (built on first use)."""
    with _build_lock:
        _finish(name, _start(name))
    return ctypes.CDLL(library_path(name))
