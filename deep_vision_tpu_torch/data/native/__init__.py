"""The native dvrec batch reader (``dvrec_reader.cc``) through ctypes.

The source builds at first use with the machine's C++ compiler (``CXX``,
else ``g++``, else ``c++``) into ``deep_vision_tpu_torch/_build/``, keyed
by a hash of the source and the flags, so an edited source rebuilds.
Where a compiler exists and the compile fails, :func:`load` raises with
the compiler's output.  Only where no C++ compiler exists at all does it
return None, and say so once on stderr: the loaders then assemble their
batches with numpy (``data/imagenet.ImageNetLoader._native_batch``).
:func:`assemble_batch` counts the batches it assembles in
``assemble_batch.batches``, so a run can show which path it took.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import sys
import tempfile
import threading

from deep_vision_tpu_torch.ops import _build

SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "dvrec_reader.cc")
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_lock = threading.Lock()
_loaded: dict = {}


def compiler() -> str | None:
    """The C++ compiler to build with, or None where there is none."""
    return os.environ.get("CXX") or shutil.which("g++") \
        or shutil.which("c++")


def library_path(build_dir: str | None = None) -> str:
    with open(SOURCE, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(CXX_FLAGS).encode())
    return os.path.join(build_dir or _build.BUILD_DIR,
                        f"dvrec_reader-{digest.hexdigest()[:16]}.so")


def build(build_dir: str | None = None) -> str | None:
    """The built library's path (built now if it is not there yet), or
    None where no C++ compiler exists.  A failing compile raises."""
    out = library_path(build_dir)
    if os.path.exists(out):
        return out
    cxx = compiler()
    if cxx is None:
        return None
    os.makedirs(os.path.dirname(out), exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=os.path.dirname(out))
    os.close(fd)
    proc = subprocess.run([cxx, *CXX_FLAGS, SOURCE, "-o", tmp],
                          capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(
            f"{cxx} failed to build {os.path.basename(SOURCE)} (exit "
            f"{proc.returncode}):\n{proc.stderr}{proc.stdout}")
    os.replace(tmp, out)  # atomic: a reader never sees a partial .so
    return out


def load() -> ctypes.CDLL | None:
    """The reader's library, built on first use; None only where no C++
    compiler exists (said once on stderr)."""
    with _lock:
        if "lib" in _loaded:
            return _loaded["lib"]
        path = build()
        if path is None:
            print("[native] no C++ compiler (CXX, g++ or c++): the dvrec "
                  "reader is not built, batches are assembled with numpy",
                  file=sys.stderr, flush=True)
            lib = None
        else:
            lib = ctypes.CDLL(path)
            lib.dvrec_assemble_batch.restype = ctypes.c_int32
            lib.dvrec_assemble_batch.argtypes = [
                ctypes.c_void_p,   # fds (int32)
                ctypes.c_void_p,   # offsets (int64)
                ctypes.c_void_p,   # heights (int32)
                ctypes.c_void_p,   # widths (int32)
                ctypes.c_void_p,   # tops (int32)
                ctypes.c_void_p,   # lefts (int32)
                ctypes.c_void_p,   # flips (uint8)
                ctypes.c_int32,    # n
                ctypes.c_int32,    # crop
                ctypes.c_void_p,   # out (uint8)
                ctypes.c_void_p,   # scratch (uint8)
            ]
        _loaded["lib"] = lib
        return lib


def reset() -> None:
    """Forget the loaded library, so the next :func:`load` builds again."""
    with _lock:
        _loaded.clear()


def assemble_batch(lib, fds, offsets, heights, widths, tops, lefts, flips,
                   out, scratch) -> int:
    """One batch of crops into ``out`` (n, S, S, 3) uint8 through
    ``dvrec_assemble_batch``; the int32/int64/uint8 numpy arrays are
    C-contiguous.  Returns the reader's code: 0, or -(i+1) where item
    i's read failed or came back short."""
    n, crop = out.shape[0], out.shape[1]
    rc = lib.dvrec_assemble_batch(
        fds.ctypes.data, offsets.ctypes.data, heights.ctypes.data,
        widths.ctypes.data, tops.ctypes.data, lefts.ctypes.data,
        flips.ctypes.data, n, crop, out.ctypes.data, scratch.ctypes.data)
    if rc == 0:
        assemble_batch.batches += 1
    return rc


assemble_batch.batches = 0
