"""``serve_ingest``: uint8 NHWC wire batch → int8 (or float32) activations.

The counterpart of the Pallas kernel ``deep_vision_tpu/ops/pallas_ops.py``
``serve_ingest`` (:94).  Per byte, with ``c`` its channel:

    y = (x / 255 - mean[c]) / std[c]
    quantize: clip(round_half_even(y / act_scale), -127, 127) as int8
    else:     y as float32

On a CUDA tensor, :func:`serve_ingest` launches the hand-written kernel
``csrc/serve_ingest.cu`` or raises; on a CPU tensor it computes
:func:`serve_ingest_plain`, the PyTorch version of the same arithmetic
that the tests and ``chip_smoke.py`` hold the kernel against.  Both
divide (never multiply by a reciprocal) and round half to even, so they
agree bit for bit with each other and with the JAX reference; the kernel
runs that arithmetic once per byte value and channel, into a table in
shared memory, and looks every byte up.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from deep_vision_tpu_torch.data.mnist import MEAN as MNIST_MEAN
from deep_vision_tpu_torch.data.mnist import STD as MNIST_STD
from deep_vision_tpu_torch.data.transforms import IMAGENET_MEAN, IMAGENET_STD
from deep_vision_tpu_torch.ops import counted

#: normalization families the fused ingest supports ("gan" is not one:
#: ops/preprocess.py keeps it on the plain path)
INGEST_KINDS = ("imagenet", "mnist", "unit")
#: channels the kernel's by-value constant block holds
MAX_CHANNELS = 4


def ingest_norm_constants(kind: str, channels: int):
    """Per-channel float32 ``(mean, std)`` for ``kind`` — the values
    ``ops/preprocess.serve_normalize`` subtracts and divides by."""
    if kind == "imagenet":
        mean = np.asarray(IMAGENET_MEAN, np.float32)
        std = np.asarray(IMAGENET_STD, np.float32)
    elif kind == "mnist":
        mean = np.full((channels,), MNIST_MEAN, np.float32)
        std = np.full((channels,), MNIST_STD, np.float32)
    elif kind == "unit":
        mean = np.zeros((channels,), np.float32)
        std = np.ones((channels,), np.float32)
    else:
        raise ValueError(f"unknown serve preprocess kind '{kind}' "
                         f"(have {INGEST_KINDS})")
    if mean.shape[0] != channels:
        raise ValueError(f"'{kind}' normalization is {mean.shape[0]}-channel; "
                         f"input has {channels}")
    return mean, std


@functools.lru_cache(maxsize=64)
def device_scalar(value, device) -> torch.Tensor:
    """float32 constant(s) ``value`` (a float or a tuple) as a tensor ON
    ``device``, made once per device.  Divide by this, never by a Python
    scalar: CUDA turns division by a host scalar into a reciprocal
    multiply, which is not bit-identical to the division the kernel and
    the JAX reference perform.  Made outside inference mode even when
    the first caller runs in it: the cached constant is shared with
    autograd callers (the YOLO loss divides by its grid), and an
    inference tensor cannot be saved for backward."""
    with torch.inference_mode(False):
        return torch.tensor(value, dtype=torch.float32, device=device)


def serve_ingest_plain(x: torch.Tensor, kind: str, act_scale: float = 1.0,
                       quantize: bool = True) -> torch.Tensor:
    """The PyTorch version of the kernel, on any device."""
    mean, std = ingest_norm_constants(kind, x.shape[-1])
    dev = x.device
    y = x.to(torch.float32) / device_scalar(255.0, dev)
    y = ((y - device_scalar(tuple(mean.tolist()), dev))
         / device_scalar(tuple(std.tolist()), dev))
    if not quantize:
        return y
    q = torch.round(y / device_scalar(float(act_scale), dev))
    return q.clamp_(-127.0, 127.0).to(torch.int8)


def _check(x: torch.Tensor, kind: str) -> None:
    if x.dtype != torch.uint8:
        raise TypeError(f"serve_ingest takes uint8 input, got {x.dtype}")
    if x.dim() != 4:
        raise ValueError(f"serve_ingest takes a 4-D NHWC batch, got shape "
                         f"{tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError("serve_ingest takes a contiguous NHWC batch")
    if x.device.type not in ("cuda", "cpu"):
        raise ValueError(f"serve_ingest runs on cuda or cpu, got {x.device}")
    if kind not in INGEST_KINDS:
        raise ValueError(f"unknown serve preprocess kind '{kind}' "
                         f"(have {INGEST_KINDS})")


@counted
def serve_ingest(x: torch.Tensor, kind: str, act_scale: float = 1.0,
                 quantize: bool = True) -> torch.Tensor:
    """uint8 ``(B, H, W, C)`` → int8 (``quantize``) or float32, same shape.

    A CUDA tensor launches ``csrc/serve_ingest.cu`` on the current
    stream and counts the launch in ``serve_ingest.launches``; a CPU
    tensor takes :func:`serve_ingest_plain`."""
    _check(x, kind)
    if x.device.type == "cpu":
        return serve_ingest_plain(x, kind, act_scale, quantize)
    channels = x.shape[-1]
    if channels > MAX_CHANNELS:
        raise ValueError(f"serve_ingest kernel takes at most {MAX_CHANNELS} "
                         f"channels, got {channels}")
    mean, std = ingest_norm_constants(kind, channels)
    out = torch.empty(x.shape, device=x.device,
                      dtype=torch.int8 if quantize else torch.float32)
    if x.numel() == 0:  # nothing to launch, so nothing to count
        return out
    lib = _library()
    vectorized = x.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0
    mean_c = (ctypes.c_float * channels)(*mean.tolist())
    std_c = (ctypes.c_float * channels)(*std.tolist())
    stream = torch.cuda.current_stream(x.device).cuda_stream
    # the runtime launches on the thread's current device, which must be
    # the stream's (a rank on another card than the thread's current one)
    with torch.cuda.device(x.device):
        err = lib.dvt_serve_ingest(
            x.data_ptr(), out.data_ptr(), x.numel(), channels,
            ctypes.cast(mean_c, ctypes.c_void_p),
            ctypes.cast(std_c, ctypes.c_void_p),
            float(act_scale), int(bool(quantize)), int(vectorized), stream)
    if err != 0:
        msg = lib.dvt_cuda_error_string(err).decode()
        raise RuntimeError(f"serve_ingest kernel launch failed: {msg} "
                           f"(cudaError {err})")
    serve_ingest.launches += 1
    return out


@functools.cache
def _library() -> ctypes.CDLL:
    from deep_vision_tpu_torch.ops import _build

    lib = _build.load("serve_ingest")
    fn = lib.dvt_serve_ingest
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                   ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_float, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.dvt_cuda_error_string.argtypes = [ctypes.c_int]
    lib.dvt_cuda_error_string.restype = ctypes.c_char_p
    return lib
