"""``train_ingest``: uint8 NHWC train batch + per-image color-jitter
factors → jittered, normalized float32.

The counterpart of the Pallas kernel ``deep_vision_tpu/ops/pallas_ops.py``
``train_ingest`` (:248) and its factor draw ``train_ingest_factors``
(:222).  Per image ``b`` with factors ``[fb, fc, fs, m]`` and per pixel:

    x = u / 255 · fb                       brightness
    x = (x − m) · fc + m                   contrast about the mean m
    gray = (r·0.299 + g·0.587) + b·0.114
    x = clip(gray + (x − gray) · fs, 0, 1) saturation
    y = (x − mean[c]) / std[c]

On a CUDA tensor, :func:`train_ingest` launches the hand-written kernel
``csrc/train_ingest.cu`` or raises; on a CPU tensor it computes
:func:`train_ingest_plain`, the PyTorch version of the same arithmetic
that the tests and ``chip_smoke.py`` hold the kernel against.  Both
perform the same IEEE operations in the same order, so they agree bit
for bit.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from deep_vision_tpu_torch.ops import counted
from deep_vision_tpu_torch.ops.ingest import (
    INGEST_KINDS,
    device_scalar,
    ingest_norm_constants,
)

#: per-pixel grayscale weights (R, G, B), the reference's ``_GRAY``
GRAY = (0.299, 0.587, 0.114)


def jitter_uniform(b: int, strength: float,
                   generator: torch.Generator | None,
                   device) -> torch.Tensor:
    """``b`` float32 draws from ``U[max(0, 1−a), 1+a]`` for ``a`` the
    jitter ``strength`` (the reference's factor range)."""
    lo, hi = max(0.0, 1.0 - strength), 1.0 + strength
    u = torch.rand(b, generator=generator, device=device,
                   dtype=torch.float32)
    return u * (hi - lo) + lo


def train_ingest_factors(x: torch.Tensor, generator: torch.Generator | None,
                         brightness: float = 0.2, contrast: float = 0.2,
                         saturation: float = 0.2) -> torch.Tensor:
    """Per-image jitter factors ``(B, 4)`` float32 ``[fb, fc, fs, m]``.

    ``fb, fc, fs ~ U[max(0, 1−a), 1+a]`` for ``a`` the brightness,
    contrast and saturation strengths, drawn from ``generator`` (on
    ``x``'s device) in that order; ``m = fb · mean(x / 255)`` is the
    post-brightness image mean the contrast pivots about.  The mean is an
    integer sum over the image divided by ``H·W·C·255``, so no float copy
    of the batch is made.  The JAX RNG's bits cannot be reproduced: this
    draw matches the reference's distributions, not its numbers."""
    b = x.shape[0]
    fb = jitter_uniform(b, brightness, generator, x.device)
    fc = jitter_uniform(b, contrast, generator, x.device)
    fs = jitter_uniform(b, saturation, generator, x.device)
    per_image = x[0].numel() * 255.0
    total = x.sum(dim=tuple(range(1, x.dim())), dtype=torch.int64)
    m = fb * (total.to(torch.float64) / per_image).to(torch.float32)
    return torch.stack([fb, fc, fs, m], dim=1)


def train_ingest_plain(x: torch.Tensor, factors: torch.Tensor,
                       kind: str = "imagenet") -> torch.Tensor:
    """The PyTorch version of the kernel, on any device."""
    mean, std = ingest_norm_constants(kind, x.shape[-1])
    dev = x.device
    f = factors.to(torch.float32).view(-1, 4, *([1] * (x.dim() - 1)))
    fb, fc, fs, m = f[:, 0], f[:, 1], f[:, 2], f[:, 3]
    y = x.to(torch.float32) / device_scalar(255.0, dev)
    y = y * fb
    y = (y - m) * fc + m
    gray = (y[..., 0:1] * GRAY[0] + y[..., 1:2] * GRAY[1]) \
        + y[..., 2:3] * GRAY[2]
    y = gray + (y - gray) * fs
    y = y.clamp(0.0, 1.0)
    return ((y - device_scalar(tuple(mean.tolist()), dev))
            / device_scalar(tuple(std.tolist()), dev))


def _check(x: torch.Tensor, factors: torch.Tensor, kind: str) -> None:
    if x.dtype != torch.uint8:
        raise TypeError(f"train_ingest takes uint8 input, got {x.dtype}")
    if x.dim() != 4 or x.shape[-1] != 3:
        raise ValueError(f"train_ingest takes a (B, H, W, 3) NHWC batch, "
                         f"got shape {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError("train_ingest takes a contiguous NHWC batch")
    if factors.shape != (x.shape[0], 4):
        raise ValueError(f"train_ingest takes (B, 4) factors for B="
                         f"{x.shape[0]}, got {tuple(factors.shape)}")
    if factors.device != x.device:
        raise ValueError(f"factors on {factors.device}, batch on {x.device}")
    if x.device.type not in ("cuda", "cpu"):
        raise ValueError(f"train_ingest runs on cuda or cpu, got {x.device}")
    if kind not in INGEST_KINDS:
        raise ValueError(f"unknown preprocess kind '{kind}' "
                         f"(have {INGEST_KINDS})")


#: the least image size, in pixels, of the kernel's tiled path: a group
#: of a thread's pixels then spans at most two images
MIN_TILED_IMAGE = 16


def tiled_path(x_ptr: int, out_ptr: int, pixels: int) -> bool:
    """Whether the kernel may take its tiled path for a batch at address
    ``x_ptr`` into an output at ``out_ptr`` with ``pixels`` pixels an
    image: its 16-byte loads and stores need both bases 16-byte aligned.
    Otherwise (a view such as ``x[1:]``, or tiny images) the kernel takes
    its per-pixel loop for the whole batch."""
    return x_ptr % 16 == 0 and out_ptr % 16 == 0 and pixels >= MIN_TILED_IMAGE


def division_magic(pixels: int, total: int) -> tuple[int, int]:
    """``(magic, shift)`` with ``((q·magic) >> 64) >> shift == q // pixels``
    for every ``0 <= q < total`` (``total <= 2**63``, ``pixels >= 2``):
    the kernel finds a pixel's image with one 64-bit multiply-high.

    With ``magic = ceil(2**s / pixels)`` the error ``e = magic·pixels −
    2**s`` is below ``pixels``, and the quotient is exact while
    ``q·e < 2**s``; ``2**s > (total − 1)·(pixels − 1)`` ensures it, and
    ``s >= 64`` keeps ``magic`` within 64 bits.  ``pixels == 1`` needs no
    division: ``(0, 0)``."""
    if pixels < 1 or total < 0 or total > 2 ** 63:
        raise ValueError(f"no magic for pixels={pixels}, total={total}")
    if pixels == 1:
        return 0, 0
    s = max(64, (max(total - 1, 0) * (pixels - 1)).bit_length())
    return -(-(1 << s) // pixels), s - 64


@counted
def train_ingest(x: torch.Tensor, factors: torch.Tensor,
                 kind: str = "imagenet") -> torch.Tensor:
    """uint8 ``(B, H, W, 3)`` + ``(B, 4)`` factors → float32, same shape.

    A CUDA tensor launches ``csrc/train_ingest.cu`` on the current stream
    and counts the launch in ``train_ingest.launches``; a CPU tensor
    takes :func:`train_ingest_plain`."""
    _check(x, factors, kind)
    if x.device.type == "cpu":
        return train_ingest_plain(x, factors, kind)
    mean, std = ingest_norm_constants(kind, 3)
    out = torch.empty(x.shape, device=x.device, dtype=torch.float32)
    if x.numel() == 0:  # nothing to launch, so nothing to count
        return out
    factors = factors.to(torch.float32).contiguous()
    if factors.data_ptr() % 16:  # the kernel reads a row as one float4
        factors = factors.clone()
    batch, pixels = x.shape[0], x.shape[1] * x.shape[2]
    magic, shift = division_magic(pixels, batch * pixels)
    mean_c = (ctypes.c_float * 3)(*mean.tolist())
    std_c = (ctypes.c_float * 3)(*std.tolist())
    lib = _library()
    with torch.cuda.device(x.device):  # launch on the stream's device
        err = lib.dvt_train_ingest(
            x.data_ptr(), factors.data_ptr(), out.data_ptr(), batch, pixels,
            ctypes.cast(mean_c, ctypes.c_void_p),
            ctypes.cast(std_c, ctypes.c_void_p),
            int(tiled_path(x.data_ptr(), out.data_ptr(), pixels)), magic,
            shift, torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        msg = lib.dvt_train_ingest_error_string(err).decode()
        raise RuntimeError(f"train_ingest kernel launch failed: {msg} "
                           f"(cudaError {err})")
    train_ingest.launches += 1
    return out


@functools.cache
def _library() -> ctypes.CDLL:
    from deep_vision_tpu_torch.ops import _build

    lib = _build.load("train_ingest")
    fn = lib.dvt_train_ingest
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_longlong, ctypes.c_longlong, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_int, ctypes.c_ulonglong,
                   ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.dvt_train_ingest_error_string.argtypes = [ctypes.c_int]
    lib.dvt_train_ingest_error_string.restype = ctypes.c_char_p
    return lib
