"""Serving prologues: the uint8 wire's decode, normalize and quantize.

Port of the serving half of ``deep_vision_tpu/ops/preprocess.py``.  Each
function takes and returns NHWC tensors, the JAX package's layout.
"""

from __future__ import annotations

import torch

from deep_vision_tpu_torch.data.mnist import MEAN as MNIST_MEAN
from deep_vision_tpu_torch.data.mnist import STD as MNIST_STD
from deep_vision_tpu_torch.data.transforms import IMAGENET_MEAN, IMAGENET_STD
from deep_vision_tpu_torch.ops.ingest import device_scalar, serve_ingest

#: normalization families the serving wire supports; "unit" is plain
#: [0,1] scaling, "gan" the GAN pipelines' [-1,1] scaling
SERVE_KINDS = ("imagenet", "mnist", "unit", "gan")


def serve_preprocess_kind(task: str, channels: int) -> str:
    """Which normalization a model's uint8 wire needs: ImageNet stats for
    RGB classifiers, MNIST stats for grayscale ones, [-1,1] for the GAN
    tasks, plain [0,1] for detection and pose."""
    if task == "classification":
        return "mnist" if channels == 1 else "imagenet"
    if str(task).startswith("gan_"):
        return "gan"
    return "unit"


def serve_normalize(x: torch.Tensor, kind: str) -> torch.Tensor:
    """uint8 wire batch → normalized float32: scale to [0,1] first, then
    standardize, dividing throughout (the reference's op order)."""
    if kind not in SERVE_KINDS:
        raise ValueError(f"unknown serve preprocess kind '{kind}' "
                         f"(have {SERVE_KINDS})")
    dev = x.device
    if kind == "gan":
        return (x.to(torch.float32) / device_scalar(127.5, dev)
                - device_scalar(1.0, dev))
    y = x.to(torch.float32) / device_scalar(255.0, dev)
    if kind == "imagenet":
        return ((y - device_scalar(tuple(IMAGENET_MEAN.tolist()), dev))
                / device_scalar(tuple(IMAGENET_STD.tolist()), dev))
    if kind == "mnist":
        return ((y - device_scalar(MNIST_MEAN, dev))
                / device_scalar(MNIST_STD, dev))
    return y


def make_serve_preprocess(kind: str, wire_dtype: torch.dtype,
                          compute_dtype: torch.dtype = torch.float32):
    """Prologue of the float32/bf16 bucket callables: an integer wire is
    normalized here; a float wire arrives normalized by the client.
    Either way the batch leaves in ``compute_dtype``."""
    wire_is_int = not wire_dtype.is_floating_point

    def fn(x):
        if wire_is_int:
            x = serve_normalize(x, kind)
        return x.to(compute_dtype)

    return fn


def quantize_activations(x: torch.Tensor, act_scale: float) -> torch.Tensor:
    """Normalized float activations → symmetric int8 with the per-tensor
    calibration scale: ``round(x/act_scale)`` clipped to ±127."""
    q = torch.round(x / device_scalar(float(act_scale), x.device))
    return q.clamp_(-127.0, 127.0).to(torch.int8)


def make_int8_ingest(kind: str, wire_dtype: torch.dtype, act_scale: float):
    """Prologue of the int8 bucket callables.  A uint8 wire takes the
    fused :func:`serve_ingest` (the CUDA kernel on the card); a float
    wire was normalized by the client, so only the quantize runs.  The
    "gan" kind has no fused family and keeps the plain path."""
    wire_is_int = not wire_dtype.is_floating_point
    if wire_is_int and kind != "gan":
        def fused(x):
            return serve_ingest(x, kind, act_scale=act_scale)

        return fused

    def plain(x):
        if wire_is_int:
            x = serve_normalize(x, kind)
        return quantize_activations(x, act_scale)

    return plain
