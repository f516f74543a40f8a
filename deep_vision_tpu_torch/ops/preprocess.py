"""Input prologues: the serving wire's decode, normalize and quantize,
the training batch's color jitter and normalize, and the [0, 1] scale of
detection batches.

Port of ``deep_vision_tpu/ops/preprocess.py`` (the serving prologues,
``jitter_normalize``, ``make_imagenet_preprocess``,
``make_mnist_preprocess``, ``make_scale_preprocess`` and
``make_gan_preprocess``).  Each function
takes and returns NHWC tensors, the JAX package's layout.
"""

from __future__ import annotations

import numpy as np
import torch

from deep_vision_tpu_torch.data.mnist import MEAN as MNIST_MEAN
from deep_vision_tpu_torch.data.mnist import STD as MNIST_STD
from deep_vision_tpu_torch.data.transforms import IMAGENET_MEAN, IMAGENET_STD
from deep_vision_tpu_torch.ops.ingest import device_scalar, serve_ingest
from deep_vision_tpu_torch.ops.train_ingest import (
    GRAY,
    jitter_uniform,
    train_ingest,
    train_ingest_factors,
)

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
    normalized here, through :func:`serve_ingest` with float32 out (the
    CUDA kernel on the card, bit-identical to :func:`serve_normalize`)
    for the kinds it holds, :func:`serve_normalize` for "gan"; a float
    wire arrives normalized by the client.  Either way the batch leaves
    in ``compute_dtype``."""
    wire_is_int = not wire_dtype.is_floating_point

    def fn(x):
        if wire_is_int:
            x = serve_normalize(x, kind) if kind == "gan" \
                else serve_ingest(x, kind, quantize=False)
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


def jitter_normalize(images: torch.Tensor, generator: torch.Generator | None,
                     train: bool, mean=IMAGENET_MEAN, std=IMAGENET_STD,
                     brightness: float = 0.2, contrast: float = 0.2,
                     saturation: float = 0.2) -> torch.Tensor:
    """uint8 ``(B, H, W, 3)`` → normalized float32, with train-time color
    jitter: the reference's multi-op XLA path, kept as the plain
    reference of :func:`train_ingest`.  The factors come from
    ``generator`` in the order :func:`train_ingest_factors` draws them
    (brightness, contrast, saturation), so both paths see the same
    factors from one seed."""
    dev = images.device
    x = images.to(torch.float32) / device_scalar(255.0, dev)
    if train:
        b = images.shape[0]
        shape = (b, 1, 1, 1)
        fb = jitter_uniform(b, brightness, generator, dev).view(shape)
        fc = jitter_uniform(b, contrast, generator, dev).view(shape)
        fs = jitter_uniform(b, saturation, generator, dev).view(shape)
        x = x * fb
        m = x.mean(dim=(1, 2, 3), keepdim=True)
        x = (x - m) * fc + m
        gray = (x * device_scalar(GRAY, dev)).sum(-1, keepdim=True)
        x = gray + (x - gray) * fs
        x = x.clamp(0.0, 1.0)
    return ((x - device_scalar(tuple(np.asarray(mean).tolist()), dev))
            / device_scalar(tuple(np.asarray(std).tolist()), dev))


def make_imagenet_preprocess(brightness: float = 0.2, contrast: float = 0.2,
                             saturation: float = 0.2):
    """The trainer's ``preprocess_fn(batch, generator, train)`` for uint8
    ImageNet batches already on the device.  Train batches take
    :func:`train_ingest` (the CUDA kernel on the card) with factors drawn
    from ``generator``; eval batches take the plain normalize, as in the
    reference, where eval is XLA and not Pallas.  Float batches (host
    normalized, e.g. ``--synthetic``) pass through untouched."""

    def fn(batch: dict, generator: torch.Generator | None,
           train: bool) -> dict:
        img = batch["image"]
        if img.dtype != torch.uint8:
            return batch
        out = dict(batch)
        if train:
            factors = train_ingest_factors(img, generator, brightness,
                                           contrast, saturation)
            out["image"] = train_ingest(img, factors)
        else:
            out["image"] = serve_normalize(img, "imagenet")
        return out

    return fn


def make_mnist_preprocess():
    """The trainer's ``preprocess_fn(batch, generator, train)`` for the
    grayscale path: a uint8 batch on the device (``data/mnist.load_mnist
    (device_normalize=True)``) is standardized with the MNIST statistics
    by :func:`serve_normalize`, in train and eval alike — plain PyTorch,
    as the reference's is XLA and not a Pallas kernel.  Float batches
    (host-normalized) pass through untouched."""

    def fn(batch: dict, generator: torch.Generator | None,
           train: bool) -> dict:
        img = batch["image"]
        if img.dtype != torch.uint8:
            return batch
        return {**batch, "image": serve_normalize(img, "mnist")}

    return fn


def make_scale_preprocess():
    """The trainer's ``preprocess_fn(batch, generator, train)`` for
    [0, 1]-input tasks (YOLO): a uint8 image batch on the device becomes
    float32 / 255, dividing by a device tensor (PyTorch on CUDA would
    turn a host-scalar division into a reciprocal multiply).  Float
    batches (host-normalized) pass through untouched."""

    def fn(batch: dict, generator: torch.Generator | None,
           train: bool) -> dict:
        img = batch["image"]
        if img.dtype != torch.uint8:
            return batch
        return {**batch, "image": img.to(torch.float32)
                / device_scalar(255.0, img.device)}

    return fn


def make_gan_preprocess():
    """The adversarial trainer's ``preprocess_fn(batch, generator,
    train)`` for the GAN tasks: every uint8 ``image*`` key (``image``,
    ``image_a``, ``image_b``) becomes ``x/127.5 − 1`` in float32, as
    :func:`serve_normalize`'s "gan" kind divides (by a device tensor);
    float keys (host-scaled images, pooled fakes) and the others pass
    through untouched."""

    def fn(batch: dict, generator: torch.Generator | None,
           train: bool) -> dict:
        out = dict(batch)
        for key, val in batch.items():
            if key.startswith("image") and val.dtype == torch.uint8:
                out[key] = serve_normalize(val, "gan")
        return out

    return fn
