"""Shared building blocks: layers that hold float32 (or int8-resident)
weights and compute in the model's dtype, with the reference's numerics.

Port of ``deep_vision_tpu/models/common.py``.  The layers subclass
``nn.Conv2d``/``nn.Linear``/``nn.BatchNorm2d`` so their ``state_dict``
keys are torchvision's.  Conventions, as in the reference:

- parameters are float32 (bfloat16 after a bf16 serving cast) and are
  cast to the compute dtype at use;
- a weight quantized for int8 serving (``serve/quant.py``) is an int8
  buffer named ``weight`` beside a float32 per-output-channel
  ``weight_scale``; it is dequantized inside each forward, and no float
  copy is kept;
- BatchNorm computes ``(x - mean) * (rsqrt(var + eps) * scale) + bias``
  in float32, then casts to the compute dtype.  In eval mode ``mean`` and
  ``var`` are the running statistics.  In training mode (``.train()``)
  they are the batch's, with flax's numerics (float32 ``E[x]`` and
  ``max(E[x²] − E[x]², 0)``), and the running statistics move as
  ``0.9·running + 0.1·batch`` with the BIASED batch variance, as flax's
  ``BatchNorm(momentum=0.9)`` does.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn


def conv_kernel_init(weight: torch.Tensor, generator: torch.Generator):
    """He normal over fan-out (the reference's kaiming_normal fan_out)."""
    fan_out = weight.shape[0] * math.prod(weight.shape[2:])
    with torch.no_grad():
        return weight.normal_(0.0, math.sqrt(2.0 / fan_out),
                              generator=generator)


def dense_kernel_init(weight: torch.Tensor, generator: torch.Generator):
    """LeCun normal, truncated at two standard deviations (flax's Dense
    default): std = sqrt(1/fan_in) / 0.8796."""
    std = math.sqrt(1.0 / weight.shape[1]) / 0.87962566103423978
    with torch.no_grad():
        return nn.init.trunc_normal_(weight, 0.0, std, -2.0 * std, 2.0 * std,
                                     generator=generator)


def lecun_conv_init(weight: torch.Tensor, generator: torch.Generator):
    """flax's default conv kernel init: LeCun normal over fan-in,
    truncated at two standard deviations."""
    fan_in = weight.shape[1] * math.prod(weight.shape[2:])
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    with torch.no_grad():
        return nn.init.trunc_normal_(weight, 0.0, std, -2.0 * std, 2.0 * std,
                                     generator=generator)


def same_pad(size: int, kernel: int, stride: int) -> tuple[int, int]:
    """flax/XLA "SAME" padding (before, after) of one spatial dim: the
    odd pixel goes after."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def global_avg_pool(x: torch.Tensor) -> torch.Tensor:
    """(N, C, H, W) → (N, C) mean over space."""
    return x.mean(dim=(2, 3))


def dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """int8 weight × its per-output-channel (dim 0) float32 scale."""
    return q.to(torch.float32) * scale.view(-1, *([1] * (q.dim() - 1)))


def resident_weight(module: nn.Module, dtype: torch.dtype) -> torch.Tensor:
    """``module.weight`` in ``dtype``, dequantized first if int8."""
    w = module.weight
    if w.dtype == torch.int8:
        w = dequantize(w, module.weight_scale)
    return w.to(dtype)


class Conv2d(nn.Conv2d):
    """Convolution computing in ``dtype`` (input, weight and bias cast);
    bias-free unless ``bias``."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int, stride: int = 1,
                 padding: int = 0, dtype: torch.dtype = torch.float32,
                 bias: bool = False):
        super().__init__(in_ch, out_ch, kernel, stride, padding, bias=bias)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        bias = None if self.bias is None else self.bias.to(dt)
        return F.conv2d(x.to(dt), resident_weight(self, dt), bias,
                        self.stride, self.padding)


class Linear(nn.Linear):
    """Dense layer computing in ``dtype``."""

    def __init__(self, in_features: int, out_features: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__(in_features, out_features)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        return F.linear(x.to(dt), resident_weight(self, dt),
                        self.bias.to(dt))


#: flax's BatchNorm momentum: running = MOMENTUM·running + (1−MOMENTUM)·batch
BN_MOMENTUM = 0.9


class _TrainBatchNorm(torch.autograd.Function):
    """Training BatchNorm over (N, H, W) of an (N, C, H, W) input.

    The backward keeps only the compute-dtype input and the per-channel
    float32 ``mean`` and ``rstd``: built from float32 elementwise ops,
    autograd would keep several float32 copies of every activation, which
    at batch 256 does not fit on an 80 GB card."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps, out_dtype):
        shape = (1, -1, 1, 1)
        xf = x.to(torch.float32)
        mean = xf.mean(dim=(0, 2, 3))
        mean2 = (xf * xf).mean(dim=(0, 2, 3))
        var = torch.clamp_min(mean2 - mean * mean, 0.0)
        rstd = torch.rsqrt(var + eps)
        mul = rstd * weight.to(torch.float32)
        y = (xf - mean.view(shape)) * mul.view(shape) + \
            bias.to(torch.float32).view(shape)
        ctx.save_for_backward(x, weight, mean, rstd)
        ctx.mark_non_differentiable(mean, var)
        return y.to(out_dtype), mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        x, weight, mean, rstd = ctx.saved_tensors
        shape = (1, -1, 1, 1)
        n = x.numel() // x.shape[1]
        dyf = dy.to(torch.float32)
        xhat = (x.to(torch.float32) - mean.view(shape)) * rstd.view(shape)
        dbias = dyf.sum(dim=(0, 2, 3))
        dscale = (dyf * xhat).sum(dim=(0, 2, 3))
        dx = None
        if ctx.needs_input_grad[0]:
            dx = (dyf - (dbias / n).view(shape)
                  - xhat * (dscale / n).view(shape)) * \
                (rstd * weight.to(torch.float32)).view(shape)
            dx = dx.to(x.dtype)
        return (dx, dscale.to(weight.dtype), dbias.to(weight.dtype), None,
                None)


class BatchNorm2d(nn.BatchNorm2d):
    """BatchNorm with the reference's (flax's) formula and rounding: batch
    statistics in training mode, running statistics in eval mode."""

    def __init__(self, features: int, dtype: torch.dtype = torch.float32):
        super().__init__(features, eps=1e-5, momentum=0.1)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            y, mean, var = _TrainBatchNorm.apply(
                x, self.weight, self.bias, self.eps, self.compute_dtype)
            with torch.no_grad():
                self.running_mean.copy_(BN_MOMENTUM * self.running_mean
                                        + (1.0 - BN_MOMENTUM) * mean)
                self.running_var.copy_(BN_MOMENTUM * self.running_var
                                       + (1.0 - BN_MOMENTUM) * var)
            return y
        shape = (1, -1, 1, 1)
        mul = torch.rsqrt(self.running_var + self.eps) * \
            self.weight.to(torch.float32)
        y = (x.to(torch.float32) - self.running_mean.view(shape)) * \
            mul.view(shape) + self.bias.to(torch.float32).view(shape)
        return y.to(self.compute_dtype)
