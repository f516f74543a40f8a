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
  ``m·running + (1 − m)·batch`` with the BIASED batch variance, as flax's
  ``BatchNorm(momentum=m)`` does: ``m`` is 0.9 where the reference sets
  it, flax's default 0.99 in the GAN family.  A training forward whose
  statistics the reference discards (``update_stats`` False) normalizes
  by the batch and leaves the running statistics alone.

The classifier zoo's pieces: ``ConvBN`` (groups, flax "SAME" or
symmetric padding, the BatchNorm's eps), ``local_response_norm``,
``Dropout`` drawing from an explicit generator that the trainer sets
every step, flax's "SAME" max and average pools, ``reset_weights`` (the
reference's inits by layer) and the ``Classifier`` and
``SequentialClassifier`` bases.

``ConvTranspose2d`` is flax's ``ConvTranspose`` (``transpose_kernel``
False): a correlation of the stride-dilated input with the kernel as
stored, with ``lax``'s transposed "SAME" padding.  Its weight is kept
``(out, in, kH, kW)``, the layout of that correlation, so the int8
serving scale runs along dim 0 (the output channels) as for every other
kernel.
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
    bias-free unless ``bias``.  ``padding`` is torch's symmetric padding
    or ``"SAME"``, flax's: the odd pixel after (:func:`same_pad`), which
    at a stride above 1 on an even input is asymmetric.  ``init`` names
    the kernel init :func:`reset_weights` gives it: ``"he"``
    (:func:`conv_kernel_init`) or ``"lecun"`` (flax's default)."""

    def __init__(self, in_ch: int, out_ch: int, kernel, stride: int = 1,
                 padding=0, dtype: torch.dtype = torch.float32,
                 bias: bool = False, groups: int = 1, init: str = "he"):
        same = padding == "SAME"
        super().__init__(in_ch, out_ch, kernel, stride,
                         0 if same else padding, bias=bias, groups=groups)
        self.same = same
        self.compute_dtype = dtype
        self.init = init

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        bias = None if self.bias is None else self.bias.to(dt)
        x = x.to(dt)
        padding = self.padding
        if self.same:
            (ht, hb), (wl, wr) = (
                same_pad(x.shape[2 + d], self.kernel_size[d], self.stride[d])
                for d in range(2))
            if ht == hb and wl == wr:
                padding = (ht, wl)
            else:
                x, padding = F.pad(x, (wl, wr, ht, hb)), 0
        return F.conv2d(x, resident_weight(self, dt), bias, self.stride,
                        padding, 1, self.groups)


def conv_transpose_same_pad(kernel: int, stride: int) -> tuple[int, int]:
    """``lax.conv_transpose``'s "SAME" padding (before, after) of the
    stride-dilated input: ``k + s − 2`` in all, ``k − 1`` before when
    ``s > k − 1``, else half of it rounded up."""
    total = kernel + stride - 2
    before = kernel - 1 if stride > kernel - 1 else -(-total // 2)
    return before, total - before


class ConvTranspose2d(Conv2d):
    """flax ``ConvTranspose(padding="SAME", transpose_kernel=False,
    use_bias=False)``: output ``size·stride``, computed by ``F.conv_transpose2d`` with the
    stored kernel flipped in both spatial axes and its two channel axes
    swapped.  ``conv_transpose2d`` pads the dilated input by ``k − 1 −
    padding`` on both sides (plus ``output_padding`` after); where flax
    pads less after than before, the extra last rows and columns are
    cropped."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int,
                 stride: int = 1, dtype: torch.dtype = torch.float32):
        super().__init__(in_ch, out_ch, kernel, 1, 0, dtype, init="lecun")
        before, after = conv_transpose_same_pad(kernel, stride)
        self.transpose_stride = stride
        self.transpose_padding = kernel - 1 - before
        self.output_pad = max(after - before, 0)
        self.crop = max(before - after, 0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        w = resident_weight(self, dt).flip(2, 3).transpose(0, 1)
        y = F.conv_transpose2d(x.to(dt), w, None, self.transpose_stride,
                               self.transpose_padding, self.output_pad)
        if self.crop:
            y = y[:, :, :y.shape[2] - self.crop, :y.shape[3] - self.crop]
        return y


class Linear(nn.Linear):
    """Dense layer computing in ``dtype``; bias-free when not ``bias``."""

    def __init__(self, in_features: int, out_features: int,
                 dtype: torch.dtype = torch.float32, bias: bool = True):
        super().__init__(in_features, out_features, bias=bias)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        bias = None if self.bias is None else self.bias.to(dt)
        return F.linear(x.to(dt), resident_weight(self, dt), bias)


#: the reference's BatchNorm momentum where it sets one:
#: running = MOMENTUM·running + (1−MOMENTUM)·batch
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
    statistics in training mode, running statistics in eval mode.
    ``momentum`` is flax's (the running statistics' share kept); a
    training forward with ``update_stats`` False leaves them alone."""

    def __init__(self, features: int, dtype: torch.dtype = torch.float32,
                 eps: float = 1e-5, momentum: float = BN_MOMENTUM):
        super().__init__(features, eps=eps, momentum=1.0 - momentum)
        self.compute_dtype = dtype
        self.flax_momentum = momentum
        self.update_stats = True

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            y, mean, var = _TrainBatchNorm.apply(
                x, self.weight, self.bias, self.eps, self.compute_dtype)
            if self.update_stats:
                m = self.flax_momentum
                with torch.no_grad():
                    self.running_mean.copy_(m * self.running_mean
                                            + (1.0 - m) * mean)
                    self.running_var.copy_(m * self.running_var
                                           + (1.0 - m) * var)
            return y
        shape = (1, -1, 1, 1)
        mul = torch.rsqrt(self.running_var + self.eps) * \
            self.weight.to(torch.float32)
        y = (x.to(torch.float32) - self.running_mean.view(shape)) * \
            mul.view(shape) + self.bias.to(torch.float32).view(shape)
        return y.to(self.compute_dtype)


class ConvBN(nn.Module):
    """Conv (no bias, He init) → BatchNorm → optional activation: the
    reference's ``ConvBN``, with ``groups`` (depthwise when it equals the
    channels), flax ``padding`` ("SAME" by default, else torch's
    symmetric) and the BatchNorm's ``eps``.  Children ``conv`` and
    ``bn``."""

    def __init__(self, in_ch: int, out_ch: int, kernel=3, stride: int = 1,
                 padding="SAME", groups: int = 1, act=F.relu,
                 eps: float = 1e-5, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv = Conv2d(in_ch, out_ch, kernel, stride, padding, dtype,
                           groups=groups)
        self.bn = BatchNorm2d(out_ch, dtype, eps)
        self.act = act

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.bn(self.conv(x))
        return x if self.act is None else self.act(x)


def local_response_norm(x: torch.Tensor, size: int, alpha: float = 1e-4,
                        beta: float = 0.75, k: float = 1.0) -> torch.Tensor:
    """Cross-channel LRN of an (N, C, H, W) input:
    ``x / (k + alpha/size · Σ x²)^beta`` over the channel window
    ``[c − size//2, c + (size−1)//2]``, zeros beyond the edges — the
    reference's window ``(half, size − 1 − half)``.  The reference's
    models pass the full channel count as ``size``.  The window sums are
    one matmul of the squares by a 0/1 band matrix over the channels (a
    GEMM over rows of C channels in the channels-last layout), in the
    input's dtype."""
    c = x.shape[1]
    idx = torch.arange(c, device=x.device)
    offset = idx[None, :] - idx[:, None]  # band[i, j]: j in i's window
    band = ((offset >= -(size // 2)) & (offset <= (size - 1) // 2)) \
        .to(x.dtype)
    sums = torch.matmul((x * x).permute(0, 2, 3, 1), band.t())
    return x / (k + alpha / size * sums.permute(0, 3, 1, 2)).pow(beta)


class LocalResponseNorm(nn.Module):
    """:func:`local_response_norm` as a module (no parameters)."""

    def __init__(self, size: int):
        super().__init__()
        self.size = size

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return local_response_norm(x, self.size)


class Dropout(nn.Module):
    """Dropout drawing its mask from an explicit ``torch.Generator``.

    In training mode with ``0 < rate < 1`` each element is kept with
    probability ``1 − rate`` and scaled by ``1/(1 − rate)`` (flax's
    ``Dropout``: ``where(keep, x / keep_prob, 0)``); ``rate`` 0 and eval
    mode pass the input through, ``rate`` 1 gives zeros.  The mask comes
    from ``self.generator`` (on the input's device), which the trainer
    sets for every step (:func:`set_dropout_generator`); a training
    forward without one raises, as flax does without a ``dropout``
    rng."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = float(rate)
        self.generator: torch.Generator | None = None

    def forward(self, x: torch.Tensor,
                keep: torch.Tensor | None = None) -> torch.Tensor:
        """``keep`` (bool, ``x``'s shape), when given, is the mask itself
        and no draw is made."""
        if not self.training or self.rate == 0.0:
            return x
        if self.rate >= 1.0:
            return torch.zeros_like(x)
        keep_prob = 1.0 - self.rate
        if keep is None:
            if self.generator is None:
                raise RuntimeError("a training forward through Dropout "
                                   "needs a generator: call "
                                   "set_dropout_generator")
            keep = torch.rand(x.shape, generator=self.generator,
                              device=x.device) < keep_prob
        return torch.where(keep, x / keep_prob, torch.zeros((), dtype=x.dtype,
                                                            device=x.device))


def set_dropout_generator(model: nn.Module,
                          generator: torch.Generator | None) -> int:
    """Give every :class:`Dropout` of ``model`` ``generator`` (None
    clears it); returns how many there are.  They draw from it in call
    order."""
    n = 0
    for m in model.modules():
        if isinstance(m, Dropout):
            m.generator = generator
            n += 1
    return n


def max_pool_same(x: torch.Tensor, kernel: int, stride: int) -> torch.Tensor:
    """flax ``max_pool(..., padding="SAME")``: the :func:`same_pad`
    borders filled with −inf, then a VALID pool (torch's ``ceil_mode``
    differs at odd sizes)."""
    (ht, hb), (wl, wr) = (same_pad(x.shape[2 + d], kernel, stride)
                          for d in range(2))
    if ht or hb or wl or wr:
        x = F.pad(x, (wl, wr, ht, hb), value=float("-inf"))
    return F.max_pool2d(x, kernel, stride)


def avg_pool_same(x: torch.Tensor, kernel: int, stride: int) -> torch.Tensor:
    """flax ``avg_pool(..., padding="SAME")``: zero borders that count in
    the divisor (``kernel²`` everywhere), the odd pixel after."""
    (ht, hb), (wl, wr) = (same_pad(x.shape[2 + d], kernel, stride)
                          for d in range(2))
    if ht or hb or wl or wr:
        x = F.pad(x, (wl, wr, ht, hb))
    return F.avg_pool2d(x, kernel, stride)


def reset_weights(model: nn.Module, generator: torch.Generator) -> None:
    """The reference's init for a model built of these layers, in module
    order: each conv's kernel by its ``init`` ("he" or "lecun"), dense
    kernels LeCun normal, every bias 0, BatchNorm scale 1, running
    mean 0 and variance 1."""
    for m in model.modules():
        if isinstance(m, Conv2d):
            init = conv_kernel_init if m.init == "he" else lecun_conv_init
            init(m.weight, generator)
        elif isinstance(m, Linear):
            dense_kernel_init(m.weight, generator)
        elif isinstance(m, BatchNorm2d):
            m.reset_parameters()
            continue
        else:
            continue
        if m.bias is not None:
            nn.init.zeros_(m.bias)


class Classifier(nn.Module):
    """Base of the classifier zoo: ``forward`` takes the reference's NHWC
    layout (a view of NCHW under ``torch.channels_last``) and returns
    float32 logits; :meth:`reset_parameters` is :func:`reset_weights`."""

    def set_compute_dtype(self, dtype: torch.dtype) -> "Classifier":
        for m in self.modules():
            if hasattr(m, "compute_dtype"):
                m.compute_dtype = dtype
        return self

    def reset_parameters(self, generator: torch.Generator) -> "Classifier":
        reset_weights(self, generator)
        return self


class SequentialClassifier(Classifier):
    """``features`` (convolutions, activations, pools) → flatten →
    ``classifier`` (dense layers): the reference's PyTorch layout of its
    plain CNNs (``features.N``/``classifier.N``, the layers at the
    indices its published checkpoints use).  The flatten is NCHW, as in
    that layout; the reference flattens NHWC, so ``convert.py`` permutes
    the first dense kernel over ``(C, *flatten_hw)``, the shape of the
    last feature map at ``image_size``."""

    flatten_hw: tuple[int, int] = (1, 1)

    def __init__(self, dtype: torch.dtype):
        super().__init__()
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """NHWC ``(N, H, W, C)`` float input → float32 logits."""
        x = self.features(x.permute(0, 3, 1, 2).to(self.compute_dtype))
        return self.classifier(torch.flatten(x, 1)).to(torch.float32)
