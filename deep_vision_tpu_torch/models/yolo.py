"""Darknet-53 + the YOLOv3 three-scale detector as ``nn.Module``s.

Port of ``deep_vision_tpu/models/yolo.py`` (``YOLO_ANCHORS``,
``ANCHOR_MASKS``, ``DarknetConv``, ``DarknetResidual``, ``Darknet53``,
``YoloConvBlock``, ``YoloHead``, ``YoloV3``) with ``width``, ``blocks``
and ``dtype``.  Numerics follow the reference:

- a stride-2 conv pads one row and column at the top-left only, then
  convolves without padding (darknet's convention); a stride-1 3×3 conv
  pads 1 on every side (flax "SAME");
- conv → training/eval BatchNorm (eps 1e-5, momentum 0.9) → leaky ReLU
  with slope 0.1; Darknet convs have no bias, the head's last 1×1 conv
  has one;
- upsampling is nearest ×2 (a repeat), and the neck concatenates
  ``[upsampled, route]`` along channels;
- the head's output leaves as float32 in the reference's layout
  ``(B, G, G, 3, 5 + C)``, channel ``c`` → anchor ``c // (5 + C)``, and the
  scales come out large grid first (52², 26², 13² at 416²).

``forward`` takes the reference's NHWC layout; run the model in
``torch.channels_last`` and the NHWC input becomes its NCHW view with no
copy.  The module tree mirrors flax's auto-names (``convert.py`` maps
``Darknet53_0/DarknetConv_0`` ↔ ``backbone.convs.0`` and so on).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from deep_vision_tpu_torch.models.common import BatchNorm2d, Conv2d

# (w, h) anchor priors normalized by 416, grouped small → large; scale 0
# (the 52×52 grid at 416²) gets the small anchors
YOLO_ANCHORS = np.array(
    [(10, 13), (16, 30), (33, 23),
     (30, 61), (62, 45), (59, 119),
     (116, 90), (156, 198), (373, 326)], np.float32) / 416.0
ANCHOR_MASKS = np.array([[0, 1, 2], [3, 4, 5], [6, 7, 8]])

LEAKY_SLOPE = 0.1


class DarknetConv(nn.Module):
    """Conv (no bias) → BatchNorm → leaky ReLU(0.1)."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int = 3,
                 stride: int = 1, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.stride = stride
        pad = 0 if stride == 2 else (kernel - 1) // 2
        self.conv = Conv2d(in_ch, out_ch, kernel, stride, pad, dtype)
        self.bn = BatchNorm2d(out_ch, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.stride == 2:
            x = F.pad(x, (1, 0, 1, 0))  # darknet pads top-left only
        # in place on the BatchNorm output: autograd keeps the result
        # (valid for a positive slope), not a second copy of the input
        return F.leaky_relu(self.bn(self.conv(x)), LEAKY_SLOPE, inplace=True)


class DarknetResidual(nn.Module):
    """1×1 to half the channels → 3×3 back, added to the input."""

    def __init__(self, features: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv1 = DarknetConv(features, features // 2, 1, dtype=dtype)
        self.conv2 = DarknetConv(features // 2, features, 3, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.conv2(self.conv1(x))


def _width(f: int, width: float) -> int:
    return max(8, int(f * width))


class Darknet53(nn.Module):
    """Backbone emitting the (52², 26², 13²) maps at a 416² input.

    ``stages[k]`` is the stride-2 conv of stage ``k`` followed by its
    ``blocks[k]`` residual blocks; a stem 3×3 conv runs first."""

    def __init__(self, dtype: torch.dtype = torch.float32,
                 width: float = 1.0, blocks=(1, 2, 8, 8, 4)):
        super().__init__()
        self.blocks = tuple(blocks)
        ch = _width(32, width)
        self.stem = DarknetConv(3, ch, 3, dtype=dtype)
        stages = []
        for k, n in enumerate(self.blocks):
            out = _width(64 * 2 ** k, width)
            layers = [DarknetConv(ch, out, 3, 2, dtype)]
            layers += [DarknetResidual(out, dtype) for _ in range(n)]
            stages.append(nn.Sequential(*layers))
            ch = out
        self.stages = nn.ModuleList(stages)

    def forward(self, x: torch.Tensor):
        x = self.stem(x)
        routes = []
        for stage in self.stages:
            x = stage(x)
            routes.append(x)
        return routes[2], routes[3], routes[4]  # 52², 26², 13² at 416²


class YoloConvBlock(nn.Module):
    """The neck's 5-conv 1-3-1-3-1 block."""

    def __init__(self, in_ch: int, features: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        chans = [in_ch, features, 2 * features, features, 2 * features,
                 features]
        self.convs = nn.Sequential(*[
            DarknetConv(chans[i], chans[i + 1], 1 if i % 2 == 0 else 3,
                        dtype=dtype) for i in range(5)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.convs(x)


class YoloHead(nn.Module):
    """3×3 DarknetConv + a 1×1 conv (with bias) to 3·(5+C) raw channels,
    returned as float32 ``(B, G, G, 3, 5 + C)``."""

    def __init__(self, features: int, num_classes: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_classes = num_classes
        self.conv = DarknetConv(features, 2 * features, 3, dtype=dtype)
        self.out = Conv2d(2 * features, 3 * (5 + num_classes), 1, 1, 0,
                          dtype, bias=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.out(self.conv(x))  # (B, 3·(5+C), G, G)
        n, _, h, w = y.shape
        y = y.permute(0, 2, 3, 1).reshape(n, h, w, 3, 5 + self.num_classes)
        return y.to(torch.float32)


def _upsample2(x: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour ×2 (each pixel repeated 2×2)."""
    return F.interpolate(x, scale_factor=2, mode="nearest")


class YoloV3(nn.Module):
    """Returns the raw t-space outputs of the three scales, LARGE grid
    first (52²: small objects), matching ``ANCHOR_MASKS``' rows."""

    def __init__(self, num_classes: int = 80,
                 dtype: torch.dtype = torch.float32, width: float = 1.0,
                 blocks=(1, 2, 8, 8, 4)):
        super().__init__()
        self.num_classes = num_classes
        self.width = width
        self.blocks = tuple(blocks)
        self.compute_dtype = dtype

        def w(f):
            return _width(f, width)

        self.backbone = Darknet53(dtype, width, blocks)
        self.block13 = YoloConvBlock(w(1024), w(512), dtype)
        self.head13 = YoloHead(w(512), num_classes, dtype)
        self.lateral26 = DarknetConv(w(512), w(256), 1, dtype=dtype)
        self.block26 = YoloConvBlock(w(256) + w(512), w(256), dtype)
        self.head26 = YoloHead(w(256), num_classes, dtype)
        self.lateral52 = DarknetConv(w(256), w(128), 1, dtype=dtype)
        self.block52 = YoloConvBlock(w(128) + w(256), w(128), dtype)
        self.head52 = YoloHead(w(128), num_classes, dtype)

    def set_compute_dtype(self, dtype: torch.dtype) -> "YoloV3":
        for m in self.modules():
            if hasattr(m, "compute_dtype"):
                m.compute_dtype = dtype
        return self

    def forward(self, x: torch.Tensor):
        """NHWC ``(N, H, W, 3)`` float input → three float32
        ``(N, G, G, 3, 5 + C)`` outputs, 52² first at 416²."""
        x = x.permute(0, 3, 1, 2).to(self.compute_dtype)
        small, medium, large = self.backbone(x)
        x13 = self.block13(large)
        out13 = self.head13(x13)
        x = torch.cat([_upsample2(self.lateral26(x13)), medium], dim=1)
        x26 = self.block26(x)
        out26 = self.head26(x26)
        x = torch.cat([_upsample2(self.lateral52(x26)), small], dim=1)
        x52 = self.block52(x)
        out52 = self.head52(x52)
        return out52, out26, out13

    def reset_parameters(self, generator: torch.Generator) -> "YoloV3":
        """The reference's (flax's default) init: every conv kernel LeCun
        normal (truncated at two standard deviations, std =
        sqrt(1/fan_in)/0.8796 with fan_in = in·kH·kW), the head bias 0,
        BatchNorm scale 1 and bias 0, running mean 0 and variance 1."""
        for m in self.modules():
            if isinstance(m, Conv2d):
                fan_in = m.weight.shape[1] * math.prod(m.weight.shape[2:])
                std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
                with torch.no_grad():
                    nn.init.trunc_normal_(m.weight, 0.0, std, -2.0 * std,
                                          2.0 * std, generator=generator)
                if m.bias is not None:
                    nn.init.zeros_(m.bias)
            elif isinstance(m, BatchNorm2d):
                m.reset_parameters()
        return self
