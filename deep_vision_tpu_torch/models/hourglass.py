"""The hourglass building blocks and the Stacked Hourglass pose model.

Port of ``deep_vision_tpu/models/hourglass.py`` (``PreActBottleneck``,
``_up2``, ``HourglassModule``, which CenterNet is built from too, and
``StackedHourglass``).  Numerics follow the reference:

- every conv is flax's ``nn.Conv`` with its default bias, "SAME"
  padding at stride 1 (1 for a 3×3, 0 for a 1×1);
- BatchNorm is the reference's (eps 1e-5, momentum 0.9), ReLU after it
  (pre-activation);
- the down path is a 2×2/2 max pool, the up path nearest ×2 (output
  pixel ``i`` reads input ``i // 2``, as ``jax.image.resize`` does at
  exactly 2×).

The blocks take and return NCHW tensors (channels_last on the card);
``StackedHourglass`` takes the reference's NHWC input and returns NHWC
float32 heatmaps.  The module tree is named for the reader, and
``convert.py`` maps it onto flax's auto-names (``Conv_k``,
``BatchNorm_k``, ``PreActBottleneck_k``, ``HourglassModule_k``).  The
pipeline split (``HourglassStem``, ``HourglassStack``,
``merge_/split_stacked_variables``) is not ported.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from deep_vision_tpu_torch.models.common import (
    BatchNorm2d,
    Conv2d,
    conv_kernel_init,
    lecun_conv_init,
    same_pad,
)


class PreActBottleneck(nn.Module):
    """BN → ReLU → 1×1 C/2 → BN → ReLU → 3×3 C/2 → BN → ReLU → 1×1 C,
    added to the input, which a 1×1 conv lifts when its channel count
    is not C."""

    def __init__(self, in_ch: int, filters: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        half = filters // 2
        self.shortcut = Conv2d(in_ch, filters, 1, dtype=dtype, bias=True) \
            if in_ch != filters else None
        self.bn1 = BatchNorm2d(in_ch, dtype)
        self.conv1 = Conv2d(in_ch, half, 1, dtype=dtype, bias=True)
        self.bn2 = BatchNorm2d(half, dtype)
        self.conv2 = Conv2d(half, half, 3, 1, 1, dtype, bias=True)
        self.bn3 = BatchNorm2d(half, dtype)
        self.conv3 = Conv2d(half, filters, 1, dtype=dtype, bias=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        identity = x if self.shortcut is None else self.shortcut(x)
        y = self.conv1(F.relu(self.bn1(x)))
        y = self.conv2(F.relu(self.bn2(y)))
        y = self.conv3(F.relu(self.bn3(y)))
        return identity + y


def up2(x: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour ×2 of an NCHW tensor."""
    return F.interpolate(x, scale_factor=2, mode="nearest")


def filters_at(filters: Sequence[int] | int, depth: int) -> int:
    """The channel count at ``depth`` of a filter table (the last entry
    past its end), or ``filters`` itself when it is one int."""
    if isinstance(filters, int):
        return filters
    return filters[min(depth, len(filters) - 1)]


class HourglassModule(nn.Module):
    """The recursive U-module.  ``filters`` is one int (the classic
    hourglass) or a per-depth table (CenterNet): depth 0 works at
    ``filters[0]`` and the level below at ``filters[1]``, and so on.

    ``up1``: ``num_residual + 1`` bottlenecks at full resolution;
    ``low1``: a 2×2 pool, then ``num_residual`` bottlenecks; then the
    module of ``order - 1`` (``sub``) or, at order 1, ``num_residual``
    more bottlenecks (``low2``); ``low3``: ``num_residual`` bottlenecks
    back to ``filters[0]``; the result is ``up1 + up2(low3)``."""

    def __init__(self, in_ch: int, order: int,
                 filters: Sequence[int] | int = 256, num_residual: int = 1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.order = order
        f, f_next = filters_at(filters, 0), filters_at(filters, 1)

        def chain(n, cin, cout):
            return nn.ModuleList(
                PreActBottleneck(cin if j == 0 else cout, cout, dtype)
                for j in range(n))

        self.up1 = chain(num_residual + 1, in_ch, f)
        self.low1 = chain(num_residual, in_ch, f_next)
        low1_out = f_next if num_residual else in_ch
        if order > 1:
            sub_filters = filters if isinstance(filters, int) \
                else list(filters[1:])
            self.sub = HourglassModule(low1_out, order - 1, sub_filters,
                                       num_residual, dtype)
            self.low2 = None
            low2_out = filters_at(sub_filters, 0)
        else:
            self.sub = None
            self.low2 = chain(num_residual, low1_out, f_next)
            low2_out = f_next if num_residual else low1_out
        self.low3 = chain(num_residual, low2_out, f)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        up1 = x
        for block in self.up1:
            up1 = block(up1)
        low = F.max_pool2d(x, 2, 2)
        for block in self.low1:
            low = block(low)
        if self.sub is not None:
            low = self.sub(low)
        else:
            for block in self.low2:
                low = block(low)
        for block in self.low3:
            low = block(low)
        return up1 + up2(low)


class _PoseStack(nn.Module):
    """One stack: hourglass → ``num_residual`` bottlenecks → the linear
    layer (1×1 conv + BN + ReLU) → the 1×1 heatmap conv; all but the last
    stack re-inject the linear layer's features and the heatmaps, each
    through its own 1×1 conv, into the stack's input."""

    def __init__(self, num_heatmap: int, filters: int, num_residual: int,
                 order: int, reinject: bool, dtype: torch.dtype):
        super().__init__()
        self.hourglass = HourglassModule(filters, order, filters,
                                         num_residual, dtype)
        self.residual = nn.ModuleList(
            PreActBottleneck(filters, filters, dtype)
            for _ in range(num_residual))
        self.linear = Conv2d(filters, filters, 1, dtype=dtype, bias=True)
        self.bn = BatchNorm2d(filters, dtype)
        self.heat = Conv2d(filters, num_heatmap, 1, dtype=dtype, bias=True)
        self.reinject_features = self.reinject_heat = None
        if reinject:
            self.reinject_features = Conv2d(filters, filters, 1, dtype=dtype,
                                            bias=True)
            self.reinject_heat = Conv2d(num_heatmap, filters, 1,
                                        dtype=dtype, bias=True)

    def forward(self, x: torch.Tensor):
        """``(next stack's input, heatmaps NCHW in the compute dtype)``."""
        y = self.hourglass(x)
        for block in self.residual:
            y = block(y)
        y = F.relu(self.bn(self.linear(y)))
        heat = self.heat(y)
        if self.reinject_features is not None:
            x = x + self.reinject_features(y) + self.reinject_heat(heat)
        return x, heat


class StackedHourglass(nn.Module):
    """256²×3 → ``num_stack`` heatmap predictions at 64² (the full
    Hourglass-104 at ``num_stack=4``).  The stem is a 7×7/2 conv to 64
    channels with flax's "SAME" padding ((2, 3) at an even input), BN +
    ReLU, a bottleneck to 128, a 2×2 pool, and bottlenecks to 128 and
    ``filters``; every stack works at ``filters`` channels."""

    def __init__(self, num_stack: int = 4, num_heatmap: int = 16,
                 filters: int = 256, num_residual: int = 1, order: int = 4,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_stack = num_stack
        self.num_heatmap = num_heatmap
        self.filters = filters
        self.num_residual = num_residual
        self.order = order
        self.compute_dtype = dtype
        self.stem_conv = Conv2d(3, 64, 7, 2, 0, dtype, bias=True)
        self.stem_bn = BatchNorm2d(64, dtype)
        self.stem_block1 = PreActBottleneck(64, 128, dtype)
        self.stem_block2 = PreActBottleneck(128, 128, dtype)
        self.stem_block3 = PreActBottleneck(128, filters, dtype)
        self.stacks = nn.ModuleList(
            _PoseStack(num_heatmap, filters, num_residual, order,
                       s < num_stack - 1, dtype) for s in range(num_stack))

    def set_compute_dtype(self, dtype: torch.dtype) -> "StackedHourglass":
        for m in self.modules():
            if hasattr(m, "compute_dtype"):
                m.compute_dtype = dtype
        return self

    def forward(self, x: torch.Tensor):
        """NHWC ``(N, H, W, 3)`` float input → a tuple of ``num_stack``
        float32 NHWC heatmaps ``(N, H/4, W/4, num_heatmap)``."""
        x = x.permute(0, 3, 1, 2).to(self.compute_dtype)
        ph, pw = same_pad(x.shape[2], 7, 2), same_pad(x.shape[3], 7, 2)
        x = self.stem_conv(F.pad(x, (*pw, *ph)))                     # /2
        x = F.relu(self.stem_bn(x))
        x = self.stem_block1(x)
        x = F.max_pool2d(x, 2, 2)                                    # /4
        x = self.stem_block3(self.stem_block2(x))
        outputs = []
        for stack in self.stacks:
            x, heat = stack(x)
            outputs.append(heat.permute(0, 2, 3, 1).to(torch.float32))
        return tuple(outputs)

    def reset_parameters(self, generator: torch.Generator
                         ) -> "StackedHourglass":
        """The reference's init: He normal over fan-out for the convs
        that name ``conv_kernel_init`` (all but the re-injection convs),
        flax's default LeCun normal for the re-injection convs; biases
        0; BatchNorm scale 1 and bias 0, running mean 0 and variance
        1."""
        lecun = {id(c) for s in self.stacks
                 for c in (s.reinject_features, s.reinject_heat)
                 if c is not None}
        for m in self.modules():
            if isinstance(m, Conv2d):
                if id(m) in lecun:
                    lecun_conv_init(m.weight, generator)
                else:
                    conv_kernel_init(m.weight, generator)
                nn.init.zeros_(m.bias)
            elif isinstance(m, BatchNorm2d):
                m.reset_parameters()
        return self
