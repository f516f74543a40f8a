"""The hourglass building blocks as ``nn.Module``s.

Port of ``deep_vision_tpu/models/hourglass.py`` (``PreActBottleneck``,
``_up2``, ``HourglassModule``), which CenterNet is built from and the
stacked-hourglass pose model will reuse.  Numerics follow the reference:

- every conv is flax's ``nn.Conv`` with its default bias, "SAME"
  padding at stride 1 (1 for a 3×3, 0 for a 1×1);
- BatchNorm is the reference's (eps 1e-5, momentum 0.9), ReLU after it
  (pre-activation);
- the down path is a 2×2/2 max pool, the up path nearest ×2 (output
  pixel ``i`` reads input ``i // 2``, as ``jax.image.resize`` does at
  exactly 2×).

Modules take and return NCHW tensors (channels_last on the card); the
module tree is named for the reader, and ``convert.py`` maps it onto
flax's auto-names (``Conv_k``, ``BatchNorm_k``, ``PreActBottleneck_k``,
``HourglassModule_0``).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from deep_vision_tpu_torch.models.common import BatchNorm2d, Conv2d


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
