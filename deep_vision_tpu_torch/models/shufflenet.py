"""ShuffleNet V1 as ``nn.Module``s.

Port of ``deep_vision_tpu/models/shufflenet.py`` (``channel_shuffle``,
``ShuffleUnit``, ``ShuffleNetV1``): a 3×3/2 SAME stem ConvBN (24) and a
3×3/2 SAME max-pool, then three stages of 4/8/4 units — grouped 1×1
ConvBN with relu (ungrouped in the first unit), channel shuffle,
depthwise 3×3 ConvBN (SAME, carrying the stride), grouped 1×1 ConvBN —
added to the input, or, in a strided unit, concatenated after a 3×3/2
SAME average pool of the input; relu; global average pool and a dense
layer.  Flax "SAME" at stride 2 on even sizes pads the odd pixel after
(0 before, 1 after), and its average pool counts the zero padding
(``models/common.avg_pool_same``).

The reference has no PyTorch ShuffleNet; the ``state_dict`` layout here
is ``stem.{conv,bn}``, ``stages.{s}.{i}.{gconv1,dwconv,gconv2}.{conv,bn}``
and ``fc``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from deep_vision_tpu_torch.models.common import (
    Classifier,
    ConvBN,
    Linear,
    avg_pool_same,
    global_avg_pool,
    max_pool_same,
)

STAGE_CHANNELS = {1: (144, 288, 576), 2: (200, 400, 800),
                  3: (240, 480, 960), 4: (272, 544, 1088),
                  8: (384, 768, 1536)}
STAGE_REPEATS = (4, 8, 4)


def channel_shuffle(x: torch.Tensor, groups: int) -> torch.Tensor:
    """(N, C, H, W): channel ``k·(C/g) + i`` moves to ``i·g + k``, the
    reference's NHWC reshape-swap-reshape."""
    n, c, h, w = x.shape
    return x.reshape(n, groups, c // groups, h, w).transpose(1, 2) \
        .reshape(n, c, h, w)


class ShuffleUnit(nn.Module):
    def __init__(self, in_ch: int, features: int, groups: int = 3,
                 stride: int = 1, first_group: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.groups, self.stride = groups, stride
        bottleneck = features // 4
        out = features - in_ch if stride > 1 else features
        self.gconv1 = ConvBN(in_ch, bottleneck, 1,
                             groups=groups if first_group else 1,
                             dtype=dtype)
        self.dwconv = ConvBN(bottleneck, bottleneck, 3, stride,
                             groups=bottleneck, act=None, dtype=dtype)
        self.gconv2 = ConvBN(bottleneck, out, 1, groups=groups, act=None,
                             dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = channel_shuffle(self.gconv1(x), self.groups)
        y = self.gconv2(self.dwconv(y))
        if self.stride > 1:
            return F.relu(torch.cat([avg_pool_same(x, 3, 2), y], 1))
        return F.relu(x + y)


class ShuffleNetV1(Classifier):
    def __init__(self, groups: int = 3, num_classes: int = 1000,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.groups, self.num_classes = groups, num_classes
        self.compute_dtype = dtype
        self.stem = ConvBN(3, 24, 3, 2, dtype=dtype)
        in_ch, stages = 24, []
        for s, (c, reps) in enumerate(zip(STAGE_CHANNELS[groups],
                                          STAGE_REPEATS)):
            units = []
            for i in range(reps):
                units.append(ShuffleUnit(
                    in_ch, c, groups, 2 if i == 0 else 1,
                    first_group=not (s == 0 and i == 0), dtype=dtype))
                in_ch = c
            stages.append(nn.Sequential(*units))
        self.stages = nn.ModuleList(stages)
        self.fc = Linear(in_ch, num_classes, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """NHWC input → float32 logits."""
        x = self.stem(x.permute(0, 3, 1, 2).to(self.compute_dtype))
        x = max_pool_same(x, 3, 2)
        for stage in self.stages:
            x = stage(x)
        return self.fc(global_avg_pool(x)).to(torch.float32)
