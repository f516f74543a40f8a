"""MobileNet V1 as ``nn.Module``s.

Port of ``deep_vision_tpu/models/mobilenet.py`` (``DepthwiseSeparable``,
``MobileNetV1``): a 3×3/2 stem ConvBN, then 13 depthwise-separable blocks
(a depthwise 3×3 ConvBN, groups = channels, padded (1,1) explicitly —
torch's window placement, which the reference chose so that
reference-format checkpoints import exactly — then a pointwise 1×1
ConvBN, each with relu), global average pool, dropout and a dense
layer.  The width multiplier ``alpha`` scales every width and floors it
at 8.  He-initialized convs, BatchNorm eps 1e-5.

The ``state_dict`` is the reference's PyTorch layout (``features.0``
stem conv, ``features.1`` its BatchNorm, ``features.{3..15}.{dw,pw}.
{conv,bn}``, ``linear``), which the JAX package's
``import_torch_mobilenet_v1`` reads.
"""

from __future__ import annotations

import torch
from torch import nn

from deep_vision_tpu_torch.models.common import (
    BatchNorm2d,
    Classifier,
    Conv2d,
    ConvBN,
    Dropout,
    Linear,
    global_avg_pool,
)

# (pointwise-out, stride) of the 13 blocks after the stem
PLAN = [(64, 1), (128, 2), (128, 1), (256, 2), (256, 1), (512, 2),
        (512, 1), (512, 1), (512, 1), (512, 1), (512, 1),
        (1024, 2), (1024, 1)]


class DepthwiseSeparable(nn.Module):
    def __init__(self, in_ch: int, features: int, stride: int = 1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dw = ConvBN(in_ch, in_ch, 3, stride, 1, groups=in_ch,
                         dtype=dtype)
        self.pw = ConvBN(in_ch, features, 1, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.pw(self.dw(x))


class MobileNetV1(Classifier):
    def __init__(self, alpha: float = 1.0, num_classes: int = 1000,
                 dropout: float = 0.001, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.alpha, self.num_classes = alpha, num_classes
        self.compute_dtype = dtype

        def w(c):
            return max(8, int(c * alpha))

        layers = [Conv2d(3, w(32), 3, 2, 1, dtype), BatchNorm2d(w(32), dtype),
                  nn.ReLU()]
        in_ch = w(32)
        for features, stride in PLAN:
            layers.append(DepthwiseSeparable(in_ch, w(features), stride,
                                             dtype))
            in_ch = w(features)
        self.features = nn.Sequential(*layers)
        self.dropout = Dropout(dropout)
        self.linear = Linear(in_ch, num_classes, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """NHWC input → float32 logits."""
        x = self.features(x.permute(0, 3, 1, 2).to(self.compute_dtype))
        x = self.dropout(global_avg_pool(x))
        return self.linear(x).to(torch.float32)


