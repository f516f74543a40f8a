"""AlexNet V1/V2 as ``nn.Module``s.

Port of ``deep_vision_tpu/models/alexnet.py`` (``AlexNet``, ``AlexNetV1``
with 96/256/384/384/256 filters, ``AlexNetV2`` with 64/192/384/384/256):
conv 11×11/4 pad 2 → relu → LRN → max-pool 3/2 → conv 5×5 pad 2 → relu →
LRN → max-pool 3/2 → three 3×3 pad-1 convs with relu → max-pool 3/2 →
flatten → dropout → dense 4096 → relu → dropout → dense 4096 → relu →
dense ``num_classes``.  The LRN windows span the full channel count, as
the reference passes them (96/256 or 64/192).  Flax's default inits.

The ``state_dict`` is the reference's PyTorch layout (convs at
``features.{0,4,8,10,12}``, dense layers at ``classifier.{1,4,6}``), which
the JAX package's ``import_torch_alexnet`` reads; without ``use_lrn`` the
LRN slots hold identities, so the indices stay.  ``image_size`` fixes the
first dense layer's width (6×6×256 at 224²).
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from deep_vision_tpu_torch.models.common import (
    Conv2d,
    Dropout,
    Linear,
    LocalResponseNorm,
    SequentialClassifier,
)


def _pooled(n: int) -> int:
    return (n - 3) // 2 + 1


class AlexNet(SequentialClassifier):
    def __init__(self, filters: Sequence[int] = (96, 256, 384, 384, 256),
                 use_lrn: bool = True, num_classes: int = 1000,
                 dropout: float = 0.5, image_size: int = 224,
                 dtype: torch.dtype = torch.float32):
        super().__init__(dtype)
        f = tuple(filters)
        self.filters, self.num_classes = f, num_classes
        s = _pooled(_pooled(_pooled((image_size + 4 - 11) // 4 + 1)))
        self.flatten_hw = (s, s)

        def conv(i, o, k, stride=1, pad=1):
            return Conv2d(i, o, k, stride, pad, dtype, bias=True,
                          init="lecun")

        def lrn(size):
            return LocalResponseNorm(size) if use_lrn else nn.Identity()

        self.features = nn.Sequential(
            conv(3, f[0], 11, 4, 2), nn.ReLU(), lrn(f[0]),
            nn.MaxPool2d(3, 2),
            conv(f[0], f[1], 5, 1, 2), nn.ReLU(), lrn(f[1]),
            nn.MaxPool2d(3, 2),
            conv(f[1], f[2], 3), nn.ReLU(),
            conv(f[2], f[3], 3), nn.ReLU(),
            conv(f[3], f[4], 3), nn.ReLU(),
            nn.MaxPool2d(3, 2))
        self.classifier = nn.Sequential(
            Dropout(dropout), Linear(f[4] * s * s, 4096, dtype), nn.ReLU(),
            Dropout(dropout), Linear(4096, 4096, dtype), nn.ReLU(),
            Linear(4096, num_classes, dtype))


def AlexNetV1(num_classes: int = 1000, dtype=torch.float32,
              image_size: int = 224) -> AlexNet:
    return AlexNet((96, 256, 384, 384, 256), num_classes=num_classes,
                   image_size=image_size, dtype=dtype)


def AlexNetV2(num_classes: int = 1000, dtype=torch.float32,
              image_size: int = 224) -> AlexNet:
    return AlexNet((64, 192, 384, 384, 256), num_classes=num_classes,
                   image_size=image_size, dtype=dtype)
