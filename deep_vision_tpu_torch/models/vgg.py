"""VGG-16/19 as ``nn.Module``s.

Port of ``deep_vision_tpu/models/vgg.py`` (``VGG``, ``VGG16``, ``VGG19``):
3×3 SAME convs with relu, 2×2 max-pools at the plan's ``"M"``s, then
flatten → dense 4096 → relu → dropout → dense 4096 → relu → dropout →
dense ``num_classes``.  Flax's default inits.

The ``state_dict`` is the reference's (and torchvision's) PyTorch layout:
convs at their ``features.N`` indices among the relus and pools, dense
layers at ``classifier.{0,3,6}``, which the JAX package's
``import_torch_vgg`` reads.  ``image_size`` fixes the first dense layer's
width (7×7×512 at 224²).
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from deep_vision_tpu_torch.models.common import (
    Conv2d,
    Dropout,
    Linear,
    SequentialClassifier,
)

# channel plan per stage; M = max-pool
VGG16_PLAN = (64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
              512, 512, 512, "M", 512, 512, 512, "M")
VGG19_PLAN = (64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M",
              512, 512, 512, 512, "M", 512, 512, 512, 512, "M")


class VGG(SequentialClassifier):
    def __init__(self, plan: Sequence = VGG16_PLAN, num_classes: int = 1000,
                 dropout: float = 0.5, image_size: int = 224,
                 dtype: torch.dtype = torch.float32):
        super().__init__(dtype)
        self.plan, self.num_classes = tuple(plan), num_classes
        layers, in_ch, s = [], 3, image_size
        for item in self.plan:
            if item == "M":
                layers.append(nn.MaxPool2d(2, 2))
                s //= 2
            else:
                layers += [Conv2d(in_ch, item, 3, 1, 1, dtype, bias=True,
                                  init="lecun"), nn.ReLU()]
                in_ch = item
        self.flatten_hw = (s, s)
        self.features = nn.Sequential(*layers)
        self.classifier = nn.Sequential(
            Linear(in_ch * s * s, 4096, dtype), nn.ReLU(), Dropout(dropout),
            Linear(4096, 4096, dtype), nn.ReLU(), Dropout(dropout),
            Linear(4096, num_classes, dtype))


def VGG16(num_classes: int = 1000, dtype=torch.float32,
          image_size: int = 224) -> VGG:
    return VGG(VGG16_PLAN, num_classes, image_size=image_size, dtype=dtype)


def VGG19(num_classes: int = 1000, dtype=torch.float32,
          image_size: int = 224) -> VGG:
    return VGG(VGG19_PLAN, num_classes, image_size=image_size, dtype=dtype)
