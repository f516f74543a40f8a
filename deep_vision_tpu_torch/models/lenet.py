"""LeNet-5 and its two cascade tiers as ``nn.Module``s.

Port of ``deep_vision_tpu/models/lenet.py`` (``LeNet5``, ``LeNet5Nano``,
``LeNet5Big``).  All three take a 32×32×1 NHWC input (MNIST padded
28 → 32) and 10 classes, compute in float32 by default, and use flax's
default inits (LeCun-normal kernels, zero biases).

- ``LeNet5``: conv6@5×5 → tanh → avg-pool 2 → tanh → conv16@5×5 → tanh →
  avg-pool 2 → tanh → conv120@5×5 → tanh → dense84 → tanh → dense10, every
  conv VALID; 61,706 parameters.  Its ``state_dict`` is the reference's
  PyTorch layout (``features.{0,4,8}``, ``classifier.{0,2}``), which the
  JAX package's ``import_torch_lenet5`` reads.
- ``LeNet5Nano``: conv8@5×5 stride 2 VALID (32 → 14) → relu → avg-pool 2
  (→ 7) → dense10.
- ``LeNet5Big``: three blocks of two 3×3 SAME convs (``width``,
  ``2·width``, ``4·width`` channels) with relu and a 2×2 max-pool each,
  then dense ``8·width`` → relu → dense10.

The two tiers have no reference PyTorch layout; they take the same
``features.N``/``classifier.N`` one, layers at their ``nn.Sequential``
indices (``models/common.SequentialClassifier``).
"""

from __future__ import annotations

import torch
from torch import nn

from deep_vision_tpu_torch.models.common import (
    Conv2d,
    Linear,
    SequentialClassifier,
)


class LeNet5(SequentialClassifier):
    flatten_hw = (1, 1)

    def __init__(self, num_classes: int = 10,
                 dtype: torch.dtype = torch.float32):
        super().__init__(dtype)
        self.num_classes = num_classes
        self.features = nn.Sequential(
            Conv2d(1, 6, 5, dtype=dtype, bias=True, init="lecun"), nn.Tanh(),
            nn.AvgPool2d(2, 2), nn.Tanh(),
            Conv2d(6, 16, 5, dtype=dtype, bias=True, init="lecun"),
            nn.Tanh(), nn.AvgPool2d(2, 2), nn.Tanh(),
            Conv2d(16, 120, 5, dtype=dtype, bias=True, init="lecun"),
            nn.Tanh())
        self.classifier = nn.Sequential(
            Linear(120, 84, dtype), nn.Tanh(), Linear(84, num_classes, dtype))


class LeNet5Nano(SequentialClassifier):
    flatten_hw = (7, 7)

    def __init__(self, num_classes: int = 10,
                 dtype: torch.dtype = torch.float32):
        super().__init__(dtype)
        self.num_classes = num_classes
        self.features = nn.Sequential(
            Conv2d(1, 8, 5, 2, dtype=dtype, bias=True, init="lecun"),
            nn.ReLU(), nn.AvgPool2d(2, 2))
        self.classifier = nn.Sequential(
            Linear(8 * 7 * 7, num_classes, dtype))


class LeNet5Big(SequentialClassifier):
    flatten_hw = (4, 4)

    def __init__(self, num_classes: int = 10, width: int = 32,
                 dtype: torch.dtype = torch.float32):
        super().__init__(dtype)
        self.num_classes = num_classes
        self.width = width
        layers, in_ch = [], 1
        for mult in (1, 2, 4):  # 32 → 16 → 8 → 4 after the pools
            ch = width * mult
            for c in (in_ch, ch):
                layers += [Conv2d(c, ch, 3, 1, 1, dtype, bias=True,
                                  init="lecun"), nn.ReLU()]
            layers.append(nn.MaxPool2d(2, 2))
            in_ch = ch
        self.features = nn.Sequential(*layers)
        self.classifier = nn.Sequential(
            Linear(in_ch * 4 * 4, 8 * width, dtype), nn.ReLU(),
            Linear(8 * width, num_classes, dtype))
