"""ResNet V1 family (ResNet-34/50/152) and ResNet-50 V2 as ``nn.Module``s.

Port of ``deep_vision_tpu/models/resnet.py``.  The V1 modules use
torchvision's ``state_dict`` layout (``conv1``/``bn1``/
``layer{s}.{i}.conv{j}``/``bn{j}``/``downsample.{0,1}``/``fc``), which
``convert.py`` maps to and from the reference's flax variables.  The V2
(pre-activation, ``preact``) model has no stem BatchNorm; each block is
``bn1 → relu → conv1 → bn2 → relu → conv2 → bn3 → relu → conv3`` plus the
shortcut, a bare 1×1 conv ``downsample`` of the pre-activated input
where the shape changes; a final ``post_bn`` (Keras ResNet50V2's name)
and relu precede the pool.  The reference has no PyTorch V2, so that
layout is this port's.

Numerics follow the reference: the stem's 7×7/2 conv pads 3, the
stride-2 3×3 and 1×1 projection convs use torch's (1,1)/(0,0) window
placement (the reference pads (1,1) explicitly to match it), the max-pool
is 3×3/2 with padding 1 filled with −inf, and the logits leave as
float32 whatever the compute dtype.  The V2 block's stride-2 3×3 conv
is flax "SAME" (the odd pixel after: its parity target is TF), as the
reference keeps it.  ``forward`` takes the reference's
NHWC layout; run the model in ``torch.channels_last`` and the NHWC input
becomes its NCHW view with no copy.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from deep_vision_tpu_torch.models.common import (
    BatchNorm2d,
    Classifier,
    Conv2d,
    Linear,
    global_avg_pool,
    reset_weights,
)


class BasicBlock(nn.Module):
    """Two 3×3 convs + identity/projection shortcut (ResNet-18/34)."""

    expansion = 1
    convs = 2

    def __init__(self, in_ch: int, filters: int, stride: int = 1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv1 = Conv2d(in_ch, filters, 3, stride, 1, dtype)
        self.bn1 = BatchNorm2d(filters, dtype)
        self.conv2 = Conv2d(filters, filters, 3, 1, 1, dtype)
        self.bn2 = BatchNorm2d(filters, dtype)
        self.downsample = _projection(in_ch, filters, stride, dtype)

    def forward(self, x):
        shortcut = x if self.downsample is None else self.downsample(x)
        y = F.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        return F.relu(y + shortcut)


class BottleneckBlock(nn.Module):
    """1×1 reduce → 3×3 (carrying the stride, "V1.5") → 1×1 expand ×4."""

    expansion = 4
    convs = 3

    def __init__(self, in_ch: int, filters: int, stride: int = 1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        out_ch = 4 * filters
        self.conv1 = Conv2d(in_ch, filters, 1, 1, 0, dtype)
        self.bn1 = BatchNorm2d(filters, dtype)
        self.conv2 = Conv2d(filters, filters, 3, stride, 1, dtype)
        self.bn2 = BatchNorm2d(filters, dtype)
        self.conv3 = Conv2d(filters, out_ch, 1, 1, 0, dtype)
        self.bn3 = BatchNorm2d(out_ch, dtype)
        self.downsample = _projection(in_ch, out_ch, stride, dtype)

    def forward(self, x):
        shortcut = x if self.downsample is None else self.downsample(x)
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        return F.relu(y + shortcut)


class PreActBottleneckBlock(nn.Module):
    """V2 pre-activation bottleneck: BN → relu → conv, three times; the
    projection shortcut sees the pre-activated input."""

    expansion = 4
    convs = 3

    def __init__(self, in_ch: int, filters: int, stride: int = 1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        out_ch = 4 * filters
        self.bn1 = BatchNorm2d(in_ch, dtype)
        self.conv1 = Conv2d(in_ch, filters, 1, 1, 0, dtype)
        self.bn2 = BatchNorm2d(filters, dtype)
        self.conv2 = Conv2d(filters, filters, 3, stride, "SAME", dtype)
        self.bn3 = BatchNorm2d(filters, dtype)
        self.conv3 = Conv2d(filters, out_ch, 1, 1, 0, dtype)
        self.downsample = Conv2d(in_ch, out_ch, 1, stride, 0, dtype) \
            if stride != 1 or in_ch != out_ch else None

    def forward(self, x):
        pre = F.relu(self.bn1(x))
        shortcut = x if self.downsample is None else self.downsample(pre)
        y = F.relu(self.bn2(self.conv1(pre)))
        y = F.relu(self.bn3(self.conv2(y)))
        return self.conv3(y) + shortcut


def _projection(in_ch, out_ch, stride, dtype):
    if stride == 1 and in_ch == out_ch:
        return None
    return nn.Sequential(Conv2d(in_ch, out_ch, 1, stride, 0, dtype),
                         BatchNorm2d(out_ch, dtype))


BLOCKS = {"BasicBlock": BasicBlock, "BottleneckBlock": BottleneckBlock,
          "PreActBottleneckBlock": PreActBottleneckBlock}


class ResNet(Classifier):
    """7×7/2 stem → 3×3/2 max-pool → stages → global average pool → fc;
    with ``preact`` (V2) no stem BatchNorm and a final BN + relu."""

    def __init__(self, stage_sizes: Sequence[int],
                 block_cls: type = BottleneckBlock, num_classes: int = 1000,
                 dtype: torch.dtype = torch.float32, preact: bool = False):
        super().__init__()
        self.stage_sizes = tuple(stage_sizes)
        self.block_cls = block_cls
        self.num_classes = num_classes
        self.compute_dtype = dtype
        self.preact = preact
        self.conv1 = Conv2d(3, 64, 7, 2, 3, dtype)
        self.bn1 = None if preact else BatchNorm2d(64, dtype)
        in_ch = 64
        for stage, num_blocks in enumerate(self.stage_sizes):
            filters = 64 * 2 ** stage
            blocks = []
            for i in range(num_blocks):
                stride = 2 if stage > 0 and i == 0 else 1
                blocks.append(block_cls(in_ch, filters, stride, dtype))
                in_ch = filters * block_cls.expansion
            self.add_module(f"layer{stage + 1}", nn.Sequential(*blocks))
        self.post_bn = BatchNorm2d(in_ch, dtype) if preact else None
        self.fc = Linear(in_ch, num_classes, dtype)

    def stages(self):
        return [getattr(self, f"layer{s + 1}")
                for s in range(len(self.stage_sizes))]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """NHWC ``(N, H, W, 3)`` float input → float32 logits."""
        x = self.conv1(x.permute(0, 3, 1, 2).to(self.compute_dtype))
        if self.bn1 is not None:
            x = F.relu(self.bn1(x))
        x = F.max_pool2d(x, 3, 2, 1)
        for stage in self.stages():
            x = stage(x)
        if self.post_bn is not None:
            x = F.relu(self.post_bn(x))
        return self.fc(global_avg_pool(x)).to(torch.float32)

    def reset_parameters(self, generator: torch.Generator) -> "ResNet":
        """The reference's init: He fan-out convs, BN scale 1 and bias 0
        with the LAST BN scale of every V1 block zeroed (each residual
        branch starts as the identity; the V2 block has no BN after its
        last conv), LeCun-normal fc with zero bias.  Running statistics
        start at mean 0, variance 1."""
        reset_weights(self, generator)
        if not self.preact:
            for stage in self.stages():
                for block in stage:
                    last = getattr(block, f"bn{block.convs}")
                    nn.init.zeros_(last.weight)
        return self


def ResNet34(num_classes: int = 1000, dtype=torch.float32) -> ResNet:
    return ResNet((3, 4, 6, 3), BasicBlock, num_classes, dtype)


def ResNet50(num_classes: int = 1000, dtype=torch.float32) -> ResNet:
    return ResNet((3, 4, 6, 3), BottleneckBlock, num_classes, dtype)


def ResNet152(num_classes: int = 1000, dtype=torch.float32) -> ResNet:
    return ResNet((3, 8, 36, 3), BottleneckBlock, num_classes, dtype)


def ResNet50V2(num_classes: int = 1000, dtype=torch.float32) -> ResNet:
    return ResNet((3, 4, 6, 3), PreActBottleneckBlock, num_classes, dtype,
                  preact=True)
