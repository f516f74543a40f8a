"""Inception V1 (GoogLeNet) and Inception V3 as ``nn.Module``s.

Port of ``deep_vision_tpu/models/inception.py``.  Numerics follow the
reference:

- ``BasicConv``: conv (He init) → relu, with a bias (V1), or conv with no
  bias → BatchNorm (eps 1e-3, momentum 0.9) → relu (V3); "SAME" padding
  unless given, flax's, so a strided SAME conv on an even input pads the
  odd pixel after;
- "SAME" max-pools pad with −inf and "SAME" average pools count the zero
  padding in their divisor (``models/common.max_pool_same``,
  ``avg_pool_same``); VALID pools floor;
- V1's stem conv pads 3 explicitly and two LRNs span 64 and 192 channels;
  V1's aux heads (5×5/3 average pool → 1×1 conv128 → dense 1024 → relu →
  dropout 0.7 → dense) read 4a and 4d, V3's one (5×5/3 average pool →
  conv128 → 5×5 VALID conv768 → global average → dense) the last 17×17
  block;
- in training mode V1 returns ``(logits, aux1, aux2)`` and V3
  ``(logits, aux)``; in eval mode both return the logits alone and the aux
  heads (whose parameters exist either way) do not run.

Layouts: ``InceptionV1``'s ``state_dict`` is the reference's PyTorch one
(``conv7x7``, ``conv1x1``, ``conv3x3``, ``inception_{3a..5b}.branchK_convJxJ``,
``aux{1,2}.features.1``/``classifier.{0,3}``, ``linear``; each BasicConv's
conv is ``.conv``), which the JAX package's ``import_torch_inception_v1``
reads; the aux heads' first dense layer flattens NCHW.  The reference has
no PyTorch Inception V3, so ``InceptionV3`` takes torchvision's
``Inception3`` layout (``Conv2d_1a_3x3`` … ``Mixed_7c``, ``AuxLogits.conv0/
conv1/fc``, ``fc``; each BasicConv ``.conv`` + ``.bn``), whose blocks are
the same modules.  ``forward`` takes NHWC.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from deep_vision_tpu_torch.models.common import (
    BatchNorm2d,
    Classifier,
    Conv2d,
    Dropout,
    Linear,
    avg_pool_same,
    global_avg_pool,
    local_response_norm,
    max_pool_same,
)


class BasicConv(nn.Module):
    """Conv + relu (V1) or conv + BatchNorm(eps 1e-3) + relu (V3)."""

    def __init__(self, in_ch: int, out_ch: int, kernel=1, stride: int = 1,
                 padding="SAME", use_bn: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv = Conv2d(in_ch, out_ch, kernel, stride, padding, dtype,
                           bias=not use_bn)
        self.bn = BatchNorm2d(out_ch, dtype, eps=1e-3) if use_bn else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv(x)
        if self.bn is not None:
            x = self.bn(x)
        return F.relu(x)


class InceptionModule(nn.Module):
    """1×1 | 1×1 → 3×3 | 1×1 → 5×5 | 3×3/1 max-pool → 1×1, concatenated."""

    def __init__(self, in_ch: int, c1: int, c3r: int, c3: int, c5r: int,
                 c5: int, cp: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.out_ch = c1 + c3 + c5 + cp
        self.branch1_conv1x1 = BasicConv(in_ch, c1, dtype=dtype)
        self.branch2_conv1x1 = BasicConv(in_ch, c3r, dtype=dtype)
        self.branch2_conv3x3 = BasicConv(c3r, c3, 3, dtype=dtype)
        self.branch3_conv1x1 = BasicConv(in_ch, c5r, dtype=dtype)
        self.branch3_conv5x5 = BasicConv(c5r, c5, 5, dtype=dtype)
        self.branch4_conv1x1 = BasicConv(in_ch, cp, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.cat([
            self.branch1_conv1x1(x),
            self.branch2_conv3x3(self.branch2_conv1x1(x)),
            self.branch3_conv5x5(self.branch3_conv1x1(x)),
            self.branch4_conv1x1(F.max_pool2d(x, 3, 1, 1))], 1)


def _aux_pool(x: torch.Tensor) -> torch.Tensor:
    return F.avg_pool2d(x, 5, 3)


class AuxClassifier(nn.Module):
    """V1's aux head: 5×5/3 average pool → 1×1 conv128 → dense 1024 →
    relu → dropout 0.7 → dense (``features.1``, ``classifier.{0,3}``)."""

    def __init__(self, in_ch: int, num_classes: int, pooled_hw: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.flatten_hw = (pooled_hw, pooled_hw)
        self.features = nn.Sequential(nn.AvgPool2d(5, 3),
                                      BasicConv(in_ch, 128, dtype=dtype))
        self.classifier = nn.Sequential(
            Linear(128 * pooled_hw * pooled_hw, 1024, dtype), nn.ReLU(),
            Dropout(0.7), Linear(1024, num_classes, dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = torch.flatten(self.features(x), 1)
        return self.classifier(x).to(torch.float32)


def _same_out(n: int, stride: int = 2) -> int:
    return -(-n // stride)


class InceptionV1(Classifier):
    def __init__(self, num_classes: int = 1000, aux_heads: bool = True,
                 use_lrn: bool = True, image_size: int = 224,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_classes, self.aux_heads = num_classes, aux_heads
        self.use_lrn, self.compute_dtype = use_lrn, dtype

        def mod(*a):
            return InceptionModule(*a, dtype=dtype)

        self.conv7x7 = BasicConv(3, 64, 7, 2, 3, dtype=dtype)
        self.conv1x1 = BasicConv(64, 64, dtype=dtype)
        self.conv3x3 = BasicConv(64, 192, 3, dtype=dtype)
        self.inception_3a = mod(192, 64, 96, 128, 16, 32, 32)
        self.inception_3b = mod(256, 128, 128, 192, 32, 96, 64)
        self.inception_4a = mod(480, 192, 96, 208, 16, 48, 64)
        self.inception_4b = mod(512, 160, 112, 224, 24, 64, 64)
        self.inception_4c = mod(512, 128, 128, 256, 24, 64, 64)
        self.inception_4d = mod(512, 112, 144, 288, 32, 64, 64)
        self.inception_4e = mod(528, 256, 160, 320, 32, 128, 128)
        self.inception_5a = mod(832, 256, 160, 320, 32, 128, 128)
        self.inception_5b = mod(832, 384, 192, 384, 48, 128, 128)
        # the 4a/4d map: stem conv /2, then three SAME 3×3/2 max-pools
        s = _same_out(_same_out(_same_out((image_size - 1) // 2 + 1)))
        pooled = (s - 5) // 3 + 1
        if aux_heads and pooled < 1:
            raise ValueError(f"the aux heads need a 4a map of at least 5×5; "
                             f"a {image_size}² input gives {s}×{s}")
        if aux_heads:
            self.aux1 = AuxClassifier(512, num_classes, pooled, dtype)
            self.aux2 = AuxClassifier(528, num_classes, pooled, dtype)
        self.dropout = Dropout(0.4)
        self.linear = Linear(1024, num_classes, dtype)

    def forward(self, x: torch.Tensor):
        """NHWC input → float32 logits; ``(logits, aux1, aux2)`` in
        training mode with aux heads."""
        x = x.permute(0, 3, 1, 2).to(self.compute_dtype)
        x = max_pool_same(self.conv7x7(x), 3, 2)
        if self.use_lrn:
            x = local_response_norm(x, 64)
        x = self.conv3x3(self.conv1x1(x))
        if self.use_lrn:
            x = local_response_norm(x, 192)
        x = max_pool_same(x, 3, 2)
        x = self.inception_3b(self.inception_3a(x))
        x = self.inception_4a(max_pool_same(x, 3, 2))
        heads = self.training and self.aux_heads
        aux1 = self.aux1(x) if heads else None
        x = self.inception_4d(self.inception_4c(self.inception_4b(x)))
        aux2 = self.aux2(x) if heads else None
        x = max_pool_same(self.inception_4e(x), 3, 2)
        x = self.inception_5b(self.inception_5a(x))
        x = self.linear(self.dropout(global_avg_pool(x)))
        x = x.to(torch.float32)
        return (x, aux1, aux2) if heads else x


# ---------------------------------------------------------------------------
# Inception V3
# ---------------------------------------------------------------------------


def _bn_conv(dtype):
    def conv(in_ch, out_ch, kernel=1, stride=1, padding="SAME"):
        return BasicConv(in_ch, out_ch, kernel, stride, padding, True, dtype)
    return conv


class InceptionA(nn.Module):
    def __init__(self, in_ch: int, pool_features: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        conv = _bn_conv(dtype)
        self.out_ch = 64 + 64 + 96 + pool_features
        self.branch1x1 = conv(in_ch, 64)
        self.branch5x5_1 = conv(in_ch, 48)
        self.branch5x5_2 = conv(48, 64, 5)
        self.branch3x3dbl_1 = conv(in_ch, 64)
        self.branch3x3dbl_2 = conv(64, 96, 3)
        self.branch3x3dbl_3 = conv(96, 96, 3)
        self.branch_pool = conv(in_ch, pool_features)

    def forward(self, x):
        b3 = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([self.branch1x1(x),
                          self.branch5x5_2(self.branch5x5_1(x)), b3,
                          self.branch_pool(avg_pool_same(x, 3, 1))], 1)


class ReductionA(nn.Module):
    def __init__(self, in_ch: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        conv = _bn_conv(dtype)
        self.out_ch = 384 + 96 + in_ch
        self.branch3x3 = conv(in_ch, 384, 3, 2, 0)
        self.branch3x3dbl_1 = conv(in_ch, 64)
        self.branch3x3dbl_2 = conv(64, 96, 3)
        self.branch3x3dbl_3 = conv(96, 96, 3, 2, 0)

    def forward(self, x):
        b2 = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([self.branch3x3(x), b2, F.max_pool2d(x, 3, 2)], 1)


class InceptionB(nn.Module):
    """17×17 blocks with 1×7/7×1 factorized convs."""

    def __init__(self, in_ch: int, c7: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        conv = _bn_conv(dtype)
        self.out_ch = 4 * 192
        self.branch1x1 = conv(in_ch, 192)
        self.branch7x7_1 = conv(in_ch, c7)
        self.branch7x7_2 = conv(c7, c7, (1, 7))
        self.branch7x7_3 = conv(c7, 192, (7, 1))
        self.branch7x7dbl_1 = conv(in_ch, c7)
        self.branch7x7dbl_2 = conv(c7, c7, (7, 1))
        self.branch7x7dbl_3 = conv(c7, c7, (1, 7))
        self.branch7x7dbl_4 = conv(c7, c7, (7, 1))
        self.branch7x7dbl_5 = conv(c7, 192, (1, 7))
        self.branch_pool = conv(in_ch, 192)

    def forward(self, x):
        b2 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x)))
        b3 = x
        for i in range(1, 6):
            b3 = getattr(self, f"branch7x7dbl_{i}")(b3)
        return torch.cat([self.branch1x1(x), b2, b3,
                          self.branch_pool(avg_pool_same(x, 3, 1))], 1)


class ReductionB(nn.Module):
    def __init__(self, in_ch: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        conv = _bn_conv(dtype)
        self.out_ch = 320 + 192 + in_ch
        self.branch3x3_1 = conv(in_ch, 192)
        self.branch3x3_2 = conv(192, 320, 3, 2, 0)
        self.branch7x7x3_1 = conv(in_ch, 192)
        self.branch7x7x3_2 = conv(192, 192, (1, 7))
        self.branch7x7x3_3 = conv(192, 192, (7, 1))
        self.branch7x7x3_4 = conv(192, 192, 3, 2, 0)

    def forward(self, x):
        b2 = x
        for i in range(1, 5):
            b2 = getattr(self, f"branch7x7x3_{i}")(b2)
        return torch.cat([self.branch3x3_2(self.branch3x3_1(x)), b2,
                          F.max_pool2d(x, 3, 2)], 1)


class InceptionC(nn.Module):
    """8×8 blocks with split 1×3/3×1 branches."""

    def __init__(self, in_ch: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        conv = _bn_conv(dtype)
        self.out_ch = 320 + 768 + 768 + 192
        self.branch1x1 = conv(in_ch, 320)
        self.branch3x3_1 = conv(in_ch, 384)
        self.branch3x3_2a = conv(384, 384, (1, 3))
        self.branch3x3_2b = conv(384, 384, (3, 1))
        self.branch3x3dbl_1 = conv(in_ch, 448)
        self.branch3x3dbl_2 = conv(448, 384, 3)
        self.branch3x3dbl_3a = conv(384, 384, (1, 3))
        self.branch3x3dbl_3b = conv(384, 384, (3, 1))
        self.branch_pool = conv(in_ch, 192)

    def forward(self, x):
        b2 = self.branch3x3_1(x)
        b2 = torch.cat([self.branch3x3_2a(b2), self.branch3x3_2b(b2)], 1)
        b3 = self.branch3x3dbl_2(self.branch3x3dbl_1(x))
        b3 = torch.cat([self.branch3x3dbl_3a(b3), self.branch3x3dbl_3b(b3)],
                       1)
        return torch.cat([self.branch1x1(x), b2, b3,
                          self.branch_pool(avg_pool_same(x, 3, 1))], 1)


class InceptionAux(nn.Module):
    """V3's aux head on the last 17×17 block."""

    def __init__(self, in_ch: int, num_classes: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        conv = _bn_conv(dtype)
        self.conv0 = conv(in_ch, 128)
        self.conv1 = conv(128, 768, 5, 1, 0)
        self.fc = Linear(768, num_classes, dtype)

    def forward(self, x):
        x = self.conv1(self.conv0(_aux_pool(x)))
        return self.fc(global_avg_pool(x)).to(torch.float32)


class InceptionV3(Classifier):
    """299² input: factorized stem → 3 × InceptionA → ReductionA (→ 17²)
    → 4 × InceptionB → ReductionB (→ 8²) → 2 × InceptionC → global
    average → dropout 0.5 → dense."""

    def __init__(self, num_classes: int = 1000, aux_heads: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_classes, self.aux_heads = num_classes, aux_heads
        self.compute_dtype = dtype
        conv = _bn_conv(dtype)
        self.Conv2d_1a_3x3 = conv(3, 32, 3, 2, 0)
        self.Conv2d_2a_3x3 = conv(32, 32, 3, 1, 0)
        self.Conv2d_2b_3x3 = conv(32, 64, 3)
        self.Conv2d_3b_1x1 = conv(64, 80)
        self.Conv2d_4a_3x3 = conv(80, 192, 3, 1, 0)
        self.Mixed_5b = InceptionA(192, 32, dtype)
        self.Mixed_5c = InceptionA(256, 64, dtype)
        self.Mixed_5d = InceptionA(288, 64, dtype)
        self.Mixed_6a = ReductionA(288, dtype)
        self.Mixed_6b = InceptionB(768, 128, dtype)
        self.Mixed_6c = InceptionB(768, 160, dtype)
        self.Mixed_6d = InceptionB(768, 160, dtype)
        self.Mixed_6e = InceptionB(768, 192, dtype)
        if aux_heads:
            self.AuxLogits = InceptionAux(768, num_classes, dtype)
        self.Mixed_7a = ReductionB(768, dtype)
        self.Mixed_7b = InceptionC(1280, dtype)
        self.Mixed_7c = InceptionC(2048, dtype)
        self.dropout = Dropout(0.5)
        self.fc = Linear(2048, num_classes, dtype)

    def forward(self, x: torch.Tensor):
        """NHWC input → float32 logits; ``(logits, aux)`` in training
        mode with the aux head."""
        x = x.permute(0, 3, 1, 2).to(self.compute_dtype)
        x = self.Conv2d_2b_3x3(self.Conv2d_2a_3x3(self.Conv2d_1a_3x3(x)))
        x = F.max_pool2d(x, 3, 2)
        x = self.Conv2d_4a_3x3(self.Conv2d_3b_1x1(x))
        x = F.max_pool2d(x, 3, 2)
        for name in ("Mixed_5b", "Mixed_5c", "Mixed_5d", "Mixed_6a",
                     "Mixed_6b", "Mixed_6c", "Mixed_6d", "Mixed_6e"):
            x = getattr(self, name)(x)
        heads = self.training and self.aux_heads
        aux = self.AuxLogits(x) if heads else None
        x = self.Mixed_7c(self.Mixed_7b(self.Mixed_7a(x)))
        x = self.fc(self.dropout(global_avg_pool(x))).to(torch.float32)
        return (x, aux) if heads else x
