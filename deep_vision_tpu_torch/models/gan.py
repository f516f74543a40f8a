"""GAN generators and discriminators: DCGAN on MNIST (28²×1) and CycleGAN
(256²×3).

Port of ``deep_vision_tpu/models/gan.py`` as NCHW modules of the layers
in ``models/common.py``.  At the edges they keep the reference's NHWC
layout: a generator returns ``(N, H, W, C)`` float32 images in [-1, 1]
and a discriminator takes them (a view of NCHW under
``torch.channels_last``).  Conventions, as in the reference:

- every layer has flax's default init (LeCun normal kernels, zero
  biases, BatchNorm scale 1) and a bias unless the reference says
  ``use_bias=False``;
- BatchNorm is flax's default: momentum 0.99, eps 1e-5;
- DCGAN's generator reshapes its Dense output as NHWC ``(7, 7, 256)`` and
  its discriminator flattens an NHWC ``(7, 7, 128)`` map, in the
  reference's order, so the Dense kernels are flax's transposed with no
  permutation; its two dropout masks (rate 0.3) are NHWC too, passed in
  by the caller (``tasks/gan.py`` draws them) or drawn from the Dropout
  generator;
- flax "SAME" convs pad the odd pixel after; reflection padding is
  ``F.pad(mode="reflect")``; ``ConvTranspose2d`` is flax's.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from deep_vision_tpu_torch.models.common import (
    BatchNorm2d,
    Conv2d,
    ConvTranspose2d,
    Dropout,
    Linear,
    reset_weights,
)

#: flax's default BatchNorm momentum (the GAN models set none)
GAN_BN_MOMENTUM = 0.99


def _bn(features: int, dtype: torch.dtype) -> BatchNorm2d:
    return BatchNorm2d(features, dtype, momentum=GAN_BN_MOMENTUM)


def _lecun(*convs: Conv2d) -> None:
    for c in convs:
        c.init = "lecun"


class GANModel(nn.Module):
    """Base of the four networks: :meth:`set_compute_dtype` and
    :meth:`reset_parameters` (flax's default init in module order)."""

    def set_compute_dtype(self, dtype: torch.dtype) -> "GANModel":
        for m in self.modules():
            if hasattr(m, "compute_dtype"):
                m.compute_dtype = dtype
        return self

    def reset_parameters(self, generator: torch.Generator) -> "GANModel":
        reset_weights(self, generator)
        return self


def _nhwc_out(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1).to(torch.float32)


# ---------------------------------------------------------------------------
# DCGAN (MNIST 28×28×1)
# ---------------------------------------------------------------------------


class DCGANGenerator(GANModel):
    """100-d noise → 28²×1 tanh image: Dense(12,544, no bias) → BN →
    leaky ReLU 0.3 → (7, 7, 256) → ConvTranspose 5×5 128 → 64 (stride 2)
    → 1 (stride 2), each but the last with BN and leaky ReLU."""

    def __init__(self, latent_dim: int = 100,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.latent_dim = latent_dim
        self.fc = Linear(latent_dim, 7 * 7 * 256, dtype, bias=False)
        self.fc_bn = _bn(7 * 7 * 256, dtype)
        self.deconv1 = ConvTranspose2d(256, 128, 5, 1, dtype)
        self.bn1 = _bn(128, dtype)
        self.deconv2 = ConvTranspose2d(128, 64, 5, 2, dtype)
        self.bn2 = _bn(64, dtype)
        self.deconv3 = ConvTranspose2d(64, 1, 5, 2, dtype)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        """``(N, latent_dim)`` → ``(N, 28, 28, 1)`` float32."""
        x = self.fc(z)
        n = x.shape[0]
        x = self.fc_bn(x.view(n, -1, 1, 1)).view(n, -1)
        x = F.leaky_relu(x, 0.3)
        x = x.view(n, 7, 7, 256).permute(0, 3, 1, 2)
        if x.is_cuda:
            x = x.contiguous(memory_format=torch.channels_last)
        x = F.leaky_relu(self.bn1(self.deconv1(x)), 0.3)
        x = F.leaky_relu(self.bn2(self.deconv2(x)), 0.3)
        return _nhwc_out(torch.tanh(self.deconv3(x)))


class DCGANDiscriminator(GANModel):
    """Conv 5×5/2 64 → leaky ReLU 0.3 → dropout 0.3 → conv 5×5/2 128 →
    leaky ReLU → dropout → NHWC flatten → Dense(1); every layer biased."""

    #: the shapes of the two dropout masks of one image, NHWC
    MASK_SHAPES = ((14, 14, 64), (7, 7, 128))
    DROPOUT = 0.3

    def __init__(self, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv1 = Conv2d(1, 64, 5, 2, "SAME", dtype, bias=True)
        self.drop1 = Dropout(self.DROPOUT)
        self.conv2 = Conv2d(64, 128, 5, 2, "SAME", dtype, bias=True)
        self.drop2 = Dropout(self.DROPOUT)
        self.fc = Linear(7 * 7 * 128, 1, dtype)
        _lecun(self.conv1, self.conv2)

    def forward(self, x: torch.Tensor, masks=None) -> torch.Tensor:
        """NHWC ``(N, 28, 28, 1)`` → ``(N, 1)`` float32 logits.
        ``masks``: the two NHWC keep masks of a training forward."""
        keep = [None, None] if masks is None else \
            [m.permute(0, 3, 1, 2) for m in masks]
        x = x.permute(0, 3, 1, 2)
        x = self.drop1(F.leaky_relu(self.conv1(x), 0.3), keep[0])
        x = self.drop2(F.leaky_relu(self.conv2(x), 0.3), keep[1])
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
        return self.fc(x).to(torch.float32)


# ---------------------------------------------------------------------------
# CycleGAN (256×256×3)
# ---------------------------------------------------------------------------


def reflect_pad(x: torch.Tensor, p: int) -> torch.Tensor:
    return F.pad(x, (p, p, p, p), mode="reflect")


class ResNetBlock(nn.Module):
    """Reflection pad → 3×3 conv → BN → ReLU → pad → conv → BN, plus the
    identity."""

    def __init__(self, dim: int = 256, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv1 = Conv2d(dim, dim, 3, 1, 0, dtype)
        self.bn1 = _bn(dim, dtype)
        self.conv2 = Conv2d(dim, dim, 3, 1, 0, dtype)
        self.bn2 = _bn(dim, dtype)
        _lecun(self.conv1, self.conv2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.bn1(self.conv1(reflect_pad(x, 1))))
        y = self.bn2(self.conv2(reflect_pad(y, 1)))
        return x + y


class CycleGANGenerator(GANModel):
    """c7s1-64, d128, d256, R256×``n_blocks``, u128, u64, c7s1-3 (tanh);
    only the last conv has a bias."""

    def __init__(self, n_blocks: int = 9,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.n_blocks = n_blocks
        self.conv_in = Conv2d(3, 64, 7, 1, 0, dtype)
        self.bn_in = _bn(64, dtype)
        self.down1 = Conv2d(64, 128, 3, 2, "SAME", dtype)
        self.bn_down1 = _bn(128, dtype)
        self.down2 = Conv2d(128, 256, 3, 2, "SAME", dtype)
        self.bn_down2 = _bn(256, dtype)
        self.blocks = nn.Sequential(*[ResNetBlock(256, dtype)
                                      for _ in range(n_blocks)])
        self.up1 = ConvTranspose2d(256, 128, 3, 2, dtype)
        self.bn_up1 = _bn(128, dtype)
        self.up2 = ConvTranspose2d(128, 64, 3, 2, dtype)
        self.bn_up2 = _bn(64, dtype)
        self.conv_out = Conv2d(64, 3, 7, 1, 0, dtype, bias=True)
        _lecun(self.conv_in, self.down1, self.down2, self.conv_out)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """NHWC ``(N, H, W, 3)`` → ``(N, H, W, 3)`` float32."""
        x = x.permute(0, 3, 1, 2)
        x = F.relu(self.bn_in(self.conv_in(reflect_pad(x, 3))))
        x = F.relu(self.bn_down1(self.down1(x)))
        x = F.relu(self.bn_down2(self.down2(x)))
        x = self.blocks(x)
        x = F.relu(self.bn_up1(self.up1(x)))
        x = F.relu(self.bn_up2(self.up2(x)))
        return _nhwc_out(torch.tanh(self.conv_out(reflect_pad(x, 3))))


class PatchGANDiscriminator(GANModel):
    """C64 (biased, no BN) - C128 - C256 (4×4, stride 2) - C512 (stride
    1) → a biased 4×4 conv to one channel: a patch map of logits; leaky
    ReLU 0.2."""

    def __init__(self, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv1 = Conv2d(3, 64, 4, 2, "SAME", dtype, bias=True)
        self.conv2 = Conv2d(64, 128, 4, 2, "SAME", dtype)
        self.bn2 = _bn(128, dtype)
        self.conv3 = Conv2d(128, 256, 4, 2, "SAME", dtype)
        self.bn3 = _bn(256, dtype)
        self.conv4 = Conv2d(256, 512, 4, 1, "SAME", dtype)
        self.bn4 = _bn(512, dtype)
        self.conv_out = Conv2d(512, 1, 4, 1, "SAME", dtype, bias=True)
        _lecun(self.conv1, self.conv2, self.conv3, self.conv4, self.conv_out)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """NHWC ``(N, H, W, 3)`` → ``(N, H/8, W/8, 1)`` float32 logits."""
        x = F.leaky_relu(self.conv1(x.permute(0, 3, 1, 2)), 0.2)
        x = F.leaky_relu(self.bn2(self.conv2(x)), 0.2)
        x = F.leaky_relu(self.bn3(self.conv3(x)), 0.2)
        x = F.leaky_relu(self.bn4(self.conv4(x)), 0.2)
        return _nhwc_out(self.conv_out(x))

