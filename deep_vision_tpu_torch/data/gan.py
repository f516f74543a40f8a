"""GAN input pipelines: MNIST in memory for DCGAN, two unpaired domains
for CycleGAN.

Port of ``deep_vision_tpu/data/gan.py`` (``to_uint8_wire``,
``mnist_gan_data``, ``GANLoader``, ``UnpairedLoader``,
``synthetic_unpaired``), in numpy with the same seeds and draw order, so
a seed and an epoch give the reference's batches.  The reference scales
images to [-1, 1] on the host (``(x − 127.5)/127.5``); with
``device_normalize`` they stay uint8 0–255 and ``ops/preprocess.py
make_gan_preprocess`` scales them on the device.
"""

from __future__ import annotations

import os
from typing import Iterator

import numpy as np


def to_uint8_wire(x: np.ndarray) -> np.ndarray:
    """Float [-1, 1] images → uint8 0–255, the inverse of the scaling."""
    return np.clip(np.round((x + 1.0) * 127.5), 0, 255).astype(np.uint8)


def mnist_gan_data(root: str | None = None, n_synthetic: int = 2048,
                   seed: int = 0,
                   device_normalize: bool = False) -> np.ndarray:
    """(N, 28, 28, 1) float32 in [-1, 1] (uint8 0–255 with
    ``device_normalize``) from ``root``'s ``train-images-idx3-ubyte[.gz]``;
    without a root, synthetic digits."""
    if root:
        from deep_vision_tpu_torch.data.mnist import load_idx_images

        for cand in ("train-images-idx3-ubyte", "train-images-idx3-ubyte.gz"):
            p = os.path.join(root, cand)
            if os.path.exists(p):
                images = load_idx_images(p)
                break
        else:
            raise FileNotFoundError(f"no MNIST idx images under {root}")
    else:
        from deep_vision_tpu_torch.data.synthetic import (
            synthetic_classification,
        )

        images = synthetic_classification(n_synthetic, 28, 1, 10,
                                          seed)["image"]
        images = (images - images.min()) / (np.ptp(images) + 1e-9) * 255.0
        images = images[..., 0]
    x = images.astype(np.float32)[..., None] if images.ndim == 3 else images
    if device_normalize:
        return np.clip(np.round(x), 0, 255).astype(np.uint8)
    return (x - 127.5) / 127.5


class GANLoader:
    """One domain: ``{"image": (B, H, W, C)}``, reshuffled each epoch
    from ``default_rng((seed, epoch))``; the last partial batch dropped."""

    def __init__(self, images: np.ndarray, batch_size: int, seed: int = 0):
        self.images = images
        self.batch_size = batch_size
        self.seed = seed
        self.epoch = 0

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def __len__(self):
        return len(self.images) // self.batch_size

    def __iter__(self) -> Iterator[dict]:
        rng = np.random.default_rng((self.seed, self.epoch))
        idx = rng.permutation(len(self.images))
        for b in range(len(self)):
            sel = idx[b * self.batch_size:(b + 1) * self.batch_size]
            yield {"image": self.images[sel]}


class UnpairedLoader:
    """Two domains, each shuffled on its own: ``{"image_a",
    "image_b"}``."""

    def __init__(self, images_a: np.ndarray, images_b: np.ndarray,
                 batch_size: int, seed: int = 0):
        self.a, self.b = images_a, images_b
        self.batch_size = batch_size
        self.seed = seed
        self.epoch = 0

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def __len__(self):
        return min(len(self.a), len(self.b)) // self.batch_size

    def __iter__(self) -> Iterator[dict]:
        rng = np.random.default_rng((self.seed, self.epoch))
        ia = rng.permutation(len(self.a))
        ib = rng.permutation(len(self.b))
        for k in range(len(self)):
            s = slice(k * self.batch_size, (k + 1) * self.batch_size)
            yield {"image_a": self.a[ia[s]], "image_b": self.b[ib[s]]}


def synthetic_unpaired(n: int, image_size: int = 64, seed: int = 0,
                       device_normalize: bool = False
                       ) -> tuple[np.ndarray, np.ndarray]:
    """Two translatable domains of ``n`` images each: the same stripes
    with opposite colour casts, in [-1, 1] (uint8 with
    ``device_normalize``)."""
    rng = np.random.default_rng(seed)
    base = rng.uniform(-0.2, 0.2, size=(2 * n, image_size, image_size, 3))
    ys, xs = np.mgrid[0:image_size, 0:image_size] / image_size
    pattern = np.sin(6.28 * ys)[..., None] * np.array([1.0, -1.0, 0.5])
    a = np.clip(base[:n] + pattern * 0.6 + [0.3, -0.3, 0.0], -1, 1)
    b = np.clip(base[n:] - pattern * 0.6 + [-0.3, 0.3, 0.0], -1, 1)
    a, b = a.astype(np.float32), b.astype(np.float32)
    if device_normalize:
        return to_uint8_wire(a), to_uint8_wire(b)
    return a, b
