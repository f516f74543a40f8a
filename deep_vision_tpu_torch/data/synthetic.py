"""Synthetic classification data for ``--synthetic`` smoke runs.

Copy of ``synthetic_classification`` from
``deep_vision_tpu/data/synthetic.py``: class-conditional Gaussian blobs
that a real network can overfit, as float32 host-normalized images.
"""

from __future__ import annotations

import numpy as np


def synthetic_classification(n: int, image_size: int = 32, channels: int = 1,
                             num_classes: int = 10, seed: int = 0
                             ) -> dict[str, np.ndarray]:
    """Learnable synthetic images: one blob location per class + noise."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, num_classes, size=n).astype(np.int32)
    images = rng.normal(0, 0.3, size=(n, image_size, image_size, channels))
    images = images.astype(np.float32)
    ys, xs = np.mgrid[0:image_size, 0:image_size]
    grid = max(2, int(np.ceil(np.sqrt(num_classes))))
    step = image_size / (grid + 1)
    sigma = max(image_size / 10.0, 1.5)
    for c in range(np.minimum(num_classes, grid * grid)):
        cy = step * (1 + c // grid)
        cx = step * (1 + c % grid)
        blob = np.exp(-(((ys - cy) ** 2 + (xs - cx) ** 2) / (2 * sigma**2)))
        images[labels == c] += 2.0 * blob[..., None].astype(np.float32)
    return {"image": images, "label": labels}
