"""Pose input: a crop around the keypoints, the left-right flip with the
joints swapped, the square resize and the 64² heatmap targets.

Port of ``deep_vision_tpu/data/pose.py`` (``MPII_NUM_KEYPOINTS``,
``MPII_FLIP_PAIRS``, ``crop_roi``, ``prepare_pose_sample``,
``PoseLoader``, ``synthetic_pose_dataset``).  Samples are dicts
``{"image": HWC uint8, "keypoints": (K, 3) [x_px, y_px, visibility],
"center": (2,), "scale": float}`` (the MPII person scale: the body is
``scale · 200`` pixels tall); the loader yields static-shape batches
``{"image": (B, S, S, 3), "heatmaps": (B, S/4, S/4, K), "keypoints":
(B, K, 3) in heatmap pixels}`` (+ ``"weight"`` in eval).  The image
stays uint8 with ``device_normalize`` (the /255 runs on the card,
``ops/preprocess.make_scale_preprocess``).

One difference from the reference: the square resize is bilinear
through torch (``data/transforms.resize_square_u8``), where the
reference uses cv2; the two differ by at most one grey level.  The
labels do not depend on the resize.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from deep_vision_tpu_torch.data.detection import resize_square
from deep_vision_tpu_torch.data.loader import PreppedSampleLoader
from deep_vision_tpu_torch.tasks.pose import make_heatmaps

MPII_NUM_KEYPOINTS = 16
#: symmetric joints swapped under a horizontal flip (MPII order: 0-5
#: right/left ankle-knee-hip, 10-15 right/left wrist-elbow-shoulder)
MPII_FLIP_PAIRS = ((0, 5), (1, 4), (2, 3), (10, 15), (11, 14), (12, 13))


def crop_roi(img: np.ndarray, keypoints: np.ndarray, scale: float,
             margin: float = 0.2) -> tuple[np.ndarray, np.ndarray]:
    """Crop around the visible keypoints with a margin of ``margin`` of
    the body height; returns the crop and the keypoints in normalized
    crop coordinates.  A keypoint is visible when its visibility is set
    AND its x is not negative (MPII keeps an occluded joint's
    coordinates; a negative one means absent)."""
    h, w = img.shape[:2]
    kp = np.asarray(keypoints, np.float32)
    vis = (kp[:, 2] > 0) & (kp[:, 0] >= 0)
    if not vis.any():
        norm = np.concatenate([kp[:, :2] / [w, h], kp[:, 2:3]], 1)
        return img, norm
    body = scale * 200.0
    x1 = int(max(0, kp[vis, 0].min() - body * margin))
    x2 = int(min(w, kp[vis, 0].max() + body * margin))
    y1 = int(max(0, kp[vis, 1].min() - body * margin))
    y2 = int(min(h, kp[vis, 1].max() + body * margin))
    crop = img[y1:y2, x1:x2]
    ch, cw = max(crop.shape[0], 1), max(crop.shape[1], 1)
    out = kp.copy()
    out[:, 0] = (kp[:, 0] - x1) / cw
    out[:, 1] = (kp[:, 1] - y1) / ch
    return crop, out


def prepare_pose_sample(sample: dict, rng: np.random.Generator, *,
                        image_size: int, heatmap_size: int,
                        flip_perm: np.ndarray, augment: bool,
                        device_normalize: bool = False) -> dict:
    """crop → flip (p 0.5: mirror x and swap the symmetric joints) →
    square resize → heatmaps."""
    img = sample["image"]
    kp = np.asarray(sample["keypoints"], np.float32)
    crop, norm_kp = crop_roi(img, kp, float(sample.get("scale", 1.0)))
    if augment and rng.random() < 0.5:
        crop = crop[:, ::-1]
        norm_kp = norm_kp[flip_perm].copy()
        norm_kp[:, 0] = 1.0 - norm_kp[:, 0]
    img = resize_square(crop, image_size)
    x = img if device_normalize else img.astype(np.float32) / 255.0
    hm_kp = np.concatenate(
        [norm_kp[:, :2] * heatmap_size, norm_kp[:, 2:3]], 1)
    heat = make_heatmaps(hm_kp, heatmap_size, heatmap_size)
    return {"image": x, "heatmaps": heat,
            "keypoints": hm_kp.astype(np.float32)}


class PoseLoader(PreppedSampleLoader):
    """Batches of pose samples (a list of dicts, or the lazy samples of
    ``data/records.load_pose_records``).  Shuffle, eval padding,
    per-item rng and worker pool: see
    :class:`~deep_vision_tpu_torch.data.loader.PreppedSampleLoader`."""

    PREPARE = staticmethod(prepare_pose_sample)

    def __init__(self, samples: Sequence[dict], batch_size: int,
                 image_size: int = 256, heatmap_size: int = 64,
                 num_keypoints: int = MPII_NUM_KEYPOINTS,
                 train: bool = True, seed: int = 0,
                 flip_pairs: Sequence[tuple[int, int]] | None =
                 MPII_FLIP_PAIRS,
                 device_normalize: bool = False, num_workers: int = 0,
                 prefetch_batches: int = 2):
        # the channel permutation of a horizontal flip (left ↔ right)
        perm = np.arange(num_keypoints)
        if flip_pairs:
            for a, b in flip_pairs:
                if a < num_keypoints and b < num_keypoints:
                    perm[a], perm[b] = perm[b], perm[a]
        self.flip_perm = perm
        self.image_size = image_size
        self.heatmap_size = heatmap_size
        self.num_keypoints = num_keypoints
        self.device_normalize = device_normalize
        super().__init__(samples, batch_size, train, seed, num_workers,
                         prefetch_batches)

    def _prep_kwargs(self) -> dict:
        return dict(image_size=self.image_size,
                    heatmap_size=self.heatmap_size,
                    flip_perm=self.flip_perm, augment=self.train,
                    device_normalize=self.device_normalize)


def synthetic_pose_dataset(n: int, image_size: int = 256,
                           num_keypoints: int = MPII_NUM_KEYPOINTS,
                           seed: int = 0) -> list[dict]:
    """Learnable synthetic poses: bright dots at the keypoints on dark
    noise, about one keypoint in ten invisible."""
    rng = np.random.default_rng(seed)
    samples = []
    for _ in range(n):
        img = rng.integers(0, 48, size=(image_size, image_size, 3),
                           dtype=np.uint8)
        kp = np.zeros((num_keypoints, 3), np.float32)
        for k in range(num_keypoints):
            x = rng.uniform(0.15, 0.85) * image_size
            y = rng.uniform(0.15, 0.85) * image_size
            vis = 1.0 if rng.random() > 0.1 else 0.0
            kp[k] = (x, y, vis)
            if vis:
                xi, yi = int(x), int(y)
                img[max(0, yi - 3):yi + 3, max(0, xi - 3):xi + 3] = \
                    [255, 40 + 12 * k, 220 - 12 * k]
        samples.append({"image": img, "keypoints": kp,
                        "center": np.array([image_size / 2] * 2, np.float32),
                        "scale": image_size / 250.0})
    return samples
