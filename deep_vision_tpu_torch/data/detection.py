"""Detection input: box-preserving flip and crop, square resize, and the
label encoding of YOLOv3 (three scales) or CenterNet (stride-4 heatmaps).

Port of ``deep_vision_tpu/data/detection.py`` (``flip_boxes_lr``,
``random_crop_with_boxes``, ``resize_square``, ``corners_to_xywh``,
``_augment_resize``, ``prepare_yolo_sample``,
``prepare_centernet_sample``, ``DetectionLoader``, ``CenterNetLoader``,
``synthetic_detection_dataset``).  Samples are dicts ``{"image": HWC
uint8, "boxes": (N, 4) normalized corners, "classes": (N,) int}``; the
loaders yield static-shape batches, ``{"image": (B, S, S, 3),
"y_true_0..2", "boxes", "boxes_mask", "gt_classes"}`` for YOLOv3 and
``{"image", "heatmap", "wh", "offset", "indices", "obj_mask", "boxes",
"gt_classes"}`` for CenterNet (+ ``"weight"`` in eval).  CenterNet takes
no crop, as in the reference.  The image stays uint8 with
``device_normalize`` (the /255 runs on the card,
``ops/preprocess.make_scale_preprocess``).

One difference from the reference: the square resize after a crop is
bilinear through torch (``data/transforms.resize_square_u8``) on every
machine, where the reference uses cv2; the two differ by at most one
grey level.  Un-cropped samples of records stored at the input size
need no resize at all.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from deep_vision_tpu_torch.data.loader import PreppedSampleLoader
from deep_vision_tpu_torch.data.transforms import resize_square_u8
from deep_vision_tpu_torch.tasks.centernet import encode_centernet_labels
from deep_vision_tpu_torch.tasks.detection import encode_labels


def flip_boxes_lr(boxes: np.ndarray) -> np.ndarray:
    """(N, 4) normalized corners (x1, y1, x2, y2) under a horizontal
    flip."""
    out = boxes.copy()
    out[:, 0] = 1.0 - boxes[:, 2]
    out[:, 2] = 1.0 - boxes[:, 0]
    return out


def random_crop_with_boxes(img: np.ndarray, boxes: np.ndarray,
                           rng: np.random.Generator):
    """Box-preserving random crop: one margin per side drawn uniformly
    between the hull of ALL boxes and the image edge (so every box stays
    whole), boxes renormalized to the crop.  Returns (crop, boxes,
    keep), keep all True."""
    h, w = img.shape[:2]
    if len(boxes) == 0:
        return img, boxes, np.zeros((0,), bool)
    dx1 = rng.uniform(0, max(0.0, boxes[:, 0].min()))
    dy1 = rng.uniform(0, max(0.0, boxes[:, 1].min()))
    dx2 = rng.uniform(0, max(0.0, 1.0 - boxes[:, 2].max()))
    dy2 = rng.uniform(0, max(0.0, 1.0 - boxes[:, 3].max()))
    new_w = 1.0 - dx1 - dx2
    new_h = 1.0 - dy1 - dy2
    out = boxes.copy()
    out[:, [0, 2]] = (boxes[:, [0, 2]] - dx1) / max(new_w, 1e-9)
    out[:, [1, 3]] = (boxes[:, [1, 3]] - dy1) / max(new_h, 1e-9)
    oy, ox = int(dy1 * h), int(dx1 * w)
    th = max(1, int(np.ceil(new_h * h)))
    tw = max(1, int(np.ceil(new_w * w)))
    crop = img[oy:oy + th, ox:ox + tw]
    out = np.clip(out, 0.0, 1.0).astype(np.float32)
    return crop, out, np.ones(len(boxes), bool)


def resize_square(img: np.ndarray, size: int) -> np.ndarray:
    """Square resize to ``size``² (after a crop; a no-op at the size)."""
    return resize_square_u8(img, size)


def corners_to_xywh(boxes: np.ndarray) -> np.ndarray:
    xy = (boxes[:, :2] + boxes[:, 2:4]) / 2
    wh = boxes[:, 2:4] - boxes[:, :2]
    return np.concatenate([xy, wh], axis=1)


def _augment_resize(sample: dict, rng: np.random.Generator,
                    image_size: int, augment: bool, crop: bool,
                    device_normalize: bool):
    """The shared front half of a sample's prep: flip (p 0.5), then,
    with ``crop``, crop (p 0.5), then the square resize; the draws in
    the reference's order.  The image stays uint8 with
    ``device_normalize``, else becomes float32 / 255.  Returns (image,
    boxes, classes)."""
    img = sample["image"]
    boxes = np.asarray(sample["boxes"], np.float32).reshape(-1, 4)
    classes = np.asarray(sample["classes"], np.int64).reshape(-1)
    if augment and len(boxes):
        if rng.random() < 0.5:
            img = img[:, ::-1]
            boxes = flip_boxes_lr(boxes)
        if crop and rng.random() < 0.5:
            img, boxes, keep = random_crop_with_boxes(img, boxes, rng)
            classes = classes[keep]
    img = resize_square(img, image_size)
    x = img if device_normalize else img.astype(np.float32) / 255.0
    return x, boxes, classes


def prepare_yolo_sample(sample: dict, rng: np.random.Generator, *,
                        num_classes: int, image_size: int, grids,
                        augment: bool, device_normalize: bool = False
                        ) -> dict:
    """flip → crop → resize → YOLOv3's three-scale label encoding."""
    x, boxes, classes = _augment_resize(sample, rng, image_size, augment,
                                        crop=True,
                                        device_normalize=device_normalize)
    enc = encode_labels(corners_to_xywh(boxes), classes, num_classes,
                        grids=grids)
    return {"image": x, **enc}


def prepare_centernet_sample(sample: dict, rng: np.random.Generator, *,
                             num_classes: int, image_size: int, grids,
                             augment: bool, device_normalize: bool = False
                             ) -> dict:
    """flip → resize (no crop) → CenterNet's label encoding at stride 4
    (``grid = image_size // 4``; ``grids`` is unused, kept for the
    shared loader signature)."""
    x, boxes, classes = _augment_resize(sample, rng, image_size, augment,
                                        crop=False,
                                        device_normalize=device_normalize)
    enc = encode_centernet_labels(corners_to_xywh(boxes), classes,
                                  num_classes, grid=image_size // 4)
    return {"image": x, **enc}


class DetectionLoader(PreppedSampleLoader):
    """Batch iterator over detection samples (a list of dicts, or the
    lazy samples of ``data/records.load_detection_records``).  Shuffle,
    eval padding, per-item rng and worker pool: see
    :class:`~deep_vision_tpu_torch.data.loader.PreppedSampleLoader`."""

    PREPARE = staticmethod(prepare_yolo_sample)

    def __init__(self, samples: Sequence[dict], batch_size: int,
                 num_classes: int, image_size: int = 416,
                 grids: Sequence[int] | None = None,
                 train: bool = True, seed: int = 0, augment: bool = True,
                 device_normalize: bool = False, num_workers: int = 0,
                 prefetch_batches: int = 2):
        self.num_classes = num_classes
        self.image_size = image_size
        self.grids = tuple(grids) if grids else (
            image_size // 8, image_size // 16, image_size // 32)
        self.augment = augment and train
        self.device_normalize = device_normalize
        super().__init__(samples, batch_size, train, seed, num_workers,
                         prefetch_batches)

    def _prep_kwargs(self) -> dict:
        return dict(num_classes=self.num_classes,
                    image_size=self.image_size, grids=self.grids,
                    augment=self.augment,
                    device_normalize=self.device_normalize)


class CenterNetLoader(DetectionLoader):
    """The same samples and augmentation (without the crop), with
    CenterNet's target encoding (``tasks/centernet.py
    encode_centernet_labels``) at stride 4."""

    PREPARE = staticmethod(prepare_centernet_sample)


def synthetic_detection_dataset(n: int, image_size: int = 416,
                                num_classes: int = 3, seed: int = 0
                                ) -> list[dict]:
    """Learnable synthetic scenes: 1-3 coloured rectangles on noise, the
    class is the colour."""
    rng = np.random.default_rng(seed)
    palette = rng.integers(64, 255, size=(num_classes, 3))
    samples = []
    for _ in range(n):
        img = rng.integers(0, 64, size=(image_size, image_size, 3),
                           dtype=np.uint8)
        k = int(rng.integers(1, 4))
        boxes, classes = [], []
        for _ in range(k):
            w = rng.uniform(0.15, 0.5)
            h = rng.uniform(0.15, 0.5)
            x1 = rng.uniform(0, 1 - w)
            y1 = rng.uniform(0, 1 - h)
            c = int(rng.integers(0, num_classes))
            px = [int(x1 * image_size), int(y1 * image_size),
                  int((x1 + w) * image_size), int((y1 + h) * image_size)]
            img[px[1]:px[3], px[0]:px[2]] = palette[c]
            boxes.append([x1, y1, x1 + w, y1 + h])
            classes.append(c)
        samples.append({"image": img,
                        "boxes": np.asarray(boxes, np.float32),
                        "classes": np.asarray(classes, np.int64)})
    return samples
