"""Host image transforms for the uint8 training wire, and the ImageNet
channel statistics.

Copies of ``deep_vision_tpu/data/transforms.py``'s uint8 half
(``rescale``, ``random_horizontal_flip``, ``random_crop``,
``center_crop``, ``train_transform_u8``, ``eval_transform_u8``,
``imagenet_resize_for``), of its float32 host half (``color_jitter``,
``normalize``, ``train_transform``, ``eval_transform``: the
``--host-normalize`` wire and the float32 serving wire's ``image_b64``
decode) and of the TF "ResNet preprocessing" variant
(``tf_train_transform``, ``tf_eval_transform``, ``TF_CHANNEL_MEANS``),
and the torch bilinear resizes that the detection and pose loaders use
on every machine (``resize_u8``, ``resize_square_u8``); the record
writers resize through ``resize_bilinear`` and ``rescale`` (cv2, else
PIL), as the reference's do.  All
functions take HWC numpy arrays on the host; randomness comes from an
explicit ``np.random.Generator`` with the reference's draw order (flip,
then crop top, then crop left, then the jitter's three factors and
their shuffled order).  On the uint8 wire the color jitter and
normalize run on the device instead (``ops/train_ingest.py``).
"""

from __future__ import annotations

import numpy as np

#: ImageNet channel statistics (RGB, on [0, 1] pixels) — the values the
#: ResNet family was trained against
IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def resize_bilinear(img: np.ndarray, w: int, h: int) -> np.ndarray:
    """Bilinear resize to (w, h) with cv2, else PIL.

    An image already at the target size is returned as it is (it may be a
    read-only view of a record's payload: callers never write it in
    place).  A real resize needs cv2 or PIL; without either it raises."""
    if img.shape[0] == h and img.shape[1] == w:
        return img
    try:
        import cv2
    except ImportError:
        cv2 = None
    if cv2 is not None:
        return cv2.resize(img, (w, h), interpolation=cv2.INTER_LINEAR)
    try:
        from PIL import Image
    except ImportError:
        raise RuntimeError(
            f"resizing a {img.shape[1]}x{img.shape[0]} image to {w}x{h} "
            f"needs cv2 or PIL, and neither is installed; store records "
            f"already at the loader's resize (prepare_data --store raw)"
        ) from None
    return np.asarray(Image.fromarray(img).resize((w, h), Image.BILINEAR))


def imagenet_resize_for(image_size: int) -> int:
    """Shorter-side resize target paired with a crop size (the 256-for-224
    ratio, clamped above the crop)."""
    return max(image_size * 256 // 224, image_size + 8)


def rescaled_hw(h: int, w: int, size: int) -> tuple[int, int]:
    """(height, width) with the SHORTER side at ``size``, the aspect
    ratio kept (the longer side rounds)."""
    if h < w:
        return size, max(1, int(round(w * size / h)))
    return max(1, int(round(h * size / w))), size


def rescale(img: np.ndarray, size: int) -> np.ndarray:
    """Resize so the SHORTER side == size, preserving aspect ratio."""
    nh, nw = rescaled_hw(*img.shape[:2], size)
    if (nh, nw) == img.shape[:2]:
        return img
    return resize_bilinear(img, nw, nh)


def random_horizontal_flip(img: np.ndarray, rng: np.random.Generator,
                           p: float = 0.5) -> np.ndarray:
    if rng.random() < p:
        return img[:, ::-1]
    return img


def random_crop(img: np.ndarray, size: int,
                rng: np.random.Generator) -> np.ndarray:
    h, w = img.shape[:2]
    top = int(rng.integers(0, h - size + 1))
    left = int(rng.integers(0, w - size + 1))
    return img[top:top + size, left:left + size]


def center_crop(img: np.ndarray, size: int) -> np.ndarray:
    h, w = img.shape[:2]
    top, left = (h - size) // 2, (w - size) // 2
    return img[top:top + size, left:left + size]


def train_transform_u8(img: np.ndarray, rng: np.random.Generator,
                       size: int = 224, resize: int = 256) -> np.ndarray:
    """Rescale → flip → RandomCrop, all uint8.  Returns a VIEW when no
    resize was needed; the one copy happens at batch assembly."""
    img = rescale(img, resize)
    img = random_horizontal_flip(img, rng)
    return random_crop(img, size, rng)


def eval_transform_u8(img: np.ndarray, size: int = 224,
                      resize: int = 256) -> np.ndarray:
    """Rescale → CenterCrop, uint8 (a view, as train_transform_u8)."""
    return center_crop(rescale(img, resize), size)


def normalize(img: np.ndarray, mean=IMAGENET_MEAN, std=IMAGENET_STD
              ) -> np.ndarray:
    """[0,1] float32 HWC → standardized; an image still in the uint8
    range (max above 1.5) is scaled by 1/255 first, as the reference
    does."""
    x = img.astype(np.float32)
    if x.max() > 1.5:
        x = x / 255.0
    return (x - mean) / std


def eval_transform(img: np.ndarray, size: int = 224, resize: int = 256
                   ) -> np.ndarray:
    """Rescale → CenterCrop → Normalize, float32 out."""
    return normalize(eval_transform_u8(img, size, resize))


def color_jitter(img: np.ndarray, rng: np.random.Generator,
                 brightness: float = 0.2, contrast: float = 0.2,
                 saturation: float = 0.2) -> np.ndarray:
    """Brightness, contrast and saturation jitter in an order
    ``rng.shuffle`` picks, each factor uniform in [1-x, 1+x] and drawn in
    that order before the shuffle; on float32 [0, 1] pixels (uint8 is
    scaled by 1/255 first), clipped to [0, 1] at the end."""
    x = img.astype(np.float32) / 255.0 if img.dtype == np.uint8 else img
    ops = []
    if brightness > 0:
        f = rng.uniform(max(0, 1 - brightness), 1 + brightness)
        ops.append(lambda a, f=f: a * f)
    if contrast > 0:
        f = rng.uniform(max(0, 1 - contrast), 1 + contrast)
        ops.append(lambda a, f=f: (a - a.mean()) * f + a.mean())
    if saturation > 0:
        f = rng.uniform(max(0, 1 - saturation), 1 + saturation)

        def sat(a, f=f):
            gray = a @ np.array([0.299, 0.587, 0.114], np.float32)
            return gray[..., None] + (a - gray[..., None]) * f

        ops.append(sat)
    rng.shuffle(ops)
    for op in ops:
        x = op(x)
    return np.clip(x, 0.0, 1.0)


def train_transform(img: np.ndarray, rng: np.random.Generator,
                    size: int = 224, resize: int = 256,
                    jitter: bool = True) -> np.ndarray:
    """Rescale → flip → RandomCrop → ColorJitter(.2, .2, .2) →
    Normalize, float32 out: the host-normalized train wire."""
    img = train_transform_u8(img, rng, size, resize)
    if jitter:
        img = color_jitter(img, rng)
    return normalize(img)


#: the TF pipeline's channel means in raw 0-255 space: it subtracts them
#: and neither divides by 255 nor by a std
TF_CHANNEL_MEANS = np.array([123.68, 116.78, 103.94], np.float32)


def tf_train_transform(img: np.ndarray, rng: np.random.Generator,
                       size: int = 224, resize: int = 256) -> np.ndarray:
    """The TF train path: aspect-preserving resize → random crop →
    random flip (crop before flip, unlike the torch pipeline; no jitter)
    → mean subtraction, float32 out."""
    img = rescale(img, resize)
    img = random_crop(img, size, rng)
    img = random_horizontal_flip(img, rng)
    return img.astype(np.float32) - TF_CHANNEL_MEANS


def tf_eval_transform(img: np.ndarray, size: int = 224, resize: int = 256
                      ) -> np.ndarray:
    """The TF eval path: aspect-preserving resize → central crop → mean
    subtraction, float32 out."""
    img = center_crop(rescale(img, resize), size)
    return img.astype(np.float32) - TF_CHANNEL_MEANS


def resize_u8(img: np.ndarray, h: int, w: int) -> np.ndarray:
    """HWC uint8 → ``h``×``w`` uint8, bilinear (half-pixel centres, no
    antialias) through torch on the CPU, on every machine: the card
    machine has neither cv2 nor PIL.  Against cv2's ``INTER_LINEAR`` it
    differs by at most 1 grey level.  An image already at the size is
    returned as it is (possibly a read-only or negatively strided view:
    callers never write it in place)."""
    if img.shape[0] == h and img.shape[1] == w:
        return img
    import torch
    import torch.nn.functional as F

    # torch takes no negative strides (a flipped view): copy first
    t = torch.from_numpy(np.ascontiguousarray(img)).permute(2, 0, 1)[None]
    out = F.interpolate(t, size=(h, w), mode="bilinear",
                        align_corners=False, antialias=False)
    return out[0].permute(1, 2, 0).contiguous().numpy()


def resize_square_u8(img: np.ndarray, size: int) -> np.ndarray:
    """:func:`resize_u8` to ``size``×``size``."""
    return resize_u8(img, size, size)
