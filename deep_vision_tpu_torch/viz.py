"""Result drawing: boxes and keypoints on an image, for ``cli.infer
detect/pose --out annotated.jpg``.

A copy of ``deep_vision_tpu/viz.py``.  Pure PIL (no matplotlib): draws
onto a copy of an RGB uint8 array and returns a new array, so callers
can save, grid or further process it.  PIL is imported where a drawing
is made: without it, drawing raises and nothing else does.
"""

from __future__ import annotations

import numpy as np

# a 12-color wheel distinct enough for overlays (tab10-ish RGB values)
_PALETTE = (
    (31, 119, 180), (255, 127, 14), (44, 160, 44), (214, 39, 40),
    (148, 103, 189), (140, 86, 75), (227, 119, 194), (127, 127, 127),
    (188, 189, 34), (23, 190, 207), (255, 187, 120), (152, 223, 138))

# MPII 16-joint order (Datasets/MPII/tfrecords_mpii.py feature semantics):
# 0 r.ankle 1 r.knee 2 r.hip 3 l.hip 4 l.knee 5 l.ankle 6 pelvis 7 thorax
# 8 neck 9 head-top 10 r.wrist 11 r.elbow 12 r.shoulder 13 l.shoulder
# 14 l.elbow 15 l.wrist
MPII_SKELETON = (
    (0, 1), (1, 2), (2, 6), (5, 4), (4, 3), (3, 6),      # legs → pelvis
    (6, 7), (7, 8), (8, 9),                               # spine → head
    (10, 11), (11, 12), (12, 7), (7, 13), (13, 14), (14, 15))  # arms


def _color(i: int) -> tuple:
    return _PALETTE[int(i) % len(_PALETTE)]


def draw_detections(image: np.ndarray, boxes: np.ndarray,
                    scores: np.ndarray, classes: np.ndarray,
                    class_names: list[str] | None = None,
                    min_score: float = 0.0) -> np.ndarray:
    """Overlay detection results on an RGB uint8 image.

    ``boxes`` are normalized (x1, y1, x2, y2) corners (the postprocess/NMS
    output, tasks/detection.py:271-295) and are scaled to the image's own
    resolution, so annotations land correctly on the ORIGINAL photo, not
    just the model's resized input."""
    from PIL import Image, ImageDraw

    im = Image.fromarray(np.ascontiguousarray(image))
    draw = ImageDraw.Draw(im)
    h, w = image.shape[:2]
    lw = max(2, round(min(h, w) / 200))
    for box, score, cls in zip(np.atleast_2d(boxes), np.atleast_1d(scores),
                               np.atleast_1d(classes)):
        if score < min_score:
            continue
        x1, y1, x2, y2 = (float(box[0]) * w, float(box[1]) * h,
                          float(box[2]) * w, float(box[3]) * h)
        color = _color(cls)
        draw.rectangle([x1, y1, x2, y2], outline=color, width=lw)
        name = class_names[int(cls)] if class_names and \
            0 <= int(cls) < len(class_names) else f"class {int(cls)}"
        label = f"{name} {float(score):.2f}"
        tb = draw.textbbox((x1, y1), label)
        ty = y1 - (tb[3] - tb[1]) - 2 * lw
        if ty < 0:  # label would leave the image: draw inside the box
            ty = y1 + lw
        tb = draw.textbbox((x1, ty), label)
        draw.rectangle([tb[0] - lw, tb[1] - lw, tb[2] + lw, tb[3] + lw],
                       fill=color)
        draw.text((x1, ty), label, fill=(255, 255, 255))
    return np.asarray(im)


def draw_keypoints(image: np.ndarray, keypoints: np.ndarray,
                   visible: np.ndarray | None = None,
                   skeleton=MPII_SKELETON) -> np.ndarray:
    """Overlay pose keypoints (K, 2) [x, y] in IMAGE pixels + skeleton
    edges on an RGB uint8 image.  ``visible`` masks joints (<=0 hidden);
    edges draw only when both endpoints are visible."""
    from PIL import Image, ImageDraw

    im = Image.fromarray(np.ascontiguousarray(image))
    draw = ImageDraw.Draw(im)
    h, w = image.shape[:2]
    r = max(2, round(min(h, w) / 100))
    kp = np.asarray(keypoints, np.float32)
    vis = np.ones(len(kp)) if visible is None else np.asarray(visible)
    for a, b in skeleton or ():
        if a < len(kp) and b < len(kp) and vis[a] > 0 and vis[b] > 0:
            draw.line([tuple(kp[a]), tuple(kp[b])], fill=_color(a),
                      width=max(1, r // 2))
    for k, (x, y) in enumerate(kp):
        if vis[k] <= 0:
            continue
        draw.ellipse([x - r, y - r, x + r, y + r], fill=_color(k),
                     outline=(255, 255, 255))
    return np.asarray(im)
