"""Detection task: YOLOv3 box codecs, loss, label encoding, postprocess.

Port of ``deep_vision_tpu/tasks/detection.py``: ``decode_boxes``,
``encode_boxes``, ``_bce``, ``yolo_scale_loss``, ``YoloTask`` (loss,
eval metrics, decoded eval outputs for the host mAP evaluator),
``MAX_BOXES``, ``find_best_anchor``, ``encode_labels`` (numpy, host) and
``postprocess`` (decode → top-k → NMS, class-agnostic by default and
class-wise, Soft-NMS or capped per class for serving).

The loss is float32.  Its ignore mask compares every prediction with a
fixed-size padded list of its own image's ground-truth boxes
(``batch["boxes"]``, mask ``batch["boxes_mask"]``) through
``ops/best_iou.best_iou_max``: on the card the ``best_iou_max`` CUDA
kernel, on the CPU its plain version.  The device picks; there is no
switch.  The mask is a hard threshold, so it runs on detached boxes
under ``no_grad``.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from deep_vision_tpu_torch.models.yolo import ANCHOR_MASKS, YOLO_ANCHORS
from deep_vision_tpu_torch.ops.best_iou import best_iou_max
from deep_vision_tpu_torch.ops.boxes import (
    batched_nms,
    topk_stable,
    xywh_to_corners,
)
from deep_vision_tpu_torch.ops.ingest import device_scalar

MAX_BOXES = 100  # static per-image ground-truth capacity


def _cell_offsets(grid: int, device) -> torch.Tensor:
    """(1, G, G, 1, 2) float32 (x, y) index of every grid cell."""
    r = torch.arange(grid, dtype=torch.float32, device=device)
    cy, cx = torch.meshgrid(r, r, indexing="ij")
    return torch.stack([cx, cy], dim=-1)[None, :, :, None, :]


def decode_boxes(raw: torch.Tensor, anchors_wh: torch.Tensor):
    """t-space raw head output → (normalized xywh boxes, obj, classes).

    raw: (B, G, G, A, 5+C).  ``bxy = (σ(txy) + cell) / G``,
    ``bwh = anchor · exp(clip(twh, −9, 9))``."""
    grid = raw.shape[1]
    t_xy, t_wh, obj, cls = torch.split(raw, (2, 2, 1, raw.shape[-1] - 5),
                                       dim=-1)
    b_xy = (torch.sigmoid(t_xy) + _cell_offsets(grid, raw.device)) \
        / device_scalar(float(grid), raw.device)
    b_wh = torch.exp(torch.clamp(t_wh, -9.0, 9.0)) * anchors_wh
    return (torch.cat([b_xy, b_wh], dim=-1), torch.sigmoid(obj),
            torch.sigmoid(cls))


def encode_boxes(xywh: torch.Tensor, anchors_wh: torch.Tensor,
                 eps: float = 1e-9):
    """normalized xywh → t-space targets (the inverse of decode): the
    cell offset of the centre, and ``log(wh / anchor)`` (0 where the
    cell is empty)."""
    grid = xywh.shape[1]
    xy, wh = xywh[..., :2], xywh[..., 2:4]
    scaled = xy * float(grid)
    t_xy = scaled - torch.floor(scaled)
    t_wh = torch.log(torch.clamp_min(wh, eps) / anchors_wh)
    t_wh = torch.where(wh <= eps, torch.zeros_like(t_wh), t_wh)
    return t_xy, t_wh


def _bce(logit: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Binary cross-entropy from logits, the numerically stable form."""
    return torch.clamp_min(logit, 0.0) - logit * target + \
        torch.log1p(torch.exp(-torch.abs(logit)))


def yolo_scale_loss(raw: torch.Tensor, y_true: torch.Tensor,
                    gt_boxes: torch.Tensor, gt_mask: torch.Tensor,
                    anchors_wh: torch.Tensor, ignore_thresh: float = 0.5,
                    lambda_coord: float = 5.0, lambda_noobj: float = 0.5):
    """Loss of ONE scale.

    raw: (B, G, G, A, 5+C) head output; y_true: the same shape, absolute
    xywh + obj + one-hot; gt_boxes: (B, MAX_BOXES, 4) corners; gt_mask:
    (B, MAX_BOXES).  Returns (total (B,), components): ``xy``, ``wh``,
    ``obj`` (object + background), ``class``, each (B,), and ``ignored``,
    each image's share of predictions that the ignore mask took out of
    the background loss (no-object cells whose best IoU reached
    ``ignore_thresh``)."""
    pred_xy_rel = torch.sigmoid(raw[..., 0:2])
    pred_wh_rel = raw[..., 2:4]
    pred_box_abs, _, _ = decode_boxes(raw, anchors_wh)
    pred_corners = xywh_to_corners(pred_box_abs)

    true_wh_abs = y_true[..., 2:4]
    true_obj = y_true[..., 4:5]
    true_class = y_true[..., 5:]
    true_xy_rel, true_wh_rel = encode_boxes(y_true[..., 0:4], anchors_wh)

    # small-box upweighting (2 − w·h)
    weight = 2.0 - true_wh_abs[..., 0] * true_wh_abs[..., 1]
    obj = true_obj[..., 0]

    xy_loss = torch.square(true_xy_rel - pred_xy_rel).sum(-1)
    xy_loss = (obj * weight * xy_loss).sum((1, 2, 3)) * lambda_coord
    wh_loss = torch.square(true_wh_rel - pred_wh_rel).sum(-1)
    wh_loss = (obj * weight * wh_loss).sum((1, 2, 3)) * lambda_coord

    # ignore mask: predictions overlapping ANY of their image's ground
    # truths past the threshold are not penalized as background
    b = raw.shape[0]
    with torch.no_grad():
        flat = pred_corners.detach().reshape(b, -1, 4).contiguous()
        best_iou = best_iou_max(
            flat, gt_boxes.to(torch.float32).contiguous(),
            gt_mask.to(torch.float32).contiguous()).reshape(obj.shape)
        ignore = (best_iou < ignore_thresh).to(torch.float32)
        ignored = ((1.0 - obj) * (1.0 - ignore)).mean((1, 2, 3))

    obj_entropy = _bce(raw[..., 4:5], true_obj)[..., 0]
    obj_loss = (obj * obj_entropy).sum((1, 2, 3))
    noobj_loss = ((1.0 - obj) * obj_entropy * ignore).sum((1, 2, 3)) \
        * lambda_noobj

    class_entropy = _bce(raw[..., 5:], true_class)
    class_loss = (true_obj * class_entropy).sum((1, 2, 3, 4))

    total = xy_loss + wh_loss + obj_loss + noobj_loss + class_loss
    return total, {"xy": xy_loss, "wh": wh_loss,
                   "obj": obj_loss + noobj_loss, "class": class_loss,
                   "ignored": ignored}


class YoloTask:
    """The trainer's task bundle: the three-scale loss, eval loss sums,
    and decoded, NMS'd eval outputs for the host mAP@0.5 evaluator."""

    monitor = "mAP"

    def __init__(self, num_classes: int,
                 anchors: np.ndarray = YOLO_ANCHORS,
                 masks: np.ndarray = ANCHOR_MASKS,
                 eval_score_threshold: float = 0.05):
        self.num_classes = num_classes
        self.anchors = np.asarray(anchors, np.float32)
        self.masks = masks
        self.eval_score_threshold = eval_score_threshold
        self._anchors_on: dict = {}

    def _scale_anchors(self, scale: int, device) -> torch.Tensor:
        key = (scale, str(device))
        if key not in self._anchors_on:
            self._anchors_on[key] = torch.from_numpy(
                self.anchors[self.masks[scale]]).to(device)
        return self._anchors_on[key]

    def _scale_losses(self, outputs, batch):
        for s, raw in enumerate(outputs):
            yield s, yolo_scale_loss(
                raw, batch[f"y_true_{s}"], batch["boxes"],
                batch["boxes_mask"], self._scale_anchors(s, raw.device))

    def loss(self, outputs, batch):
        """(mean loss over the batch summed over scales, per-scale
        component means ``{xy,wh,obj,class,ignored}_{s}``)."""
        total, comps = 0.0, {}
        for s, (t, c) in self._scale_losses(outputs, batch):
            total = total + t.mean()
            for k, v in c.items():
                comps[f"{k}_{s}"] = v.mean()
        return total, comps

    def eval_metrics(self, outputs, batch) -> dict:
        """Weighted per-image loss sums; ``weight`` 0 marks the padded
        filler rows of the last eval batch."""
        w = batch.get("weight")
        w = torch.ones(batch["boxes"].shape[0], device=outputs[0].device) \
            if w is None else w.to(torch.float32)
        per_image = 0.0
        for _, (t, _) in self._scale_losses(outputs, batch):
            per_image = per_image + t
        loss_sum = (per_image * w).sum()
        return {"loss": loss_sum, "neg_loss": -loss_sum, "count": w.sum()}

    def eval_outputs(self, outputs, batch) -> dict:
        """Decode + NMS on the device for the host mAP accumulator."""
        boxes, scores, classes, valid = postprocess(
            outputs, self.num_classes, anchors=self.anchors,
            masks=self.masks, score_threshold=self.eval_score_threshold)
        return {"det_boxes": boxes, "det_scores": scores,
                "det_classes": classes, "det_valid": valid,
                "gt_boxes": batch["boxes"], "gt_mask": batch["boxes_mask"],
                "gt_classes": batch["gt_classes"]}

    def make_host_evaluator(self):
        from deep_vision_tpu_torch.tasks.map_eval import (
            DetectionMAPAccumulator,
        )

        return DetectionMAPAccumulator(self.num_classes)


# ---------------------------------------------------------------------------
# Label encoding (host side, numpy)
# ---------------------------------------------------------------------------


def find_best_anchor(wh: np.ndarray, anchors: np.ndarray = YOLO_ANCHORS
                     ) -> np.ndarray:
    """Best of the 9 anchors by centred IoU: (N, 2) normalized → (N,)."""
    inter = np.minimum(wh[:, None, 0], anchors[None, :, 0]) * \
        np.minimum(wh[:, None, 1], anchors[None, :, 1])
    union = wh[:, None, 0] * wh[:, None, 1] + \
        anchors[None, :, 0] * anchors[None, :, 1] - inter
    return np.argmax(inter / np.maximum(union, 1e-9), axis=1)


def encode_labels(boxes_xywh: np.ndarray, classes: np.ndarray,
                  num_classes: int, grids: Sequence[int] = (52, 26, 13),
                  anchors: np.ndarray = YOLO_ANCHORS,
                  masks: np.ndarray = ANCHOR_MASKS) -> dict:
    """One image's boxes → the 3 ``y_true`` grids + the padded box list.

    boxes_xywh: (N, 4) normalized centroids; classes: (N,) int.  Returns
    ``{y_true_0..2: (G, G, 3, 5+C), boxes: (MAX_BOXES, 4) corners,
    boxes_mask: (MAX_BOXES,), gt_classes: (MAX_BOXES,)}``.  Boxes past
    MAX_BOXES are dropped everywhere, so every positive cell's box is in
    the ignore mask's list."""
    n = len(boxes_xywh)
    out = {f"y_true_{s}": np.zeros((g, g, 3, 5 + num_classes), np.float32)
           for s, g in enumerate(grids)}
    boxes_list = np.zeros((MAX_BOXES, 4), np.float32)
    boxes_mask = np.zeros((MAX_BOXES,), np.float32)
    classes_list = np.zeros((MAX_BOXES,), np.int32)
    if n:
        m = min(n, MAX_BOXES)
        boxes_xywh = boxes_xywh[:m]
        classes = classes[:m]
        corners = np.concatenate(
            [boxes_xywh[:, :2] - boxes_xywh[:, 2:4] / 2,
             boxes_xywh[:, :2] + boxes_xywh[:, 2:4] / 2], 1)
        boxes_list[:m] = corners
        boxes_mask[:m] = 1.0
        classes_list[:m] = classes
        best = find_best_anchor(boxes_xywh[:, 2:4], anchors)
        for s, g in enumerate(grids):
            sel = np.isin(best, masks[s])
            if not sel.any():
                continue
            b = boxes_xywh[sel]
            cls = classes[sel]
            a_idx = np.searchsorted(masks[s], best[sel])
            gx = np.clip((b[:, 0] * g).astype(int), 0, g - 1)
            gy = np.clip((b[:, 1] * g).astype(int), 0, g - 1)
            y = out[f"y_true_{s}"]
            y[gy, gx, a_idx, 0:4] = b[:, 0:4]
            y[gy, gx, a_idx, 4] = 1.0
            y[gy, gx, a_idx, 5 + cls] = 1.0
    return {**out, "boxes": boxes_list, "boxes_mask": boxes_mask,
            "gt_classes": classes_list}


# ---------------------------------------------------------------------------
# Postprocess: decode every scale → top-k → NMS
# ---------------------------------------------------------------------------


def postprocess(outputs, num_classes: int, max_outputs: int = 100,
                iou_threshold: float = 0.5, score_threshold: float = 0.1,
                anchors: np.ndarray = YOLO_ANCHORS,
                masks: np.ndarray = ANCHOR_MASKS,
                pre_nms_top_k: int = 512, class_aware: bool = False,
                soft_nms: str = "off", soft_sigma: float = 0.5,
                max_per_class: int = 0):
    """Raw 3-scale outputs → (boxes (B, K, 4) corners, scores (B, K),
    classes (B, K), valid (B, K)).  Only the ``pre_nms_top_k``
    best-scoring candidates of each image enter NMS (a box outside them
    can never outrank one inside), taken in ``jax.lax.top_k``'s order:
    the lower index first among equal scores.

    The default is class-agnostic hard NMS, as the reference's
    evaluation; ``class_aware=True`` makes suppression class-wise (what
    the serving epilogue uses), ``soft_nms``/``soft_sigma`` switch to
    Soft-NMS decay and ``max_per_class`` caps each class's kept boxes
    (``ops/boxes.batched_nms``).  ``max_per_class`` is ignored unless
    ``class_aware``, as in the reference."""
    all_boxes, all_scores, all_cls = [], [], []
    for s, raw in enumerate(outputs):
        anchors_wh = torch.from_numpy(
            np.asarray(anchors, np.float32)[masks[s]]).to(raw.device)
        box, obj, cls = decode_boxes(raw, anchors_wh)
        b = raw.shape[0]
        scores = obj * cls  # per-class confidence
        best_score, best_cls = scores.max(-1)
        all_boxes.append(xywh_to_corners(box).reshape(b, -1, 4))
        all_scores.append(best_score.reshape(b, -1))
        all_cls.append(best_cls.reshape(b, -1))
    boxes = torch.cat(all_boxes, 1)
    scores = torch.cat(all_scores, 1)
    classes = torch.cat(all_cls, 1)
    k = min(pre_nms_top_k, scores.shape[1])
    scores, top_idx = topk_stable(scores, k)
    boxes = boxes.gather(1, top_idx[..., None].expand(-1, -1, 4))
    classes = classes.gather(1, top_idx)
    idx, sel_scores, valid = batched_nms(
        boxes, scores, max_outputs, iou_threshold, score_threshold,
        classes=classes if class_aware else None, soft=soft_nms,
        soft_sigma=soft_sigma,
        max_per_class=max_per_class if class_aware else 0)
    sel_boxes = boxes.gather(1, idx[..., None].expand(-1, -1, 4))
    sel_classes = classes.gather(1, idx)
    return sel_boxes, sel_scores, sel_classes, valid
