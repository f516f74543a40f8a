"""CenterNet ("Objects as Points"): label encoding, loss and decode.

Port of ``deep_vision_tpu/tasks/centernet.py`` (``MAX_OBJECTS``,
``gaussian_radius``, ``encode_centernet_labels``, ``focal_loss``,
``_gather_at``, ``CenterNetTask``, ``decode_detections``):

- the labels are made on the host in numpy, as the reference makes them:
  a size-adaptive Gaussian per object on its class's heatmap (each built
  in float64, then a float32 ``max``), the grid cell, size and sub-cell
  offset of every object, and its box for the host mAP evaluator;
- the loss is the penalty-reduced pixelwise focal loss on the class
  heatmap (α 2, β 4, normalized per image by its positives), plus L1 on
  wh (weight 0.1) and on the offset (weight 1) at the objects' cells,
  summed over the stacks (intermediate supervision);
- the decode is the reference's 3×3 ``reduce_window(max, "SAME")`` with
  −inf padding, which is ``F.max_pool2d(h, 3, 1, 1)``; a cell keeps its
  score where it equals the pooled value of the very same tensor.  The
  top-K takes ``jax.lax.top_k``'s order (``ops/boxes.topk_stable``):
  suppression leaves many exact zeros, and equal sigmoid values survive
  as several peaks, so ties are common.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from deep_vision_tpu_torch.ops.boxes import topk_stable
from deep_vision_tpu_torch.ops.ingest import device_scalar

#: static per-image object capacity of the encoded labels
MAX_OBJECTS = 100


def gaussian_radius(h: np.ndarray, w: np.ndarray, min_iou: float = 0.7
                    ) -> np.ndarray:
    """CenterNet's size-adaptive radius: the smallest r such that a
    corner shifted by r still gives IoU ≥ ``min_iou`` (the CornerNet
    derivation)."""
    a1, b1 = 1.0, h + w
    c1 = w * h * (1 - min_iou) / (1 + min_iou)
    r1 = (b1 - np.sqrt(np.maximum(b1**2 - 4 * a1 * c1, 0))) / 2
    a2, b2 = 4.0, 2 * (h + w)
    c2 = (1 - min_iou) * w * h
    r2 = (b2 - np.sqrt(np.maximum(b2**2 - 4 * a2 * c2, 0))) / 2
    a3, b3 = 4 * min_iou, -2 * min_iou * (h + w)
    c3 = (min_iou - 1) * w * h
    r3 = (b3 + np.sqrt(np.maximum(b3**2 - 4 * a3 * c3, 0))) / (2 * a3)
    return np.maximum(np.minimum(np.minimum(r1, r2), r3), 0.0)


def encode_centernet_labels(boxes_xywh: np.ndarray, classes: np.ndarray,
                            num_classes: int, grid: int = 64) -> dict:
    """One image's ground truth (normalized centroid xywh) → its targets.

    Returns ``{"heatmap": (G, G, C) float32, "wh": (M, 2), "offset":
    (M, 2), "indices": (M,) int64 flat cell, "obj_mask": (M,), "boxes":
    (M, 4) normalized corners, "gt_classes": (M,) int32}`` with M =
    ``MAX_OBJECTS``; objects past M are dropped everywhere."""
    heat = np.zeros((grid, grid, num_classes), np.float32)
    wh = np.zeros((MAX_OBJECTS, 2), np.float32)
    offset = np.zeros((MAX_OBJECTS, 2), np.float32)
    indices = np.zeros((MAX_OBJECTS,), np.int64)
    mask = np.zeros((MAX_OBJECTS,), np.float32)
    boxes_list = np.zeros((MAX_OBJECTS, 4), np.float32)
    classes_list = np.zeros((MAX_OBJECTS,), np.int32)
    n = min(len(boxes_xywh), MAX_OBJECTS)
    if n:
        b = np.asarray(boxes_xywh[:n], np.float32)
        cls = np.asarray(classes[:n], np.int64)
        cx, cy = b[:, 0] * grid, b[:, 1] * grid
        gw, gh = b[:, 2] * grid, b[:, 3] * grid
        xi = np.clip(cx.astype(np.int64), 0, grid - 1)
        yi = np.clip(cy.astype(np.int64), 0, grid - 1)
        radius = np.maximum(gaussian_radius(gh, gw).astype(np.int64), 0)
        ys, xs = np.mgrid[0:grid, 0:grid]
        for k in range(n):
            sigma = max((2 * radius[k] + 1) / 6.0, 1e-3)
            g = np.exp(-((xs - xi[k]) ** 2 + (ys - yi[k]) ** 2)
                       / (2 * sigma**2))
            g = np.where((np.abs(xs - xi[k]) <= radius[k]) &
                         (np.abs(ys - yi[k]) <= radius[k]), g, 0.0)
            c = cls[k]
            heat[:, :, c] = np.maximum(heat[:, :, c], g)
            heat[yi[k], xi[k], c] = 1.0
        wh[:n] = np.stack([gw, gh], 1)
        offset[:n] = np.stack([cx - xi, cy - yi], 1)
        indices[:n] = yi * grid + xi
        mask[:n] = 1.0
        boxes_list[:n] = np.concatenate(
            [b[:, :2] - b[:, 2:4] / 2, b[:, :2] + b[:, 2:4] / 2], 1)
        classes_list[:n] = cls
    return {"heatmap": heat, "wh": wh, "offset": offset,
            "indices": indices, "obj_mask": mask,
            "boxes": boxes_list, "gt_classes": classes_list}


def focal_loss(pred_logits: torch.Tensor, gt_heatmap: torch.Tensor,
               alpha: float = 2.0, beta: float = 4.0,
               eps: float = 1e-6) -> torch.Tensor:
    """Penalty-reduced pixelwise focal loss of NHWC logits, (B,): each
    image's sum over cells and classes divided by its positives (at
    least 1)."""
    p = torch.sigmoid(pred_logits)
    pos = (gt_heatmap >= 1.0).to(torch.float32)
    neg_weight = torch.pow(1.0 - gt_heatmap, beta)
    pos_loss = -torch.log(torch.clamp_min(p, eps)) * \
        torch.pow(1 - p, alpha) * pos
    neg_loss = -torch.log(torch.clamp_min(1 - p, eps)) * \
        torch.pow(p, alpha) * neg_weight * (1 - pos)
    num_pos = torch.clamp_min(pos.sum((1, 2, 3)), 1.0)
    return (pos_loss.sum((1, 2, 3)) + neg_loss.sum((1, 2, 3))) / num_pos


def _gather_at(features: torch.Tensor, indices: torch.Tensor
               ) -> torch.Tensor:
    """features (B, G, G, C), indices (B, M) flat cells → (B, M, C)."""
    b, g = features.shape[0], features.shape[1]
    flat = features.reshape(b, g * g, -1)
    return flat.gather(1, indices[..., None].expand(-1, -1, flat.shape[-1]))


class CenterNetTask:
    """The trainer's task bundle: the multi-stack loss, per-image eval
    loss sums, and the final stack's decoded peaks for the host mAP
    evaluator."""

    monitor = "mAP"

    def __init__(self, num_classes: int, wh_weight: float = 0.1,
                 offset_weight: float = 1.0,
                 eval_score_threshold: float = 0.05):
        self.num_classes = num_classes
        self.wh_weight = wh_weight
        self.offset_weight = offset_weight
        self.eval_score_threshold = eval_score_threshold
        # the trainer's data-parallel mesh: the wh and offset losses are
        # normalized by the global batch's object count
        self.mesh = None

    @staticmethod
    def _l1_terms(wh, offset, batch):
        """The masked L1 errors of wh and offset at the objects' cells,
        (B, M, 2) each."""
        mask = batch["obj_mask"][..., None]
        pred_wh = _gather_at(wh, batch["indices"])
        pred_off = _gather_at(offset, batch["indices"])
        return (torch.abs(pred_wh - batch["wh"]) * mask,
                torch.abs(pred_off - batch["offset"]) * mask)

    def loss(self, outputs, batch):
        """(the loss summed over stacks, per-stack components
        ``heat_s``, ``wh_s``, ``off_s``); wh and offset normalized by
        the batch's objects.  Under a mesh of R > 1 ranks the batch is
        the global one: a rank's wh and offset sums are divided by the
        all-reduced object count and multiplied by R, so the ranks' mean
        (what the trainer's all-reduce takes) is the global loss; the
        focal term is a per-image mean and needs nothing."""
        total, comps = 0.0, {}
        n = torch.clamp_min(batch["obj_mask"].sum(), 1.0)
        if self.mesh is not None and self.mesh.reduces:
            # this rank's share of max(global count, 1)
            count = self.mesh.all_reduce_(
                batch["obj_mask"].sum().detach().to(torch.float32))
            n = torch.clamp_min(count, 1.0) / float(self.mesh.data_size)
        for s, (heat, wh, offset) in enumerate(outputs):
            l_heat = focal_loss(heat, batch["heatmap"]).mean()
            e_wh, e_off = self._l1_terms(wh, offset, batch)
            l_wh, l_off = e_wh.sum() / n, e_off.sum() / n
            total = total + l_heat + self.wh_weight * l_wh + \
                self.offset_weight * l_off
            comps.update({f"heat_{s}": l_heat, f"wh_{s}": l_wh,
                          f"off_{s}": l_off})
        return total, comps

    def eval_metrics(self, outputs, batch) -> dict:
        """Weighted per-image loss sums (objects normalized per image);
        ``weight`` 0 marks the padded filler rows of the last eval
        batch."""
        w = batch.get("weight")
        w = torch.ones(batch["heatmap"].shape[0],
                       device=batch["heatmap"].device) if w is None \
            else w.to(torch.float32)
        n_img = torch.clamp_min(batch["obj_mask"].sum(-1), 1.0)
        per_image = 0.0
        for heat, wh, offset in outputs:
            e_wh, e_off = self._l1_terms(wh, offset, batch)
            per_image = per_image + focal_loss(heat, batch["heatmap"]) + \
                self.wh_weight * (e_wh.sum((1, 2)) / n_img) + \
                self.offset_weight * (e_off.sum((1, 2)) / n_img)
        loss_sum = (per_image * w).sum()
        return {"loss": loss_sum, "neg_loss": -loss_sum, "count": w.sum()}

    def eval_outputs(self, outputs, batch) -> dict:
        """The FINAL stack's peaks for the host mAP accumulator, boxes
        normalized to [0, 1] like the encoded ground-truth list."""
        heat, wh, offset = outputs[-1]
        grid = device_scalar(float(heat.shape[1]), heat.device)
        boxes, scores, cls = decode_detections(heat, wh, offset)
        valid = (scores > self.eval_score_threshold).to(torch.float32)
        return {"det_boxes": boxes / grid, "det_scores": scores,
                "det_classes": cls, "det_valid": valid,
                "gt_boxes": batch["boxes"], "gt_mask": batch["obj_mask"],
                "gt_classes": batch["gt_classes"]}

    def make_host_evaluator(self):
        from deep_vision_tpu_torch.tasks.map_eval import (
            DetectionMAPAccumulator,
        )

        return DetectionMAPAccumulator(self.num_classes)


def decode_detections(heat_logits: torch.Tensor, wh: torch.Tensor,
                      offset: torch.Tensor, k: int = 100):
    """3×3 peak suppression + top-K of one stack's NHWC outputs →
    ``(boxes (B, K, 4) xyxy in grid cells, scores (B, K), classes (B, K)
    int64)``."""
    b, g, c = heat_logits.shape[0], heat_logits.shape[1], \
        heat_logits.shape[-1]
    heat = torch.sigmoid(heat_logits)
    peak = F.max_pool2d(heat.permute(0, 3, 1, 2), 3, 1, 1).permute(
        0, 2, 3, 1)
    heat = torch.where(heat == peak, heat, torch.zeros_like(heat))
    scores, idx = topk_stable(heat.reshape(b, -1), k)    # over G·G·C
    cls = idx % c
    cell = idx // c
    ys, xs = cell // g, cell % g
    pwh = _gather_at(wh, cell)
    poff = _gather_at(offset, cell)
    cx = xs + poff[..., 0]
    cy = ys + poff[..., 1]
    boxes = torch.stack([cx - pwh[..., 0] / 2, cy - pwh[..., 1] / 2,
                         cx + pwh[..., 0] / 2, cy + pwh[..., 1] / 2], -1)
    return boxes, scores, cls
