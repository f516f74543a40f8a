"""Box utilities and batched greedy NMS.

Port of ``deep_vision_tpu/ops/boxes.py``: ``xywh_to_corners``,
``broadcast_iou`` and the hard, class-agnostic NMS that evaluation uses
(``nms_single`` / ``batched_nms`` with ``soft="off"``, ``classes=None``).
NMS is K rounds of argmax → record → suppress, written over the batch
dimension, so every image runs in the same tensor ops and the output
shape is static.  Class-aware NMS, Soft-NMS and ``max_per_class`` belong
to the detect-serving epilogue and are not ported.
"""

from __future__ import annotations

import torch


def xywh_to_corners(box: torch.Tensor) -> torch.Tensor:
    """(cx, cy, w, h) → (x1, y1, x2, y2), any leading dims."""
    xy, wh = box[..., :2], box[..., 2:4]
    return torch.cat([xy - wh / 2.0, xy + wh / 2.0], dim=-1)


def broadcast_iou(box_a: torch.Tensor, box_b: torch.Tensor,
                  eps: float = 1e-9) -> torch.Tensor:
    """IoU of every a-box against every b-box.

    box_a: (..., N, 4) corners; box_b: (..., M, 4) corners → (..., N, M).
    The denominator is ``((area_a + area_b) − inter) + eps``."""
    a = box_a[..., :, None, :]
    b = box_b[..., None, :, :]
    inter_lo = torch.maximum(a[..., :2], b[..., :2])
    inter_hi = torch.minimum(a[..., 2:], b[..., 2:])
    inter_wh = torch.clamp_min(inter_hi - inter_lo, 0.0)
    inter = inter_wh[..., 0] * inter_wh[..., 1]
    area_a = torch.clamp_min(box_a[..., 2] - box_a[..., 0], 0.0) * \
        torch.clamp_min(box_a[..., 3] - box_a[..., 1], 0.0)
    area_b = torch.clamp_min(box_b[..., 2] - box_b[..., 0], 0.0) * \
        torch.clamp_min(box_b[..., 3] - box_b[..., 1], 0.0)
    union = area_a[..., :, None] + area_b[..., None, :] - inter
    return inter / (union + eps)


def batched_nms(boxes: torch.Tensor, scores: torch.Tensor, max_outputs: int,
                iou_threshold: float = 0.5, score_threshold: float = 0.0):
    """Greedy hard NMS per image: (B, N, 4) corners, (B, N) scores →
    ``(idx, sel_scores, valid)``, each (B, K) for K = ``max_outputs``.

    Each round picks every image's highest live score (the first index
    on a tie), records it and kills it and every live box whose IoU with
    it exceeds ``iou_threshold``.  Scores below ``score_threshold`` never
    enter; a round that finds no live box records index 0 (argmax over
    an all −inf row), score 0 and valid 0."""
    neg_inf = torch.tensor(float("-inf"), dtype=scores.dtype,
                           device=scores.device)
    live = torch.where(scores >= score_threshold, scores, neg_inf)
    iou = broadcast_iou(boxes, boxes)  # (B, N, N)
    n = scores.shape[1]
    arange = torch.arange(n, device=scores.device)
    idxs, sels, valids = [], [], []
    for _ in range(max_outputs):
        i = live.argmax(dim=1)                                  # (B,)
        best = live.gather(1, i[:, None])[:, 0]
        valid = torch.isfinite(best)
        row = iou.gather(1, i[:, None, None].expand(-1, 1, n))[:, 0]
        suppress = (row > iou_threshold) | (arange[None, :] == i[:, None])
        live = torch.where(valid[:, None] & suppress, neg_inf, live)
        idxs.append(i)
        sels.append(torch.where(valid, best, torch.zeros_like(best)))
        valids.append(valid.to(torch.float32))
    return (torch.stack(idxs, 1), torch.stack(sels, 1),
            torch.stack(valids, 1))


def nms_single(boxes: torch.Tensor, scores: torch.Tensor, max_outputs: int,
               iou_threshold: float = 0.5, score_threshold: float = 0.0):
    """:func:`batched_nms` for one image: (N, 4), (N,) → three (K,)."""
    idx, sel, valid = batched_nms(boxes[None], scores[None], max_outputs,
                                  iou_threshold, score_threshold)
    return idx[0], sel[0], valid[0]
