"""Box utilities and batched greedy NMS.

Port of ``deep_vision_tpu/ops/boxes.py``: ``xywh_to_corners``,
``broadcast_iou``, ``nms_single`` / ``batched_nms`` with every variant
the reference has: hard or Soft-NMS (``soft="gaussian"``/``"linear"``),
class-agnostic or class-wise (``classes``, by the class-offset trick),
and the per-class cap ``max_per_class``.  NMS is K rounds of argmax →
record → suppress, written over the batch dimension, so every image
runs in the same tensor ops and the output shape is static.  The
argmax takes the first index on a tie, as ``jnp.argmax`` does.

``topk_stable`` is ``jax.lax.top_k``'s order: among equal values the
lower index comes first (``torch.topk`` promises no order on ties).
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


#: class-offset magnitude for class-wise NMS: boxes are normalized to
#: [0, 1] (a few units at most after decode), so shifting each box by
#: ``class_id * 4`` puts different classes on disjoint diagonals — their
#: IoU is exactly 0 — while same-class IoU is unchanged
_CLASS_OFFSET = 4.0
SOFT_MODES = ("off", "gaussian", "linear")


def topk_stable(x: torch.Tensor, k: int):
    """The ``k`` largest of ``x`` along the last dim, descending, the
    lower index first among equal values: ``(values, indices)``."""
    values, indices = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], indices[..., :k]


def _per_class_cap(idx: torch.Tensor, valid: torch.Tensor,
                   classes: torch.Tensor, max_per_class: int):
    """Invalidate selections past the ``max_per_class``-th VALID box of
    each class, in selection (descending-score) order.

    idx/valid: (B, K) the rounds' outputs; classes: (B, N) per-box
    labels.  The rank comes from a (K, K) lower-triangular same-class
    mask: K is small and the shapes stay static."""
    k = idx.shape[1]
    sel_cls = classes.gather(1, idx)
    same = sel_cls[:, :, None] == sel_cls[:, None, :]
    earlier = torch.tril(torch.ones((k, k), dtype=torch.bool,
                                    device=idx.device))
    # 1-based occurrence index among VALID same-class selections
    rank = (same & earlier & (valid > 0.0)[:, None, :]).sum(2)
    return valid * (rank <= max_per_class).to(valid.dtype)


def batched_nms(boxes: torch.Tensor, scores: torch.Tensor, max_outputs: int,
                iou_threshold: float = 0.5, score_threshold: float = 0.0,
                classes: torch.Tensor | None = None, soft: str = "off",
                soft_sigma: float = 0.5, max_per_class: int = 0):
    """Greedy NMS per image: (B, N, 4) corners, (B, N) scores →
    ``(idx, sel_scores, valid)``, each (B, K) for K = ``max_outputs``.

    Each round picks every image's highest live score (the first index
    on a tie) and records it.  ``soft="off"`` then kills it and every
    live box whose IoU with it exceeds ``iou_threshold``; ``"gaussian"``
    multiplies every live score by ``exp(-iou² / soft_sigma)`` and
    ``"linear"`` by ``1 - iou`` where the IoU exceeds the threshold —
    a decayed score under ``score_threshold`` dies, the chosen box
    always leaves the pool, and the recorded scores are the decayed
    ones.  Scores below ``score_threshold`` never enter; a round that
    finds no live box records index 0 (argmax over an all −inf row),
    score 0 and valid 0.

    ``classes`` (B, N) int makes suppression class-wise (boxes shifted
    by ``class * _CLASS_OFFSET`` before the IoU, so other classes'
    IoU is exactly 0); ``max_per_class > 0`` then keeps only each
    class's first ``max_per_class`` valid selections.  Without
    ``classes`` the cap is ignored, as in the reference."""
    if soft not in SOFT_MODES:
        raise ValueError(f"soft must be 'off', 'gaussian' or 'linear', "
                         f"got {soft!r}")
    neg_inf = torch.tensor(float("-inf"), dtype=scores.dtype,
                           device=scores.device)
    live = torch.where(scores >= score_threshold, scores, neg_inf)
    iou_boxes = boxes
    if classes is not None:
        iou_boxes = boxes + (classes.to(boxes.dtype)
                             * _CLASS_OFFSET)[..., None]
    iou = broadcast_iou(iou_boxes, iou_boxes)  # (B, N, N)
    n = scores.shape[1]
    arange = torch.arange(n, device=scores.device)
    idxs, sels, valids = [], [], []
    for _ in range(max_outputs):
        i = live.argmax(dim=1)                                  # (B,)
        best = live.gather(1, i[:, None])[:, 0]
        valid = torch.isfinite(best)
        row = iou.gather(1, i[:, None, None].expand(-1, 1, n))[:, 0]
        chosen = arange[None, :] == i[:, None]
        if soft == "off":
            suppress = (row > iou_threshold) | chosen
            live = torch.where(valid[:, None] & suppress, neg_inf, live)
        else:
            if soft == "gaussian":
                decay = torch.exp(-(row * row) / soft_sigma)
            else:
                decay = torch.where(row > iou_threshold, 1.0 - row,
                                    torch.ones_like(row))
            decayed = live * decay
            # decayed scores under the floor die; the chosen box always
            # leaves the pool
            decayed = torch.where(decayed >= score_threshold, decayed,
                                  neg_inf)
            decayed = torch.where(chosen, neg_inf, decayed)
            live = torch.where(valid[:, None], decayed, live)
        idxs.append(i)
        sels.append(torch.where(valid, best, torch.zeros_like(best)))
        valids.append(valid.to(torch.float32))
    idx = torch.stack(idxs, 1)
    sel = torch.stack(sels, 1)
    valid = torch.stack(valids, 1)
    if max_per_class and max_per_class > 0 and classes is not None:
        valid = _per_class_cap(idx, valid, classes, int(max_per_class))
        sel = sel * valid
    return idx, sel, valid


def nms_single(boxes: torch.Tensor, scores: torch.Tensor, max_outputs: int,
               iou_threshold: float = 0.5, score_threshold: float = 0.0,
               classes: torch.Tensor | None = None, soft: str = "off",
               soft_sigma: float = 0.5, max_per_class: int = 0):
    """:func:`batched_nms` for one image: (N, 4), (N,) → three (K,)."""
    idx, sel, valid = batched_nms(
        boxes[None], scores[None], max_outputs, iou_threshold,
        score_threshold, None if classes is None else classes[None],
        soft, soft_sigma, max_per_class)
    return idx[0], sel[0], valid[0]
