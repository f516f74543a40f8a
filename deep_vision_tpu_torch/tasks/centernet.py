"""CenterNet's decode: heatmap peaks → top-K boxes, no box NMS.

Port of ``decode_detections`` and ``_gather_at`` of
``deep_vision_tpu/tasks/centernet.py``.  The loss, the label encoder
(``encode_centernet_labels``, ``gaussian_radius``) and
``CenterNetTask`` belong to the training slice and are not ported.

Peak suppression is the reference's 3×3 ``reduce_window(max, "SAME")``
with −inf padding, which is ``F.max_pool2d(h, 3, 1, 1)``; a cell keeps
its score where it equals the pooled value of the very same tensor.
The top-K takes ``jax.lax.top_k``'s order (``ops/boxes.topk_stable``):
suppression leaves many exact zeros, and equal sigmoid values survive
as several peaks, so ties are common.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from deep_vision_tpu_torch.ops.boxes import topk_stable


def _gather_at(features: torch.Tensor, indices: torch.Tensor
               ) -> torch.Tensor:
    """features (B, G, G, C), indices (B, M) flat cells → (B, M, C)."""
    b, g = features.shape[0], features.shape[1]
    flat = features.reshape(b, g * g, -1)
    return flat.gather(1, indices[..., None].expand(-1, -1, flat.shape[-1]))


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
