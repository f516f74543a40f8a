"""Pose: Gaussian heatmap targets, the weighted MSE over stacks, the
heatmap decode and PCKh.

Port of ``deep_vision_tpu/tasks/pose.py`` (``make_heatmaps``,
``heatmap_argmax``, ``decode_heatmaps``, ``pckh``, ``PoseTask``):

- the targets are made on the host in numpy, as the reference makes
  them: a Gaussian of σ 1 px scaled by 12 on a 7×7 support at each
  keypoint (rounded half to even), an all-zero channel where the
  keypoint is invisible or its support lies wholly outside the map;
- the loss is the MSE with foreground weight 81 (each target pixel above
  0 weighs 82, the rest 1), a per-image mean summed over the stacks
  (intermediate supervision);
- the decode (the ``/v1/pose`` epilogue) takes each channel's first
  maximum, as ``jnp.argmax`` does and ``torch.argmax`` documents, and
  with ``refine`` moves a quarter pixel toward the larger neighbour on
  each axis, except on the map's border.
"""

from __future__ import annotations

import numpy as np
import torch


def make_heatmaps(keypoints: np.ndarray, height: int = 64, width: int = 64,
                  sigma: int = 1, scale: float = 12.0) -> np.ndarray:
    """(K, 3) [x, y, visibility] in heatmap pixels → (H, W, K) float32."""
    kp = np.asarray(keypoints, np.float32)
    x0 = np.round(kp[:, 0]).astype(np.int64)
    y0 = np.round(kp[:, 1]).astype(np.int64)
    vis = kp[:, 2]
    ys, xs = np.mgrid[0:height, 0:width]
    dx = xs[None] - x0[:, None, None]
    dy = ys[None] - y0[:, None, None]
    g = np.exp(-(dx**2 + dy**2) / (2.0 * sigma**2)) * scale
    g = np.where((np.abs(dx) <= 3 * sigma) & (np.abs(dy) <= 3 * sigma), g,
                 0.0)
    inb = (x0 - 3 * sigma < width) & (y0 - 3 * sigma < height) & \
        (x0 + 3 * sigma >= 0) & (y0 + 3 * sigma >= 0)
    valid = (vis > 0) & inb
    g = g * valid[:, None, None]
    return np.transpose(g, (1, 2, 0)).astype(np.float32)


def heatmap_argmax(heatmaps: np.ndarray) -> np.ndarray:
    """(H, W, K) → (K, 2) [x, y] peak coordinates (host side)."""
    h, w, k = heatmaps.shape
    flat = heatmaps.reshape(-1, k)
    idx = flat.argmax(0)
    return np.stack([idx % w, idx // w], axis=1).astype(np.float32)


def decode_heatmaps(heatmaps: torch.Tensor, refine: bool = True) -> dict:
    """(B, H, W, K) float32 heatmaps → ``{"keypoints": (B, K, 2) [x, y]
    float32, "scores": (B, K) float32}``: each channel's peak (the first
    of equal maxima in row-major order) and its value.  Off ``refine``,
    the integer peak is :func:`heatmap_argmax`'s."""
    b, h, w, k = heatmaps.shape
    flat = heatmaps.reshape(b, h * w, k)
    idx = torch.argmax(flat, dim=1)                      # (B, K)
    scores = flat.amax(dim=1)
    xi, yi = idx % w, idx // w
    x = xi.to(torch.float32)
    y = yi.to(torch.float32)
    if refine:
        def neighbor(dy, dx):
            yy = torch.clamp(yi + dy, 0, h - 1)
            xx = torch.clamp(xi + dx, 0, w - 1)
            return flat.gather(1, (yy * w + xx)[:, None, :])[:, 0, :]

        dx = torch.sign(neighbor(0, 1) - neighbor(0, -1))
        dy = torch.sign(neighbor(1, 0) - neighbor(-1, 0))
        x = x + 0.25 * dx * ((xi > 0) & (xi < w - 1)).to(torch.float32)
        y = y + 0.25 * dy * ((yi > 0) & (yi < h - 1)).to(torch.float32)
    return {"keypoints": torch.stack([x, y], dim=-1), "scores": scores}


def pckh(pred_xy: np.ndarray, true_xy: np.ndarray, visible: np.ndarray,
         head_size: float, alpha: float = 0.5) -> tuple[float, int]:
    """PCKh: (correct, visible) keypoints, correct within
    ``alpha · head_size`` of the truth."""
    d = np.linalg.norm(pred_xy - true_xy, axis=-1)
    ok = (d <= alpha * head_size) & (visible > 0)
    return float(ok.sum()), int((visible > 0).sum())


class PoseTask:
    """The trainer's task bundle: the weighted MSE over stacks and
    per-image eval sums; the plateau scheduler watches ``neg_loss``."""

    monitor = "neg_loss"

    def __init__(self, foreground_weight: float = 81.0):
        self.fg = foreground_weight

    def _stack_loss_per_image(self, outputs, labels) -> torch.Tensor:
        """(B,) summed over the stacks."""
        loss = 0.0
        for out in outputs:
            w = (labels > 0).to(torch.float32) * self.fg + 1.0
            loss = loss + (torch.square(labels - out) * w).mean((1, 2, 3))
        return loss

    def loss(self, outputs, batch):
        """(the batch mean of the per-image loss, ``{"mse_stacks"}``)."""
        if not isinstance(outputs, (tuple, list)):
            outputs = (outputs,)
        loss = self._stack_loss_per_image(outputs, batch["heatmaps"]).mean()
        return loss, {"mse_stacks": loss}

    def eval_metrics(self, outputs, batch) -> dict:
        """Weighted per-image loss sums; ``weight`` 0 marks the padded
        filler rows of the last eval batch."""
        if not isinstance(outputs, (tuple, list)):
            outputs = (outputs,)
        per = self._stack_loss_per_image(outputs, batch["heatmaps"])
        w = batch.get("weight")
        w = torch.ones_like(per) if w is None else w.to(torch.float32)
        return {"loss": (per * w).sum(), "neg_loss": -(per * w).sum(),
                "count": w.sum()}
