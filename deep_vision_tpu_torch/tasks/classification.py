"""Classification task: softmax cross-entropy + top-k accuracy.

Port of ``deep_vision_tpu/tasks/classification.py`` for single-head
classifiers: mean softmax cross-entropy on float32 logits, with label
smoothing as ``optax.smooth_labels`` (``(1−α)·onehot + α/K``), and the
weighted metric sums eval accumulates.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


class ClassificationTask:
    monitor = "top1"

    def __init__(self, num_classes: int, label_smoothing: float = 0.0):
        self.num_classes = num_classes
        self.label_smoothing = label_smoothing

    def loss(self, outputs: torch.Tensor, batch: dict):
        """(mean loss, {"top1": batch accuracy}), both 0-d device tensors."""
        labels = batch["label"].long()
        logits = outputs.to(torch.float32)
        loss = F.cross_entropy(logits, labels,
                               label_smoothing=self.label_smoothing)
        top1 = (logits.argmax(-1) == labels).to(torch.float32).mean()
        return loss, {"top1": top1}

    def eval_metrics(self, outputs: torch.Tensor, batch: dict) -> dict:
        """Weighted sums of loss, top1, top5 and count; ``weight`` 0 marks
        the padded filler rows of the last eval batch."""
        logits = outputs.to(torch.float32)
        labels = batch["label"].long()
        w = batch.get("weight")
        w = torch.ones(labels.shape[0], device=logits.device) \
            if w is None else w.to(torch.float32)
        xent = F.cross_entropy(logits, labels, reduction="none")
        top1 = ((logits.argmax(-1) == labels) * w).sum()
        k = min(5, logits.shape[-1])
        topk = logits.topk(k, dim=-1).indices
        top5 = ((topk == labels[:, None]).any(-1) * w).sum()
        return {"loss": (xent * w).sum(), "top1": top1, "top5": top5,
                "count": w.sum()}
