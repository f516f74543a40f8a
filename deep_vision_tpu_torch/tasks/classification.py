"""Classification task: softmax cross-entropy + top-k accuracy.

Port of ``deep_vision_tpu/tasks/classification.py``: mean softmax
cross-entropy on float32 logits, with label smoothing as
``optax.smooth_labels`` (``(1−α)·onehot + α/K``), and the weighted metric
sums eval accumulates.  A tuple of outputs is the main head and aux heads
(Inception's training forward): the loss adds ``aux_weight`` (0.3, the
GoogLeNet discount) × each aux head's cross-entropy, and top-1 and every
eval metric read the main head only.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def main_head(outputs):
    """The main logits of a model's output (the first of a tuple)."""
    return outputs[0] if isinstance(outputs, (tuple, list)) else outputs


class ClassificationTask:
    monitor = "top1"

    def __init__(self, num_classes: int, label_smoothing: float = 0.0,
                 aux_weight: float = 0.3):
        self.num_classes = num_classes
        self.label_smoothing = label_smoothing
        self.aux_weight = aux_weight

    def _xent(self, logits: torch.Tensor, labels: torch.Tensor):
        return F.cross_entropy(logits.to(torch.float32), labels,
                               label_smoothing=self.label_smoothing)

    def loss(self, outputs, batch: dict):
        """(mean loss, {"top1": batch accuracy}), both 0-d device tensors."""
        labels = batch["label"].long()
        logits = main_head(outputs).to(torch.float32)
        loss = self._xent(logits, labels)
        if isinstance(outputs, (tuple, list)):
            for aux in outputs[1:]:
                loss = loss + self.aux_weight * self._xent(aux, labels)
        top1 = (logits.argmax(-1) == labels).to(torch.float32).mean()
        return loss, {"top1": top1}

    def eval_metrics(self, outputs, batch: dict) -> dict:
        """Weighted sums of loss, top1, top5 and count; ``weight`` 0 marks
        the padded filler rows of the last eval batch."""
        logits = main_head(outputs).to(torch.float32)
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
