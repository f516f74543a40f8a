"""mAP evaluation on the host, in numpy.

Copy of ``deep_vision_tpu/tasks/map_eval.py``: VOC-style AP (the VOC2007
11-point and the continuous area-under-PR interpolations, VOC-devkit
matching) at one IoU threshold, plus the COCO-standard mAP@[.5:.95]
(continuous AP averaged over IoU 0.50:0.95:0.05, COCO matching), and
``DetectionMAPAccumulator``, the trainer's host evaluator for detection.
"""

from __future__ import annotations

import numpy as np


def _iou_matrix(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """(N,4)×(M,4) corner boxes → (N,M) IoU."""
    lo = np.maximum(a[:, None, :2], b[None, :, :2])
    hi = np.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = np.maximum(hi - lo, 0.0)
    inter = wh[..., 0] * wh[..., 1]
    area_a = np.maximum(a[:, 2] - a[:, 0], 0) * np.maximum(a[:, 3] - a[:, 1], 0)
    area_b = np.maximum(b[:, 2] - b[:, 0], 0) * np.maximum(b[:, 3] - b[:, 1], 0)
    return inter / np.maximum(area_a[:, None] + area_b[None, :] - inter, 1e-9)


def average_precision(recall: np.ndarray, precision: np.ndarray,
                      use_07_metric: bool = False) -> float:
    if use_07_metric:
        ap = 0.0
        for t in np.arange(0.0, 1.01, 0.1):
            p = precision[recall >= t].max() if (recall >= t).any() else 0.0
            ap += p / 11.0
        return float(ap)
    # continuous: envelope + area under PR
    mrec = np.concatenate([[0.0], recall, [1.0]])
    mpre = np.concatenate([[0.0], precision, [0.0]])
    for i in range(len(mpre) - 2, -1, -1):
        mpre[i] = max(mpre[i], mpre[i + 1])
    idx = np.where(mrec[1:] != mrec[:-1])[0]
    return float(((mrec[idx + 1] - mrec[idx]) * mpre[idx + 1]).sum())


class MeanAPEvaluator:
    """Accumulate per-image detections + ground truth, then compute mAP.

    ``add(dets, gts)`` per image:
      dets: (boxes (K,4), scores (K,), classes (K,)) — corner coords
      gts:  (boxes (M,4), classes (M,))
    """

    def __init__(self, num_classes: int, iou_threshold: float = 0.5,
                 use_07_metric: bool = False):
        self.num_classes = num_classes
        self.iou_threshold = iou_threshold
        self.use_07 = use_07_metric
        self._dets: list[list] = [[] for _ in range(num_classes)]
        self._n_gt = np.zeros(num_classes, np.int64)
        self._img = 0

    def add(self, det_boxes, det_scores, det_classes, gt_boxes, gt_classes):
        img = self._img
        self._img += 1
        gt_boxes = np.asarray(gt_boxes, np.float32).reshape(-1, 4)
        gt_classes = np.asarray(gt_classes, np.int64).reshape(-1)
        for c in np.unique(gt_classes):
            self._n_gt[c] += int((gt_classes == c).sum())
        for b, s, c in zip(np.asarray(det_boxes).reshape(-1, 4),
                           np.asarray(det_scores).reshape(-1),
                           np.asarray(det_classes, np.int64).reshape(-1)):
            self._dets[c].append(
                (float(s), b, img,
                 gt_boxes[gt_classes == c]))

    # IoU grid for the COCO-standard average: 0.50, 0.55, ..., 0.95.
    # Invariant: a detection whose IoU lands EXACTLY on a grid value
    # (e.g. 80/100 overlap vs threshold 0.80) must count as matched at
    # that threshold.  ``np.arange(...).round(2)`` happens to produce
    # the same nearest-doubles as the IoU arithmetic today, but that is
    # representation luck, not a guarantee — so ``_class_ap`` compares
    # against ``threshold - IOU_EPS`` to make boundary inclusion
    # explicit and robust to any future grid construction.
    COCO_IOUS = tuple(np.arange(0.50, 0.96, 0.05).round(2))
    IOU_EPS = 1e-9

    def _class_entries(self, c: int) -> list:
        """Score-sorted detections with their per-gt IoU vectors AND the
        IoU-descending gt order computed ONCE — scores, IoUs, and sort
        order are threshold-independent, so the per-threshold passes
        below only redo the (cheap) matching/cumsum."""
        dets = sorted(self._dets[c], key=lambda d: -d[0])
        out = []
        for (_s, box, img, gts) in dets:
            if len(gts):
                ious = _iou_matrix(box[None], gts)[0]
                out.append((img, ious, np.argsort(-ious)))
            else:
                out.append((img, None, None))
        return out

    def _class_ap(self, entries: list, n_gt: int, iou_threshold: float,
                  coco_matching: bool) -> float:
        """AP for one class at one IoU threshold.

        Matching rule differs by metric family (and it matters on crowded
        scenes): the VOC devkit assigns each detection (score-descending)
        to its ARGMAX-IoU gt and counts FP if that gt is already matched;
        COCO lets the detection fall through to the highest-IoU UNMATCHED
        gt above threshold."""
        if not entries:
            return 0.0
        # boundary-exact IoUs count as matched (see IOU_EPS invariant)
        thr = iou_threshold - self.IOU_EPS
        matched: dict[int, set] = {}
        tp = np.zeros(len(entries))
        fp = np.zeros(len(entries))
        for i, (img, ious, order) in enumerate(entries):
            if ious is None:
                fp[i] = 1
                continue
            taken = matched.setdefault(img, set())
            j = -1
            if coco_matching:
                for cand in order:
                    if ious[cand] < thr:
                        break
                    if int(cand) not in taken:
                        j = int(cand)
                        break
            else:
                jmax = int(np.argmax(ious))
                if ious[jmax] >= thr and jmax not in taken:
                    j = jmax
            if j >= 0:
                tp[i] = 1
                taken.add(j)
            else:
                fp[i] = 1
        ctp, cfp = np.cumsum(tp), np.cumsum(fp)
        recall = ctp / n_gt
        precision = ctp / np.maximum(ctp + cfp, 1e-9)
        # the 11-point interpolation is a VOC2007 compatibility mode; the
        # COCO grid always uses continuous AP regardless of use_07
        use_07 = self.use_07 and not coco_matching
        return average_precision(recall, precision, use_07)

    def compute(self) -> dict:
        """``mAP`` at the primary threshold (default 0.5) with the VOC-
        devkit matching rule — comparable to published VOC numbers;
        ``mAP50_95`` averaged over the COCO IoU grid with COCO matching
        (continuous-AP interpolation, within ~1e-2 of COCO's 101-point)."""
        aps = {}
        coco = {}
        for c in range(self.num_classes):
            if self._n_gt[c] == 0:
                continue
            entries = self._class_entries(c)
            n = int(self._n_gt[c])
            aps[c] = self._class_ap(entries, n, self.iou_threshold,
                                    coco_matching=False)
            coco[c] = float(np.mean(
                [self._class_ap(entries, n, t, coco_matching=True)
                 for t in self.COCO_IOUS]))
        mean_ap = float(np.mean(list(aps.values()))) if aps else 0.0
        map50_95 = float(np.mean(list(coco.values()))) if coco else 0.0
        return {"mAP": mean_ap, "mAP50_95": map50_95, "per_class": aps}


class DetectionMAPAccumulator:
    """Trainer host-evaluator: consumes ``task.eval_outputs`` batches
    (device-side decode+NMS results + padded gt lists) and reduces to
    scalar metrics merged into the validation dict."""

    def __init__(self, num_classes: int, iou_threshold: float = 0.5,
                 use_07_metric: bool = False):
        self.ev = MeanAPEvaluator(num_classes, iou_threshold, use_07_metric)

    def add_batch(self, outs: dict):
        det_boxes = np.asarray(outs["det_boxes"])
        det_scores = np.asarray(outs["det_scores"])
        det_classes = np.asarray(outs["det_classes"])
        det_valid = np.asarray(outs["det_valid"])
        gt_boxes = np.asarray(outs["gt_boxes"])
        gt_mask = np.asarray(outs["gt_mask"])
        gt_classes = np.asarray(outs["gt_classes"])
        # weight-0 rows are eval padding (pad_last batches): skip whole image
        img_w = np.asarray(outs.get("weight", np.ones(len(det_boxes))))
        for i in range(len(det_boxes)):
            if img_w[i] <= 0:
                continue
            v = det_valid[i] > 0
            m = gt_mask[i] > 0
            self.ev.add(det_boxes[i][v], det_scores[i][v], det_classes[i][v],
                        gt_boxes[i][m], gt_classes[i][m])

    def compute(self) -> dict:
        res = self.ev.compute()
        return {"mAP": res["mAP"], "mAP50_95": res["mAP50_95"]}
