"""Workload adapters: what the serving tier knows per model kind.

Port of ``deep_vision_tpu/serve/workloads.py``: the ``SLO`` service
class, the ``Workload`` base, ``ClassifyWorkload`` (dense-logits rows →
``{"model", "top": [{class, prob, logit}]}``), ``DetectWorkload`` (both
detection families behind ``/v1/detect``, decoded on the device by an
epilogue fused after the forward), ``PoseWorkload`` (the stacked
hourglass behind ``/v1/pose``, its last stack's heatmaps decoded to
keypoints on the device) and ``GenerateWorkload`` (the GAN generators
behind ``/v1/generate``: a latent or a seed in for DCGAN, an image in
for CycleGAN, uint8 pixels out).  Each verb also owns its shadow
``agree`` rule (the control plane's shadow phase, serve/models.py) and
its response-cache size guard (``cacheable``), and the cascade's
verbs their ``CascadeWorkloadRule`` (``cascade_rule``): classify reads
the front tier's fused softmax + top-K epilogue, detect its
device-decoded rows (serve/cascade.py).  ``decode_manifest_item`` is
the batch tier's per-item codec (serve/batch_sched.py).
"""

from __future__ import annotations

import numpy as np


class SLO:
    """A workload's service class: the default per-request deadline and
    the per-model admission queue bound."""

    def __init__(self, name: str, deadline_ms: float, max_queue: int):
        self.name = name
        self.deadline_ms = float(deadline_ms)
        self.max_queue = int(max_queue)

    def bound_queue(self, requested: int) -> int:
        """The operator's ``--max-queue`` capped by this class."""
        return min(int(requested), self.max_queue)


class Workload:
    """Base adapter; stateless, one shared instance per verb."""

    verb = ""
    slo = SLO("interactive", deadline_ms=30_000.0, max_queue=256)
    #: the largest serialized 200 answer the response cache takes
    cacheable_bytes = 256 * 1024

    def serving_input_shape(self, cfg, model=None) -> tuple:
        """One request's input shape (``core/restore.py``)."""
        from deep_vision_tpu_torch.core.restore import serving_input_shape

        return serving_input_shape(cfg, model)

    def wire_dtype_for(self, cfg, requested: str) -> str:
        """The input wire a model of ``cfg`` takes: the requested one."""
        return requested

    def output_wire(self, cfg) -> str | None:
        """The dtype the epilogue hands the D2H copy, when it is not the
        forward's float32 (None)."""
        return None

    def decode(self, body: dict, model):
        """The workload's own request decode (one input in the wire
        dtype), or None for the generic ``pixels`` decode.  A bad body
        raises ``ValueError`` (answered 400)."""
        return None

    def make_epilogue(self, model):
        """A transform of the forward's float32 outputs run on the
        device inside each bucket callable, or None."""
        return None

    def decode_manifest_item(self, item: dict, model):
        """One batch-job manifest entry (serve/jobs.py) → one input in
        the wire dtype: the workload's own ``decode`` first (generate
        takes ``latent``/``seed`` entries), else the generic
        ``pixels``/``image_b64`` decode of an interactive body, so a
        manifest is a list of request bodies.  A malformed entry raises
        ``ValueError`` (the scheduler records it as that item's error
        row; one bad entry never fails its shard)."""
        if not isinstance(item, dict):
            raise ValueError(f"manifest entry must be an object, got "
                             f"{type(item).__name__}")
        x = self.decode(item, model)
        if x is not None:
            return x
        # imported here: serve/http.py imports this module
        from deep_vision_tpu_torch.serve.http import ServeError, decode_pixels

        try:
            return decode_pixels(item, model)
        except ServeError as e:
            raise ValueError(str(e)) from e

    def respond(self, model, body: dict, row) -> dict:
        raise NotImplementedError

    def cacheable(self, nbytes: int) -> bool:
        """Whether a serialized 200 of ``nbytes`` may enter the response
        cache: the per-workload size guard."""
        return int(nbytes) <= self.cacheable_bytes

    def agree(self, primary_row, shadow_row):
        """Shadow agreement verdict: True/False, or None when the rows
        are not comparable (counted as discarded)."""
        return None

    def cascade_rule(self):
        """This verb's :class:`CascadeWorkloadRule`, or None when the
        verb cannot cascade (pose and generate: no escalation signal on
        their rows).  The router resolves it from the big tier."""
        return None


class CascadeWorkloadRule:
    """How one verb's rows drive the cascade (serve/cascade.py).

    ``signal(row)`` is the escalation signal of a cheap tier's row:
    ``(class, confidence)``, confidence in [0, 1] (the hop's histogram
    bucket and threshold comparison), class keying the optional
    per-class thresholds (None: pooled only).  ``(None, None)`` means
    the row carries no signal (a Shed, a dense host row): the router
    escalates.  ``agree(tier_row, big_row)`` scores one dual-run
    calibration sample: True/False, or None when not comparable
    (discarded).  Stateless, like the adapters."""

    def signal(self, row) -> tuple:
        raise NotImplementedError

    def agree(self, tier_row, big_row):
        raise NotImplementedError


class ClassifyWorkload(Workload):
    verb = "classify"
    slo = SLO("interactive", deadline_ms=30_000.0, max_queue=256)

    def make_epilogue(self, model):
        """The cascade front tiers' confidence reduction, fused into the
        bucket callable on the device: float32 softmax, then the top-K
        probabilities (the lower class first among equal ones, as
        ``jax.lax.top_k``: ``ops/boxes.topk_stable``), their classes and
        their logits, so the D2H copy moves 3·K scalars an image instead
        of the dense logits.  Gated on the model's ``cascade_topk`` (set
        by cli.serve on the non-final tiers, copied across reloads), so
        the big tier keeps its dense rows and an escalated answer is a
        big-only answer."""
        k = int(getattr(model, "cascade_topk", 0) or 0)
        if k <= 0:
            return None
        import torch

        from deep_vision_tpu_torch.ops.boxes import topk_stable

        def post(out):
            logits = out.to(torch.float32)
            probs = torch.softmax(logits, dim=-1)
            top_p, top_i = topk_stable(probs, min(k, logits.shape[-1]))
            return {"topk_class": top_i.to(torch.int32),
                    "topk_prob": top_p,
                    "topk_logit": torch.gather(logits, -1, top_i)}

        return post

    @staticmethod
    def top1(row):
        """``(class, prob)`` of a classify row, dense logits OR the
        confidence epilogue's dict, or ``(None, None)`` for a row with
        no top-1 (a Shed or Quarantined, a foreign shape).  The cascade
        router and ``agree`` both read rows through it, so the two
        shapes always compare."""
        if isinstance(row, dict):
            try:
                cls = np.asarray(row["topk_class"]).reshape(-1)
                prob = np.asarray(row["topk_prob"]).reshape(-1)
            except (KeyError, TypeError, ValueError):
                return None, None
            if cls.size == 0 or prob.size == 0:
                return None, None
            return int(cls[0]), float(prob[0])
        if isinstance(row, np.ndarray) and row.ndim >= 1 and row.size:
            logits = row.astype(np.float64)
            z = np.exp(logits - logits.max())
            c = int(np.argmax(logits))
            return c, float(z[c] / z.sum())
        return None, None

    def respond(self, model, body: dict, row) -> dict:
        if isinstance(row, dict):
            # a confidence-epilogue row: the top K already on the device
            cls = np.asarray(row["topk_class"]).reshape(-1)
            prob = np.asarray(row["topk_prob"]).reshape(-1)
            logit = np.asarray(row["topk_logit"]).reshape(-1)
            k = min(int(body.get("top_k", 5)), cls.shape[0])
            return {"model": model.name,
                    "top": [{"class": int(cls[j]), "prob": float(prob[j]),
                             "logit": float(logit[j])} for j in range(k)]}
        logits = np.asarray(row)
        k = min(int(body.get("top_k", 5)), logits.shape[-1])
        top = np.argsort(logits)[-k:][::-1]
        z = np.exp(logits - logits.max())
        probs = z / z.sum()
        return {"model": model.name,
                "top": [{"class": int(c), "prob": float(probs[c]),
                         "logit": float(logits[c])} for c in top]}

    def agree(self, primary_row, shadow_row):
        """Top-1 equality; None when either row has no top-1."""
        p, _ = self.top1(primary_row)
        s, _ = self.top1(shadow_row)
        if p is None or s is None:
            return None
        return p == s

    def cascade_rule(self):
        return _ClassifyCascadeRule()


class DetectWorkload(Workload):
    """YOLOv3 (three-scale heads) and CenterNet (heatmap peaks) behind
    one verb.  By default the decode runs on the device, fused after
    the forward (:meth:`make_epilogue`): YOLO decodes every scale, takes
    the pre-NMS top-512 and runs class-wise NMS; CenterNet suppresses
    non-peaks and takes the top K.  Either way a batch leaves the device
    as ``{boxes (B, K, 4) float32, scores (B, K) float32, classes (B, K)
    int32, valid (B, K) float32}``, K·28 bytes an image.
    ``detect_decode="host"`` keeps the dense outputs on the wire and
    runs the same math per request in :meth:`respond` (the A/B
    baseline), so both paths answer identically."""

    verb = "detect"
    slo = SLO("interactive", deadline_ms=30_000.0, max_queue=256)
    #: shadow agreement (the mAP proxy): greedy same-class pairing at
    #: IoU ≥ ``iou_match`` over the valid rows of both sides; agreement
    #: is matched / max(n_primary, n_shadow) and must reach
    #: ``min_match_frac``
    iou_match = 0.5
    min_match_frac = 0.6
    #: the response threshold when the client sends none
    default_score_threshold = 0.3

    @staticmethod
    def knobs(model) -> tuple:
        """The model's decode knobs ``(top_k, score floor, iou
        threshold)`` (``ServingModel``'s ``detect_*``; a top-k of 0
        means the default 100, as in the reference)."""
        return (int(model.detect_topk) or 100,
                float(model.detect_score_threshold),
                float(model.detect_iou_threshold))

    @staticmethod
    def nms_knobs(model) -> tuple:
        """The suppression knobs ``(soft_nms, soft_sigma,
        max_per_class)``."""
        return (str(model.detect_soft_nms), float(model.detect_soft_sigma),
                int(model.detect_max_per_class))

    def _decode(self, model, out) -> dict:
        """A batch of head outputs (float32, on any device) → the
        K-row dict, by the model's family."""
        import torch

        k, floor, iou = self.knobs(model)
        if model.task == "centernet":
            from deep_vision_tpu_torch.ops.ingest import device_scalar
            from deep_vision_tpu_torch.tasks.centernet import (
                decode_detections,
            )

            # one (heat, wh, offset) per stack: serve the last, most
            # refined one
            heat, wh, offset = out[-1]
            grid = device_scalar(float(heat.shape[1]), heat.device)
            boxes, scores, cls = decode_detections(heat, wh, offset, k=k)
            return {"boxes": boxes / grid, "scores": scores,
                    "classes": cls.to(torch.int32),
                    "valid": (scores >= floor).to(torch.float32)}
        from deep_vision_tpu_torch.tasks.detection import postprocess

        soft, sigma, per_cls_k = self.nms_knobs(model)
        boxes, scores, classes, valid = postprocess(
            out, int(model.num_classes), max_outputs=k, iou_threshold=iou,
            score_threshold=floor, class_aware=True, soft_nms=soft,
            soft_sigma=sigma, max_per_class=per_cls_k)
        return {"boxes": boxes, "scores": scores,
                "classes": classes.to(torch.int32), "valid": valid}

    def make_epilogue(self, model):
        """The decode fused into the bucket callables; None when
        ``detect_decode`` is "host".  The compiled score threshold is a
        FLOOR: greedy NMS selects in descending score order and a lower
        score never suppresses a higher one, so NMS at the floor and a
        trim at a higher request threshold in :meth:`respond` keep what
        NMS at that threshold would."""
        if model.detect_decode != "device":
            return None

        def post(out):
            return self._decode(model, out)

        return post

    def _decoded(self, model, row) -> dict:
        """One image's K-row dict whatever the row: a device-decoded
        dict passes through; a dense row (``detect_decode="host"``) goes
        back to the model's device with a batch dimension of 1 and
        through the same math with the same knobs."""
        if isinstance(row, dict):
            return row
        import torch

        from deep_vision_tpu_torch.serve.engine import map_leaves

        with torch.inference_mode():
            dec = self._decode(model, map_leaves(
                lambda a: torch.from_numpy(np.asarray(a)[None]).to(
                    model.device), row))
        return {key: v[0].cpu().numpy() for key, v in dec.items()}

    def respond(self, model, body: dict, row) -> dict:
        dec = self._decoded(model, row)
        boxes = np.asarray(dec["boxes"])
        scores = np.asarray(dec["scores"]).reshape(-1)
        classes = np.asarray(dec["classes"]).reshape(-1)
        valid = np.asarray(dec["valid"]).reshape(-1)
        _, floor, _ = self.knobs(model)
        # the compiled floor bounds the request threshold from below:
        # boxes under it never survived NMS
        thr = max(float(body.get("score_threshold",
                                 self.default_score_threshold)), floor)
        keep = np.nonzero((valid > 0) & (scores >= thr))[0]
        return {"model": model.name, "num_detections": int(len(keep)),
                "detections": [
                    {"box": boxes[j].round(4).tolist(),
                     "score": float(scores[j]),
                     "class": int(classes[j])} for j in keep]}

    @staticmethod
    def _agree_rows(row):
        """(valid boxes, valid classes) of a device-decoded row, or None
        when the row is not one (a Shed or Quarantined, a dense
        host-decode row, a foreign shape)."""
        if not isinstance(row, dict):
            return None
        try:
            b = np.asarray(row["boxes"], np.float32)
            s = np.asarray(row["scores"], np.float32).reshape(-1)
            c = np.asarray(row["classes"]).reshape(-1).astype(np.int64)
            v = np.asarray(row["valid"], np.float32).reshape(-1)
        except (KeyError, TypeError, ValueError):
            return None
        if b.ndim != 2 or b.shape[-1] != 4 or b.shape[0] != v.shape[0] \
                or s.shape[0] != v.shape[0] or c.shape[0] != v.shape[0]:
            return None
        keep = v > 0
        return b[keep], c[keep]

    def agree(self, primary_row, shadow_row):
        """Greedy IoU ≥ 0.5 class-matched pairing in primary score order
        (rows arrive score-sorted), then the matched fraction over
        max(n_primary, n_shadow) against ``min_match_frac``.  Both empty
        agree; rows that are not device-decoded are not comparable."""
        p = self._agree_rows(primary_row)
        s = self._agree_rows(shadow_row)
        if p is None or s is None:
            return None
        pb, pc = p
        sb, sc = s
        n_p, n_s = len(pb), len(sb)
        if n_p == 0 and n_s == 0:
            return True
        if n_p == 0 or n_s == 0:
            return False
        taken = np.zeros(n_s, bool)
        matched = 0
        for i in range(n_p):
            cand = np.nonzero(~taken & (sc == pc[i]))[0]
            if not len(cand):
                continue
            lo = np.maximum(pb[i, :2], sb[cand, :2])
            hi = np.minimum(pb[i, 2:], sb[cand, 2:])
            wh = np.maximum(hi - lo, 0.0)
            inter = wh[:, 0] * wh[:, 1]
            area_p = max(float((pb[i, 2] - pb[i, 0])
                               * (pb[i, 3] - pb[i, 1])), 0.0)
            area_s = np.maximum(sb[cand, 2] - sb[cand, 0], 0.0) * \
                np.maximum(sb[cand, 3] - sb[cand, 1], 0.0)
            iou = inter / np.maximum(area_p + area_s - inter, 1e-9)
            j = int(np.argmax(iou))
            if iou[j] >= self.iou_match:
                taken[cand[j]] = True
                matched += 1
        return matched / max(n_p, n_s) >= self.min_match_frac

    def cascade_rule(self):
        return _DetectCascadeRule(self)


class _ClassifyCascadeRule(CascadeWorkloadRule):
    """Classify cascades on the top-1: confidence is the row's
    ``topk_prob[0]`` (the softmax of dense logits for a row without the
    epilogue), class its ``topk_class[0]``; a dual-run sample agrees
    when the two tiers' top-1 classes match."""

    def signal(self, row) -> tuple:
        return ClassifyWorkload.top1(row)

    def agree(self, tier_row, big_row):
        t, _ = ClassifyWorkload.top1(tier_row)
        b, _ = ClassifyWorkload.top1(big_row)
        if t is None or b is None:
            return None
        return t == b


class _DetectCascadeRule(CascadeWorkloadRule):
    """Detect cascades on the device-decoded row: an answer with no
    valid box signals confidence 0.0 (an empty scene escalates unless
    the sample shows the cheap tier agrees on such scenes), otherwise
    its best valid box's score, that box's class keying the per-class
    axis.  Agreement is ``DetectWorkload.agree`` (the greedy-IoU mAP
    proxy).  A dense host row carries no signal: escalate."""

    def __init__(self, workload):
        self._workload = workload

    def signal(self, row) -> tuple:
        if not isinstance(row, dict):
            return None, None
        try:
            s = np.asarray(row["scores"], np.float32).reshape(-1)
            c = np.asarray(row["classes"]).reshape(-1)
            v = np.asarray(row["valid"], np.float32).reshape(-1)
        except (KeyError, TypeError, ValueError):
            return None, None
        if s.shape[0] != v.shape[0] or c.shape[0] != v.shape[0]:
            return None, None
        keep = v > 0
        if not keep.any():
            return None, 0.0
        s, c = s[keep], c[keep]
        j = int(np.argmax(s))
        return int(c[j]), float(min(max(s[j], 0.0), 1.0))

    def agree(self, tier_row, big_row):
        return self._workload.agree(tier_row, big_row)


class PoseWorkload(Workload):
    """Keypoints of one person an image.  The epilogue decodes the last
    (most refined) stack's heatmaps on the device
    (``tasks/pose.decode_heatmaps``, quarter-pixel refined), so a batch
    leaves the device as ``{keypoints (B, K, 2) float32, scores (B, K)
    float32}``, K·12 bytes an image; the answer is in heatmap pixels
    (``"space": "heatmap"``, a quarter of the input's)."""

    verb = "pose"
    slo = SLO("interactive", deadline_ms=30_000.0, max_queue=256)
    #: shadow agreement: the share of keypoints within ``pck_px``
    #: heatmap pixels that must match
    pck_px = 2.0
    pck_min_frac = 0.8

    def make_epilogue(self, model):
        from deep_vision_tpu_torch.tasks.pose import decode_heatmaps

        def post(out):
            hm = out[-1] if isinstance(out, (tuple, list)) else out
            return decode_heatmaps(hm)

        return post

    def respond(self, model, body: dict, row) -> dict:
        kp = np.asarray(row["keypoints"])
        sc = np.asarray(row["scores"])
        return {"model": model.name, "space": "heatmap",
                "keypoints": [
                    {"x": float(kp[j, 0]), "y": float(kp[j, 1]),
                     "score": float(sc[j])} for j in range(kp.shape[0])]}

    def agree(self, primary_row, shadow_row):
        """PCK-style: at least ``pck_min_frac`` of the keypoints within
        ``pck_px``; None for rows that are not pose rows."""
        try:
            pk = np.asarray(primary_row["keypoints"])
            sk = np.asarray(shadow_row["keypoints"])
        except (TypeError, KeyError, IndexError):
            return None
        if pk.shape != sk.shape or pk.ndim < 2:
            return None
        d = np.linalg.norm(pk.astype(np.float32) - sk.astype(np.float32),
                           axis=-1)
        return float((d <= self.pck_px).mean()) >= self.pck_min_frac


class GenerateWorkload(Workload):
    """The GAN generators.  DCGAN takes a latent (``latent``, a list of
    ``latent_dim`` floats, or ``seed``, an int drawn as
    ``default_rng(seed).standard_normal``, 0 by default) on a float32
    wire whatever was asked; CycleGAN takes ``pixels`` on the requested
    wire (uint8 scaled to [-1, 1] on the device by the plain "gan"
    prologue: ``serve_ingest`` has no "gan" family).  The epilogue turns
    the [-1, 1] float32 image into uint8 on the device, so the D2H copy
    moves one byte a pixel, and the answer is its bytes in base64."""

    verb = "generate"
    #: a generative batch holds the card far longer than a classify
    #: batch: a longer deadline, a shorter queue
    slo = SLO("batchy", deadline_ms=60_000.0, max_queue=64)
    #: a CycleGAN answer is a 256²×3 image in base64
    cacheable_bytes = 2 * 2**20

    def wire_dtype_for(self, cfg, requested: str) -> str:
        """A latent-in model (DCGAN) takes float32: a uint8 latent means
        nothing."""
        if getattr(cfg, "task", "") == "gan_dcgan":
            return "float32"
        return requested

    def output_wire(self, cfg) -> str | None:
        return "uint8"

    def decode(self, body: dict, model):
        """A latent-in model's input from ``latent`` or ``seed``; None
        (the pixels decode) for an image-in model."""
        if len(model.input_shape) != 1:
            return None
        z = body.get("latent")
        if z is None:
            seed = body.get("seed", 0)
            try:
                seed = int(seed)
            except (TypeError, ValueError) as e:
                raise ValueError(f"bad seed: {seed!r}") from e
            rng = np.random.default_rng(seed)
            return rng.standard_normal(model.input_shape).astype(np.float32)
        try:
            x = np.asarray(z, np.float32)
        except (ValueError, TypeError, OverflowError) as e:
            raise ValueError(f"bad latent payload: {e}") from e
        if x.shape != model.input_shape:
            raise ValueError(
                f"latent shape {list(x.shape)} != model input "
                f"{list(model.input_shape)}")
        if not np.isfinite(x).all():
            raise ValueError("latent contains non-finite values (NaN/Inf)")
        return x

    def make_epilogue(self, model):
        """[-1, 1] float32 → ``clip(round((x + 1)·127.5), 0, 255)`` uint8
        (round half to even, as ``jnp.round``); None when the model's
        ``output_wire`` is float32."""
        if getattr(model, "output_wire", "uint8") == "float32":
            return None
        import torch

        def post(out):
            return torch.clamp(torch.round((out + 1.0) * 127.5),
                               0.0, 255.0).to(torch.uint8)

        return post

    def respond(self, model, body: dict, row) -> dict:
        import base64

        img = np.ascontiguousarray(np.asarray(row))
        return {"model": model.name,
                "image": {"b64": base64.b64encode(img.tobytes()).decode(
                              "ascii"),
                          "shape": list(img.shape),
                          "dtype": str(img.dtype)}}

    def agree(self, primary_row, shadow_row):
        """Byte equality of the two uint8 images (by digest); None when
        either is not an image array."""
        import hashlib

        comparable = (isinstance(primary_row, np.ndarray)
                      and isinstance(shadow_row, np.ndarray)
                      and primary_row.shape == shadow_row.shape
                      and primary_row.dtype == shadow_row.dtype)
        if not comparable:
            return None

        def dig(a):
            return hashlib.blake2b(np.ascontiguousarray(a).tobytes(),
                                   digest_size=8).hexdigest()

        return dig(primary_row) == dig(shadow_row)


WORKLOADS = {w.verb: w for w in (ClassifyWorkload(), DetectWorkload(),
                                 PoseWorkload(), GenerateWorkload())}
#: operator lifecycle verbs on /v1/models/{name}/<verb>, not inference
#: verbs
LIFECYCLE_VERBS = ("reload", "promote", "rollback")
_BY_TASK = {"classification": "classify", "detection": "detect",
            "centernet": "detect", "pose": "pose",
            "gan_dcgan": "generate", "gan_cyclegan": "generate"}


def workload_for_task(task: str) -> Workload:
    """The adapter serving ``task``; tasks of later slices raise."""
    verb = _BY_TASK.get(str(task))
    if verb is None:
        raise ValueError(f"task '{task}' has no serving workload in this "
                         f"port yet (have {sorted(_BY_TASK)})")
    return WORKLOADS[verb]


def infer_verbs() -> tuple:
    """Every inference verb, sorted — the route allowlist for the edge
    and the gateway (unknown verbs 404 with this list in the body)."""
    return tuple(sorted(WORKLOADS))


def infer_paths() -> tuple:
    """The canonical ``/v1/<verb>`` inference routes."""
    return tuple(f"/v1/{v}" for v in infer_verbs())
