"""The port's YOLOv3 (deep_vision_tpu_torch: models/yolo.py, convert.py's
YOLO mapping, tasks/detection.py, tasks/map_eval.py) against the JAX
reference, on the CPU at the ``yolov3_toy`` size (width 0.125, one
residual block per stage, 3 classes, 64×64).

Tolerances, each with its reason:

- Forward, eval and train mode, float32: every scale's output within
  1e-4·max|ref| (the convolutions sum in different orders), running
  statistics after one train forward within 1e-4 of each tensor's
  largest magnitude.
- ``yolo_scale_loss``: every per-image component, and the gradient with
  respect to the raw head output, within 1e-5 relative to the largest
  magnitude; the reference runs its Pallas ``best_iou_max`` in interpret
  mode (``use_pallas=True``), the port the plain version of its kernel.
  The inputs put predictions on both sides of the 0.5 ignore threshold,
  and the test shows that the ignore mask moves the loss.
- ``encode_labels``, the mAP accumulator: exact (the same numpy code).
- ``postprocess``: boxes and scores within 1e-6, classes and valid flags
  equal, on scores without ties.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import _torch_port as tp
from deep_vision_tpu.models.yolo import YoloV3 as JaxYoloV3
from deep_vision_tpu.tasks import detection as jax_det
from deep_vision_tpu.tasks import map_eval as jax_map
from deep_vision_tpu_torch import convert
from deep_vision_tpu_torch.models.yolo import (
    ANCHOR_MASKS,
    YOLO_ANCHORS,
    YoloV3,
)
from deep_vision_tpu_torch.ops.best_iou import best_iou_max_plain
from deep_vision_tpu_torch.tasks import detection as port_det
from deep_vision_tpu_torch.tasks import map_eval as port_map

TOY = dict(num_classes=3, width=0.125, blocks=(1, 1, 1, 1, 1))
SIZE, GRIDS = 64, (8, 4, 2)


@functools.cache
def _variables(seed=0):
    return tp.seeded_variables(JaxYoloV3(**TOY), (SIZE, SIZE, 3), seed)


def _port_model():
    model = YoloV3(**TOY)
    convert.load_yolo(model, _variables())
    return model


def _images(n, seed=0):
    return (tp.images(n, SIZE, seed) / 255.0).astype(np.float32)


def _close(got, want, rel, what=""):
    want = np.asarray(want, np.float32)
    err = np.abs(np.asarray(got, np.float32) - want).max()
    assert err <= rel * np.abs(want).max(), (what, err, np.abs(want).max())


# -- model and weights --------------------------------------------------------


def test_convert_round_trip():
    variables = _variables()
    model = _port_model()
    sd = convert.yolo_from_flax(variables, TOY["blocks"])
    assert set(sd) == set(model.state_dict())
    back = convert.flatten_tree(convert.yolo_to_flax(model.state_dict(),
                                                     TOY["blocks"]))
    want = convert.flatten_tree(variables)
    assert set(back) == set(want)
    for k in want:
        np.testing.assert_array_equal(back[k], want[k], err_msg=k)


def test_full_width_mapping_covers_the_reference_tree():
    """At yolov3_coco's width and depth every flax leaf has a port tensor
    of the same shape (eval_shape: nothing is run)."""
    jm = JaxYoloV3(num_classes=80)
    shapes = jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)), train=False))
    want = {k: tuple(v.shape)
            for k, v in convert.flatten_tree(shapes).items()}
    model = YoloV3(80)
    got = {k: v.shape for k, v in convert.flatten_tree(
        convert.yolo_to_flax(model.state_dict())).items()}
    assert got == want
    assert sum(p.numel() for p in model.parameters()) == sum(
        int(np.prod(s)) for k, s in want.items() if k.startswith("params"))


def test_forward_eval_matches_flax():
    x = _images(2)
    want = JaxYoloV3(**TOY).apply(_variables(), jnp.asarray(x), train=False)
    with torch.no_grad():
        got = _port_model().eval()(torch.from_numpy(x))
    for s, (g, w) in enumerate(zip(got, want)):
        assert tuple(g.shape) == w.shape == (2, GRIDS[s], GRIDS[s], 3, 8)
        assert g.dtype == torch.float32
        _close(g.numpy(), w, 1e-4, f"scale {s}")


def test_forward_train_matches_flax():
    x = _images(4, seed=1)
    want, upd = JaxYoloV3(**TOY).apply(_variables(), jnp.asarray(x),
                                       train=True, mutable=["batch_stats"])
    model = _port_model().train()
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    for s, (g, w) in enumerate(zip(got, want)):
        _close(g.numpy(), w, 1e-4, f"scale {s}")
    stats = convert.flatten_tree(convert.yolo_to_flax(
        model.state_dict(), TOY["blocks"])["batch_stats"])
    ref = convert.flatten_tree(jax.tree_util.tree_map(np.asarray,
                                                      upd["batch_stats"]))
    moved = 0
    for k, w in ref.items():
        _close(stats[k], w, 1e-4, k)
        moved += not np.allclose(w, convert.flatten_tree(
            _variables()["batch_stats"])[k])
    assert moved == len(ref)  # every running statistic was updated


# -- loss ---------------------------------------------------------------------


def _scale_case(seed=0, b=4, g=8, max_boxes=100):
    """Raw scale-0 output plus ground truths cut from jittered decoded
    predictions, so some predictions overlap a ground truth past 0.5."""
    rng = np.random.default_rng(seed)
    raw = (rng.normal(0, 0.7, (b, g, g, 3, 8))).astype(np.float32)
    anchors = YOLO_ANCHORS[ANCHOR_MASKS[0]]
    box, _, _ = port_det.decode_boxes(torch.from_numpy(raw),
                                      torch.from_numpy(anchors))
    box = box.reshape(b, -1, 4).numpy()
    out = {k: [] for k in ("y_true", "boxes", "boxes_mask")}
    for i in range(b):
        pick = rng.choice(box.shape[1], 6, replace=False)
        xywh = box[i, pick] * rng.uniform(0.9, 1.1, (6, 4))
        xywh[:, :2] = np.clip(xywh[:, :2], 0.01, 0.99)
        enc = port_det.encode_labels(xywh.astype(np.float32),
                                     rng.integers(0, 3, 6), 3, grids=GRIDS)
        out["y_true"].append(enc["y_true_0"])
        out["boxes"].append(enc["boxes"][:max_boxes])
        out["boxes_mask"].append(enc["boxes_mask"][:max_boxes])
    return raw, anchors, {k: np.stack(v) for k, v in out.items()}


def _jax_scale(raw, anchors, case, **kw):
    def total(r):
        t, c = jax_det.yolo_scale_loss(
            r, jnp.asarray(case["y_true"]), jnp.asarray(case["boxes"]),
            jnp.asarray(case["boxes_mask"]), jnp.asarray(anchors),
            use_pallas=True, **kw)
        return t.sum(), (t, c)

    (_, (t, c)), grad = jax.value_and_grad(total, has_aux=True)(
        jnp.asarray(raw))
    return np.asarray(t), {k: np.asarray(v) for k, v in c.items()}, \
        np.asarray(grad)


def test_scale_loss_and_gradient_match_jax():
    raw, anchors, case = _scale_case()
    assert case["y_true"][..., 4].sum() > 0  # some positive cells
    want_t, want_c, want_g = _jax_scale(raw, anchors, case)
    r = torch.from_numpy(raw).requires_grad_(True)
    t, c = port_det.yolo_scale_loss(
        r, torch.from_numpy(case["y_true"]), torch.from_numpy(case["boxes"]),
        torch.from_numpy(case["boxes_mask"]), torch.from_numpy(anchors))
    t.sum().backward()
    _close(t.detach().numpy(), want_t, 1e-5, "total")
    assert set(c) == set(want_c) | {"ignored"}
    for k, w in want_c.items():
        _close(c[k].detach().numpy(), w, 1e-5, k)
    _close(r.grad.numpy(), want_g, 1e-5, "d loss / d raw")
    # the ignore mask is not trivial: predictions on both sides of 0.5 ...
    corners = port_det.xywh_to_corners(port_det.decode_boxes(
        torch.from_numpy(raw), torch.from_numpy(anchors))[0])
    best = best_iou_max_plain(corners.reshape(len(raw), -1, 4),
                              torch.from_numpy(case["boxes"]),
                              torch.from_numpy(case["boxes_mask"]))
    assert 0 < float((best >= 0.5).float().mean()) < 1
    assert float(c["ignored"].sum()) > 0
    # ... and it moves the loss: with nothing ignored it differs
    none_t, none_c, _ = _jax_scale(raw, anchors, case, ignore_thresh=1.1)
    assert (none_c["obj"] > want_c["obj"] * (1 + 1e-4)).any()
    assert not np.allclose(none_t, want_t, rtol=1e-4)


def _three_scale_batch(seed=0, b=4):
    rng = np.random.default_rng(seed)
    raws = [rng.normal(0, 0.7, (b, g, g, 3, 8)).astype(np.float32)
            for g in GRIDS]
    items = []
    for _ in range(b):
        n = int(rng.integers(1, 5))
        xy = rng.uniform(0.2, 0.8, (n, 2))
        wh = rng.uniform(0.05, 0.6, (n, 2))
        items.append(port_det.encode_labels(
            np.concatenate([xy, wh], 1).astype(np.float32),
            rng.integers(0, 3, n), 3, grids=GRIDS))
    batch = {k: np.stack([it[k] for it in items]) for k in items[0]}
    batch["weight"] = np.array([1, 1, 1, 0], np.float32)[:b]
    return raws, batch


def test_yolo_task_loss_and_eval_metrics_match_jax():
    raws, batch = _three_scale_batch()
    ref = jax_det.YoloTask(3, use_pallas=True)
    got = port_det.YoloTask(3)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    jl, jc = ref.loss([jnp.asarray(r) for r in raws], jb)
    tl, tc = got.loss([torch.from_numpy(r) for r in raws], tb)
    assert float(tl) == pytest.approx(float(jl), rel=1e-5)
    for k, v in jc.items():
        assert float(tc[k]) == pytest.approx(float(v), rel=1e-5, abs=1e-6), k
    assert {f"ignored_{s}" for s in range(3)} <= set(tc)
    je = ref.eval_metrics([jnp.asarray(r) for r in raws], jb)
    te = got.eval_metrics([torch.from_numpy(r) for r in raws], tb)
    for k in ("loss", "neg_loss", "count"):
        assert float(te[k]) == pytest.approx(float(je[k]), rel=1e-5), k
    assert float(te["count"]) == 3.0
    assert got.monitor == ref.monitor == "mAP"


def test_decode_and_encode_boxes_match_jax():
    raws, batch = _three_scale_batch(seed=2)
    for s, raw in enumerate(raws):
        anchors = YOLO_ANCHORS[ANCHOR_MASKS[s]]
        want = jax_det.decode_boxes(jnp.asarray(raw), jnp.asarray(anchors))
        got = port_det.decode_boxes(torch.from_numpy(raw),
                                    torch.from_numpy(anchors))
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                       atol=1e-7)
        y = batch[f"y_true_{s}"][..., :4]
        want = jax_det.encode_boxes(jnp.asarray(y), jnp.asarray(anchors))
        got = port_det.encode_boxes(torch.from_numpy(y),
                                    torch.from_numpy(anchors))
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                       atol=1e-7)


@pytest.mark.parametrize("n", [0, 7, 130])
def test_encode_labels_matches_jax_exactly(n):
    rng = np.random.default_rng(n)
    xy = rng.uniform(0.05, 0.95, (n, 2))
    wh = rng.uniform(0.01, 0.9, (n, 2))
    boxes = np.concatenate([xy, wh], 1).astype(np.float32)
    classes = rng.integers(0, 80, n)
    want = jax_det.encode_labels(boxes, classes, 80)
    got = port_det.encode_labels(boxes, classes, 80)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    np.testing.assert_array_equal(
        port_det.find_best_anchor(wh.astype(np.float32)),
        jax_det.find_best_anchor(wh.astype(np.float32)))


def test_postprocess_and_map_match_jax():
    raws, batch = _three_scale_batch(seed=3)
    want = jax_det.postprocess([jnp.asarray(r) for r in raws], 3,
                               max_outputs=40, score_threshold=0.5)
    got = port_det.postprocess([torch.from_numpy(r) for r in raws], 3,
                               max_outputs=40, score_threshold=0.5)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               atol=1e-6)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                               atol=1e-6)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))
    valid = got[3].numpy()
    assert 0 < valid.sum() < valid.size
    # the task's eval outputs feed both accumulators the same detections
    outs = port_det.YoloTask(3, eval_score_threshold=0.05).eval_outputs(
        [torch.from_numpy(r) for r in raws],
        {k: torch.from_numpy(v) for k, v in batch.items()})
    host = {k: v.numpy() for k, v in outs.items()}
    host["weight"] = batch["weight"]
    ref, mine = (jax_map.DetectionMAPAccumulator(3),
                 port_map.DetectionMAPAccumulator(3))
    ref.add_batch(host)
    mine.add_batch(host)
    assert mine.compute() == ref.compute()
    # a perfect detector scores 1 at both metrics; the weight-0 row is
    # skipped, so its (absent) detections cost nothing
    perfect = dict(host, det_boxes=batch["boxes"][:, :20],
                   det_scores=batch["boxes_mask"][:, :20],
                   det_classes=batch["gt_classes"][:, :20],
                   det_valid=batch["boxes_mask"][:, :20])
    perfect["det_valid"][3] = 0.0
    acc = port_map.DetectionMAPAccumulator(3)
    acc.add_batch(perfect)
    assert acc.compute() == {"mAP": 1.0, "mAP50_95": 1.0}
