"""The port's NMS variants and top-k order against the JAX reference.

``deep_vision_tpu_torch/ops/boxes.py`` ``batched_nms`` (hard or Soft-NMS,
class-agnostic or class-wise, with the per-class cap) against
``deep_vision_tpu/ops/boxes.py`` ``batched_nms``/``nms_single`` on the
same numpy inputs: indices and valid flags equal, scores within 1e-6
for hard NMS (the same float32 arithmetic) and 1e-5 for Soft-NMS (the
decay's ``exp`` may differ by an ulp between the two libraries).  Then
``topk_stable`` against ``jax.lax.top_k`` on ties, YOLO's
``postprocess`` with the serving knobs against the reference's (kept
set equal, boxes within 1e-4·max|ref|), and the reference's own
behavioural cases (tests/test_detect_epilogue.py)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deep_vision_tpu.ops import boxes as jax_boxes
from deep_vision_tpu.tasks import detection as jax_detection
from deep_vision_tpu_torch.ops import boxes as port_boxes
from deep_vision_tpu_torch.tasks import detection as port_detection

torch.set_num_threads(2)


def _scene(seed, b=3, n=64, num_classes=4, tie=False):
    """(B, N, 4) corners clustered so that boxes overlap, (B, N) scores
    and (B, N) int32 classes from a seed; ``tie`` rounds the scores to
    a few levels so that equal scores are common."""
    rng = np.random.RandomState(seed)
    centers = rng.uniform(0.1, 0.9, (b, 6, 2))
    pick = rng.randint(0, 6, (b, n))
    c = np.take_along_axis(centers, pick[..., None], 1) + \
        rng.normal(0, 0.03, (b, n, 2))
    wh = rng.uniform(0.05, 0.3, (b, n, 2))
    boxes = np.concatenate([c - wh / 2, c + wh / 2], -1).astype(np.float32)
    scores = rng.uniform(0, 1, (b, n)).astype(np.float32)
    if tie:
        scores = (np.round(scores * 4) / 4).astype(np.float32)
    classes = rng.randint(0, num_classes, (b, n)).astype(np.int32)
    return boxes, scores, classes


VARIANTS = {
    "hard": dict(),
    "hard_floor": dict(score_threshold=0.3),
    "classwise": dict(classes=True),
    "gaussian": dict(soft="gaussian", soft_sigma=0.5),
    "gaussian_classwise_floor": dict(soft="gaussian", soft_sigma=0.3,
                                     classes=True, score_threshold=0.2),
    "linear": dict(soft="linear", iou_threshold=0.3),
    "linear_classwise": dict(soft="linear", classes=True),
    "max_per_class": dict(classes=True, max_per_class=2),
    "gaussian_max_per_class": dict(soft="gaussian", classes=True,
                                   max_per_class=3, score_threshold=0.1),
    "cap_without_classes": dict(max_per_class=2),
    "ties": dict(classes=True, tie=True),
    "ties_linear": dict(soft="linear", tie=True),
}


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_batched_nms_matches_reference(variant):
    kw = dict(VARIANTS[variant])
    use_classes = kw.pop("classes", False)
    tie = kw.pop("tie", False)
    boxes, scores, classes = _scene(sorted(VARIANTS).index(variant),
                                    tie=tie)
    k = 24
    ref = jax_boxes.batched_nms(
        jnp.asarray(boxes), jnp.asarray(scores), k,
        classes=jnp.asarray(classes) if use_classes else None, **kw)
    got = port_boxes.batched_nms(
        torch.from_numpy(boxes), torch.from_numpy(scores), k,
        classes=torch.from_numpy(classes).long() if use_classes else None,
        **kw)
    r_idx, r_sel, r_valid = (np.asarray(a) for a in ref)
    g_idx, g_sel, g_valid = (t.numpy() for t in got)
    np.testing.assert_array_equal(g_valid, r_valid)
    # an invalid round's index is argmax over an all −inf row: 0 on both
    np.testing.assert_array_equal(g_idx, r_idx)
    tol = 1e-5 if kw.get("soft", "off") != "off" else 1e-6
    np.testing.assert_allclose(g_sel, r_sel, rtol=0, atol=tol)
    assert g_valid.sum() > 0
    # nms_single is the same function on one image
    one = port_boxes.nms_single(
        torch.from_numpy(boxes[1]), torch.from_numpy(scores[1]), k,
        classes=torch.from_numpy(classes[1]).long() if use_classes
        else None, **kw)
    np.testing.assert_array_equal(one[0].numpy(), g_idx[1])
    np.testing.assert_array_equal(one[2].numpy(), g_valid[1])


def test_first_index_wins_a_tie():
    """Disjoint boxes with three equal top scores: both pick them in
    index order."""
    boxes = np.asarray([[0.0, 0.0, 0.1, 0.1], [0.2, 0.2, 0.3, 0.3],
                        [0.4, 0.4, 0.5, 0.5], [0.6, 0.6, 0.7, 0.7]],
                       np.float32)
    scores = np.asarray([0.5, 0.9, 0.9, 0.9], np.float32)
    ref, _, _ = jax_boxes.nms_single(jnp.asarray(boxes),
                                     jnp.asarray(scores), 4)
    got, _, _ = port_boxes.nms_single(torch.from_numpy(boxes),
                                      torch.from_numpy(scores), 4)
    assert np.asarray(ref).tolist() == [1, 2, 3, 0]
    assert got.tolist() == [1, 2, 3, 0]


def test_invalid_soft_mode_raises():
    b = torch.zeros((1, 2, 4))
    s = torch.ones((1, 2))
    with pytest.raises(ValueError, match="soft"):
        port_boxes.batched_nms(b, s, 2, soft="sigmoid")
    with pytest.raises(ValueError, match="soft"):
        port_boxes.nms_single(b[0], s[0], 2, soft="hard")


def test_topk_stable_is_lax_top_k_order():
    """Heavy ties: the lower index first among equal values, and the
    lowest indices taken at the k-th boundary, as ``jax.lax.top_k``
    does.  ``torch.topk`` on the CPU returns another order here, which
    is why the port does not use it where ties occur."""
    rng = np.random.RandomState(0)
    x = (rng.randint(0, 4, (3, 200)) / 4).astype(np.float32)
    for k in (1, 7, 50, 200):
        rv, ri = jax.lax.top_k(jnp.asarray(x), k)
        gv, gi = port_boxes.topk_stable(torch.from_numpy(x), k)
        np.testing.assert_array_equal(gi.numpy(), np.asarray(ri))
        np.testing.assert_array_equal(gv.numpy(), np.asarray(rv))
    _, ti = torch.topk(torch.from_numpy(x), 50)
    _, ri = jax.lax.top_k(jnp.asarray(x), 50)
    assert not np.array_equal(ti.numpy(), np.asarray(ri))


def _raw_outputs(seed, grids=(16, 8, 4), num_classes=3, b=2, tie=False):
    """Three YOLO head outputs (B, G, G, 3, 5 + C); ``tie`` gives every
    candidate of a scale the same objectness and class logits, so the
    pre-NMS top-k and NMS meet long runs of equal scores."""
    rng = np.random.RandomState(seed)
    outs = []
    for g in grids:
        raw = rng.normal(0, 1.5, (b, g, g, 3, 5 + num_classes))
        if tie:
            raw[..., 4] = 1.0
            raw[..., 5:] = np.arange(num_classes) * 0.5
        outs.append(raw.astype(np.float32))
    return outs


POSTPROCESS = {
    "eval_default": dict(),
    "serving_classwise": dict(class_aware=True, score_threshold=0.05),
    "serving_gaussian_cap": dict(class_aware=True, soft_nms="gaussian",
                                 soft_sigma=0.4, max_per_class=3,
                                 score_threshold=0.05),
    "serving_linear": dict(class_aware=True, soft_nms="linear"),
    "cap_ignored_agnostic": dict(max_per_class=1),
    "tied_scores_classwise": dict(class_aware=True, tie=True),
    "tied_scores_small_topk": dict(class_aware=True, tie=True,
                                   pre_nms_top_k=40),
}


@pytest.mark.parametrize("case", sorted(POSTPROCESS))
def test_postprocess_matches_reference(case):
    kw = dict(POSTPROCESS[case])
    tie = kw.pop("tie", False)
    outs = _raw_outputs(sorted(POSTPROCESS).index(case), tie=tie)
    ref = jax_detection.postprocess([jnp.asarray(o) for o in outs], 3,
                                    max_outputs=30, **kw)
    got = port_detection.postprocess([torch.from_numpy(o) for o in outs],
                                     3, max_outputs=30, **kw)
    r_boxes, r_scores, r_cls, r_valid = (np.asarray(a) for a in ref)
    g_boxes, g_scores, g_cls, g_valid = (t.numpy() for t in got)
    np.testing.assert_array_equal(g_valid, r_valid)
    np.testing.assert_array_equal(g_cls, r_cls)
    # boxes within 1e-4·max|ref|, the bound of the detect bucket parity:
    # under parallel test load the CPU decode has been seen to compute a
    # box's width and height 4e-5 to 6e-5 relative off its own repeat in
    # the same process (the exp of the wh logits), which a tighter
    # bound would report as a port fault
    np.testing.assert_allclose(g_boxes, r_boxes, rtol=0,
                               atol=1e-4 * np.abs(r_boxes).max())
    tol = 1e-5 if kw.get("soft_nms", "off") != "off" else 1e-6
    np.testing.assert_allclose(g_scores, r_scores, rtol=0, atol=tol)
    assert g_valid.sum() > 0


# -- the reference's behavioural cases (tests/test_detect_epilogue.py) ------


def _overlap_triplet():
    """Two heavily overlapping same-class boxes plus one far box."""
    boxes = np.asarray([[0.1, 0.1, 0.5, 0.5],
                        [0.12, 0.12, 0.5, 0.5],
                        [0.7, 0.7, 0.9, 0.9]], np.float32)
    return boxes, np.asarray([0.9, 0.8, 0.7], np.float32)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _class_wise():
    boxes, scores = _overlap_triplet()
    same = _t(np.zeros(3, np.int64))
    mixed = _t(np.asarray([0, 1, 2], np.int64))
    _, _, v_agnostic = port_boxes.nms_single(_t(boxes), _t(scores), 3)
    _, _, v_same = port_boxes.nms_single(_t(boxes), _t(scores), 3,
                                         classes=same)
    _, _, v_mixed = port_boxes.nms_single(_t(boxes), _t(scores), 3,
                                          classes=mixed)
    # same class (or none): the overlapping pair collapses; different
    # classes never suppress each other
    assert v_agnostic.sum() == 2 and v_same.sum() == 2
    assert v_mixed.sum() == 3
    _, _, bv = port_boxes.batched_nms(_t(boxes)[None], _t(scores)[None], 3,
                                      classes=mixed[None])
    assert bv.sum() == 3


def _gaussian_decays():
    boxes, scores = _overlap_triplet()
    iou01 = float(port_boxes.broadcast_iou(_t(boxes), _t(boxes))[0, 1])
    assert iou01 > 0.5
    _, _, hard_valid = port_boxes.nms_single(_t(boxes), _t(scores), 3)
    assert hard_valid.sum() == 2
    idx, sel, valid = port_boxes.nms_single(_t(boxes), _t(scores), 3,
                                            soft="gaussian", soft_sigma=0.5)
    assert valid.sum() == 3  # everyone survives, reordered by decay
    order = {int(i): float(s) for i, s in zip(idx, sel)}
    assert order[0] == pytest.approx(0.9)
    assert order[2] == pytest.approx(0.7)  # iou 0: no decay
    expect = 0.8 * np.exp(-(iou01 ** 2) / 0.5)
    assert order[1] == pytest.approx(expect, abs=1e-5)
    assert idx.tolist() == [0, 2, 1]
    # a floor above the decayed score kills the neighbour after all
    _, _, v_floor = port_boxes.nms_single(
        _t(boxes), _t(scores), 3, soft="gaussian", soft_sigma=0.5,
        score_threshold=expect + 0.05)
    assert v_floor.sum() == 2


def _linear_and_off():
    boxes, scores = _overlap_triplet()
    iou01 = float(port_boxes.broadcast_iou(_t(boxes), _t(boxes))[0, 1])
    idx, sel, valid = port_boxes.nms_single(_t(boxes), _t(scores), 3,
                                            soft="linear")
    assert valid.sum() == 3
    order = {int(i): float(s) for i, s in zip(idx, sel)}
    # linear decay only past the IoU threshold: (1 - iou)·s
    assert order[1] == pytest.approx(0.8 * (1.0 - iou01), abs=1e-5)
    assert order[2] == pytest.approx(0.7)
    for a, b in zip(port_boxes.nms_single(_t(boxes), _t(scores), 3),
                    port_boxes.nms_single(_t(boxes), _t(scores), 3,
                                          soft="off")):
        assert torch.equal(a, b)


def _per_class_cap():
    # four disjoint boxes: three of class 0, one of class 1
    boxes = np.asarray([[0.0, 0.0, 0.2, 0.2], [0.3, 0.3, 0.5, 0.5],
                        [0.6, 0.6, 0.8, 0.8], [0.0, 0.6, 0.2, 0.8]],
                       np.float32)
    scores = np.asarray([0.9, 0.8, 0.7, 0.6], np.float32)
    classes = _t(np.asarray([0, 0, 0, 1], np.int64))
    _, _, v_uncapped = port_boxes.nms_single(_t(boxes), _t(scores), 4,
                                             classes=classes)
    assert v_uncapped.sum() == 4
    idx, sel, valid = port_boxes.nms_single(_t(boxes), _t(scores), 4,
                                            classes=classes,
                                            max_per_class=2)
    kept = {int(i) for i, v in zip(idx, valid) if v > 0}
    assert kept == {0, 1, 3}
    # an invalidated row's score is zeroed too
    assert float(sel[idx == 2][0]) == 0.0
    # a cap without classes is a no-op
    _, _, v_nocls = port_boxes.nms_single(_t(boxes), _t(scores), 4,
                                          max_per_class=2)
    assert v_nocls.sum() == 4
    _, _, bv = port_boxes.batched_nms(_t(boxes)[None], _t(scores)[None], 4,
                                      classes=classes[None],
                                      max_per_class=2)
    assert bv.sum() == 3


BEHAVIOUR = {"class_wise_within_class_only": _class_wise,
             "gaussian_decays_instead_of_killing": _gaussian_decays,
             "linear_and_off": _linear_and_off,
             "per_class_cap_within_class_only": _per_class_cap}


@pytest.mark.parametrize("case", sorted(BEHAVIOUR))
def test_reference_behaviour(case):
    BEHAVIOUR[case]()
