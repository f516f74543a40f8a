"""The port's ``best_iou_max`` (deep_vision_tpu_torch/ops/best_iou.py) and
box utilities (ops/boxes.py) against the JAX reference, on the CPU.

On a CPU tensor the wrapper computes the plain PyTorch version; the CUDA
kernel (csrc/best_iou_max.cu) is held bit for bit against that plain
version on the card by ``chip_smoke.py``.  Here the plain version is held
against the JAX Pallas kernel in interpret mode and against
``broadcast_iou(...).max(-1)`` with the mask applied, within atol 1e-6,
rtol 1e-5 (the tolerance of tests/test_pallas_ops.py).  The kernel's own
reduction (one division per prediction, see the numpy model below) is
held bit for bit against the plain version.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import _torch_port  # noqa: F401  (two intra-op threads)
from deep_vision_tpu.ops import boxes as jax_boxes
from deep_vision_tpu.ops.pallas_ops import best_iou_max as jax_best_iou_max
from deep_vision_tpu_torch.ops import boxes as port_boxes
from deep_vision_tpu_torch.ops.best_iou import best_iou_max, best_iou_max_plain

ATOL, RTOL = 1e-6, 1e-5


def _boxes(rng, b, n):
    xy = rng.uniform(0, 1, (b, n, 2))
    wh = rng.uniform(0.01, 0.5, (b, n, 2))
    return np.concatenate([xy - wh / 2, xy + wh / 2], -1).astype(np.float32)


def _inputs(shape, seed=0):
    b, n, m = shape
    rng = np.random.default_rng(seed)
    pred, gt = _boxes(rng, b, n), _boxes(rng, b, m)
    mask = (rng.uniform(0, 1, (b, m)) > 0.3).astype(np.float32)
    return pred, gt, mask


def _jax_masked_max(pred, gt, mask):
    iou = jax_boxes.broadcast_iou(jnp.asarray(pred), jnp.asarray(gt))
    return np.asarray(jnp.where(jnp.asarray(mask)[:, None, :] > 0, iou,
                                0.0).max(-1))


def _port(pred, gt, mask):
    return best_iou_max(torch.from_numpy(pred), torch.from_numpy(gt),
                        torch.from_numpy(mask)).numpy()


# (2, 600, 100) is the reference's own parity shape; the yolov3_toy loss
# at 64² runs (8, 3·8², 100), (8, 3·4², 100), (8, 3·2², 100); (3, 1000, 7)
# has an N that is no multiple of 256 and a short M
@pytest.mark.parametrize("shape", [(2, 600, 100), (8, 192, 100),
                                   (8, 48, 100), (8, 12, 100),
                                   (3, 1000, 7)])
def test_plain_matches_pallas_interpret_and_xla(shape):
    pred, gt, mask = _inputs(shape, seed=sum(shape))
    got = _port(pred, gt, mask)
    assert got.shape == shape[:2] and got.dtype == np.float32
    want = np.asarray(jax_best_iou_max(jnp.asarray(pred), jnp.asarray(gt),
                                       jnp.asarray(mask), interpret=True))
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(got, _jax_masked_max(pred, gt, mask),
                               atol=ATOL, rtol=RTOL)
    # a real mix on both sides of the loss's 0.5 ignore threshold
    assert 0 < (got >= 0.5).mean() < 1


def test_edge_cases():
    pred, gt, mask = _inputs((3, 40, 9), seed=5)
    mask[0] = 0.0                       # image 0: every gt masked
    pred[:, ::4, 2] = pred[:, ::4, 0]   # zero-width predictions
    gt[:, ::3, 3] = gt[:, ::3, 1]       # zero-height ground truths
    pred[0, 1] = np.nan                 # NaN rows in images 0 and 1
    pred[1, 2] = np.nan
    got = _port(pred, gt, mask)
    want = np.asarray(jax_best_iou_max(jnp.asarray(pred), jnp.asarray(gt),
                                       jnp.asarray(mask), interpret=True))
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL,
                               equal_nan=True)
    np.testing.assert_array_equal(got[0], 0.0)   # masked: 0, NaN row too
    assert np.isnan(got[1, 2]) and np.isnan(got).sum() == 1
    assert (got[:, ::4] == 0).all()     # zero area overlaps nothing
    # a zero-area ground truth scores 0 against every prediction
    only_flat = mask.copy()
    only_flat[:, :] = 0.0
    only_flat[:, ::3] = 1.0
    flat = _port(pred, gt, only_flat)
    assert (flat[~np.isnan(flat)] == 0).all()


def test_no_ground_truths():
    pred, _, _ = _inputs((2, 30, 1), seed=1)
    got = best_iou_max(torch.from_numpy(pred), torch.zeros((2, 0, 4)),
                       torch.zeros((2, 0)))
    assert got.shape == (2, 30) and (got == 0).all()
    np.testing.assert_array_equal(
        best_iou_max_plain(torch.from_numpy(pred), torch.zeros((2, 0, 4)),
                           torch.zeros((2, 0))).numpy(), 0.0)


def test_cpu_tensor_counts_no_launch_and_bad_input_raises():
    pred, gt, mask = (torch.from_numpy(a) for a in _inputs((2, 20, 5)))
    before = best_iou_max.launches
    out = best_iou_max(pred, gt, mask)
    assert best_iou_max.launches == before
    assert torch.equal(out, best_iou_max_plain(pred, gt, mask))
    with pytest.raises(TypeError, match="float32"):
        best_iou_max(pred.double(), gt, mask)
    with pytest.raises(ValueError, match="contiguous"):
        best_iou_max(pred.transpose(0, 1), gt, mask)
    with pytest.raises(ValueError, match=r"\(B, M\) mask"):
        best_iou_max(pred, gt, mask[:, :3].contiguous())
    with pytest.raises(ValueError, match="ground truths"):
        best_iou_max(pred, gt[:1].contiguous(), mask[:1].contiguous())


def test_boxes_match_reference():
    rng = np.random.default_rng(3)
    xywh = rng.uniform(0.1, 0.9, (2, 7, 4)).astype(np.float32)
    np.testing.assert_allclose(
        port_boxes.xywh_to_corners(torch.from_numpy(xywh)).numpy(),
        np.asarray(jax_boxes.xywh_to_corners(jnp.asarray(xywh))), atol=0)
    a, b = _boxes(rng, 2, 11), _boxes(rng, 2, 6)
    np.testing.assert_allclose(
        port_boxes.broadcast_iou(torch.from_numpy(a),
                                 torch.from_numpy(b)).numpy(),
        np.asarray(jax_boxes.broadcast_iou(jnp.asarray(a), jnp.asarray(b))),
        atol=ATOL, rtol=RTOL)


def test_batched_nms_matches_reference():
    rng = np.random.default_rng(4)
    # clusters of overlapping boxes, so suppression decides; distinct
    # scores (no ties) and a score floor that drops some
    centres = rng.uniform(0.2, 0.8, (3, 6, 1, 2))
    xy = (centres + rng.normal(0, 0.02, (3, 6, 5, 2))).reshape(3, 30, 2)
    wh = rng.uniform(0.1, 0.3, (3, 30, 2))
    boxes = np.concatenate([xy - wh / 2, xy + wh / 2], -1).astype(np.float32)
    scores = rng.permutation(90).reshape(3, 30).astype(np.float32) / 90
    want = jax_boxes.batched_nms(jnp.asarray(boxes), jnp.asarray(scores),
                                 20, 0.5, 0.1)
    got = port_boxes.batched_nms(torch.from_numpy(boxes),
                                 torch.from_numpy(scores), 20, 0.5, 0.1)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    valid = got[2].numpy()
    assert 0 < valid.sum() < valid.size   # suppression and exhaustion
    one = port_boxes.nms_single(torch.from_numpy(boxes[1]),
                                torch.from_numpy(scores[1]), 20, 0.5, 0.1)
    for g, w in zip(one, got):
        assert torch.equal(g, w[1])


# --- the kernel's reduction, modelled in numpy -----------------------------
#
# csrc/best_iou_max.cu does not divide once per pair: it packs the unmasked
# ground truths, keeps for each prediction the pair with the largest exact
# quotient inter / den (float32 cross products, float64 where they tie),
# divides that pair once, and sends every pair with a box that is not tame
# (a coordinate beyond 2^62, inf or NaN) down the per-pair path.  Every
# result starts at +0.  The model below is that reduction, vectorised over
# predictions and walked over ground truths in order; it is held bit for
# bit against best_iou_max_plain, NaN matching NaN.

TAME = np.float32(2.0 ** 62)
EPS = np.float32(1e-9)


def _area(b):
    return (np.maximum(b[..., 2] - b[..., 0], np.float32(0))
            * np.maximum(b[..., 3] - b[..., 1], np.float32(0)))


def _terms(p, g, area_p):
    """(inter, den) of predictions p (n, 4) against one box g (4,), each
    step one float32 operation in the plain version's order."""
    w = np.maximum(np.minimum(p[:, 2], g[2]) - np.maximum(p[:, 0], g[0]),
                   np.float32(0))
    h = np.maximum(np.minimum(p[:, 3], g[3]) - np.maximum(p[:, 1], g[1]),
                   np.float32(0))
    inter = w * h
    return inter, ((area_p + _area(g)) - inter) + EPS


def _model(pred, gt, mask, exact_ties=True):
    """The kernel's reduction → ``(out, stats)``; ``stats`` counts the
    float32 ties broken by the float64 products and the pairs on the
    per-pair path.  ``exact_ties=False`` keeps the leader on every float32
    tie: the reduction without its float64 step."""
    b, n, _ = pred.shape
    out = np.empty((b, n), np.float32)
    stats = {"float64_ties": 0, "per_pair": 0}
    with np.errstate(all="ignore"):
        for img in range(b):
            g, on = gt[img], mask[img] > 0
            tame_g = (np.abs(g) <= TAME).all(-1)
            packed, wild_g = g[on & tame_g], g[on & ~tame_g]
            p = pred[img]
            area_p = _area(p)
            tame_p = (np.abs(p) <= TAME).all(-1)
            lead_inter = np.zeros(n, np.float32)
            lead_den = np.ones(n, np.float32)
            for gk in packed:
                inter, den = _terms(p, gk, area_p)
                a, c = inter * lead_den, lead_inter * den
                tie = (a == c) & (inter > 0) & tame_p
                exact = (inter.astype(np.float64) * lead_den
                         > lead_inter.astype(np.float64) * den)
                take = ((a > c) | (tie & exact & exact_ties)) & tame_p
                stats["float64_ties"] += int(tie.sum())
                lead_inter = np.where(take, inter, lead_inter)
                lead_den = np.where(take, den, lead_den)
            best = np.where(lead_inter > 0, lead_inter / lead_den,
                            np.float32(0))
            # the per-pair path: every prediction against a ground truth
            # that is not tame, and a prediction that is not tame against
            # every unmasked ground truth
            for gk, rows in [(x, np.ones(n, bool)) for x in wild_g] + [
                    (x, ~tame_p) for x in packed]:
                inter, den = _terms(p, gk, area_p)
                best = np.where(rows, np.maximum(best, inter / den), best)
                stats["per_pair"] += int(rows.sum())
            out[img] = best
    return out, stats


def _same_bits(got, want, signed_zero=True):
    """Elements whose bits differ, NaN matching any NaN; with
    ``signed_zero`` False a zero matches a zero of either sign."""
    same = (got.view(np.int32) == want.view(np.int32)) | (
        np.isnan(got) & np.isnan(want))
    if not signed_zero:
        same |= (got == 0) & (want == 0)
    return int((~same).sum())


def _ulps(a, rng, most):
    step = rng.integers(-most, most + 1, a.shape).astype(np.int32)
    return (a.view(np.int32) + step).view(np.float32)


def _case(name):
    """Seeded (pred, gt, mask) for one named case of the model test."""
    shape = {"past_one_chunk": (2, 150, 600), "m0": (2, 64, 0),
             "near_tie": (2, 500, 40)}.get(name, (3, 200, 40))
    seed = {"near_tie": 3}.get(name, sum(map(ord, name)))
    rng = np.random.default_rng(seed)
    pred, gt, mask = _inputs(shape, seed=seed)
    b, n, m = shape
    if name == "near_tie":
        # each ground truth twinned 1 ulp away, each prediction a ground
        # truth moved by 1 ulp: the cross products tie, and with this
        # seed the float32 products alone pick the wrong leader
        half = m // 2
        gt[:, half:] = _ulps(gt[:, :half].copy(), rng, 1)
        pred = _ulps(gt[:, rng.integers(0, m, n)], rng, 1)
    elif name == "duplicates":
        gt[:, 20:] = gt[:, :20]
        pred[:, ::2] = gt[:, rng.integers(0, m, n // 2)]
    elif name == "zero_area":
        pred[:, ::3, 2] = pred[:, ::3, 0]
        pred[:, 1::3, 3] = pred[:, 1::3, 1]
        gt[:, ::4, 2] = gt[:, ::4, 0]
        gt[:, 1::4, 3] = gt[:, 1::4, 1]
    elif name == "signed_zero":
        # corners at +0 and -0, so sides and overlaps of zero width come
        # out as -0 as well as +0
        pred[:, ::4, 0], pred[:, ::4, 2] = 0.0, -0.0
        pred[:, 1::4, 0], pred[:, 1::4, 2] = -0.0, 0.0
        pred[:, 2::4, 1], pred[:, 2::4, 3] = 0.0, -0.0
        gt[:, ::3, 0] = -0.0
        gt[:, 1::3, 2] = 0.0
        gt[:, ::2, 1] = -0.1
    elif name == "nan_inf":
        pred[:, ::11, 0] = np.nan
        pred[:, 3::13, 2] = np.inf
        pred[:, 5::17, 1] = -np.inf
        pred[:, 7::19] *= np.float32(1e30)      # finite, not tame
        gt[0, 1, 2] = np.inf
        gt[1, 2, 0] = np.nan
        gt[2, 3] = [-1e30, -1e30, 1e30, 1e30]
        gt[2, 4] = [-np.inf, -np.inf, np.inf, np.inf]
        mask[:, 1:5] = 1.0
        mask[1, 2] = 0.0                        # a masked NaN box: 0
    elif name == "wholly_masked":
        mask[0] = 0.0
        mask[1] = 1.0
        pred[0, 1] = np.nan
    elif name == "coco_share":
        mask = (rng.uniform(0, 1, (b, m)) < 0.07).astype(np.float32)
    return pred, gt, mask


MODEL_CASES = ["random", "near_tie", "duplicates", "zero_area",
               "signed_zero", "nan_inf", "wholly_masked", "m0",
               "past_one_chunk", "coco_share"]


@pytest.mark.parametrize("name", MODEL_CASES)
def test_divide_once_model_matches_plain(name):
    """The kernel's reduction (compaction, exact cross products, one
    division, the per-pair path) equals the plain per-pair max bit for
    bit.  ``signed_zero`` alone matches a zero with a zero of either sign:
    torch's CPU ``clamp_min`` keeps a -0 side and its ``amax`` picks
    either zero by its reduction order, where the card's ``max.NaN``
    orders -0 below +0 and so never makes a -0 IoU; the sign of a zero
    result is then a property of the CPU reduction, not of this one."""
    pred, gt, mask = _case(name)
    want = best_iou_max_plain(torch.from_numpy(pred), torch.from_numpy(gt),
                              torch.from_numpy(mask)).numpy()
    got, stats = _model(pred, gt, mask)
    assert got.shape == want.shape
    assert _same_bits(got, want, signed_zero=name != "signed_zero") == 0
    if name == "near_tie":
        # the float64 step decides: without it the model is wrong here
        assert stats["float64_ties"] > 0
        assert _same_bits(_model(pred, gt, mask, exact_ties=False)[0],
                          want) > 0
    if name == "duplicates":
        assert stats["float64_ties"] > 0 and (want == 1.0).any()
    if name == "nan_inf":
        assert stats["per_pair"] > 0
        assert np.isnan(want).any() and (want[~np.isnan(want)] >= 0).all()
    if name == "wholly_masked":
        np.testing.assert_array_equal(want[0], 0.0)
    if name == "m0":
        np.testing.assert_array_equal(got, 0.0)
    if name == "signed_zero":
        assert (np.signbit(want) & (want == 0)).any()   # -0 reached
        assert not (np.signbit(got) & (got == 0)).any()


def test_divide_once_model_random_values():
    """The same identity on draws over a value set with ties, zero sides,
    subnormal, huge, infinite and NaN coordinates (one test, many
    draws).  The set holds -0, so a zero matches a zero of either sign,
    as in ``signed_zero`` above."""
    from hypothesis import given, settings
    from hypothesis import strategies as st

    values = st.sampled_from([0.0, -0.0, 0.25, 0.5, 0.5000001, 0.75, 1.0,
                              -0.25, 1e-20, 3e-39, 1e30, np.inf, -np.inf,
                              np.nan])

    def array(data, shape, elements):
        size = int(np.prod(shape))
        return np.array(data.draw(st.lists(elements, min_size=size,
                                           max_size=size)),
                        np.float32).reshape(shape)

    @settings(max_examples=60, deadline=None, derandomize=True)
    @given(st.integers(1, 2), st.integers(1, 9), st.integers(0, 7),
           st.data())
    def check(b, n, m, data):
        pred = array(data, (b, n, 4), values)
        gt = array(data, (b, m, 4), values)
        mask = array(data, (b, m), st.sampled_from([0.0, 1.0]))
        want = best_iou_max_plain(torch.from_numpy(pred),
                                  torch.from_numpy(gt),
                                  torch.from_numpy(mask)).numpy()
        assert _same_bits(_model(pred, gt, mask)[0], want,
                          signed_zero=False) == 0

    check()
