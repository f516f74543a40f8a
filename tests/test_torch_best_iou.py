"""The port's ``best_iou_max`` (deep_vision_tpu_torch/ops/best_iou.py) and
box utilities (ops/boxes.py) against the JAX reference, on the CPU.

On a CPU tensor the wrapper computes the plain PyTorch version; the CUDA
kernel (csrc/best_iou_max.cu) is held bit for bit against that plain
version on the card by ``chip_smoke.py``.  Here the plain version is held
against the JAX Pallas kernel in interpret mode and against
``broadcast_iou(...).max(-1)`` with the mask applied, within atol 1e-6,
rtol 1e-5 (the tolerance of tests/test_pallas_ops.py).
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
