"""Each workload's shadow ``agree`` rule and cache size guard equal the
reference's (deep_vision_tpu/serve/workloads.py) on the same row pairs:
dense classify logits with ties and NaNs, detect rows with empty,
partial and class-mismatched sets, pose keypoints at the PCK radius,
generate images one code apart, and rows that are not comparable (a
Shed, a Quarantined, another shape)."""

import numpy as np
import pytest

from deep_vision_tpu.serve import workloads as jwl
from deep_vision_tpu.serve.admission import Shed as JaxShed
from deep_vision_tpu_torch.serve import workloads as pwl
from deep_vision_tpu_torch.serve.admission import Shed
from deep_vision_tpu_torch.serve.faults import Quarantined

pytestmark = pytest.mark.serve

RNG = np.random.RandomState(0)
LOGITS = RNG.randn(10).astype(np.float32)


def _tied(a):
    b = a.copy()
    b[int(np.argsort(a)[-2])] = a.max()  # a tie for the top
    return b


def _classify_pairs():
    nan = LOGITS.copy()
    nan[3] = np.nan
    return [(LOGITS, LOGITS), (LOGITS, LOGITS + 1.0), (LOGITS, -LOGITS),
            (LOGITS, _tied(LOGITS)), (_tied(LOGITS), LOGITS),
            (nan, LOGITS), (nan, nan), (LOGITS, np.zeros(0, np.float32)),
            (LOGITS, Shed("queue_full")), (Quarantined("poison"), LOGITS),
            (LOGITS, "not a row")]


def _det(boxes, classes, valid=None, k=6):
    n = len(boxes)
    b = np.zeros((k, 4), np.float32)
    b[:n] = boxes
    c = np.zeros(k, np.int32)
    c[:n] = classes
    v = np.zeros(k, np.float32)
    v[:n] = 1.0 if valid is None else valid
    s = np.linspace(0.9, 0.1, k).astype(np.float32)
    return {"boxes": b, "scores": s, "classes": c, "valid": v}


BOXES = np.array([[0.1, 0.1, 0.4, 0.4], [0.5, 0.5, 0.9, 0.8],
                  [0.2, 0.6, 0.3, 0.9]], np.float32)


def _detect_pairs():
    shifted = BOXES + 0.02
    far = BOXES[::-1] + np.array([0.3, 0.0, 0.3, 0.0], np.float32)
    nan = BOXES.copy()
    nan[1, 0] = np.nan
    return [(_det(BOXES, [1, 2, 3]), _det(BOXES, [1, 2, 3])),
            (_det(BOXES, [1, 2, 3]), _det(shifted, [1, 2, 3])),
            (_det(BOXES, [1, 2, 3]), _det(BOXES, [1, 2, 4])),
            (_det(BOXES, [1, 2, 3]), _det(BOXES[:2], [1, 2])),
            (_det(BOXES, [1, 2, 3]), _det(far, [1, 2, 3])),
            (_det(BOXES[:0], []), _det(BOXES[:0], [])),
            (_det(BOXES[:0], []), _det(BOXES[:1], [1])),
            (_det(nan, [1, 2, 3]), _det(BOXES, [1, 2, 3])),
            (_det(BOXES, [1, 1, 1]), _det(BOXES[[1, 0, 2]], [1, 1, 1])),
            (_det(BOXES, [1, 2, 3], valid=[1, 0, 1]),
             _det(BOXES, [1, 2, 3])),
            (_det(BOXES, [1, 2, 3]), {"boxes": BOXES}),
            (_det(BOXES, [1, 2, 3]), (np.zeros((3, 4)),)),
            (_det(BOXES, [1, 2, 3]), Shed("deadline"))]


def _pose(xy):
    return {"keypoints": np.asarray(xy, np.float32),
            "scores": np.ones(len(xy), np.float32)}


def _pose_pairs():
    kp = RNG.uniform(0, 64, (16, 2)).astype(np.float32)
    near = kp + 1.9
    edge = kp.copy()
    edge[:, 0] += 2.0  # exactly the PCK radius
    far = kp.copy()
    far[:4] += 10.0  # 12 of 16 within: 0.75 < 0.8
    farther = kp.copy()
    farther[:3] += 10.0  # 13 of 16: 0.8125
    return [(_pose(kp), _pose(kp)), (_pose(kp), _pose(near)),
            (_pose(kp), _pose(edge)), (_pose(kp), _pose(far)),
            (_pose(kp), _pose(farther)), (_pose(kp), _pose(kp[:8])),
            (_pose(kp), Quarantined("poison")), (Shed("shutdown"),
                                                 _pose(kp))]


def _generate_pairs():
    img = RNG.randint(0, 256, (8, 8, 3)).astype(np.uint8)
    off = img.copy()
    off[0, 0, 0] ^= 1
    return [(img, img), (img, off), (img, img.astype(np.int16)),
            (img, img[:4]), (img, Shed("queue_full"))]


def _jax_row(row):
    # the reference's own Shed type where a Shed stands in
    if isinstance(row, Shed):
        return JaxShed(row.reason)
    return row


@pytest.mark.parametrize("verb,pairs", [
    ("classify", _classify_pairs()), ("detect", _detect_pairs()),
    ("pose", _pose_pairs()), ("generate", _generate_pairs())])
def test_agree_matches_reference(verb, pairs):
    mine, theirs = pwl.WORKLOADS[verb], jwl.WORKLOADS[verb]
    got = [mine.agree(p, s) for p, s in pairs]
    want = [theirs.agree(_jax_row(p), _jax_row(s)) for p, s in pairs]
    assert got == want
    # every verdict kind occurs somewhere in the sample
    assert set(got) >= {True, False, None}


@pytest.mark.parametrize("verb", ["classify", "detect", "pose",
                                  "generate"])
def test_cacheable_matches_reference(verb):
    mine, theirs = pwl.WORKLOADS[verb], jwl.WORKLOADS[verb]
    assert mine.cacheable_bytes == theirs.cacheable_bytes
    for n in (0, mine.cacheable_bytes, mine.cacheable_bytes + 1):
        assert mine.cacheable(n) == theirs.cacheable(n)


def test_lifecycle_verbs_match_reference():
    assert pwl.LIFECYCLE_VERBS == jwl.LIFECYCLE_VERBS
    assert pwl.Workload().agree(LOGITS, LOGITS) is None
