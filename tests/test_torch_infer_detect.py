"""``cli.infer`` detect and pose against the reference's ``cli.infer``
on the same seeded weights (helpers in tests/test_torch_infer.py): the
kept set equal and the boxes within the NMS tolerance of
tests/test_torch_nms.py; the keypoints equal; ``--out`` writes the
annotated originals."""

import os

import numpy as np
import pytest
import torch
from PIL import Image

import _torch_infer as ti
from _torch_port import seeded_variables
from deep_vision_tpu.cli import infer as jinfer
from deep_vision_tpu.core.config import get_config as jax_get_config
from deep_vision_tpu_torch.cli import infer


@pytest.fixture(autouse=True)
def _no_compile_cache(monkeypatch):
    monkeypatch.setenv("DEEP_VISION_TPU_NO_COMPILE_CACHE", "1")


def _detect_variables():
    cfg = jax_get_config("yolov3_toy")
    return seeded_variables(cfg.model(), (64, 64, 3), seed=3)


def _recorder(monkeypatch, module, seen):
    real = module.postprocess

    def record(*a, **k):
        out = real(*a, **k)
        seen.append([np.asarray(t.cpu() if isinstance(t, torch.Tensor)
                                else t) for t in out])
        return out

    monkeypatch.setattr(module, "postprocess", record)


def test_detect_kept_set_equals_reference(tmp_path, capsys, monkeypatch):
    from deep_vision_tpu.tasks import detection as jdet
    from deep_vision_tpu_torch.tasks import detection as pdet

    v = _detect_variables()
    wd = ti.workdir(tmp_path, "yolov3_toy", v)
    ti.point_reference(monkeypatch, "yolov3_toy", v)
    imgs = ti.images(tmp_path, 2, (64, 64, 3), seed=1)
    seen_ref, seen_port = [], []
    _recorder(monkeypatch, jdet, seen_ref)
    _recorder(monkeypatch, pdet, seen_port)
    out = str(tmp_path / "ann.png")
    argv = ["detect", "-m", "yolov3_toy", "--workdir", wd, "--images",
            *imgs, "--score-threshold", "0.05"]
    assert jinfer.main(argv) == 0
    assert infer.main(argv + ["--device", "cpu", "--out", out]) == 0
    (rb, rs, rc, rv), = seen_ref
    (pb, ps, pc, pv), = seen_port
    rv, pv = rv.astype(bool), pv.astype(bool)
    np.testing.assert_array_equal(pv, rv)
    assert rv.sum() > 0
    np.testing.assert_array_equal(pc[pv], rc[rv])
    # the NMS tolerance of tests/test_torch_nms.py
    np.testing.assert_allclose(ps[pv], rs[rv], rtol=0, atol=1e-6)
    np.testing.assert_allclose(pb[pv], rb[rv], rtol=0,
                               atol=1e-4 * np.abs(rb[rv]).max())
    for i, img in enumerate(imgs):
        stem = os.path.splitext(os.path.basename(img))[0]
        ann = Image.open(str(tmp_path / f"ann-{stem}.png"))
        assert ann.size == (64, 64)


def test_pose_keypoints_equal_reference(tmp_path, capsys, monkeypatch):
    cfg = jax_get_config("hourglass_toy")
    jm = cfg.model()
    v = seeded_variables(jm, (64, 64, 3), seed=3)
    for s in range(jm.num_stack):  # heatmaps at a trained model's scale
        conv = v["params"][f"Conv_{2 + 4 * s}"]
        conv["kernel"] = conv["kernel"] * 1e-3
    wd = ti.workdir(tmp_path, "hourglass_toy", v)
    ti.point_reference(monkeypatch, "hourglass_toy", v)
    imgs = ti.images(tmp_path, 2, (64, 64, 3), seed=2)
    argv = ["pose", "-m", "hourglass_toy", "--workdir", wd, "--images",
            *imgs]
    assert jinfer.main(argv) == 0
    want = ti.lines(capsys, str(tmp_path))
    out = str(tmp_path / "pose.png")
    assert infer.main(argv + ["--device", "cpu", "--out", out]) == 0
    got = ti.lines(capsys, str(tmp_path))
    assert len(want) == 2 and got == want
    assert Image.open(str(tmp_path / "pose-img0.png")).size == (64, 64)
