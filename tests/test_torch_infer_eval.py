"""``cli.infer eval`` against the reference's on the same seeded weights
and the same records: classification top-1/top-5 (MNIST idx files),
``--pretrained`` from a torch-format checkpoint, YOLOv3's VOC and COCO
mAP with its val loss, and the pose val loss, each within 1e-5 (helpers
in tests/test_torch_infer.py)."""

import numpy as np
import pytest
import torch

import _torch_serve as ts
import _torch_infer as ti
from _torch_port import seeded_variables
from deep_vision_tpu.cli import infer as jinfer
from deep_vision_tpu.core import trainer as jtrainer
from deep_vision_tpu.core.config import get_config as jax_get_config
from deep_vision_tpu_torch.cli import infer
from deep_vision_tpu_torch.core import trainer as ptrainer
from deep_vision_tpu_torch.data.records import RecordWriter, shard_name


@pytest.fixture(autouse=True)
def _no_compile_cache(monkeypatch):
    monkeypatch.setenv("DEEP_VISION_TPU_NO_COMPILE_CACHE", "1")


def _both_evals(monkeypatch, argv):
    """The metrics dict of the reference's and of the port's eval."""
    seen = {}
    for name, mod in (("ref", jtrainer), ("port", ptrainer)):
        real = mod.Trainer.evaluate

        def record(self, state, data, real=real, name=name):
            seen[name] = real(self, state, data)
            return seen[name]

        monkeypatch.setattr(mod.Trainer, "evaluate", record)
    assert jinfer.main(argv) == 0
    assert infer.main(argv + ["--device", "cpu"]) == 0
    return seen["ref"], seen["port"]


def _close(got, want, keys):
    assert keys <= set(want) and set(got) == set(want)
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=1e-5, abs=1e-6), k


def _mnist(root, n=20, seed=0):
    from deep_vision_tpu_torch.data.mnist import write_idx

    rng = np.random.default_rng(seed)
    root.mkdir()
    write_idx(str(root), "test",
              rng.integers(0, 256, (n, 28, 28), np.uint8),
              (np.arange(n) % 10).astype(np.uint8))


def test_eval_classification_equals_reference(tmp_path, monkeypatch):
    v = ts.lenet_variables(6)
    wd = ti.workdir(tmp_path, "lenet5", v)
    ti.point_reference(monkeypatch, "lenet5", v)
    _mnist(tmp_path / "mnist")
    ref, got = _both_evals(monkeypatch, [
        "eval", "-m", "lenet5", "--workdir", wd, "--data-root",
        str(tmp_path / "mnist"), "--batch-size", "8"])
    _close(got, ref, {"top1", "top5", "loss"})


def test_eval_pretrained_equals_reference(tmp_path, monkeypatch, capsys):
    from deep_vision_tpu_torch.models.lenet import LeNet5

    model = LeNet5()
    g = torch.Generator().manual_seed(12)
    ckpt = {k: torch.randn(t.shape, generator=g) * 0.2
            for k, t in model.state_dict().items()}
    path = str(tmp_path / "lenet.pth")
    torch.save({"state_dict": {f"module.{k}": t for k, t in ckpt.items()}},
               path)
    _mnist(tmp_path / "mnist", seed=1)
    ref, got = _both_evals(monkeypatch, [
        "eval", "-m", "lenet5", "--workdir", str(tmp_path / "wd"),
        "--pretrained", path, "--data-root", str(tmp_path / "mnist"),
        "--batch-size", "8"])
    out = capsys.readouterr().out
    assert out.count(f"[eval] imported lenet5 weights from {path} "
                     f"(with checkpoint head)") == 2
    _close(got, ref, {"top1", "top5", "loss"})
    with pytest.raises(SystemExit, match="--pretrained supports"):
        infer.main(["eval", "-m", "yolov3_toy", "--workdir", "w",
                    "--pretrained", path, "--synthetic", "--device", "cpu"])


def test_eval_detection_equals_reference(tmp_path, monkeypatch):
    from deep_vision_tpu.data.detection import synthetic_detection_dataset
    from deep_vision_tpu_torch.data.records import encode_detection_sample

    v = seeded_variables(jax_get_config("yolov3_toy").model(), (64, 64, 3),
                         seed=4)
    wd = ti.workdir(tmp_path, "yolov3_toy", v)
    ti.point_reference(monkeypatch, "yolov3_toy", v)
    data = tmp_path / "det"
    with RecordWriter(shard_name(str(data), "val", 0, 1)) as w:
        for scene in synthetic_detection_dataset(10, 64, 3, seed=5):
            w.write(*encode_detection_sample(scene, store="raw",
                                             resize=64))
    ref, got = _both_evals(monkeypatch, [
        "eval", "-m", "yolov3_toy", "--workdir", wd, "--data-root",
        str(data), "--batch-size", "8"])
    _close(got, ref, {"loss", "mAP", "mAP50_95"})


def test_eval_pose_equals_reference(tmp_path, monkeypatch):
    from deep_vision_tpu.data.pose import synthetic_pose_dataset
    from deep_vision_tpu_torch.data.records import encode_pose_sample

    jm = jax_get_config("hourglass_toy").model()
    v = seeded_variables(jm, (64, 64, 3), seed=5)
    for s in range(jm.num_stack):
        conv = v["params"][f"Conv_{2 + 4 * s}"]
        conv["kernel"] = conv["kernel"] * 1e-3
    wd = ti.workdir(tmp_path, "hourglass_toy", v)
    ti.point_reference(monkeypatch, "hourglass_toy", v)
    data = tmp_path / "pose"
    with RecordWriter(shard_name(str(data), "val", 0, 1)) as w:
        for pose in synthetic_pose_dataset(10, 64, 8, seed=6):
            # a crop past every edge: at the input size, so no resize
            w.write(*encode_pose_sample(dict(pose, scale=10.0),
                                        store="raw", resize=64))
    ref, got = _both_evals(monkeypatch, [
        "eval", "-m", "hourglass_toy", "--workdir", wd, "--data-root",
        str(data), "--batch-size", "8"])
    _close(got, ref, {"loss"})
