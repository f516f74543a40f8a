"""The host preprocessing pipelines (``--host-normalize``,
``--tf-preprocessing``) against the reference's: the float32
transforms for the same seeds, the ImageNet records loader's float32 and
TF batches pooled and inline, the MNIST, detection, pose and GAN
loaders' float32 wires, the flags' exclusion, and ``cli.train`` with
either flag training and resuming without ever calling
``train_ingest``."""

import json
import os

import numpy as np
import pytest
import torch

from deep_vision_tpu.data import detection as jax_det
from deep_vision_tpu.data import imagenet as jax_imagenet
from deep_vision_tpu.data import mnist as jax_mnist
from deep_vision_tpu.data import pose as jax_pose
from deep_vision_tpu.data import transforms as jax_T
from deep_vision_tpu_torch.core import config as port_config
from deep_vision_tpu_torch.data import detection as port_det
from deep_vision_tpu_torch.data import imagenet as port_imagenet
from deep_vision_tpu_torch.data import mnist as port_mnist
from deep_vision_tpu_torch.data import pose as port_pose
from deep_vision_tpu_torch.data import transforms as port_T
from deep_vision_tpu_torch.data.records import RecordWriter, shard_name


def _img(seed, shape=(40, 48, 3)):
    return np.random.default_rng(seed).integers(0, 256, shape, np.uint8)


@pytest.mark.parametrize("seed", range(6))
def test_float_transforms_equal_reference(seed):
    img = _img(seed)
    x = img.astype(np.float32) / 255.0
    for a, b in ((img, img), (x, x)):
        np.testing.assert_array_equal(
            port_T.color_jitter(a, np.random.default_rng(seed)),
            jax_T.color_jitter(b, np.random.default_rng(seed)))
    np.testing.assert_array_equal(
        port_T.train_transform(img, np.random.default_rng(seed), 32, 40),
        jax_T.train_transform(img, np.random.default_rng(seed), 32, 40))
    np.testing.assert_array_equal(
        port_T.train_transform(img, np.random.default_rng(seed), 32, 40,
                               jitter=False),
        jax_T.train_transform(img, np.random.default_rng(seed), 32, 40,
                              jitter=False))
    np.testing.assert_array_equal(
        port_T.tf_train_transform(img, np.random.default_rng(seed), 32, 40),
        jax_T.tf_train_transform(img, np.random.default_rng(seed), 32, 40))
    np.testing.assert_array_equal(port_T.tf_eval_transform(img, 32, 40),
                                  jax_T.tf_eval_transform(img, 32, 40))
    np.testing.assert_array_equal(port_T.TF_CHANNEL_MEANS,
                                  jax_T.TF_CHANNEL_MEANS)
    # the uint8 sniff: a [0, 1] image is not scaled again
    np.testing.assert_array_equal(port_T.normalize(x), jax_T.normalize(x))
    np.testing.assert_array_equal(port_T.normalize(img),
                                  jax_T.normalize(img))


def _write_records(root, n_train=10, n_val=5, side=40, seed=0):
    rng = np.random.default_rng(seed)
    for split, n in (("train", n_train), ("val", n_val)):
        with RecordWriter(shard_name(str(root), split, 0, 1)) as w:
            for i in range(n):
                img = rng.integers(0, 256, (side, side, 3), dtype=np.uint8)
                w.write({"label": int(i % 7), "enc": "raw",
                         "shape": [side, side, 3]}, img.tobytes())


def _assert_batches_equal(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert set(a) == set(b)
        for k in b:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("preprocessing,dev_norm", [("torch", False),
                                                    ("tf", False)])
@pytest.mark.parametrize("train", [True, False])
def test_records_loader_float_batches_equal_reference(
        tmp_path, preprocessing, dev_norm, train):
    _write_records(tmp_path)
    split = "train" if train else "val"
    kw = dict(train=train, image_size=32, resize=40, seed=3,
              device_normalize=dev_norm, preprocessing=preprocessing)
    want = jax_imagenet.ImageNetLoader.from_records(
        str(tmp_path), split, 4, num_workers=0, process_index=0,
        process_count=1, **kw)
    inline = port_imagenet.ImageNetLoader.from_records(
        str(tmp_path), split, 4, num_workers=0, **kw)
    pooled = port_imagenet.ImageNetLoader.from_records(
        str(tmp_path), split, 4, num_workers=2, **kw)
    try:
        assert inline.wire_dtype == pooled.wire_dtype == want.wire_dtype \
            == np.float32
        for epoch in (1, 2):
            for loader in (want, inline, pooled):
                loader.set_epoch(epoch)
            w = list(want)
            assert w[0]["image"].dtype == np.float32
            _assert_batches_equal(list(inline), w)
            _assert_batches_equal(list(pooled), w)
    finally:
        for loader in (want, inline, pooled):
            loader.close()


def test_records_loader_refuses_what_the_reference_refuses(tmp_path):
    _write_records(tmp_path)
    ds = port_imagenet.ImageNetRecords(str(tmp_path), "train")
    with pytest.raises(ValueError, match="preprocessing must be torch|tf"):
        port_imagenet.ImageNetLoader(ds, 4, preprocessing="keras",
                                     num_workers=0)
    with pytest.raises(ValueError, match="host-side only"):
        port_imagenet.ImageNetLoader(ds, 4, preprocessing="tf",
                                     device_normalize=True, num_workers=0)
    assert port_imagenet.ImageNetLoader(ds, 4, num_workers=0).wire_dtype \
        == np.uint8


def test_mnist_host_normalized_equals_reference(tmp_path):
    raw = np.random.default_rng(0).integers(0, 256, (12, 28, 28), np.uint8)
    labels = np.arange(12, dtype=np.uint8) % 10
    port_mnist.write_idx(str(tmp_path), "train", raw, labels)
    for dev_norm in (False, True):
        got = port_mnist.load_mnist(str(tmp_path), "train",
                                    device_normalize=dev_norm)
        want = jax_mnist.load_mnist(str(tmp_path), "train",
                                    device_normalize=dev_norm)
        for k in want:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])


def _floats_follow_u8(make, epochs=(1, 2)):
    """A loader's float32 wire is its uint8 wire / 255 with the same
    draws, batch for batch (the uint8 wire is held against the
    reference's by the task's loader tests)."""
    f32, u8 = make(False), make(True)
    for epoch in epochs:
        f32.set_epoch(epoch)
        u8.set_epoch(epoch)
        for a, b in zip(list(f32), list(u8)):
            assert a["image"].dtype == np.float32
            assert b["image"].dtype == np.uint8
            np.testing.assert_array_equal(
                a["image"], b["image"].astype(np.float32) / 255.0)
            for k in b:
                if k != "image":
                    np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_detection_and_pose_host_normalized_loaders(tmp_path):
    det = jax_det.synthetic_detection_dataset(6, 64, 3, seed=1)
    poses = jax_pose.synthetic_pose_dataset(6, 64, 16, seed=2)
    for train in (True, False):
        _floats_follow_u8(lambda dn: port_det.DetectionLoader(
            det, 2, 3, 64, train=train, seed=5, device_normalize=dn))
        _floats_follow_u8(lambda dn: port_pose.PoseLoader(
            poses, 2, 64, 16, 16, train=train, seed=5, device_normalize=dn))
    # eval batches at the stored size need no resize: equal to the
    # reference's float32 batches exactly
    for mod_p, mod_j, make in (
            (port_det, jax_det, lambda m: m.DetectionLoader(
                det, 2, 3, 64, train=False, device_normalize=False)),
            (port_det, jax_det, lambda m: m.CenterNetLoader(
                det, 2, 3, 64, train=False, device_normalize=False))):
        _assert_batches_equal(list(make(mod_p)), list(make(mod_j)))


def test_gan_host_normalized_data_equals_reference():
    from deep_vision_tpu.data import gan as jax_gan
    from deep_vision_tpu_torch.data import gan as port_gan

    got = port_gan.mnist_gan_data(None, n_synthetic=8, device_normalize=False)
    want = jax_gan.mnist_gan_data(None, n_synthetic=8, device_normalize=False)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    for g, w in zip(port_gan.synthetic_unpaired(3, 16, device_normalize=False),
                    jax_gan.synthetic_unpaired(3, 16, device_normalize=False)):
        np.testing.assert_array_equal(g, w)


CLASSES = 7


def _register_tiny():
    from deep_vision_tpu_torch.core import optim as port_optim
    from deep_vision_tpu_torch.models.resnet import BottleneckBlock, ResNet

    port_config.register_config("torch_port_host_tiny")(
        lambda: port_config.TrainConfig(
            name="torch_port_host_tiny",
            model=lambda: ResNet((1,), BottleneckBlock, CLASSES,
                                 torch.float32),
            batch_size=4, image_size=32, num_classes=CLASSES,
            log_every_steps=1,
            optimizer=port_optim.OptimizerConfig(learning_rate=0.01,
                                                 momentum=0.9)))


@pytest.mark.parametrize("flag", ["--host-normalize", "--tf-preprocessing",
                                  None])
def test_cli_train_host_pipelines_never_call_train_ingest(tmp_path, capsys,
                                                          monkeypatch, flag):
    """Train one epoch and resume a second on tiny records; a spy counts
    ``train_ingest`` calls: none under either flag, one a step on the
    uint8 wire (the control)."""
    from deep_vision_tpu_torch.cli import train as cli
    from deep_vision_tpu_torch.ops import preprocess

    _register_tiny()
    calls = []
    real = preprocess.train_ingest

    def spy(images, factors):
        calls.append(images.dtype)
        return real(images, factors)

    monkeypatch.setattr(preprocess, "train_ingest", spy)
    data, work = tmp_path / "data", tmp_path / "work"
    _write_records(data, n_train=8, n_val=6)
    argv = ["-m", "torch_port_host_tiny", "--data-root", str(data),
            "--workdir", str(work), "--num-workers", "0", "--device", "cpu"]
    argv += [flag] if flag else []
    assert cli.main(argv + ["--epochs", "1"]) == 0
    assert cli.main(argv + ["--epochs", "2", "--resume"]) == 0
    out = capsys.readouterr().out
    assert "[resume] restored step=2 start_epoch=2" in out
    lines = [json.loads(s) for s in
             (work / "metrics.jsonl").read_text().splitlines()]
    losses = [d["value"] for d in lines if d["name"] == "train_loss"]
    assert len(losses) == 4 and np.all(np.isfinite(losses))
    h2d = [d["value"] for d in lines
           if d["name"] == "input_h2d_bytes_per_step"]
    pixels = 4 * 32 * 32 * 3
    if flag:
        assert calls == []
        assert h2d == [4 * pixels + 16] * 2  # float32 images + labels
    else:
        assert calls == [torch.uint8] * 4
        assert h2d == [pixels + 16] * 2
    assert os.listdir(work / "tensorboard")


def test_cli_train_refuses_both_host_pipelines(tmp_path):
    from deep_vision_tpu_torch.cli import train as cli

    _register_tiny()
    _write_records(tmp_path)
    with pytest.raises(SystemExit, match="contradictory pipelines"):
        cli.main(["-m", "torch_port_host_tiny", "--data-root",
                  str(tmp_path), "--host-normalize", "--tf-preprocessing",
                  "--num-workers", "0", "--workdir", str(tmp_path / "w"),
                  "--device", "cpu"])


def test_cli_train_refuses_profile_on_a_gan_task(tmp_path):
    """A departure from the reference, whose ``_main_gan`` accepts
    ``--profile`` and never traces: the port refuses it, so a run never
    believes it was traced."""
    from deep_vision_tpu_torch.cli import train as cli

    with pytest.raises(SystemExit, match="--profile is not ported for "
                                         "the GAN tasks"):
        cli.main(["-m", "dcgan", "--synthetic", "--profile", "--workdir",
                  str(tmp_path), "--device", "cpu"])
    assert not os.path.exists(tmp_path / "checkpoints")
