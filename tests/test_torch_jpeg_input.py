"""The port's decoding input path against the JAX package's, on the CPU:
JPEG-store detection, pose and ImageNet records and the flat-folder
ImageNet layout read through the port give the reference's decoded
arrays and batches, byte for byte (both decode with PIL, or cv2's
reduced decode on ImageNet records on the uint8 wire, and resize with
cv2 here); ``cli.train --data-format folder --device cpu`` trains on the
reference loader's batches and its two losses match the JAX Trainer's
on them; without PIL every JPEG or folder read fails naming PIL.

Tolerances, each with its reason:

- Decoded images and ImageNet batches (uint8 and float32): exact.
- Detection and pose loader batches from JPEG records: exact where no
  resize was taken, within 1 grey level where one was: the port's
  loaders resize crops with torch's bilinear on every machine (the card
  has neither cv2 nor PIL), the reference with cv2 (as
  tests/test_torch_detection_train.py and test_torch_pose.py hold them).
- The two cli.train losses against the JAX Trainer's on the same
  batches and weights: within 1e-5 relative, the float32 bound of
  tests/test_torch_train.py's two-step check.

Each bound has a control that must fail it: a neighbouring record's
pixels, a full decode against the reduced one, rolled labels.
"""

import io
import json
import os
import sys

import numpy as np
import pytest
import torch

pytest.importorskip("PIL")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import _torch_port as port_tp  # noqa: E402
import _torch_prep as tp  # noqa: E402
from deep_vision_tpu.data import detection as jax_detection  # noqa: E402
from deep_vision_tpu.data import imagenet as jax_imagenet  # noqa: E402
from deep_vision_tpu.data import pose as jax_pose  # noqa: E402
from deep_vision_tpu.data import records as jax_records  # noqa: E402
from deep_vision_tpu_torch import convert  # noqa: E402
from deep_vision_tpu_torch.data import detection as port_detection  # noqa: E402
from deep_vision_tpu_torch.data import imagenet as port_imagenet  # noqa: E402
from deep_vision_tpu_torch.data import pose as port_pose  # noqa: E402
from deep_vision_tpu_torch.data import prep as port_prep  # noqa: E402
from deep_vision_tpu_torch.data import records as port_records  # noqa: E402

SIZE, RESIZE, BATCH = 32, 40, 4


def _equal_batches(got, want):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in w:
            assert g[k].dtype == w[k].dtype, k
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def _epochs(loader, epochs=(1, 2)):
    out = []
    for e in epochs:
        loader.set_epoch(e)
        out += list(loader)
    loader.close()
    return out


# -- detection and pose records of the JPEG store ------------------------------


def _write_both(tmp_path, write, samples, **kw):
    """The same samples through the port's and the reference's writer:
    the shards byte-identical; returns the reference's directory."""
    mine, ref = str(tmp_path / "mine"), str(tmp_path / "ref")
    getattr(port_records, write)(samples, mine, "train", 2, num_workers=1,
                                 **kw)
    getattr(jax_records, write)(samples, ref, "train", 2, num_workers=1,
                                **kw)
    tp.assert_same_tree(mine, ref)
    return ref


def test_jpeg_detection_records_equal_reference(tmp_path):
    samples = jax_detection.synthetic_detection_dataset(10, 64, 3, seed=2)
    # an encoded image given as it is, and one at another size
    buf = io.BytesIO()
    from PIL import Image

    Image.fromarray(samples[1]["image"][:40]).save(buf, format="PNG")
    samples[1] = dict(samples[1], image_bytes=buf.getvalue())
    del samples[1]["image"]
    root = _write_both(tmp_path, "write_detection_records", samples,
                       store="jpeg")
    got = port_records.load_detection_records(root, "train")
    want = jax_records.load_detection_records(root, "train")
    assert len(got) == len(want) == 10
    for g, w in zip(got, want):
        for k in ("image", "boxes", "classes"):
            np.testing.assert_array_equal(g[k], w[k])
    assert not np.array_equal(got[0]["image"], want[2]["image"])  # control
    for train in (False, True):
        kw = dict(train=train, seed=3, device_normalize=True)
        g = _epochs(port_detection.DetectionLoader(got, BATCH, 3, 64, **kw))
        w = _epochs(jax_detection.DetectionLoader(want, BATCH, 3, 64, **kw))
        exact = inexact = 0
        for a, b in zip(g, w):
            for k in b:
                if k != "image":
                    np.testing.assert_array_equal(a[k], b[k], err_msg=k)
            diff = np.abs(a["image"].astype(int) - b["image"].astype(int))
            assert diff.max() <= 1
            per = diff.reshape(len(diff), -1).max(1)
            exact += int((per == 0).sum())
            inexact += int((per > 0).sum())
        assert exact > 0
        if not train:  # no crop: only the 40-row image takes a resize
            assert inexact <= 2


def test_jpeg_pose_records_equal_reference(tmp_path):
    samples = jax_pose.synthetic_pose_dataset(6, 64, 16, seed=4)
    root = _write_both(tmp_path, "write_pose_records", samples,
                       store="jpeg")
    got = port_records.load_pose_records(root, "train")
    want = jax_records.load_pose_records(root, "train")
    for g, w in zip(got, want):
        for k in ("image", "keypoints", "center"):
            np.testing.assert_array_equal(g[k], w[k])
        assert g["scale"] == w["scale"]
    kw = dict(train=True, seed=5, device_normalize=True)
    g = _epochs(port_pose.PoseLoader(got, 2, 64, 16, 16, **kw))
    w = _epochs(jax_pose.PoseLoader(want, 2, 64, 16, 16, **kw))
    for a, b in zip(g, w):
        for k in b:
            if k != "image":
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        assert np.abs(a["image"].astype(int)
                      - b["image"].astype(int)).max() <= 1


# -- ImageNet: JPEG records and the flat folder --------------------------------


@pytest.fixture(scope="module")
def imagenet(tmp_path_factory):
    """A flat train folder (small images, and large ones that PIL's draft
    and cv2's reduced decode shrink 4x) with its metadata file, and the
    same images as JPEG-store records."""
    root = tmp_path_factory.mktemp("imagenet")
    flat = tp.imagenet_flat(root / "train", per_class=2)
    for s, syn in enumerate(tp.SYNSETS):
        tp.save_image(root / "train" / f"{syn}_big.JPEG", 170 + s, 200,
                      seed=900 + s)
    labels = tp.metadata(root / "meta.txt")
    recs = str(root / "recs")
    assert port_prep.prepare_imagenet(flat, labels, recs, "train",
                                      num_shards=2, num_workers=1) == 9
    return flat, labels, recs


@pytest.mark.parametrize("dev_norm", [True, False], ids=["uint8", "float"])
@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
@pytest.mark.parametrize("source", ["records", "folder"])
def test_imagenet_batches_equal_reference(imagenet, source, train,
                                          dev_norm):
    flat, labels, recs = imagenet
    kw = dict(train=train, image_size=SIZE, resize=RESIZE, seed=3,
              num_workers=0, device_normalize=dev_norm)
    ref_kw = dict(kw, process_index=0, process_count=1)
    if source == "records":
        got = port_imagenet.ImageNetLoader.from_records(recs, "train",
                                                        BATCH, **kw)
        want = jax_imagenet.ImageNetLoader.from_records(recs, "train",
                                                        BATCH, **ref_kw)
        assert got.ds.entries == want.ds.entries
    else:
        got = port_imagenet.ImageNetLoader(flat, labels, BATCH, **kw)
        want = jax_imagenet.ImageNetLoader(flat, labels, BATCH, **ref_kw)
        assert got.ds.files == want.ds.files
    np.testing.assert_array_equal(got.ds.labels, want.ds.labels)
    assert got.wire_dtype == want.wire_dtype
    _equal_batches(_epochs(got), _epochs(want))


def test_folder_dataset_and_synset_index_equal_reference(imagenet, tmp_path):
    flat, labels, _ = imagenet
    got = port_imagenet.ImageNetFolder(flat, labels)
    want = jax_imagenet.ImageNetFolder(flat, labels)
    assert got.files == want.files and len(got) == len(want) == 9
    np.testing.assert_array_equal(got.labels, want.labels)
    for i in range(len(got)):
        (a, la), (b, lb) = got.read(i), want.read(i)
        assert la == lb
        np.testing.assert_array_equal(a, b)
    meta = tmp_path / "meta.txt"
    meta.write_text("n1 a b\n\n  n2\tc\nn3\n")
    assert port_imagenet.load_synset_index(str(meta)) == \
        jax_imagenet.load_synset_index(str(meta)) == \
        {"n1": 0, "n2": 1, "n3": 2}


@pytest.mark.parametrize("kind", ["big", "small", "cmyk", "png"])
@pytest.mark.parametrize("fast", [True, False])
def test_decode_bytes_equals_reference(tmp_path, kind, fast):
    from PIL import Image

    rng = np.random.default_rng(6)
    h, w = (170, 200) if kind == "big" else (44, 52)
    img = Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8))
    if kind == "cmyk":
        img = img.convert("CMYK")
    buf = io.BytesIO()
    img.save(buf, format="PNG" if kind == "png" else "JPEG")
    data = buf.getvalue()
    for draft in (None, RESIZE):
        got = port_imagenet._decode_bytes(data, draft, fast)
        want = jax_imagenet._decode_bytes(data, draft, fast)
        assert got.dtype == np.uint8 and got.shape[2] == 3
        np.testing.assert_array_equal(got, want)
    if kind == "big":  # control: the reduced decode is another image
        assert port_imagenet._decode_bytes(data, RESIZE, fast).shape != \
            port_imagenet._decode_bytes(data, None, fast).shape


def test_unpaired_records_from_port_prep_equal_reference(tmp_path):
    from deep_vision_tpu.cli.train import _load_unpaired_records
    from deep_vision_tpu_torch.cli.train import load_unpaired_records

    da, db = tp.unpaired_dirs(tmp_path)
    out = str(tmp_path / "recs")
    assert port_prep.prepare_unpaired(da, db, out, num_shards=2,
                                      num_workers=1) == (3, 3)
    for dev_norm in (True, False):
        got = load_unpaired_records(out, 16, device_normalize=dev_norm)
        want = _load_unpaired_records(out, 16, device_normalize=dev_norm)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and g.shape[0] == 3
            np.testing.assert_array_equal(g, w)


# -- without PIL ---------------------------------------------------------------


def test_jpeg_and_folder_reads_without_pil_name_it(imagenet, tmp_path,
                                                   monkeypatch):
    from deep_vision_tpu_torch.cli import train as cli

    flat, labels, recs = imagenet
    samples = jax_detection.synthetic_detection_dataset(2, 32, 3, seed=1)
    det = str(tmp_path / "det")
    jax_records.write_detection_records(samples, det, "train", 1,
                                        num_workers=1, store="jpeg")
    raw = str(tmp_path / "raw")
    port_prep.prepare_imagenet(flat, labels, raw, "train", num_shards=1,
                               num_workers=1, store="raw", resize=RESIZE)
    monkeypatch.setitem(sys.modules, "PIL", None)
    monkeypatch.setitem(sys.modules, "PIL.Image", None)
    with pytest.raises(ImportError, match="needs PIL"):
        port_imagenet.ImageNetLoader(flat, labels, BATCH, num_workers=0)
    with pytest.raises(ImportError, match="needs PIL"):
        port_imagenet.ImageNetLoader.from_records(recs, "train", BATCH,
                                                  num_workers=0)
    with pytest.raises(ImportError, match="needs PIL"):
        port_records.load_detection_records(det, "train")[0]["image"]
    with pytest.raises(ImportError, match="needs PIL"):
        port_records.encode_detection_sample(samples[0], store="jpeg")
    data = tmp_path / "data"
    data.mkdir()
    os.symlink(flat, data / "train")
    os.symlink(flat, data / "val")
    os.symlink(labels, data / "imagenet_2012_metadata.txt")
    with pytest.raises(ImportError, match="needs PIL"):
        cli.main(["-m", "resnet50", "--data-root", str(data), "--workdir",
                  str(tmp_path / "w"), "--num-workers", "0", "--device",
                  "cpu"])
    # control: the raw store reads without a decoder
    batches = _epochs(port_imagenet.ImageNetLoader.from_records(
        raw, "train", BATCH, image_size=SIZE, resize=RESIZE,
        num_workers=0), (1,))
    assert batches[0]["image"].shape == (BATCH, SIZE, SIZE, 3)


# -- cli.train --data-format folder against the JAX Trainer --------------------


STAGES, BLOCK, CLASSES, LR = (1, 1, 1, 1), "BottleneckBlock", 10, 0.1
FOLDER_CONFIG = "torch_port_folder_tiny"


def _register():
    from deep_vision_tpu_torch.core import config as port_config
    from deep_vision_tpu_torch.core import optim as port_optim

    port_config.register_config(FOLDER_CONFIG)(
        lambda: port_config.TrainConfig(
            name=FOLDER_CONFIG,
            model=lambda: port_tp.port_model(STAGES, BLOCK, CLASSES),
            batch_size=BATCH, image_size=SIZE, num_classes=CLASSES,
            log_every_steps=1,
            optimizer=port_optim.OptimizerConfig(learning_rate=LR,
                                                 momentum=0.9,
                                                 weight_decay=1e-4),
            scheduler=port_config.SchedulerConfig(
                name="plateau",
                kwargs=dict(mode="max", factor=0.1, patience=10))))


def _jax_losses(variables, runs) -> list[list[float]]:
    """The JAX Trainer's step losses on each list of batches in ``runs``,
    each run from ``variables`` (SGD as the port's config, no device
    preprocess: float32 batches); one trainer, so one compile."""
    import tempfile

    from deep_vision_tpu.core.config import OptimizerConfig, TrainConfig
    from deep_vision_tpu.core.trainer import Trainer
    from deep_vision_tpu.parallel import make_mesh, replicate
    from deep_vision_tpu.tasks.classification import ClassificationTask

    model = port_tp.jax_model(STAGES, BLOCK, CLASSES)
    cfg = TrainConfig(name="parity", model=lambda: model, batch_size=BATCH,
                      image_size=SIZE, num_classes=CLASSES,
                      optimizer=OptimizerConfig(name="sgd", learning_rate=LR,
                                                momentum=0.9,
                                                weight_decay=1e-4))
    mesh = make_mesh({"data": 1}, devices=jax.devices()[:1])
    out = []
    with tempfile.TemporaryDirectory() as work:
        trainer = Trainer(cfg, model, ClassificationTask(CLASSES), mesh=mesh,
                          workdir=work)
        for batches in runs:
            state = trainer.init_state(batches[0])
            params = jax.tree_util.tree_map(jnp.asarray,
                                            variables["params"])
            state = replicate(state.replace(
                params=params,
                batch_stats=jax.tree_util.tree_map(
                    jnp.asarray, variables["batch_stats"]),
                opt_state=trainer.tx.init(params)), mesh)
            losses = []
            for b in batches:
                state, m = trainer.train_step(
                    state, {k: np.array(v) for k, v in b.items()})
                losses.append(float(m["loss"]))
            out.append(losses)
    return out


def _folder_root(tmp_path, imagenet) -> str:
    flat, labels, _ = imagenet
    data = tmp_path / "data"
    data.mkdir()
    os.symlink(flat, data / "train")
    val = tp.imagenet_flat(data / "val", per_class=1)
    assert len(os.listdir(val)) == 3
    os.symlink(labels, data / "imagenet_2012_metadata.txt")
    return str(data)


def _run_cli(data, work, monkeypatch, extra=()) -> tuple[list, list,
                                                        dict]:
    """cli.train for one epoch; (the batches of its train steps, the
    logged train losses, the model's state_dict before the first)."""
    from deep_vision_tpu_torch.cli import train as cli
    from deep_vision_tpu_torch.core.trainer import Trainer

    seen, start = [], {}
    real = Trainer.train_step

    def spy(self, state, batch):
        if not seen:
            start.update({k: v.detach().clone() for k, v in
                          state.model.state_dict().items()})
        seen.append({k: (v.numpy() if isinstance(v, torch.Tensor)
                         else np.asarray(v)).copy()
                     for k, v in batch.items()})
        return real(self, state, batch)

    monkeypatch.setattr(Trainer, "train_step", spy)
    argv = ["-m", FOLDER_CONFIG, "--data-root", data, "--workdir", work,
            "--num-workers", "0", "--device", "cpu", "--epochs", "1",
            *extra]
    assert cli.main(argv) == 0
    monkeypatch.undo()
    with open(os.path.join(work, "metrics.jsonl")) as f:
        lines = [json.loads(s) for s in f]
    return seen, [d["value"] for d in lines
                  if d["name"] == "train_loss"], start


def test_cli_train_folder_matches_jax_trainer(imagenet, tmp_path,
                                              monkeypatch):
    """Two steps from the flat folder: the batches the port trains on
    are the reference loader's, on the uint8 wire and host-normalized,
    and the host-normalized run's losses are the JAX Trainer's on them."""
    _register()
    data = _folder_root(tmp_path, imagenet)
    flat, labels, _ = imagenet
    from deep_vision_tpu_torch.core.config import get_config

    seed = get_config(FOLDER_CONFIG).seed
    for extra, dev_norm in (((), True), (("--host-normalize",), False)):
        work = str(tmp_path / f"work{int(dev_norm)}")
        seen, losses, start = _run_cli(data, work, monkeypatch, extra)
        want = jax_imagenet.ImageNetLoader(
            flat, labels, BATCH, train=True, image_size=SIZE,
            resize=RESIZE, seed=seed, num_workers=0, process_index=0,
            process_count=1, device_normalize=dev_norm)
        want.set_epoch(1)
        ref_batches = list(want)
        want.close()
        assert len(seen) == len(ref_batches) == 2 == len(losses)
        _equal_batches(seen, ref_batches)
        assert np.isfinite(losses).all()
    # the reference's step from the port's own init (the reference's
    # init scheme: the last BN scale of every block zero)
    variables = convert.import_torch_resnet(start, stage_sizes=STAGES,
                                            block=BLOCK)
    # control: the reference's step on rolled labels misses the bound
    rolled = [dict(b, label=np.roll(b["label"], 1)) for b in seen[:1]]
    jax_losses, (off,) = _jax_losses(variables, [seen, rolled])
    for g, w in zip(losses, jax_losses):
        assert abs(g - w) <= 1e-5 * abs(w), (losses, jax_losses)
    assert abs(losses[0] - off) > 1e-5 * abs(off)
