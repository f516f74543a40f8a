"""The port's offline data preparation (deep_vision_tpu_torch/data/prep.py
and the JPEG store of data/records.py) against the JAX package's, on the
synthetic layouts of tests/_torch_prep.py: every builder of
tests/test_prep.py runs through both packages into two directories, and
the shards must be byte-identical, headers and payloads, for both
stores (``jpeg`` and ``raw``).  The port's shards are then read back
with the port's readers and checked as tests/test_prep.py checks the
reference's."""

import io
import os

import numpy as np
import pytest

pytest.importorskip("PIL")
from PIL import Image  # noqa: E402

import _torch_prep as tp  # noqa: E402
from deep_vision_tpu.data import prep as jax_prep  # noqa: E402
from deep_vision_tpu_torch.data import prep as port_prep  # noqa: E402
from deep_vision_tpu_torch.data.records import (  # noqa: E402
    list_shards,
    load_detection_records,
    load_pose_records,
    read_records,
)

STORES = ("jpeg", "raw")


def _both(tmp_path, build, *args, **kwargs):
    """Run ``build`` of both packages into ``mine`` and ``ref``; their
    results must be equal and their trees byte-identical."""
    mine, ref = str(tmp_path / "mine"), str(tmp_path / "ref")
    got = getattr(port_prep, build)(*args, mine, **kwargs)
    want = getattr(jax_prep, build)(*args, ref, **kwargs)
    assert got == want
    tp.assert_same_tree(mine, ref)
    return mine, got


@pytest.mark.parametrize("store", STORES)
@pytest.mark.parametrize("split_lists", [False, True])
def test_voc_shards_equal_reference(tmp_path, store, split_lists):
    root = tp.voc_tree(tmp_path / "src", split_lists)
    splits = {"train": 2, "val": 1} if split_lists else {"train": 3}
    for split, n in splits.items():
        mine, got = _both(tmp_path / split, "prepare_voc", root, split=split,
                          num_shards=2, num_workers=1, store=store)
        assert got == n
    split = "val" if split_lists else "train"
    samples = load_detection_records(mine, split)
    for s in samples:
        assert s["boxes"].shape == (2, 4)
        assert s["classes"].tolist() == [11, 14]  # dog, person
    shapes = sorted(s["image"].shape for s in samples)
    if store == "raw":
        assert shapes == [(416, 416, 3)] * len(samples)
    elif split_lists:
        assert shapes == [(64, 64, 3)]  # img002 alone
        np.testing.assert_allclose(samples[0]["boxes"][0],
                                   [0.09375, 0.09375, 0.59375, 0.796875])
    else:
        assert shapes == [(64, 64, 3), (100, 200, 3), (120, 90, 3)]


@pytest.mark.parametrize("store", STORES)
def test_coco_shards_equal_reference(tmp_path, store):
    anno, images = tp.coco_tree(tmp_path)
    mine, n = _both(tmp_path, "prepare_coco", anno, images, split="val",
                    num_shards=1, num_workers=1, store=store, resize=64)
    assert n == 2  # the image without annotations is not written
    first, second = load_detection_records(mine, "val")
    assert first["classes"].tolist() == [1, 0]  # 17 → 1, 1 → 0
    np.testing.assert_allclose(first["boxes"][0], [0.1, 0.1, 0.4, 0.5],
                               atol=1e-6)
    assert second["classes"].tolist() == [2]
    np.testing.assert_allclose(second["boxes"][0], [0, 0, 1, 1])  # clipped
    assert first["image"].shape == ((64, 64, 3) if store == "raw"
                                    else (50, 100, 3))


@pytest.mark.parametrize("store", STORES)
def test_mpii_shards_equal_reference(tmp_path, store):
    anno, images = tp.mpii_tree(tmp_path)
    mine, n = _both(tmp_path, "prepare_mpii", anno, images, split="train",
                    num_shards=2, num_workers=1, store=store, resize=48)
    assert n == 2  # the missing image is skipped
    by_shape = {tuple(s["image"].shape): s
                for s in load_pose_records(mine, "train")}
    s = by_shape[(48, 48, 3) if store == "raw" else (80, 80, 3)]
    assert s["keypoints"].shape == (16, 3)
    f = 48 / 80 if store == "raw" else 1.0
    np.testing.assert_allclose(s["keypoints"][0], [10 * f, 20 * f, 2.0],
                               rtol=1e-6)  # visibility 1 → 2
    assert s["keypoints"][1][2] == 0.0
    assert s["scale"] == pytest.approx(0.8 * f)


@pytest.mark.parametrize("store", STORES)
def test_imagenet_shards_equal_reference(tmp_path, store):
    src = tp.imagenet_flat(tmp_path / "flat")
    labels = tp.metadata(tmp_path / "meta.txt")
    mine, n = _both(tmp_path, "prepare_imagenet", src, labels,
                    split="train", num_shards=2, num_workers=1, store=store,
                    resize=36)
    assert n == 9
    shards = list_shards(mine, "train")
    assert len(shards) == 2
    headers = [h for sh in shards for h, _ in read_records(sh)]
    assert sorted(h["label"] for h in headers) == [0] * 3 + [1] * 3 + [2] * 3
    assert all(h["human"].startswith("class ") for h in headers)
    if store == "raw":
        assert all(min(h["shape"][:2]) == 36 and h["enc"] == "raw"
                   for h in headers)


@pytest.mark.parametrize("store", STORES)
def test_dirty_imagenet_dir_equal_reference(tmp_path, store):
    """Content classification: a PNG named .JPEG, CMYK, truncated and
    grayscale files are re-encoded (or decoded once for the raw store),
    the junk file dropped, by both packages alike."""
    src = tp.imagenet_dirty(tmp_path / "flat")
    labels = tp.metadata(tmp_path / "meta.txt")
    mine, n = _both(tmp_path, "prepare_imagenet", src, labels,
                    split="train", num_shards=1, num_workers=1, store=store,
                    resize=32)
    assert n == 5
    recs = [(h, p) for sh in list_shards(mine, "train")
            for h, p in read_records(sh)]
    if store == "jpeg":
        for _, payload in recs:
            img = Image.open(io.BytesIO(payload))
            img.load()
            assert img.mode == "RGB" and img.format == "JPEG"
        assert sum(bool(h.get("reencoded")) for h, _ in recs) == 4
    else:
        assert all(h["enc"] == "raw" for h, _ in recs)


@pytest.mark.parametrize("payload,status", [
    ("clean", "ok"), ("png", "reencoded"), ("cmyk", "reencoded"),
    ("junk", "bad")])
def test_sanitize_and_robust_decode_equal_reference(tmp_path, payload,
                                                    status):
    src = tp.imagenet_dirty(tmp_path / "flat")
    name = {"clean": "n01440764_0", "png": "n01440764_1",
            "cmyk": "n01443537_0", "junk": "n01484850_1"}[payload]
    with open(os.path.join(src, f"{name}.JPEG"), "rb") as f:
        data = f.read()
    got, want = port_prep.sanitize_image(data), jax_prep.sanitize_image(data)
    assert got == want and got[1] == status
    a, b = port_prep.decode_image_robust(data), \
        jax_prep.decode_image_robust(data)
    if status == "bad":
        assert a is None and b is None
    else:
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("store", STORES)
def test_bboxes_csv_and_headers_equal_reference(tmp_path, store):
    xml_dir, synsets = tp.bbox_tree(tmp_path)
    out = {}
    for tag, mod in (("mine", port_prep), ("ref", jax_prep)):
        csv = str(tmp_path / f"{tag}.csv")
        out[tag] = (mod.process_imagenet_bboxes(xml_dir, csv, synsets),
                    open(csv).read(), mod.load_bbox_csv(csv))
    assert out["mine"] == out["ref"]
    stats, _, rows = out["mine"]
    assert stats == {"files": 2, "boxes": 4, "skipped_files": 2,
                     "skipped_boxes": 2}
    np.testing.assert_allclose(rows["n01440764_1.JPEG"][1],
                               [0.2, 0.2, 0.8, 0.9], atol=1e-4)
    src = tmp_path / "flat"
    src.mkdir()
    tp.save_image(src / "n01440764_1.JPEG", 32, 32, seed=1)
    tp.save_image(src / "n01440764_7.JPEG", 32, 40, seed=2)
    labels = tp.metadata(tmp_path / "meta.txt")
    mine, n = _both(tmp_path / "recs", "prepare_imagenet", str(src), labels,
                    split="train", num_shards=1, num_workers=1,
                    bbox_csv=str(tmp_path / "mine.csv"), store=store)
    headers = {h["filename"]: h for sh in list_shards(mine, "train")
               for h, _ in read_records(sh)}
    assert len(headers["n01440764_1.JPEG"]["bboxes"]) == 3
    assert "bboxes" not in headers["n01440764_7.JPEG"]


def test_flatten_train_equal_reference(tmp_path):
    raw = tp.raw_train_tree(tmp_path)
    mine, n = _both(tmp_path, "flatten_imagenet_train", raw)
    assert n == 3
    assert sorted(os.listdir(mine)) == [
        "n01440764_0.JPEG", "n01440764_1.JPEG", "n01443537_0.JPEG"]
    # idempotent: a second run places nothing
    assert port_prep.flatten_imagenet_train(raw, mine) == 0


@pytest.mark.parametrize("layout", ["flat", "dirs"])
def test_flatten_val_equal_reference(tmp_path, layout):
    if layout == "flat":
        raw, gt, synsets = tp.raw_val_flat(tmp_path)
        mine, n = _both(tmp_path, "flatten_imagenet_val", raw,
                        ground_truth=gt, synsets_file=synsets)
        assert n == 3
        assert sorted(os.listdir(mine))[0] == \
            "n01440764_ILSVRC2012_val_00000002.JPEG"
    else:
        raw = tp.raw_val_dirs(tmp_path)
        mine, n = _both(tmp_path, "flatten_imagenet_val", raw)
        assert sorted(os.listdir(mine)) == ["n01440764_x0.JPEG",
                                            "n01443537_x1.JPEG"]


@pytest.mark.parametrize("case", ["no_ground_truth", "count", "zero_based"])
def test_flatten_val_refusals_equal_reference(tmp_path, case):
    raw, gt, synsets = tp.raw_val_flat(tmp_path)
    if case == "no_ground_truth":
        gt = None
    else:
        with open(gt, "w") as f:
            f.write("1\n2\n" if case == "count" else "0\n1\n1\n")
    errors = []
    for mod in (port_prep, jax_prep):
        with pytest.raises(ValueError) as e:
            mod.flatten_imagenet_val(raw, str(tmp_path / "out"), gt, synsets)
        errors.append(str(e.value))
    assert errors[0] == errors[1]


def test_unpaired_and_celeba_equal_reference(tmp_path):
    da, db = tp.unpaired_dirs(tmp_path)
    mine, n = _both(tmp_path / "unpaired", "prepare_unpaired", da, db,
                    split="train", num_shards=2, num_workers=1)
    assert n == (3, 3)
    assert list_shards(mine, "train_a") and list_shards(mine, "train_b")
    attr, imgs = tp.celeba_tree(tmp_path)
    got = port_prep.split_celeba_by_attribute(
        attr, imgs, str(tmp_path / "m1"), str(tmp_path / "f1"), "Male")
    want = jax_prep.split_celeba_by_attribute(
        attr, imgs, str(tmp_path / "m2"), str(tmp_path / "f2"), "Male")
    assert got == want == (2, 2)  # 4.jpg is missing
    for a, b in (("m1", "m2"), ("f1", "f2")):
        tp.assert_same_tree(tmp_path / a, tmp_path / b)


def test_pooled_writer_equals_inline_reference(tmp_path):
    """Two shard-writer processes (the port's spawn pool pickles the
    module-level encoder) write what the reference writes inline."""
    src = tp.imagenet_flat(tmp_path / "flat")
    labels = tp.metadata(tmp_path / "meta.txt")
    mine, ref = str(tmp_path / "mine"), str(tmp_path / "ref")
    assert port_prep.prepare_imagenet(src, labels, mine, num_shards=2,
                                      num_workers=2, store="raw",
                                      resize=36) == 9
    assert jax_prep.prepare_imagenet(src, labels, ref, num_shards=2,
                                     num_workers=1, store="raw",
                                     resize=36) == 9
    tp.assert_same_tree(mine, ref)


def test_class_names_and_voc_xml_equal_reference(tmp_path):
    root = tp.voc_tree(tmp_path)
    names = tmp_path / "names.txt"
    names.write_text("person\n\ndog\n")
    for path in (None, str(names)):
        assert port_prep.load_class_names(path) == \
            jax_prep.load_class_names(path)
    xml = os.path.join(root, "VOC2007", "Annotations", "img001.xml")
    got = port_prep.parse_voc_xml(xml, port_prep.load_class_names(None))
    want = jax_prep.parse_voc_xml(xml, jax_prep.load_class_names(None))
    assert got["filename"] == want["filename"]
    for k in ("boxes", "classes"):
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])
    meta = tp.metadata(tmp_path / "meta.txt")
    assert port_prep.load_synset_humans(meta) == \
        jax_prep.load_synset_humans(meta)
