"""Synthetic raw dataset layouts for the data-preparation parity tests
(tests/test_torch_prep.py, test_torch_prepare_data_cli.py,
test_torch_jpeg_input.py, test_torch_native_reader.py): VOC XML, COCO
JSON, MPII JSON, a flat ImageNet directory (clean or dirty), the bbox XML
tree, the raw train and val downloads, two CycleGAN domains and a CelebA
attribute file, every image made with numpy and PIL from a seed."""

import io
import json
import os
import tarfile

import numpy as np
from PIL import Image

SYNSETS = ("n01440764", "n01443537", "n01484850")


def save_image(path, h, w, seed, fmt=None, mode="RGB"):
    rng = np.random.default_rng(seed)
    img = Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8))
    if mode != "RGB":
        img = img.convert(mode)
    img.save(path, format=fmt)


def voc_tree(root, split_lists=False) -> str:
    """``root/VOC2007/{Annotations,JPEGImages}`` with three images of two
    objects each (a dog, a person); ``split_lists`` adds
    ``ImageSets/Main/{train,val}.txt``."""
    base = os.path.join(root, "VOC2007")
    os.makedirs(os.path.join(base, "Annotations"))
    os.makedirs(os.path.join(base, "JPEGImages"))
    for i, (h, w) in enumerate(((100, 200), (120, 90), (64, 64))):
        name = f"img{i:03d}.jpg"
        save_image(os.path.join(base, "JPEGImages", name), h, w, seed=i)
        xml = f"""<annotation>
  <filename>{name}</filename>
  <size><width>{w}</width><height>{h}</height><depth>3</depth></size>
  <object><name>dog</name>
    <bndbox><xmin>{w // 10}</xmin><ymin>{h // 10}</ymin>
    <xmax>{w * 6 // 10}</xmax><ymax>{h * 8 // 10}</ymax></bndbox>
  </object>
  <object><name>person</name>
    <bndbox><xmin>{w // 2}</xmin><ymin>5</ymin><xmax>{w - 1}</xmax>
    <ymax>{h - 5}</ymax></bndbox>
  </object>
</annotation>"""
        with open(os.path.join(base, "Annotations", f"img{i:03d}.xml"),
                  "w") as f:
            f.write(xml)
    if split_lists:
        main = os.path.join(base, "ImageSets", "Main")
        os.makedirs(main)
        with open(os.path.join(main, "train.txt"), "w") as f:
            f.write("img000\nimg001\n")
        with open(os.path.join(main, "val.txt"), "w") as f:
            f.write("img002\n")
    return str(root)


def coco_tree(root) -> tuple[str, str]:
    """(instances JSON, image dir): sparse 1-based categories, two
    annotated images and one without annotations (not written)."""
    img_dir = os.path.join(root, "images")
    os.makedirs(img_dir)
    images = []
    for i, (h, w) in enumerate(((50, 100), (80, 60), (40, 40))):
        name = f"{i + 1:012d}.jpg"
        save_image(os.path.join(img_dir, name), h, w, seed=10 + i)
        images.append({"id": i + 1, "file_name": name, "width": w,
                       "height": h})
    coco = {
        "images": images,
        "categories": [{"id": 1, "name": "person"}, {"id": 17, "name": "cat"},
                       {"id": 90, "name": "toothbrush"}],
        "annotations": [
            {"image_id": 1, "category_id": 17, "bbox": [10, 5, 30, 20]},
            {"image_id": 1, "category_id": 1, "bbox": [50, 25, 40, 20]},
            {"image_id": 2, "category_id": 90, "bbox": [0, 0, 70, 90]},
        ],
    }
    anno = os.path.join(root, "instances.json")
    with open(anno, "w") as f:
        json.dump(coco, f)
    return anno, img_dir


def mpii_tree(root) -> tuple[str, str]:
    """(pose JSON, image dir): two people on images that exist, one on
    an image that does not (skipped)."""
    img_dir = os.path.join(root, "images")
    os.makedirs(img_dir)
    save_image(os.path.join(img_dir, "pose1.jpg"), 80, 80, seed=20)
    save_image(os.path.join(img_dir, "pose2.jpg"), 90, 120, seed=21)
    annos = [{"image": "pose1.jpg",
              "joints": [[10, 20], [-1, -1]] + [[5, 5]] * 14,
              "joints_visibility": [1, 0] + [1] * 14,
              "center": [40, 40], "scale": 0.8},
             {"image": "missing.jpg", "joints": [[0, 0]] * 16,
              "joints_visibility": [0] * 16},
             {"image": "pose2.jpg",
              "joints": [[float(3 * k), float(2 * k + 1)] for k in range(16)],
              "joints_visibility": [k % 3 for k in range(16)],
              "center": [60, 45], "scale": 0.4}]
    anno = os.path.join(root, "mpii.json")
    with open(anno, "w") as f:
        json.dump(annos, f)
    return anno, img_dir


def metadata(path, synsets=SYNSETS) -> str:
    """The metadata file: tab-separated "synset\\thuman" lines."""
    with open(path, "w") as f:
        f.write("".join(f"{s}\tclass {i}, label {i}\n"
                        for i, s in enumerate(synsets)))
    return str(path)


def imagenet_flat(root, per_class=3, shape=(40, 48)) -> str:
    """A flat ``synset_j.JPEG`` directory: ``per_class`` images of each
    of SYNSETS, odd sizes around ``shape``."""
    os.makedirs(root, exist_ok=True)
    h, w = shape
    for s, syn in enumerate(SYNSETS):
        for j in range(per_class):
            save_image(os.path.join(root, f"{syn}_{j}.JPEG"),
                       h + 4 * s + j, w - 3 * j + 2 * s, seed=100 * s + j)
    return str(root)


def imagenet_dirty(root) -> str:
    """A flat directory with one image of every kind the builder sorts:
    a clean JPEG, a PNG named .JPEG, a CMYK JPEG, a truncated JPEG, a
    grayscale JPEG and junk."""
    os.makedirs(root)
    rng = np.random.default_rng(0)
    arr = rng.integers(0, 255, (32, 36, 3), dtype=np.uint8)
    Image.fromarray(arr).save(os.path.join(root, "n01440764_0.JPEG"),
                              format="JPEG")
    Image.fromarray(arr).save(os.path.join(root, "n01440764_1.JPEG"),
                              format="PNG")
    Image.fromarray(arr).convert("CMYK").save(
        os.path.join(root, "n01443537_0.JPEG"), format="JPEG")
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="JPEG")
    with open(os.path.join(root, "n01443537_1.JPEG"), "wb") as f:
        f.write(buf.getvalue()[:int(len(buf.getvalue()) * 0.9)])
    Image.fromarray(arr).convert("L").save(
        os.path.join(root, "n01484850_0.JPEG"), format="JPEG")
    with open(os.path.join(root, "n01484850_1.JPEG"), "wb") as f:
        f.write(b"not an image at all")
    return str(root)


def bbox_tree(root) -> tuple[str, str]:
    """(bbox XML dir, synsets file): normal, inverted, out-of-bounds,
    degenerate, human-labelled and off-synset boxes, and an off-challenge
    synset directory."""
    xml_dir = os.path.join(root, "bbox")

    def write(path, objs, w=200, h=100):
        os.makedirs(os.path.dirname(path), exist_ok=True)
        body = "".join(
            f"<object><name>{n}</name><bndbox><xmin>{x1}</xmin>"
            f"<ymin>{y1}</ymin><xmax>{x2}</xmax><ymax>{y2}</ymax>"
            f"</bndbox></object>" for n, x1, y1, x2, y2 in objs)
        with open(path, "w") as f:
            f.write(f"<annotation><filename>%s</filename>"
                    f"<size><width>{w}</width><height>{h}</height>"
                    f"</size>{body}</annotation>")

    write(os.path.join(xml_dir, "n01440764", "n01440764_1.xml"),
          [("n01440764", 20, 10, 120, 80), ("n01440764", 160, 90, 40, 20),
           ("n01440764", -50, -10, 400, 150), ("n01440764", 20, 10, 20, 80)])
    write(os.path.join(xml_dir, "n01440764", "n01440764_2.xml"),
          [("Scottish_deerhound", 10, 10, 50, 50),
           ("n01443537", 10, 10, 50, 50)])
    write(os.path.join(xml_dir, "n09999999", "n09999999_1.xml"),
          [("n09999999", 10, 10, 50, 50)])
    os.makedirs(os.path.join(xml_dir, "n01443537"))
    with open(os.path.join(xml_dir, "n01443537", "n01443537_1.xml"),
              "w") as f:
        f.write("<annotation><unclosed>")
    synsets = os.path.join(root, "synsets.txt")
    with open(synsets, "w") as f:
        f.write("n01440764\nn01443537\n")
    return xml_dir, synsets


def raw_train_tree(root) -> str:
    """The raw train download: one synset as a tar, one as a directory."""
    raw = os.path.join(root, "raw_train")
    os.makedirs(os.path.join(raw, "n01443537"))
    save_image(os.path.join(raw, "n01443537", "n01443537_0.JPEG"), 16, 16,
               seed=30)
    tar_src = os.path.join(root, "tarsrc")
    os.makedirs(tar_src)
    for j in range(2):
        save_image(os.path.join(tar_src, f"n01440764_{j}.JPEG"), 16, 18,
                   seed=31 + j)
    with tarfile.open(os.path.join(raw, "n01440764.tar"), "w") as tf:
        for f in sorted(os.listdir(tar_src)):
            tf.add(os.path.join(tar_src, f), arcname=f)
    return raw


def raw_val_flat(root) -> tuple[str, str, str]:
    """(flat official val dir, 1-based ground truth, synsets list)."""
    raw = os.path.join(root, "raw_val")
    os.makedirs(raw)
    for j in range(3):
        save_image(os.path.join(raw, f"ILSVRC2012_val_{j + 1:08d}.JPEG"),
                   16, 16, seed=40 + j)
    gt = os.path.join(root, "gt.txt")
    with open(gt, "w") as f:
        f.write("2\n1\n2\n")
    synsets = os.path.join(root, "val_synsets.txt")
    with open(synsets, "w") as f:
        f.write("n01440764\nn01443537\n")
    return raw, gt, synsets


def raw_val_dirs(root) -> str:
    """The per-synset-directory val layout."""
    raw = os.path.join(root, "raw_val_dirs")
    for s, syn in enumerate(SYNSETS[:2]):
        os.makedirs(os.path.join(raw, syn))
        save_image(os.path.join(raw, syn, f"x{s}.JPEG"), 16, 16, seed=50 + s)
    return raw


def unpaired_dirs(root) -> tuple[str, str]:
    """Two domain directories: JPEGs and a PNG, and a file of another
    extension that the builder skips."""
    da, db = os.path.join(root, "a"), os.path.join(root, "b")
    os.makedirs(da)
    os.makedirs(db)
    for i in range(3):
        save_image(os.path.join(da, f"a{i}.jpg"), 24 + i, 30, seed=60 + i)
    for i in range(2):
        save_image(os.path.join(db, f"b{i}.jpeg"), 28, 20 + i, seed=70 + i)
    save_image(os.path.join(db, "b9.png"), 20, 20, seed=79, fmt="PNG")
    with open(os.path.join(db, "notes.txt"), "w") as f:
        f.write("skipped")
    return da, db


def celeba_tree(root) -> tuple[str, str]:
    """(list_attr_celeba.txt, image dir) with one listed file missing."""
    imgs = os.path.join(root, "celeba")
    os.makedirs(imgs)
    for f in ("1.jpg", "2.jpg", "3.jpg", "5.jpg"):
        save_image(os.path.join(imgs, f), 16, 16, seed=int(f[0]))
    attr = os.path.join(root, "attrs.txt")
    with open(attr, "w") as f:
        f.write("5\nSmiling Male\n1.jpg 1 1\n2.jpg 1 -1\n3.jpg -1 1\n"
                "4.jpg 1 1\n5.jpg -1 -1\n")
    return attr, imgs


def tree_bytes(root) -> dict:
    """relative path → file bytes (or ``-> target`` for a symlink)."""
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            p = os.path.join(d, f)
            rel = os.path.relpath(p, root)
            if os.path.islink(p):
                out[rel] = "-> " + os.readlink(p)
            else:
                with open(p, "rb") as fh:
                    out[rel] = fh.read()
    return out


def assert_same_tree(a, b) -> dict:
    """Both directories hold the same files, byte for byte; returns one."""
    ta, tb = tree_bytes(a), tree_bytes(b)
    assert sorted(ta) == sorted(tb)
    for k in ta:
        assert ta[k] == tb[k], k
    return ta
