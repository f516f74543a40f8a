"""Dataset preparation: raw downloads → dvrec shards.

Copy of ``deep_vision_tpu/data/prep.py``; the shards it writes are byte
for byte the reference's:

- VOC: XML annotations → normalized corner boxes, the split lists of
  ``ImageSets/Main`` honoured;
- COCO: instances JSON → per-image grouped boxes, 1-based sparse
  category ids re-indexed to dense 0-based, xywh → corners;
- MPII: pose JSON → pixel keypoints with visibility remapped to 0 / 2;
- ImageNet: a flat ``synset_*.JPEG`` directory → classification shards,
  each image classified by content (``sanitize_image``: clean,
  re-encoded or dropped), synset, human label and boxes in the header;
  ``process_imagenet_bboxes`` writes the bbox CSV, and
  ``flatten_imagenet_train`` / ``flatten_imagenet_val`` turn the raw
  downloads into the flat layout;
- CycleGAN: two domain directories → ``<split>_a`` / ``<split>_b``
  shards, and the CelebA split by one attribute.

``store="jpeg"`` (the default) keeps the encoded image; ``store="raw"``
decodes once and stores uint8 pixels at the loader's size, which a
machine without a decoder reads.  Preparation decodes and encodes with
PIL (and resizes with cv2, else PIL).  Shards fan out over
``records.write_sharded``'s process pool.
"""

from __future__ import annotations

import json
import os
import xml.etree.ElementTree as ET

import numpy as np

from deep_vision_tpu_torch.data import records as R


def _pil(what: str):
    """``(PIL.Image, PIL.ImageFile)``, or an ImportError naming PIL."""
    Image = R.require_pil(what)
    from PIL import ImageFile

    return Image, ImageFile


def sanitize_image(payload: bytes) -> tuple[bytes, str]:
    """Build-time image hardening → (clean JPEG bytes, status).

    The reference handled ImageNet's dirty files with hard-coded filename
    blacklists (PNG-as-.JPEG ``_is_png`` build_imagenet_tfrecord.py:272-283,
    CMYK JPEGs ``_is_cmyk`` :286-309) re-encoded through a TF session
    (``ImageCoder`` :236-270).  We detect by CONTENT instead of filename, so
    any dirty file is caught, not just the 23 known ones:

    - clean RGB JPEG → bytes pass through untouched (status ``ok``);
    - PNG/CMYK/grayscale/palette/alpha → decoded + re-encoded as RGB JPEG
      quality 100, matching the ImageCoder settings (status ``reencoded``);
    - truncated-but-salvageable → partial decode re-encoded (``reencoded``);
    - undecodable → status ``bad`` (caller drops the file so shards are
      100% readable instead of throwing mid-epoch).
    """
    import io

    Image, ImageFile = _pil("sanitizing an image")
    try:
        with Image.open(io.BytesIO(payload)) as im:
            if im.format == "JPEG" and im.mode == "RGB":
                im.load()  # full decode — catches truncation up front
                return payload, "ok"
    except Exception:  # noqa: BLE001 — any decode error falls through to the salvage path
        pass
    old = ImageFile.LOAD_TRUNCATED_IMAGES
    ImageFile.LOAD_TRUNCATED_IMAGES = True
    try:
        with Image.open(io.BytesIO(payload)) as im:
            rgb = im.convert("RGB")
        buf = io.BytesIO()
        rgb.save(buf, format="JPEG", quality=100)
        return buf.getvalue(), "reencoded"
    except Exception:  # noqa: BLE001 — undecodable even with truncation allowed: drop the sample
        return b"", "bad"
    finally:
        ImageFile.LOAD_TRUNCATED_IMAGES = old


def decode_image_robust(payload: bytes) -> np.ndarray | None:
    """One decode with sanitize_image's salvage semantics: any format →
    RGB uint8 HWC; truncated files partially decode; undecodable → None."""
    import io

    Image, ImageFile = _pil("decoding an image")
    old = ImageFile.LOAD_TRUNCATED_IMAGES
    ImageFile.LOAD_TRUNCATED_IMAGES = True
    try:
        with Image.open(io.BytesIO(payload)) as im:
            return np.asarray(im.convert("RGB"))
    except Exception:  # noqa: BLE001 — undecodable payload maps to None by contract
        return None
    finally:
        ImageFile.LOAD_TRUNCATED_IMAGES = old


# encoders must be MODULE-LEVEL: they are pickled into the shard-writer
# process pool (local closures are not picklable)
def _encode_imagenet_item(item, store: str = "jpeg", resize: int = 256):
    """(path, label, synset, human, bboxes) → (header, payload) or None
    to drop an undecodable file (records._write_shard skips None).

    ``store`` picks the payload encoding:

    - ``jpeg``: the sanitized original JPEG — archival fidelity, decode at
      read time (the TFRecord builder's semantics,
      build_imagenet_tfrecord.py:472-689);
    - ``raw``: decode ONCE at build time, aspect-preserving rescale of the
      shorter side to ``resize``, store raw uint8 HWC — the read path is
      then decode-free (frombuffer + crop, or the native reader,
      ``data/native``), and needs no decoder.
      Train-time augmentation (random crop + flip) is unchanged: it
      operates on the rescaled image in both paths.
    """
    path, label, synset, human, bboxes = item
    with open(path, "rb") as f:
        payload = f.read()
    header = {"label": int(label), "filename": os.path.basename(path),
              "synset": synset, "human": human}
    if bboxes:
        header["bboxes"] = bboxes
    if store == "raw":
        # raw stores decoded pixels, so sanitize's JPEG re-encode step is
        # moot — decode ONCE (salvaging truncated files like
        # sanitize_image does), rescale, store
        img = decode_image_robust(payload)
        if img is None:
            print(f"[prep] dropping undecodable image {path}", flush=True)
            return None
        from deep_vision_tpu_torch.data.transforms import rescale

        img = np.ascontiguousarray(rescale(img, resize))
        header["shape"] = list(img.shape)
        header["enc"] = "raw"
        return header, img.tobytes()
    clean, status = sanitize_image(payload)
    if status == "bad":
        print(f"[prep] dropping undecodable image {path}", flush=True)
        return None
    if status == "reencoded":
        header["reencoded"] = True
    return header, clean


def _encode_file(path):
    with open(path, "rb") as f:
        return {"filename": os.path.basename(path)}, f.read()


VOC_CLASSES = (
    "aeroplane", "bicycle", "bird", "boat", "bottle", "bus", "car", "cat",
    "chair", "cow", "diningtable", "dog", "horse", "motorbike", "person",
    "pottedplant", "sheep", "sofa", "train", "tvmonitor")


def load_class_names(path: str | None, default=VOC_CLASSES) -> dict[str, int]:
    """names file (one class per line — voc_2007_names.txt style) → map."""
    if path is None:
        return {n: i for i, n in enumerate(default)}
    with open(path) as f:
        return {line.strip(): i for i, line in enumerate(f) if line.strip()}


def parse_voc_xml(xml_path: str, names_map: dict[str, int]) -> dict:
    """One VOC annotation → sample dict with NORMALIZED corner boxes
    (reference parse_one_xml + normalization asserts tfrecords.py:61-64)."""
    root = ET.parse(xml_path).getroot()
    filename = root.find(".//filename").text
    size = root.find("size")
    w = float(size.find("width").text)
    h = float(size.find("height").text)
    boxes, classes = [], []
    for obj in root.findall(".//object"):
        name = obj.find("name").text
        bb = obj.find("bndbox")
        x1 = float(bb.find("xmin").text) / w
        y1 = float(bb.find("ymin").text) / h
        x2 = float(bb.find("xmax").text) / w
        y2 = float(bb.find("ymax").text) / h
        assert 0 <= x1 <= 1 and 0 <= y1 <= 1, f"bad bbox in {xml_path}"
        assert x1 <= x2 <= 1.001 and y1 <= y2 <= 1.001
        boxes.append([x1, y1, min(x2, 1.0), min(y2, 1.0)])
        classes.append(names_map[name])
    return {"filename": filename,
            "boxes": np.asarray(boxes, np.float32).reshape(-1, 4),
            "classes": np.asarray(classes, np.int64)}


def prepare_voc(voc_root: str, out_dir: str, split: str = "train",
                names_file: str | None = None, num_shards: int = 8,
                num_workers: int = 8, year: str = "2007",
                store: str = "jpeg", resize: int = 416) -> int:
    """VOCdevkit/VOC{year}/{Annotations,JPEGImages} → dvrec shards."""
    base = os.path.join(voc_root, f"VOC{year}")
    anno_dir = os.path.join(base, "Annotations")
    img_dir = os.path.join(base, "JPEGImages")
    names_map = load_class_names(names_file)
    # honor VOC's split lists (ImageSets/Main/<split>.txt) so train and val
    # shards hold disjoint images; fall back to everything if absent
    split_file = os.path.join(base, "ImageSets", "Main", f"{split}.txt")
    wanted = None
    if os.path.exists(split_file):
        with open(split_file) as f:
            wanted = {line.split()[0] for line in f if line.strip()}
    samples = []
    for xml_file in sorted(os.listdir(anno_dir)):
        if not xml_file.endswith(".xml"):
            continue
        if wanted is not None and xml_file[:-4] not in wanted:
            continue
        s = parse_voc_xml(os.path.join(anno_dir, xml_file), names_map)
        img_path = os.path.join(img_dir, s["filename"])
        with open(img_path, "rb") as f:
            s["image_bytes"] = f.read()
        samples.append(s)
    _, n = R.write_detection_records(samples, out_dir, split, num_shards,
                                     num_workers, store=store, resize=resize)
    return n


def prepare_coco(annotation_json: str, image_dir: str, out_dir: str,
                 split: str = "train", num_shards: int = 16,
                 num_workers: int = 8, store: str = "jpeg",
                 resize: int = 416) -> int:
    """COCO instances JSON → dvrec (per-image grouping + 0-based classes)."""
    with open(annotation_json) as f:
        coco = json.load(f)
    # re-index 1-based, possibly sparse, category ids → dense 0-based
    cat_ids = sorted(c["id"] for c in coco["categories"])
    cat_map = {cid: i for i, cid in enumerate(cat_ids)}
    images = {im["id"]: im for im in coco["images"]}
    by_image: dict[int, list] = {}
    for anno in coco.get("annotations", []):
        by_image.setdefault(anno["image_id"], []).append(anno)
    samples = []
    for image_id, annos in sorted(by_image.items()):
        im = images[image_id]
        w, h = float(im["width"]), float(im["height"])
        boxes, classes = [], []
        for a in annos:
            x, y, bw, bh = a["bbox"]  # xywh corner-origin (COCO format)
            boxes.append([x / w, y / h, (x + bw) / w, (y + bh) / h])
            classes.append(cat_map[int(a["category_id"])])
        path = os.path.join(image_dir, im["file_name"])
        with open(path, "rb") as f:
            payload = f.read()
        samples.append({"image_bytes": payload,
                        "boxes": np.clip(np.asarray(boxes, np.float32)
                                         .reshape(-1, 4), 0, 1),
                        "classes": np.asarray(classes, np.int64)})
    _, n = R.write_detection_records(samples, out_dir, split, num_shards,
                                     num_workers, store=store, resize=resize)
    return n


def prepare_mpii(annotation_json: str, image_dir: str, out_dir: str,
                 split: str = "train", num_shards: int = 8,
                 num_workers: int = 8, store: str = "jpeg",
                 resize: int = 384) -> int:
    """MPII pose JSON (list of {image, joints, joints_visibility, center,
    scale}) → pose dvrec.  Visibility remap 0→0, else→2 (reference :63)."""
    with open(annotation_json) as f:
        annos = json.load(f)
    samples = []
    for a in annos:
        path = os.path.join(image_dir, a["image"])
        if not os.path.exists(path):
            continue
        with open(path, "rb") as f:
            payload = f.read()
        joints = np.asarray(a["joints"], np.float32)
        vis = np.asarray([0 if v == 0 else 2
                          for v in a["joints_visibility"]], np.float32)
        kp = np.concatenate([joints, vis[:, None]], axis=1)
        samples.append({"image_bytes": payload, "keypoints": kp,
                        "center": np.asarray(a.get("center", (0, 0)),
                                             np.float32),
                        "scale": float(a.get("scale", 1.0))})
    _, n = R.write_pose_records(samples, out_dir, split, num_shards,
                                num_workers, store=store, resize=resize)
    return n


def load_synset_humans(metadata_file: str) -> dict[str, str]:
    """synset → human-readable label ("n01440764 → tench, Tinca tinca") —
    the ``synset_to_human`` lookup of build_imagenet_tfrecord.py:472-689.
    Accepts both tab- and space-separated metadata lines."""
    out: dict[str, str] = {}
    with open(metadata_file) as f:
        for line in f:
            parts = line.strip().split(None, 1)
            if parts:
                out[parts[0]] = parts[1] if len(parts) > 1 else ""
    return out


def load_bbox_csv(csv_path: str) -> dict[str, list[list[float]]]:
    """bbox CSV (``process_imagenet_bboxes`` output / the reference's
    process_bounding_boxes.py format) → filename → [[x1,y1,x2,y2], ...]."""
    out: dict[str, list[list[float]]] = {}
    with open(csv_path) as f:
        for line in f:
            parts = line.strip().split(",")
            if len(parts) != 5:
                continue
            out.setdefault(parts[0], []).append(
                [float(v) for v in parts[1:]])
    return out


def process_imagenet_bboxes(xml_dir: str, out_csv: str,
                            synsets_file: str | None = None) -> dict:
    """ImageNet bbox XML tree (``<xml_dir>/nXXXX/nXXXX_YYYY.xml``) → CSV of
    ``<file>.JPEG,xmin,ymin,xmax,ymax`` relative coords — the
    process_bounding_boxes.py:16-264 role.

    Same data-noise rules as the reference: coords are normalized by the
    annotator-displayed width/height stored in the XML, min/max swapped if
    inverted, clamped to [0,1]; degenerate boxes (zero extent after
    clamping) are skipped; with a synsets file, off-challenge XML dirs are
    skipped, and a box label that differs from the directory synset is only
    rejected when it IS a challenge synset (many dog boxes carry human
    labels like 'Scottish_deerhound' instead of a synset id).
    Returns counters {files, boxes, skipped_files, skipped_boxes}.
    """
    import glob as _glob

    wanted = None
    if synsets_file is not None:
        with open(synsets_file) as f:
            wanted = {line.strip() for line in f if line.strip()}
    stats = {"files": 0, "boxes": 0, "skipped_files": 0, "skipped_boxes": 0}
    with open(out_csv, "w") as out:
        for xml_path in sorted(
                _glob.glob(os.path.join(xml_dir, "*", "*.xml"))):
            synset = os.path.basename(os.path.dirname(xml_path))
            if wanted is not None and synset not in wanted:
                stats["skipped_files"] += 1
                continue
            try:
                root = ET.parse(xml_path).getroot()
            except ET.ParseError:
                stats["skipped_files"] += 1
                continue
            # the XML's <filename> is noisy (sometimes '%s'); the XML
            # basename is authoritative, as in the reference
            image_name = os.path.splitext(os.path.basename(xml_path))[0]
            wrote = 0
            for obj in root.iter("object"):
                name = obj.findtext("name", "")
                if (wanted is not None and name != synset
                        and name in wanted):
                    stats["skipped_boxes"] += 1
                    continue
                try:
                    w = float(root.findtext(".//width"))
                    h = float(root.findtext(".//height"))
                    bb = obj.find("bndbox")
                    xs = sorted((float(bb.findtext("xmin")) / w,
                                 float(bb.findtext("xmax")) / w))
                    ys = sorted((float(bb.findtext("ymin")) / h,
                                 float(bb.findtext("ymax")) / h))
                except (TypeError, ValueError, ZeroDivisionError):
                    stats["skipped_boxes"] += 1
                    continue
                x1, x2 = (min(max(v, 0.0), 1.0) for v in xs)
                y1, y2 = (min(max(v, 0.0), 1.0) for v in ys)
                if x1 >= x2 or y1 >= y2:
                    stats["skipped_boxes"] += 1
                    continue
                out.write(f"{image_name}.JPEG,{x1:.4f},{y1:.4f},"
                          f"{x2:.4f},{y2:.4f}\n")
                wrote += 1
            if wrote:
                stats["files"] += 1
                stats["boxes"] += wrote
            else:
                stats["skipped_files"] += 1
    return stats


def prepare_imagenet(src_dir: str, labels_file: str, out_dir: str,
                     split: str = "train", num_shards: int = 64,
                     num_workers: int = 8, bbox_csv: str | None = None,
                     store: str = "jpeg", resize: int = 256) -> int:
    """Flattened synset-prefixed JPEG dir → classification dvrec shards
    (the 1024/128-shard layout of build_imagenet_tfrecord.py, scaled by
    ``num_shards``).

    Every image is content-sanitized at build time (``sanitize_image`` —
    the blacklist+ImageCoder role, :236-309): PNG-as-JPEG / CMYK /
    truncated files are re-encoded, undecodable ones dropped, so shards
    are 100% readable.  Headers carry synset + human label (:472-689) and,
    with ``bbox_csv``, the image's bounding boxes."""
    # one pass over the metadata file yields both lookups (synset→index by
    # line order, synset→human by the rest of the line)
    label_map: dict[str, int] = {}
    humans = load_synset_humans(labels_file)
    for idx, synset in enumerate(humans):
        label_map[synset] = idx
    boxes = load_bbox_csv(bbox_csv) if bbox_csv else {}
    files = sorted(f for f in os.listdir(src_dir)
                   if os.path.isfile(os.path.join(src_dir, f)))
    items = []
    for f in files:
        synset = f.split("_")[0]
        items.append((os.path.join(src_dir, f), label_map[synset], synset,
                      humans.get(synset, ""), boxes.get(f, None)))
    import functools

    encode = _encode_imagenet_item if store == "jpeg" else functools.partial(
        _encode_imagenet_item, store=store, resize=resize)
    _, written = R.write_sharded(items, out_dir, split, num_shards,
                                 encode, num_workers)
    if written < len(items):
        print(f"[prep] dropped {len(items) - written} undecodable file(s) "
              f"of {len(items)}", flush=True)
    return written


def flatten_imagenet_train(train_dir: str, out_dir: str,
                           link: bool = True) -> int:
    """Raw ILSVRC2012 train layout → the flat ``synset_imagename.JPEG``
    dir the loaders expect — the untar-script.sh + flatten-script.sh role.

    Handles both raw layouts: per-synset tars (``nXXXX.tar`` as extracted
    from ILSVRC2012_img_train.tar) and per-synset subdirectories.  Files
    inside train tars are already named ``nXXXX_YYYY.JPEG`` so flattening
    is a move/link, not a rename.  ``link=True`` hardlinks (falls back to
    copy across filesystems) instead of the reference's 150 GB ``cp``."""
    import shutil
    import tarfile

    os.makedirs(out_dir, exist_ok=True)
    n = 0
    for entry in sorted(os.listdir(train_dir)):
        full = os.path.join(train_dir, entry)
        if entry.endswith(".tar"):
            with tarfile.open(full) as tf:
                for member in tf:
                    if not member.isfile():
                        continue
                    if os.path.exists(os.path.join(
                            out_dir, os.path.basename(member.name))):
                        continue  # idempotent re-runs, like the dir branch
                    tf.extract(member, out_dir, filter="data")
                    n += 1
        elif os.path.isdir(full):
            for f in sorted(os.listdir(full)):
                dst = os.path.join(out_dir, f)
                if os.path.exists(dst):
                    continue
                if link:
                    try:
                        os.link(os.path.join(full, f), dst)
                    except OSError:
                        shutil.copy2(os.path.join(full, f), dst)
                else:
                    shutil.copy2(os.path.join(full, f), dst)
                n += 1
    return n


def flatten_imagenet_val(val_dir: str, out_dir: str,
                         ground_truth: str | None = None,
                         synsets_file: str | None = None,
                         link: bool = True) -> int:
    """Raw val layout → flat ``synset_ILSVRC2012_val_XXXX.JPEG`` dir —
    the flatten-val-script.sh role.

    Two raw layouts:
    - per-synset subdirectories (the reference script's input): flatten
      with ``<dirname>_<filename>`` naming;
    - the flat official tar output (``ILSVRC2012_val_00000001.JPEG`` ...)
      plus the 50k-line ground-truth file (1-based ILSVRC2012 label ids)
      and the synsets list mapping id→synset: prefix each file with its
      synset."""
    import shutil

    os.makedirs(out_dir, exist_ok=True)

    def place(src, name):
        dst = os.path.join(out_dir, name)
        if os.path.exists(dst):
            return
        if link:
            try:
                os.link(src, dst)
                return
            except OSError:
                pass
        shutil.copy2(src, dst)

    entries = sorted(os.listdir(val_dir))
    subdirs = [e for e in entries
               if os.path.isdir(os.path.join(val_dir, e))]
    n = 0
    if subdirs:
        for d in subdirs:
            for f in sorted(os.listdir(os.path.join(val_dir, d))):
                place(os.path.join(val_dir, d, f), f"{d}_{f}")
                n += 1
        return n
    if not (ground_truth and synsets_file):
        raise ValueError(
            "flat val dir needs --ground-truth (ILSVRC2012 validation "
            "ground truth) and --synsets (id→synset order) to label files")
    with open(synsets_file) as f:
        synsets = [line.strip() for line in f if line.strip()]
    with open(ground_truth) as f:
        labels = [int(line) for line in f if line.strip()]
    files = [e for e in entries if e.upper().endswith((".JPEG", ".JPG"))]
    if len(files) != len(labels):
        raise ValueError(f"{len(files)} val images vs {len(labels)} "
                         f"ground-truth lines")
    bad = [l for l in labels if not 1 <= l <= len(synsets)]
    if bad:
        raise ValueError(
            f"ground-truth labels must be 1..{len(synsets)} (ILSVRC ids "
            f"are 1-based); got e.g. {bad[0]} — is the file 0-based?")
    for f, lab in zip(files, labels):
        place(os.path.join(val_dir, f), f"{synsets[lab - 1]}_{f}")
        n += 1
    return n


def prepare_unpaired(dir_a: str, dir_b: str, out_dir: str,
                     split: str = "train", num_shards: int = 4,
                     num_workers: int = 4) -> tuple[int, int]:
    """CycleGAN pair-less builder: domain dirs → '<split>_a' / '<split>_b'
    shards (CycleGAN/tensorflow/tfrecords.py:9-73)."""
    counts = []
    for tag, d in (("a", dir_a), ("b", dir_b)):
        files = sorted(f for f in os.listdir(d)
                       if f.lower().endswith((".jpg", ".jpeg", ".png")))
        items = [os.path.join(d, f) for f in files]
        R.write_sharded(items, out_dir, f"{split}_{tag}", num_shards,
                        _encode_file, num_workers)
        counts.append(len(items))
    return tuple(counts)


def split_celeba_by_attribute(attr_file: str, image_dir: str, out_a: str,
                              out_b: str, attribute: str = "Male") -> tuple[int, int]:
    """CelebA list_attr_celeba.txt split (celeba.py:1-24): symlink images
    into two domain dirs by one binary attribute."""
    os.makedirs(out_a, exist_ok=True)
    os.makedirs(out_b, exist_ok=True)
    with open(attr_file) as f:
        lines = f.read().splitlines()
    header = lines[1].split()
    col = header.index(attribute)
    na = nb = 0
    for line in lines[2:]:
        parts = line.split()
        fname, val = parts[0], int(parts[1 + col])
        src = os.path.join(image_dir, fname)
        if not os.path.exists(src):
            continue
        dst = os.path.join(out_a if val > 0 else out_b, fname)
        if not os.path.exists(dst):
            os.symlink(os.path.abspath(src), dst)
        if val > 0:
            na += 1
        else:
            nb += 1
    return na, nb
