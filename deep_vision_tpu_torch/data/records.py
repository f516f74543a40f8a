"""dvrec: the packed record format, byte for byte the reference's.

Copy of ``deep_vision_tpu/data/records.py``:

    shard = repeat[u32 header_len | header JSON | u32 payload_len | payload]

- header: JSON metadata (``label``; raw-store records add ``"enc": "raw"``
  and ``"shape": [H, W, C]``);
- payload: the encoded image (the JPEG store, the default) or its HWC
  uint8 pixels (the raw store);
- shards are named ``{split}-{i:05d}-of-{n:05d}.dvrec``.

Detection records (``encode_detection_sample``,
``write_detection_records``, ``load_detection_records``) hold a header
``{"boxes", "classes"}`` and, in the raw store, the image square-resized
to 416² by default with ``"shape"`` and ``"enc": "raw"``.  Pose records
(``encode_pose_sample``, ``write_pose_records``, ``load_pose_records``)
hold ``{"keypoints", "center", "scale"}`` and, in the raw store, the
image with its shorter side at 384 by default.  Writing and reading the
JPEG store, and the raw store's resize where one is needed, take PIL or
cv2 (``data/transforms.resize_bilinear``); a machine with neither
writes and reads the raw store at the stored size only.
"""

from __future__ import annotations

import functools
import glob
import io
import json
import os
import struct
from typing import Callable, Iterator, Sequence

import numpy as np

_U32 = struct.Struct("<I")


class RecordWriter:
    def __init__(self, path: str):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._f = open(path, "wb")

    def write(self, header: dict, payload: bytes = b""):
        hb = json.dumps(header).encode()
        self._f.write(_U32.pack(len(hb)))
        self._f.write(hb)
        self._f.write(_U32.pack(len(payload)))
        self._f.write(payload)

    def close(self):
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def scan_records(path: str) -> Iterator[tuple[dict, int, int]]:
    """Headers + (payload_offset, payload_len), WITHOUT reading payloads."""
    with open(path, "rb") as f:
        while True:
            raw = f.read(4)
            if len(raw) < 4:
                return
            (hlen,) = _U32.unpack(raw)
            header = json.loads(f.read(hlen))
            (plen,) = _U32.unpack(f.read(4))
            off = f.tell()
            f.seek(plen, 1)
            yield header, off, plen


def read_records(path: str) -> Iterator[tuple[dict, bytes]]:
    with open(path, "rb") as f:
        for header, off, plen in scan_records(path):
            f.seek(off)
            yield header, f.read(plen)


def shard_name(out_dir: str, split: str, i: int, n: int) -> str:
    return os.path.join(out_dir, f"{split}-{i:05d}-of-{n:05d}.dvrec")


def list_shards(root: str, split: str) -> list[str]:
    return sorted(glob.glob(os.path.join(root, f"{split}-*.dvrec")))


def _write_shard(args):
    path, items, encode = args
    n = 0
    with RecordWriter(path) as w:
        for item in items:
            enc = encode(item)
            if enc is None:  # the encoder dropped the item
                continue
            header, payload = enc
            w.write(header, payload)
            n += 1
    return path, n


def write_sharded(items: Sequence, out_dir: str, split: str,
                  num_shards: int, encode: Callable,
                  num_workers: int = 8) -> tuple[list[str], int]:
    """Fan items out to ``num_shards`` files with ``num_workers``
    processes.  Returns (shard paths, records actually written)."""
    os.makedirs(out_dir, exist_ok=True)
    chunks = [list(items[i::num_shards]) for i in range(num_shards)]
    jobs = [(shard_name(out_dir, split, i, num_shards), chunk, encode)
            for i, chunk in enumerate(chunks)]
    if num_workers <= 1:
        results = [_write_shard(j) for j in jobs]
    else:
        import multiprocessing as mp

        with mp.get_context("spawn").Pool(
                min(num_workers, num_shards)) as pool:
            results = pool.map(_write_shard, jobs)
    return [p for p, _ in results], sum(n for _, n in results)


# ---------------------------------------------------------------------------
# Detection records
# ---------------------------------------------------------------------------


def require_pil(what: str):
    """``PIL.Image``, or an ImportError that names PIL and ``what``."""
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError(
            f"{what} needs PIL (Pillow), which is not installed; write "
            f"and read raw-store records (prepare_data --store raw) at the "
            f"loader's size instead") from e
    return Image


def _decode_for_raw(sample: dict) -> np.ndarray | None:
    """The sample's pixels as HWC uint8, ``image_bytes`` decoded once
    (``data/prep.decode_image_robust``); None drops an undecodable item."""
    if "image_bytes" not in sample:
        return np.asarray(sample["image"], np.uint8)
    from deep_vision_tpu_torch.data.prep import decode_image_robust

    return decode_image_robust(sample["image_bytes"])


def _jpeg_payload(sample: dict) -> bytes:
    """The JPEG store's payload: ``image_bytes`` as given, or the decoded
    ``image`` encoded at quality 95."""
    if "image_bytes" in sample:
        return sample["image_bytes"]
    Image = require_pil("encoding an image for the JPEG store")
    buf = io.BytesIO()
    Image.fromarray(sample["image"]).save(buf, format="JPEG", quality=95)
    return buf.getvalue()


def encode_detection_sample(sample: dict, store: str = "jpeg",
                            resize: int = 416) -> tuple[dict, bytes] | None:
    """``{"image": HWC uint8 | "image_bytes": JPEG, "boxes": (N, 4)
    normalized corners, "classes": (N,)}`` → ``(header, payload)``.

    ``store="raw"`` decodes once, square-resizes to ``resize``² (boxes
    are normalized, so the square resize changes no label) and stores
    the uint8 HWC bytes with ``"shape"`` and ``"enc": "raw"``; an
    undecodable ``image_bytes`` gives None (the writer drops it).
    ``store="jpeg"`` stores the encoded image."""
    header = {
        "boxes": np.asarray(sample["boxes"], np.float32).reshape(
            -1, 4).tolist(),
        "classes": np.asarray(sample["classes"], np.int64).reshape(
            -1).tolist(),
    }
    if store == "raw":
        from deep_vision_tpu_torch.data.transforms import resize_bilinear

        img = _decode_for_raw(sample)
        if img is None:
            return None
        img = np.ascontiguousarray(resize_bilinear(img, resize, resize))
        header["shape"] = list(img.shape)
        header["enc"] = "raw"
        return header, img.tobytes()
    return header, _jpeg_payload(sample)


def write_detection_records(samples: Sequence[dict], out_dir: str,
                            split: str, num_shards: int = 8,
                            num_workers: int = 8, store: str = "jpeg",
                            resize: int = 416):
    """Detection samples → ``num_shards`` dvrec shards."""
    encode = functools.partial(encode_detection_sample, store=store,
                               resize=resize)
    return write_sharded(samples, out_dir, split, num_shards, encode,
                         num_workers)


class LazyRecordSample(dict):
    """A record as a dict whose ``"image"`` is read on access with one
    positioned read: raw-store payloads come back with ``frombuffer``,
    JPEG payloads are decoded with PIL.  The labels come from the header
    (``_parse``), and the sample keeps only (shard, offset, length), so
    it pickles to loader workers in a few hundred bytes.
    ``cache_decoded`` keeps the image after the first read (for a small,
    revisited split)."""

    def __init__(self, header: dict, src: tuple, cache_decoded: bool):
        super().__init__()
        self._src = src
        self._cache = cache_decoded
        self._shape = (tuple(header["shape"])
                       if header.get("enc") == "raw" else None)
        self._parse(header)

    def _parse(self, header: dict):
        raise NotImplementedError

    def __getitem__(self, key):
        if key == "image" and not dict.__contains__(self, "image"):
            path, off, plen = self._src
            fd = os.open(path, os.O_RDONLY)
            try:
                payload = os.pread(fd, plen, off)
            finally:
                os.close(fd)
            if self._shape is not None:
                img = np.frombuffer(payload, np.uint8).reshape(self._shape)
            else:  # RGB whatever the encoding's mode (alpha, CMYK, gray)
                Image = require_pil("decoding a JPEG payload")
                with Image.open(io.BytesIO(payload)) as im:
                    img = np.asarray(im.convert("RGB"))
            if self._cache:
                dict.__setitem__(self, "image", img)
            return img
        return dict.__getitem__(self, key)

    def __contains__(self, key):
        return key == "image" or dict.__contains__(self, key)


def _load_lazy_records(root: str, split: str, sample_cls,
                       cache_decoded: bool) -> list[dict]:
    """Every ``split`` shard under ``root`` → lazy samples, one header
    scan and no payload read."""
    shards = list_shards(root, split)
    if not shards:
        raise FileNotFoundError(f"no {split}-*.dvrec under {root}")
    return [sample_cls(header, (s, off, plen), cache_decoded)
            for s in shards for header, off, plen in scan_records(s)]


class LazyDetectionSample(LazyRecordSample):
    def _parse(self, header: dict):
        self["boxes"] = np.asarray(header["boxes"], np.float32).reshape(
            -1, 4)
        self["classes"] = np.asarray(header["classes"], np.int64)


def load_detection_records(root: str, split: str,
                           cache_decoded: bool = False) -> list[dict]:
    """Every ``split`` detection shard under ``root`` → lazy samples."""
    return _load_lazy_records(root, split, LazyDetectionSample,
                              cache_decoded)


# ---------------------------------------------------------------------------
# Pose records (the MPII layout: keypoints, center, scale)
# ---------------------------------------------------------------------------


def encode_pose_sample(sample: dict, store: str = "jpeg", resize: int = 384
                       ) -> tuple[dict, bytes] | None:
    """``{"image": HWC uint8 | "image_bytes": JPEG, "keypoints": (K, 3)
    [x_px, y_px, vis], "center"?: (2,), "scale"?: float}`` →
    ``(header, payload)``.

    ``store="raw"`` decodes once and rescales the image so its shorter
    side is ``resize`` (``data/transforms.rescale``); the labels are in
    PIXEL coordinates and rescale with it: keypoint x and the center's x
    by the width's factor, y by the height's (the longer side rounds, so
    one shared factor would drift keypoints by up to a pixel), and the
    MPII person scale (·200 = the body's height in pixels) by the
    height's.  ``store="jpeg"`` stores the encoded image and the labels
    as given."""
    kp = np.asarray(sample["keypoints"], np.float32).reshape(-1, 3)
    center = np.asarray(sample.get("center", (0, 0)), np.float32)
    scale = float(sample.get("scale", 1.0))
    if store == "raw":
        from deep_vision_tpu_torch.data.transforms import rescale

        img = _decode_for_raw(sample)
        if img is None:
            return None
        h, w = img.shape[:2]
        img = np.ascontiguousarray(rescale(img, resize))
        fy, fx = img.shape[0] / h, img.shape[1] / w
        kp = np.concatenate([kp[:, 0:1] * fx, kp[:, 1:2] * fy,
                             kp[:, 2:3]], axis=1)
        header = {
            "keypoints": kp.tolist(),
            "center": [float(center[0]) * fx, float(center[1]) * fy],
            "scale": scale * fy,
            "shape": list(img.shape),
            "enc": "raw",
        }
        return header, img.tobytes()
    payload = _jpeg_payload(sample)
    header = {
        "keypoints": kp.tolist(),
        "center": center.tolist(),
        "scale": scale,
    }
    return header, payload


def write_pose_records(samples: Sequence[dict], out_dir: str, split: str,
                       num_shards: int = 8, num_workers: int = 8,
                       store: str = "jpeg", resize: int = 384):
    """Pose samples → ``num_shards`` dvrec shards."""
    encode = functools.partial(encode_pose_sample, store=store,
                               resize=resize)
    return write_sharded(samples, out_dir, split, num_shards, encode,
                         num_workers)


class LazyPoseSample(LazyRecordSample):
    def _parse(self, header: dict):
        self["keypoints"] = np.asarray(header["keypoints"], np.float32)
        self["center"] = np.asarray(header["center"], np.float32)
        self["scale"] = header["scale"]


def load_pose_records(root: str, split: str,
                      cache_decoded: bool = False) -> list[dict]:
    """Every ``split`` pose shard under ``root`` → lazy samples."""
    return _load_lazy_records(root, split, LazyPoseSample, cache_decoded)
