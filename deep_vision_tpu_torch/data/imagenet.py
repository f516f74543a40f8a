"""ImageNet classification input: dvrec shards and the flat-folder layout.

Port of ``deep_vision_tpu/data/imagenet.py`` (``load_synset_index``,
``ImageNetRecords``, ``ImageNetFolder``, ``ImageNetLoader`` with
``from_records``, ``_load_one``, ``_native_batch`` and the worker
pool).  Three sources: records written by ``prepare_data --store raw``
hold HWC uint8 pixels, read back with ``np.frombuffer`` and no decode;
records of the JPEG store (``--store jpeg``, the default) decode at read
time; the flat folder (``synset_*.JPEG``, labels from the metadata
file's line order) decodes each file.  Decoding takes PIL (cv2's decode
where installed, for records on the uint8 wire); without PIL a JPEG or
folder loader raises an error that names PIL when it is built.

Three pipelines, as in the reference: with ``device_normalize`` (the
uint8 wire, what ``cli.train`` uses by default) the host only rescales
(a no-op at the stored size), flips and crops, and the color jitter and
normalize run on the device (``ops/preprocess.make_imagenet_preprocess``);
without it the host also jitters and normalizes and ships float32
(``--host-normalize``); ``preprocessing="tf"`` is the TF pipeline's
crop, flip and mean subtraction on the host, float32
(``--tf-preprocessing``).  With ``device_normalize``, 0 workers and raw
payloads stored at the loader's resize, each batch is assembled by the
native reader (``data/native``) in one call, byte for byte the numpy
path's batch.  One process reads every record: per-host sharding is the
identity.
"""

from __future__ import annotations

import io
import os
from collections import deque
from typing import Iterator

import numpy as np

from deep_vision_tpu_torch.data import transforms as T
from deep_vision_tpu_torch.data.loader import pad_eval_indices
from deep_vision_tpu_torch.data.records import (
    list_shards,
    require_pil,
    scan_records,
)


def load_synset_index(labels_file: str) -> dict[str, int]:
    """synset → class index, in the metadata file's line order; blank
    lines take no index, and a line splits on any whitespace (the
    metadata file is tab-separated: "n01440764\ttench, Tinca tinca")."""
    mapping: dict[str, int] = {}
    with open(labels_file) as f:
        for line in f:
            line = line.strip()
            if line:
                mapping[line.split()[0]] = len(mapping)
    return mapping


def _decode(path: str, draft_size: int | None = None) -> np.ndarray:
    """An image file → RGB uint8 HWC through PIL; ``draft_size`` lets
    PIL's JPEG decoder downscale by 1/2 to 1/8 while it decodes, never
    below ``draft_size`` on either side."""
    Image = require_pil(f"decoding {path}")
    with Image.open(path) as im:
        if draft_size is not None:
            im.draft("RGB", (draft_size, draft_size))
        return np.asarray(im.convert("RGB"))  # drops alpha, CMYK→RGB


def _decode_bytes(data: bytes, draft_size: int | None = None,
                  fast: bool = False) -> np.ndarray:
    """An encoded image → RGB uint8 HWC.  ``fast`` decodes with cv2 where
    it is installed (bit-identical to PIL's libjpeg-turbo decode on the
    clean RGB JPEGs ``prepare_data`` writes; cv2 mis-decodes CMYK, so
    only sanitized records take it), at the deepest DCT reduction that
    still covers ``draft_size``; otherwise, or where cv2 cannot decode
    the payload, PIL with ``draft``."""
    Image = require_pil("decoding a JPEG payload")
    if fast:
        try:
            import cv2
        except ImportError:
            cv2 = None
        if cv2 is not None:
            flag = cv2.IMREAD_COLOR
            if draft_size is not None:
                with Image.open(io.BytesIO(data)) as im:  # header only
                    w, h = im.size
                for shift, reduced in ((3, cv2.IMREAD_REDUCED_COLOR_8),
                                       (2, cv2.IMREAD_REDUCED_COLOR_4),
                                       (1, cv2.IMREAD_REDUCED_COLOR_2)):
                    if min(w, h) >> shift >= draft_size:
                        flag = reduced
                        break
            img = cv2.imdecode(np.frombuffer(data, np.uint8), flag)
            if img is not None and img.ndim == 3 and img.shape[2] == 3:
                return cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
    with Image.open(io.BytesIO(data)) as im:
        if draft_size is not None:
            im.draft("RGB", (draft_size, draft_size))
        return np.asarray(im.convert("RGB"))


class ImageNetRecords:
    """Random-access view over classification dvrec shards: one header
    scan at construction builds a ``(path, offset, length, shape)`` index
    and the label array; reads are then single positioned reads."""

    def __init__(self, root: str, split: str):
        self.entries: list[tuple[str, int, int, tuple | None]] = []
        labels: list[int] = []
        shards = list_shards(root, split)
        if not shards:
            raise FileNotFoundError(f"no {split}-*.dvrec under {root}")
        for path in shards:
            for header, off, plen in scan_records(path):
                shape = tuple(header["shape"]) \
                    if header.get("enc") == "raw" else None
                self.entries.append((path, off, plen, shape))
                labels.append(int(header["label"]))
        self.labels = np.asarray(labels, np.int32)

    def __len__(self) -> int:
        return len(self.entries)


# worker-local fd cache: positioned reads reuse one open file per shard,
# capped so thousand-shard datasets stay below the open-file limit
_FDS: dict = {}
_FDS_MAX = 64


def _pread(path: str, off: int, length: int) -> bytes:
    f = _FDS.pop(path, None)
    if f is None:
        while len(_FDS) >= _FDS_MAX:
            _FDS.pop(next(iter(_FDS))).close()
        f = open(path, "rb")
    _FDS[path] = f  # (re)insert at the end: least recently used first
    f.seek(off)
    data = f.read(length)
    if len(data) != length:
        raise OSError(f"{path}@{off}: read {len(data)} of the record's "
                      f"{length} payload bytes (a truncated shard)")
    return data


def _close_fds():
    while _FDS:
        _, f = _FDS.popitem()
        f.close()


class ImageNetFolder:
    """The flat-folder dataset: every file of ``root_dir`` in name order,
    its label the index of its synset prefix (the name up to the first
    ``_``) in ``labels_file``; ``read(i)`` decodes one."""

    def __init__(self, root_dir: str, labels_file: str):
        self.root_dir = root_dir
        self.files = sorted(
            f for f in os.listdir(root_dir)
            if os.path.isfile(os.path.join(root_dir, f)))
        label_to_idx = load_synset_index(labels_file)
        self.labels = np.array(
            [label_to_idx[f.split("_")[0]] for f in self.files], np.int32)

    def __len__(self) -> int:
        return len(self.files)

    def read(self, i: int) -> tuple[np.ndarray, int]:
        return _decode(os.path.join(self.root_dir, self.files[i])), \
            int(self.labels[i])


# worker-side state, set once per worker process by the pool initializer
_WORKER: dict = {}


def _worker_init(cfg: dict):
    _WORKER.update(cfg)


def _load_one(cfg: dict, i: int, seed: int) -> tuple[np.ndarray, np.int32]:
    """Item ``i`` → (HWC image at the crop size, label): uint8 with
    ``device_normalize``, else float32 from the torch or the TF host
    pipeline.  A raw payload needs no decode; a JPEG payload or a folder
    file decodes, with PIL's draft (and, for records, cv2's decode) only
    on the uint8 wire: the host pipelines keep PIL's full decode."""
    draft = cfg["resize"] if cfg["device_normalize"] else None
    if "entries" in cfg:
        path, off, plen, shape = cfg["entries"][i]
        if shape is not None:
            img = np.frombuffer(_pread(path, off, plen),
                                np.uint8).reshape(shape)
        else:
            img = _decode_bytes(_pread(path, off, plen), draft_size=draft,
                                fast=cfg["device_normalize"])
    else:
        img = _decode(os.path.join(cfg["root_dir"], cfg["files"][i]),
                      draft_size=draft)
    size, resize = cfg["image_size"], cfg["resize"]
    rng = np.random.default_rng(seed) if cfg["train"] else None
    if cfg["preprocessing"] == "tf":
        x = T.tf_train_transform(img, rng, size, resize) if cfg["train"] \
            else T.tf_eval_transform(img, size, resize)
    elif cfg["device_normalize"]:
        x = T.train_transform_u8(img, rng, size, resize) if cfg["train"] \
            else T.eval_transform_u8(img, size, resize)
    else:
        x = T.train_transform(img, rng, size, resize).astype(np.float32) \
            if cfg["train"] else T.eval_transform(img, size, resize)
    return x, cfg["labels"][i]


def _worker_load(args) -> tuple[np.ndarray, np.int32]:
    i, seed = args
    return _load_one(_WORKER, i, seed)


class ImageNetLoader:
    """Epoch-reshuffled batch iterator over the flat folder at
    ``root_dir`` (labels from ``labels_file``) or over ``dataset``
    (:meth:`from_records`).

    Yields ``{"image": (B, H, W, 3), "label": (B,) int32}`` host
    batches, the images uint8 with ``device_normalize`` and float32
    otherwise (:attr:`wire_dtype`); eval iteration adds ``"weight"`` and
    pads the last partial batch with weight-0 fillers so every example is
    scored once.  With ``num_workers > 0`` a forkserver pool reads,
    decodes and crops while ``prefetch_batches`` batches are in flight;
    with 0 workers each batch is read inline, through the native reader
    where :meth:`_native_batch` takes it."""

    def __init__(self, root_dir: str | None, labels_file: str | None,
                 batch_size: int, train: bool = True, image_size: int = 224,
                 resize: int = 256, num_workers: int = 16, seed: int = 0,
                 prefetch_batches: int = 2, device_normalize: bool = True,
                 preprocessing: str = "torch",
                 dataset: ImageNetRecords | None = None):
        if preprocessing not in ("torch", "tf"):
            raise ValueError(f"preprocessing must be torch|tf, "
                             f"got {preprocessing!r}")
        if preprocessing == "tf" and device_normalize:
            raise ValueError("tf preprocessing is host-side only "
                             "(mean-centered 0-255 floats); disable "
                             "device_normalize")
        self.ds = dataset if dataset is not None \
            else ImageNetFolder(root_dir, labels_file)
        self.host_indices = np.arange(len(self.ds))
        self.batch_size = batch_size
        self.train = train
        self.image_size, self.resize = image_size, resize
        self.num_workers = num_workers
        self.seed = seed
        self.epoch = 0
        self.prefetch_batches = max(1, prefetch_batches)
        self._cfg = dict(labels=self.ds.labels, train=train,
                         image_size=image_size, resize=resize,
                         device_normalize=device_normalize,
                         preprocessing=preprocessing)
        if isinstance(self.ds, ImageNetRecords):
            self._cfg["entries"] = self.ds.entries
            decodes = any(e[3] is None for e in self.ds.entries)
        else:
            self._cfg["root_dir"] = self.ds.root_dir
            self._cfg["files"] = self.ds.files
            decodes = True
        if decodes:  # fail here, not in a worker mid-epoch
            require_pil(f"reading the JPEG images of "
                        f"{root_dir or 'JPEG-store records'}")
        #: what this loader ships a pixel (the trainer's H2D bytes)
        self.wire_dtype = np.uint8 if device_normalize else np.float32
        self._scratch = None
        self._pool = None
        if self.num_workers > 0:
            import multiprocessing as mp

            # forkserver, not fork: the trainer's process has live threads
            # (CUDA, the prefetcher) by the time a loader is built
            self._pool = mp.get_context("forkserver").Pool(
                self.num_workers, initializer=_worker_init,
                initargs=(self._cfg,))

    @classmethod
    def from_records(cls, root: str, split: str, batch_size: int,
                     **kwargs) -> "ImageNetLoader":
        """A loader over the ``split`` shards under ``root``."""
        return cls(None, None, batch_size,
                   dataset=ImageNetRecords(root, split), **kwargs)

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def __len__(self) -> int:
        full = len(self.host_indices) // self.batch_size
        if not self.train and len(self.host_indices) % self.batch_size:
            return full + 1
        return full

    def _batch_args(self, idx, seeds, b):
        sel, _, n_real = pad_eval_indices(idx, b * self.batch_size,
                                          self.batch_size)
        start = b * self.batch_size
        args = [(int(i), int(s)) for i, s in
                zip(sel, seeds[start:start + self.batch_size])]
        return args, n_real

    def _finish(self, batch: dict, n_real: int) -> dict:
        if not self.train:
            weight = np.zeros(self.batch_size, np.float32)
            weight[:n_real] = 1.0
            batch["weight"] = weight
        return batch

    def _assemble(self, out, n_real) -> dict:
        return self._finish(
            {"image": np.stack([o[0] for o in out]),
             "label": np.asarray([o[1] for o in out], np.int32)}, n_real)

    def _native_batch(self, args, n_real) -> dict | None:
        """The whole batch through the native reader (``data/native``):
        positioned reads, crop and flip fused into one call, with the
        numpy path's per-item draws (flip, then crop top, then crop
        left, from ``default_rng(seed)``), so the batch is byte for byte
        the one :func:`_load_one` would give.  None, and the caller
        takes that path, unless ``device_normalize`` is on, every item
        is a raw payload stored at the loader's resize, and the machine
        has a C++ compiler.  A failed read raises, naming the shard and
        the record's offset."""
        if not self._cfg["device_normalize"] or "entries" not in self._cfg:
            return None
        entries = self._cfg["entries"]
        size, resize = self.image_size, self.resize
        for i, _ in args:
            _, _, plen, shape = entries[i]
            if shape is None or min(shape[0], shape[1]) != resize \
                    or shape[0] < size or shape[1] < size:
                return None  # a decode or a rescale is needed
            if len(shape) != 3 or shape[2] != 3 \
                    or plen != shape[0] * shape[1] * 3:
                return None  # not the reader's layout: numpy names it
        from deep_vision_tpu_torch.data import native

        lib = native.load()
        if lib is None:
            return None
        n = len(args)
        offs = np.empty(n, np.int64)
        hs, ws = np.empty(n, np.int32), np.empty(n, np.int32)
        tops, lefts = np.empty(n, np.int32), np.empty(n, np.int32)
        flips = np.zeros(n, np.uint8)
        labels = np.empty(n, np.int32)
        for j, (i, seed) in enumerate(args):
            path, off, plen, (h, w, _) = entries[i]
            if self.train:
                r = np.random.default_rng(seed)
                flips[j] = r.random() < 0.5
                tops[j] = r.integers(0, h - size + 1)
                lefts[j] = r.integers(0, w - size + 1)
            else:
                tops[j], lefts[j] = (h - size) // 2, (w - size) // 2
            offs[j], hs[j], ws[j] = off, h, w
            labels[j] = self._cfg["labels"][i]
        need = max(entries[i][2] for i, _ in args)
        if self._scratch is None or len(self._scratch) < need:
            self._scratch = np.empty(need, np.uint8)
        out = np.empty((n, size, size, 3), np.uint8)
        # one descriptor a shard for this call, closed after it: a cached
        # descriptor evicted mid-batch could be reused for another shard
        paths = {entries[i][0] for i, _ in args}
        fd_of = {}
        try:
            for path in paths:
                fd_of[path] = os.open(path, os.O_RDONLY)
            fds = np.asarray([fd_of[entries[i][0]] for i, _ in args],
                             np.int32)
            rc = native.assemble_batch(lib, fds, offs, hs, ws, tops, lefts,
                                       flips, out, self._scratch)
        finally:
            for fd in fd_of.values():
                os.close(fd)
        if rc != 0:
            path, off, plen, _ = entries[args[-rc - 1][0]]
            raise OSError(f"{path}@{off}: the native reader could not read "
                          f"the record's {plen} payload bytes (a truncated "
                          f"shard?)")
        return self._finish({"image": out, "label": labels}, n_real)

    def __iter__(self) -> Iterator[dict]:
        rng = np.random.default_rng((self.seed, self.epoch))
        idx = self.host_indices.copy()
        if self.train:
            rng.shuffle(idx)
        seeds = rng.integers(0, 2**63 - 1, size=len(idx) + self.batch_size)
        n_batches = len(self)
        if self._pool is None:
            for b in range(n_batches):
                args, n_real = self._batch_args(idx, seeds, b)
                batch = self._native_batch(args, n_real)
                if batch is None:
                    batch = self._assemble(
                        [_load_one(self._cfg, *a) for a in args], n_real)
                yield batch
            return
        # overlapped reads: the workers prepare batches N+1..N+k while
        # the device trains on batch N
        chunk = max(1, self.batch_size // (2 * self.num_workers))
        pending: deque = deque()
        for b in range(n_batches):
            args, n_real = self._batch_args(idx, seeds, b)
            pending.append(
                (self._pool.map_async(_worker_load, args, chunksize=chunk),
                 n_real))
            if len(pending) > self.prefetch_batches:
                res, nr = pending.popleft()
                # a hung worker fails the epoch instead of pinning it
                yield self._assemble(res.get(timeout=600.0), nr)
        while pending:
            res, nr = pending.popleft()
            yield self._assemble(res.get(timeout=600.0), nr)

    def close(self):
        if self._pool is not None:
            self._pool.terminate()
            self._pool.join()
            self._pool = None
        _close_fds()
