"""ImageNet classification input from raw-payload dvrec shards.

Port of ``deep_vision_tpu/data/imagenet.py`` (``ImageNetRecords``,
``ImageNetLoader``, ``ImageNetLoader.from_records``, ``_load_one`` and
the worker pool): records written by ``prepare_data --store raw`` hold
HWC uint8 pixels, read back with ``np.frombuffer`` and no decode.  Three
pipelines, as in the reference: with ``device_normalize`` (the uint8
wire, what ``cli.train`` uses by default) the host only rescales (a
no-op at the stored size), flips and crops, and the color jitter and
normalize run on the device (``ops/preprocess.make_imagenet_preprocess``);
without it the host also jitters and normalizes and ships float32
(``--host-normalize``); ``preprocessing="tf"`` is the TF pipeline's
crop, flip and mean subtraction on the host, float32 (``--tf-preprocessing``).
Records that hold JPEG payloads, and the flat-folder JPEG layout, need
a decoder and are not read here.  One process reads every record:
per-host sharding is the identity.
"""

from __future__ import annotations

from collections import deque
from typing import Iterator

import numpy as np

from deep_vision_tpu_torch.data import transforms as T
from deep_vision_tpu_torch.data.loader import pad_eval_indices
from deep_vision_tpu_torch.data.records import list_shards, scan_records


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
    return f.read(length)


def _close_fds():
    while _FDS:
        _, f = _FDS.popitem()
        f.close()


# worker-side state, set once per worker process by the pool initializer
_WORKER: dict = {}


def _worker_init(cfg: dict):
    _WORKER.update(cfg)


def _load_one(cfg: dict, i: int, seed: int) -> tuple[np.ndarray, np.int32]:
    """Record ``i`` → (HWC image at the crop size, label): uint8 with
    ``device_normalize``, else float32 from the torch or the TF host
    pipeline."""
    path, off, plen, shape = cfg["entries"][i]
    if shape is None:
        raise ValueError(
            f"{path}@{off}: a JPEG payload; the port reads raw-payload "
            f"records (prepare_data --store raw) and has no image decoder")
    img = np.frombuffer(_pread(path, off, plen), np.uint8).reshape(shape)
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
    """Epoch-reshuffled batch iterator over :class:`ImageNetRecords`.

    Yields ``{"image": (B, H, W, 3), "label": (B,) int32}`` host
    batches, the images uint8 with ``device_normalize`` and float32
    otherwise (:attr:`wire_dtype`); eval iteration adds ``"weight"`` and
    pads the last partial batch with weight-0 fillers so every example is
    scored once.  With ``num_workers > 0`` a forkserver pool reads and
    crops while ``prefetch_batches`` batches are in flight."""

    def __init__(self, dataset: ImageNetRecords, batch_size: int,
                 train: bool = True, image_size: int = 224,
                 resize: int = 256, num_workers: int = 16, seed: int = 0,
                 prefetch_batches: int = 2, device_normalize: bool = True,
                 preprocessing: str = "torch"):
        if preprocessing not in ("torch", "tf"):
            raise ValueError(f"preprocessing must be torch|tf, "
                             f"got {preprocessing!r}")
        if preprocessing == "tf" and device_normalize:
            raise ValueError("tf preprocessing is host-side only "
                             "(mean-centered 0-255 floats); disable "
                             "device_normalize")
        self.ds = dataset
        self.host_indices = np.arange(len(self.ds))
        self.batch_size = batch_size
        self.train = train
        self.image_size, self.resize = image_size, resize
        self.num_workers = num_workers
        self.seed = seed
        self.epoch = 0
        self.prefetch_batches = max(1, prefetch_batches)
        self._cfg = dict(labels=self.ds.labels, entries=self.ds.entries,
                         train=train, image_size=image_size, resize=resize,
                         device_normalize=device_normalize,
                         preprocessing=preprocessing)
        #: what this loader ships a pixel (the trainer's H2D bytes)
        self.wire_dtype = np.uint8 if device_normalize else np.float32
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
        return cls(ImageNetRecords(root, split), batch_size, **kwargs)

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

    def _assemble(self, out, n_real) -> dict:
        batch = {"image": np.stack([o[0] for o in out]),
                 "label": np.asarray([o[1] for o in out], np.int32)}
        if not self.train:
            weight = np.zeros(self.batch_size, np.float32)
            weight[:n_real] = 1.0
            batch["weight"] = weight
        return batch

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
                yield self._assemble(
                    [_load_one(self._cfg, *a) for a in args], n_real)
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
