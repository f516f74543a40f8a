"""dvrec: the packed record format, byte for byte the reference's.

Copy of the format half of ``deep_vision_tpu/data/records.py``:

    shard = repeat[u32 header_len | header JSON | u32 payload_len | payload]

- header: JSON metadata (``label``; raw-store records add ``"enc": "raw"``
  and ``"shape": [H, W, C]``);
- payload: raw bytes (uint8 HWC pixels for the raw store);
- shards are named ``{split}-{i:05d}-of-{n:05d}.dvrec``.
"""

from __future__ import annotations

import glob
import json
import os
import struct
from typing import Callable, Iterator, Sequence

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
