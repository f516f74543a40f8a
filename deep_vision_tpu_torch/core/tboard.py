"""Dependency-free TensorBoard scalar logging (tfevents writer).

A copy of ``deep_vision_tpu/core/tboard.py``: the trainers'
``MetricLogger`` (``core/metrics.py``) writes ``events.out.tfevents.*``
files under ``workdir/tensorboard`` without TensorFlow or the
tensorboard package.  The Event protobuf needed for scalars is small
(wall_time, step, summary.value{tag, simple_value}), so it is
serialized by hand, in the TFRecord framing (u64 length + masked
crc32c, payload + masked crc32c).
"""

from __future__ import annotations

import os
import socket
import struct
import time

# ---------------------------------------------------------------------------
# crc32c (Castagnoli, poly 0x82F63B78) + TFRecord masking
# ---------------------------------------------------------------------------

_CRC_TABLE = []
for _i in range(256):
    _c = _i
    for _ in range(8):
        _c = (_c >> 1) ^ 0x82F63B78 if _c & 1 else _c >> 1
    _CRC_TABLE.append(_c)


def _crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    for b in data:
        crc = _CRC_TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = _crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


# ---------------------------------------------------------------------------
# minimal protobuf wire encoding for Event{wall_time, step, summary|file_version}
# ---------------------------------------------------------------------------


def _varint(n: int) -> bytes:
    if n < 0:  # protobuf int64: negatives are two's-complement 10-byters
        n &= (1 << 64) - 1
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _field_bytes(num: int, payload: bytes) -> bytes:
    return _varint((num << 3) | 2) + _varint(len(payload)) + payload


def _event(wall_time: float, step: int | None = None,
           file_version: str | None = None,
           scalars: list[tuple[str, float]] | None = None) -> bytes:
    ev = bytearray()
    ev += _varint((1 << 3) | 1) + struct.pack("<d", wall_time)  # wall_time
    if step is not None:
        ev += _varint(2 << 3) + _varint(step)                   # step
    if file_version is not None:
        ev += _field_bytes(3, file_version.encode())
    if scalars:
        summary = bytearray()
        for tag, value in scalars:
            val = _field_bytes(1, tag.encode()) \
                + _varint((2 << 3) | 5) + struct.pack("<f", value)
            summary += _field_bytes(1, val)                     # Summary.value
        ev += _field_bytes(5, bytes(summary))                   # Event.summary
    return bytes(ev)


class TFEventWriter:
    """Append-only scalar event file a stock TensorBoard can plot."""

    def __init__(self, logdir: str):
        os.makedirs(logdir, exist_ok=True)
        name = (f"events.out.tfevents.{int(time.time())}."
                f"{socket.gethostname()}")
        self._f = open(os.path.join(logdir, name), "ab")
        self._write(_event(time.time(), file_version="brain.Event:2"))

    def _write(self, payload: bytes):
        header = struct.pack("<Q", len(payload))
        self._f.write(header)
        self._f.write(struct.pack("<I", _masked_crc(header)))
        self._f.write(payload)
        self._f.write(struct.pack("<I", _masked_crc(payload)))

    def scalar(self, tag: str, value: float, step: int):
        self._write(_event(time.time(), step=int(step),
                           scalars=[(tag, float(value))]))

    def scalars(self, metrics: dict, step: int):
        self._write(_event(time.time(), step=int(step),
                           scalars=[(k, float(v)) for k, v in
                                    metrics.items()]))

    def flush(self):
        self._f.flush()

    def close(self):
        self._f.close()
