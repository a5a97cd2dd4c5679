"""Dependency-free TensorBoard scalars writer (a copy of
`semiblind_tv_tpu/runtime/tensorboard.py`, which this package may not import:
importing any `semiblind_tv_tpu` submodule pulls in jax).

The reference's observability is fprintf traces and saved figures (SURVEY §5);
the framework's structured metrics stream is `profiling.MetricsLogger`
(JSON-lines).  This module adds the TensorBoard event-file sink behind it
without importing the (heavyweight, ~seconds) `tensorboard` package: a
tfevents file is just TFRecord-framed `Event` protobufs, and scalar events
use three tiny, stable proto messages (Event{wall_time,step,summary},
Summary{value+}, Value{tag,simple_value}), hand-encoded here.  Readable by
any standard TensorBoard (round-trip tested against the real reader).
"""
from __future__ import annotations

import os
import socket
import struct
import time
from typing import Optional

__all__ = ["TensorBoardWriter"]

# ---------------------------------------------------------------------------
# CRC32C (Castagnoli) — TFRecord framing checksums
# ---------------------------------------------------------------------------

_CRC_TABLE = []
for _n in range(256):
    _c = _n
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
# Minimal protobuf encoding (varint / length-delimited / fixed)
# ---------------------------------------------------------------------------

def _varint(n: int) -> bytes:
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


def _field_double(num: int, v: float) -> bytes:
    return _varint((num << 3) | 1) + struct.pack("<d", v)


def _field_float(num: int, v: float) -> bytes:
    return _varint((num << 3) | 5) + struct.pack("<f", v)


def _field_varint(num: int, v: int) -> bytes:
    return _varint(num << 3) + _varint(v & 0xFFFFFFFFFFFFFFFF)


def _scalar_event(tag: str, value: float, step: int, wall_time: float) -> bytes:
    value_msg = _field_bytes(1, tag.encode()) + _field_float(2, float(value))
    summary = _field_bytes(1, value_msg)  # repeated Summary.Value value = 1
    return (
        _field_double(1, wall_time)  # Event.wall_time = 1
        + _field_varint(2, int(step))  # Event.step = 2
        + _field_bytes(5, summary)  # Event.summary = 5
    )


def _version_event(wall_time: float) -> bytes:
    return _field_double(1, wall_time) + _field_bytes(3, b"brain.Event:2")


class TensorBoardWriter:
    """Append scalar events to an `events.out.tfevents.*` file in `logdir`."""

    def __init__(self, logdir: str, filename_suffix: str = ""):
        os.makedirs(logdir, exist_ok=True)
        name = "events.out.tfevents.%010d.%s%s" % (
            time.time(),
            socket.gethostname(),
            filename_suffix,
        )
        self.path = os.path.join(logdir, name)
        self._f = open(self.path, "wb")
        self._write_record(_version_event(time.time()))

    def _write_record(self, payload: bytes) -> None:
        header = struct.pack("<Q", len(payload))
        self._f.write(header)
        self._f.write(struct.pack("<I", _masked_crc(header)))
        self._f.write(payload)
        self._f.write(struct.pack("<I", _masked_crc(payload)))

    def add_scalar(self, tag: str, value: float, step: int, wall_time: Optional[float] = None) -> None:
        self._write_record(
            _scalar_event(tag, value, step, time.time() if wall_time is None else wall_time)
        )

    def flush(self) -> None:
        self._f.flush()

    def close(self) -> None:
        if not self._f.closed:
            self._f.flush()
            self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
