"""Minimal TensorBoard event-file writer (the stdlib only).

Counterpart of ``swinvox_tpu/utils/tb_writer.py``, the same bytes: TFRecord
framing (a length and masked CRC32C around each record) of hand-encoded
``Event`` / ``Summary`` protobuf messages, the scalar and image shapes
TensorBoard's dashboards read, so no protobuf or tensorboard package is
needed.  Files are named ``events.out.tfevents.<time>.<host>.<pid>.<n>``.
"""

from __future__ import annotations

import itertools
import os
import socket
import struct
import time
from typing import Optional

# ---------------------------------------------------------------- CRC32C

_CRC_TABLE = []
for _i in range(256):
    _c = _i
    for _ in range(8):
        _c = (_c >> 1) ^ (0x82F63B78 if _c & 1 else 0)
    _CRC_TABLE.append(_c)


def _crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    for b in data:
        crc = (crc >> 8) ^ _CRC_TABLE[(crc ^ b) & 0xFF]
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = _crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


# ------------------------------------------------- protobuf wire encoding


def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        bits = n & 0x7F
        n >>= 7
        if n:
            out.append(bits | 0x80)
        else:
            out.append(bits)
            return bytes(out)


def _tag(field: int, wire: int) -> bytes:
    return _varint((field << 3) | wire)


def _f_double(field: int, value: float) -> bytes:
    return _tag(field, 1) + struct.pack("<d", value)


def _f_float(field: int, value: float) -> bytes:
    return _tag(field, 5) + struct.pack("<f", value)


def _f_varint(field: int, value: int) -> bytes:
    return _tag(field, 0) + _varint(value & 0xFFFFFFFFFFFFFFFF)


def _f_bytes(field: int, value: bytes) -> bytes:
    return _tag(field, 2) + _varint(len(value)) + value


def _f_str(field: int, value: str) -> bytes:
    return _f_bytes(field, value.encode("utf-8"))


# Event: wall_time=1(double) step=2(int64) file_version=3(string)
#        summary=5(Summary)
# Summary: value=1(repeated Summary.Value)
# Summary.Value: tag=1(string) simple_value=2(float) image=4(Summary.Image)
# Summary.Image: height=1 width=2 colorspace=3 encoded_image_string=4


def _event(
    wall_time: float,
    step: Optional[int] = None,
    file_version: Optional[str] = None,
    summary: Optional[bytes] = None,
) -> bytes:
    msg = _f_double(1, wall_time)
    if step is not None:
        msg += _f_varint(2, int(step))
    if file_version is not None:
        msg += _f_str(3, file_version)
    if summary is not None:
        msg += _f_bytes(5, summary)
    return msg


def _scalar_summary(tag: str, value: float) -> bytes:
    return _f_bytes(1, _f_str(1, tag) + _f_float(2, float(value)))


def _image_summary(
    tag: str, png_bytes: bytes, height: int, width: int, channels: int = 3
) -> bytes:
    image = (
        _f_varint(1, height)
        + _f_varint(2, width)
        + _f_varint(3, channels)
        + _f_bytes(4, png_bytes)
    )
    return _f_bytes(1, _f_str(1, tag) + _f_bytes(4, image))


class EventFileWriter:
    """Appends TensorBoard events to an ``events.out.tfevents.*`` file."""

    _seq = itertools.count()  # per-process uniquifier

    def __init__(self, log_dir: str, suffix: str = ""):
        os.makedirs(log_dir, exist_ok=True)
        host = socket.gethostname()
        # pid and counter (as tensorboardX names them): two writers opened
        # in one directory within one second get two files
        uniq = f"{os.getpid()}.{next(self._seq)}"
        name = f"events.out.tfevents.{int(time.time())}.{host}.{uniq}{suffix}"
        self.path = os.path.join(log_dir, name)
        self._fh = open(self.path, "ab")
        self._record(_event(time.time(), file_version="brain.Event:2"))
        self._fh.flush()

    def _record(self, data: bytes) -> None:
        header = struct.pack("<Q", len(data))
        self._fh.write(header)
        self._fh.write(struct.pack("<I", _masked_crc(header)))
        self._fh.write(data)
        self._fh.write(struct.pack("<I", _masked_crc(data)))

    def add_scalar(self, tag: str, value: float, step: int) -> None:
        self._record(
            _event(time.time(), step=step, summary=_scalar_summary(tag, value))
        )
        self._fh.flush()

    def add_image_png(
        self, tag: str, png_bytes: bytes, step: int, height: int, width: int
    ) -> None:
        self._record(
            _event(
                time.time(),
                step=step,
                summary=_image_summary(tag, png_bytes, height, width),
            )
        )
        self._fh.flush()

    def close(self) -> None:
        self._fh.close()
