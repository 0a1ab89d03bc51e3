"""TensorBoard event files without tensorboardX (the machine with the card
has none): the scalars that the JAX package's ``--tb`` writes with
``tensorboardX.SummaryWriter.add_scalar``, in the same records.

A file is a sequence of TFRecords: the data's length as a little-endian
u64, the masked CRC-32C of those 8 bytes, the data, and the masked CRC-32C
of the data.  Each record is one ``Event`` protobuf, encoded here by hand:
``wall_time`` (field 1, double), ``step`` (2, int64), ``file_version``
(3, string; "brain.Event:2" in the file's first event) and ``summary``
(5) holding one ``Summary.Value`` with ``tag`` (1) and ``simple_value``
(2, float).  ``step`` is left out at 0, its proto3 default.

    w = EventWriter(log_dir)
    w.add_scalar("train/loss", 0.5, step=0)
    w.flush()
    w.close()
"""
from __future__ import annotations

import os
import socket
import struct
import time

_CASTAGNOLI = 0x82F63B78  # CRC-32C's polynomial, bit-reversed


def _crc_table():
    table = []
    for n in range(256):
        c = n
        for _ in range(8):
            c = (c >> 1) ^ _CASTAGNOLI if c & 1 else c >> 1
        table.append(c)
    return table


_TABLE = _crc_table()


def crc32c(data: bytes) -> int:
    """CRC-32C (Castagnoli) of ``data``, table-driven."""
    crc = 0xFFFFFFFF
    for b in data:
        crc = _TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def masked_crc32c(data: bytes) -> int:
    """TFRecord's masked CRC: rotated right by 15 bits plus a constant."""
    crc = crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


def tfrecord(data: bytes) -> bytes:
    """``data`` framed as one TFRecord."""
    length = struct.pack("<Q", len(data))
    return (length + struct.pack("<I", masked_crc32c(length)) + data
            + struct.pack("<I", masked_crc32c(data)))


def _varint(n: int) -> bytes:
    out = bytearray()
    n &= (1 << 64) - 1  # int64 as protobuf encodes it
    while True:
        bits = n & 0x7F
        n >>= 7
        if n:
            out.append(bits | 0x80)
        else:
            out.append(bits)
            return bytes(out)


def _field(number: int, wire: int) -> bytes:
    return _varint(number << 3 | wire)


def _bytes_field(number: int, data: bytes) -> bytes:
    return _field(number, 2) + _varint(len(data)) + data


def encode_event(wall_time: float, step: int = 0, file_version: str = "",
                 tag: str = "", value: float = 0.0) -> bytes:
    """One ``Event``: a file-version event when ``file_version`` is given,
    else a scalar summary of ``tag``."""
    out = _field(1, 1) + struct.pack("<d", wall_time)
    if step:
        out += _field(2, 0) + _varint(step)
    if file_version:
        out += _bytes_field(3, file_version.encode())
    if tag:
        # simple_value sits in a oneof, so it is written even when 0
        val = (_bytes_field(1, tag.encode()) + _field(2, 5)
               + struct.pack("<f", value))
        out += _bytes_field(5, _bytes_field(1, val))
    return out


class EventWriter:
    """Scalars into ``{log_dir}/events.out.tfevents.{time}.{host}``, the
    name tensorboardX gives its files.  Records are buffered until
    ``flush`` (the training loop flushes every epoch) or ``close``."""

    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        now = time.time()
        self.path = os.path.join(
            log_dir, f"events.out.tfevents.{int(now):010d}."
                     f"{socket.gethostname()}")
        self._f = open(self.path, "wb")
        self._pending = [tfrecord(encode_event(now,
                                               file_version="brain.Event:2"))]

    def add_scalar(self, tag: str, value: float, step: int) -> None:
        self._pending.append(tfrecord(encode_event(
            time.time(), step=int(step), tag=tag, value=float(value))))

    def flush(self) -> None:
        self._f.write(b"".join(self._pending))
        self._pending.clear()
        self._f.flush()

    def close(self) -> None:
        if not self._f.closed:
            self.flush()
            self._f.close()
