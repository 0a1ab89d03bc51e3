"""Bob Jenkins' lookup3 hash (``hashlittle``), as HDF5 computes it
(``H5_checksum_lookup3``): the checksum of every version-2 metadata block
of an HDF5 file (initial value 0) and the hash of the link and attribute
names that its version-2 B-trees index.

The bytes are taken as little-endian 32-bit words in blocks of 12; the
last block, 1 to 12 bytes, is padded with zeros; no bytes at all give the
seed itself, with no final mixing.
"""
from __future__ import annotations

import numpy as np

_M = 0xFFFFFFFF


def _rot(x: int, k: int) -> int:
    return ((x << k) | (x >> (32 - k))) & _M


def hashlittle(data: bytes, initval: int = 0) -> int:
    """The 32-bit lookup3 hash of ``data`` with seed ``initval``."""
    n = len(data)
    a = b = c = (0xDEADBEEF + n + initval) & _M
    if n == 0:
        return c
    # all blocks but the last full ones are mixed; the last (1-12 bytes)
    # is padded and goes through the final mixing
    blocks = (n - 1) // 12
    words = np.frombuffer(bytes(data) + b"\0" * (12 * (blocks + 1) - n),
                          "<u4").tolist()
    for i in range(0, 3 * blocks, 3):
        a = (a + words[i]) & _M
        b = (b + words[i + 1]) & _M
        c = (c + words[i + 2]) & _M
        a = (a - c) & _M; a ^= _rot(c, 4); c = (c + b) & _M   # noqa: E702
        b = (b - a) & _M; b ^= _rot(a, 6); a = (a + c) & _M   # noqa: E702
        c = (c - b) & _M; c ^= _rot(b, 8); b = (b + a) & _M   # noqa: E702
        a = (a - c) & _M; a ^= _rot(c, 16); c = (c + b) & _M  # noqa: E702
        b = (b - a) & _M; b ^= _rot(a, 19); a = (a + c) & _M  # noqa: E702
        c = (c - b) & _M; c ^= _rot(b, 4); b = (b + a) & _M   # noqa: E702
    i = 3 * blocks
    a = (a + words[i]) & _M
    b = (b + words[i + 1]) & _M
    c = (c + words[i + 2]) & _M
    c ^= b; c = (c - _rot(b, 14)) & _M   # noqa: E702
    a ^= c; a = (a - _rot(c, 11)) & _M   # noqa: E702
    b ^= a; b = (b - _rot(a, 25)) & _M   # noqa: E702
    c ^= b; c = (c - _rot(b, 16)) & _M   # noqa: E702
    a ^= c; a = (a - _rot(c, 4)) & _M    # noqa: E702
    b ^= a; b = (b - _rot(a, 14)) & _M   # noqa: E702
    c ^= b; c = (c - _rot(b, 24)) & _M   # noqa: E702
    return c
