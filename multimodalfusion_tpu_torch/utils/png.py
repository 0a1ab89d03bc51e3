"""A PNG writer and reader of the port's own (the machine with the card
has no OpenCV or PIL): 8-bit grayscale (colour type 0) and 8-bit RGB
(colour type 2), not interlaced, every row with filter 0, the image data
deflated by ``zlib`` at its fastest level (OpenCV's default) and every
chunk's CRC from ``zlib.crc32``.  The JAX package writes its images with
``cv2.imwrite`` of the BGR-converted array, so its files hold the same
pixels; the bytes differ where the compression does."""
from __future__ import annotations

import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
_TYPES = {2: 0, 3: 2}  # array ndim -> colour type
_CHANNELS = {0: 1, 2: 3}
_LEVEL = 1  # zlib's fastest, as OpenCV writes PNG by default


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data)))


def encode_png(array) -> bytes:
    """The PNG file of a uint8 array [H, W] (grayscale) or [H, W, 3]
    (RGB)."""
    a = np.ascontiguousarray(array)
    if a.dtype != np.uint8 or a.ndim not in _TYPES or (
            a.ndim == 3 and a.shape[2] != 3) or a.size == 0:
        raise ValueError(f"write_png takes a non-empty uint8 [H, W] or "
                         f"[H, W, 3] array, got {a.dtype} {a.shape}")
    h, w = a.shape[:2]
    rows = a.reshape(h, -1)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1)
    header = struct.pack(">IIBBBBB", w, h, 8, _TYPES[a.ndim], 0, 0, 0)
    return (SIGNATURE + _chunk(b"IHDR", header)
            + _chunk(b"IDAT", zlib.compress(raw.tobytes(), _LEVEL))
            + _chunk(b"IEND", b""))


def write_png(path: str, array) -> str:
    """Write ``array`` (see ``encode_png``) to ``path``."""
    data = encode_png(array)
    with open(path, "wb") as f:
        f.write(data)
    return path


def decode_png(data: bytes) -> np.ndarray:
    """The pixels of an 8-bit grayscale or RGB PNG that is not interlaced
    and whose rows all use filter 0, as ``write_png`` writes them: uint8
    [H, W] or [H, W, 3].  Anything else, and a bad signature or CRC,
    raises ``ValueError``."""
    if data[:8] != SIGNATURE:
        raise ValueError("not a PNG file")
    pos, header, idat = 8, None, []
    while True:
        if pos + 12 > len(data):
            raise ValueError("truncated PNG file")
        (n,) = struct.unpack_from(">I", data, pos)
        kind = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + n]
        (crc,) = struct.unpack_from(">I", data, pos + 8 + n)
        if len(body) != n or zlib.crc32(kind + body) != crc:
            raise ValueError(f"bad PNG chunk {kind!r}")
        pos += 12 + n
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError("PNG file without IHDR")
    w, h, depth, ctype, _, _, interlace = header
    if depth != 8 or ctype not in _CHANNELS or interlace:
        raise ValueError(f"only 8-bit grayscale or RGB PNG without "
                         f"interlacing is read, got bit depth {depth}, "
                         f"colour type {ctype}, interlace {interlace}")
    c = _CHANNELS[ctype]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != h * (1 + w * c):
        raise ValueError("PNG image data of the wrong size")
    raw = raw.reshape(h, 1 + w * c)
    if raw[:, 0].any():
        raise ValueError("only PNG rows with filter 0 are read")
    pixels = raw[:, 1:].reshape((h, w, c) if c == 3 else (h, w))
    return pixels.copy()


def read_png(path: str) -> np.ndarray:
    """The pixels of the PNG file at ``path`` (see ``decode_png``)."""
    with open(path, "rb") as f:
        return decode_png(f.read())
