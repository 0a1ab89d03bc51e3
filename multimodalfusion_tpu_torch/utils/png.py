"""A PNG writer and reader of the port's own (the machine with the card
has no OpenCV or PIL).

The writer (``encode_png``, ``write_png``) writes 8-bit grayscale
(colour type 0) and 8-bit RGB (colour type 2), not interlaced, every row
with filter 0, the image data deflated by ``zlib`` at its fastest level
(OpenCV's default) and every chunk's CRC from ``zlib.crc32``.  The JAX
package writes its images with ``cv2.imwrite`` of the BGR-converted
array, so its files hold the same pixels; the bytes differ where the
compression does.

The reader (``decode_png``, ``read_png``) reads every PNG that PIL
reads, as PIL reads it: colour types 0 (bit depths 1, 2, 4, 8, 16), 2 (8,
16), 3 (palette, 1, 2, 4, 8), 4 (8, 16) and 6 (8, 16), Adam7 interlace,
row filters 0-4 (None, Sub, Up, Average, Paeth) undone in C++
(``csrc/imgcodec.cpp``, ``mmf_png_unfilter``) or, with ``plain=True``, in
numpy and Python (``unfilter_plain``), every chunk's CRC checked.
``mode`` gives PIL's mode of each (``MODES``); ``rgb=True`` returns what
PIL's ``convert("RGB")`` gives: alpha dropped, a palette expanded (an
index past the palette black), gray repeated, 16-bit gray saturated at
255, 16-bit colour by its high byte.
"""
from __future__ import annotations

import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
_TYPES = {2: 0, 3: 2}  # array ndim -> colour type
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


# (bit depth, colour type) -> PIL's mode (PngImagePlugin._MODES)
MODES = {(1, 0): "1", (2, 0): "L", (4, 0): "L", (8, 0): "L", (16, 0): "I;16",
         (8, 2): "RGB", (16, 2): "RGB", (1, 3): "P", (2, 3): "P",
         (4, 3): "P", (8, 3): "P", (8, 4): "LA", (16, 4): "RGBA",
         (8, 6): "RGBA", (16, 6): "RGBA"}
_SAMPLES = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
# Adam7: (first column, first row, column step, row step) of each pass
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
          (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


def mode(depth: int, ctype: int) -> str:
    """PIL's mode of a PNG of this bit depth and colour type."""
    m = MODES.get((depth, ctype))
    if m is None:
        raise ValueError(f"not a PNG bit depth and colour type: {depth}, "
                         f"{ctype}")
    return m


def _chunks(data: bytes):
    """(IHDR fields, the IDAT bytes, PLTE) of a PNG file."""
    if data[:8] != SIGNATURE:
        raise ValueError("not a PNG file")
    pos, header, idat, plte = 8, None, [], b""
    while True:
        if pos + 12 > len(data):
            raise ValueError("truncated PNG file")
        (n,) = struct.unpack_from(">I", data, pos)
        kind = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + n]
        if pos + 12 + n > len(data):
            raise ValueError("truncated PNG file")
        (crc,) = struct.unpack_from(">I", data, pos + 8 + n)
        if len(body) != n or zlib.crc32(kind + body) != crc:
            raise ValueError(f"bad PNG chunk {kind!r}")
        pos += 12 + n
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"PLTE":
            plte = body
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError("PNG file without IHDR")
    return header, b"".join(idat), plte


def unfilter_plain(raw: np.ndarray, bpp: int) -> np.ndarray:
    """The PNG rows [h, rowbytes] of the filtered rows ``raw`` [h, 1 +
    rowbytes] (each led by its filter type), ``bpp`` bytes a pixel (at
    least 1): the plain version of ``mmf_png_unfilter``.  Sub and Up in
    numpy, Average and Paeth byte by byte."""
    h, rb = raw.shape[0], raw.shape[1] - 1
    out = np.empty((h, rb), np.uint8)
    prior = np.zeros(rb, np.uint8)
    for y in range(h):
        f, x = int(raw[y, 0]), raw[y, 1:]
        if f == 0:
            cur = x
        elif f == 1:
            lanes = np.zeros(-(-rb // bpp) * bpp, np.uint8)
            lanes[:rb] = x
            cur = np.cumsum(lanes.reshape(-1, bpp), axis=0,
                            dtype=np.uint8).ravel()[:rb]
        elif f == 2:
            cur = x + prior
        elif f in (3, 4):
            xs, ps, o = x.tolist(), prior.tolist(), [0] * rb
            for i in range(rb):
                a = o[i - bpp] if i >= bpp else 0
                b = ps[i]
                if f == 3:
                    o[i] = (xs[i] + ((a + b) >> 1)) & 255
                    continue
                c = ps[i - bpp] if i >= bpp else 0
                p = a + b - c
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                pred = a if pa <= pb and pa <= pc else (b if pb <= pc
                                                         else c)
                o[i] = (xs[i] + pred) & 255
            cur = np.array(o, np.uint8)
        else:
            raise ValueError(f"PNG row {y} has filter type {f}")
        out[y] = cur
        prior = out[y]
    return out


def _unfilter(raw: np.ndarray, bpp: int, plain: bool) -> np.ndarray:
    if plain:
        return unfilter_plain(raw, bpp)
    from multimodalfusion_tpu_torch import native
    raw = np.ascontiguousarray(raw)
    h, rb = raw.shape[0], raw.shape[1] - 1
    out = np.empty((h, rb), np.uint8)
    bad = native.codec_lib().mmf_png_unfilter(raw.ctypes.data, h, rb, bpp,
                                              out.ctypes.data)
    if bad:
        raise ValueError(f"PNG row {bad - 1} has filter type "
                         f"{raw[bad - 1, 0]}")
    return out


def _samples(rows: np.ndarray, w: int, depth: int, ch: int) -> np.ndarray:
    """The samples [h, w, ch] of unfiltered rows: uint8 below 16 bits
    (raw values), uint16 at 16."""
    h = rows.shape[0]
    if depth == 16:
        return rows[:, :2 * w * ch].view(">u2").astype(np.uint16).reshape(
            h, w, ch)
    if depth == 8:
        return rows[:, :w * ch].reshape(h, w, ch)
    bits = np.unpackbits(rows, axis=1).reshape(h, -1, depth)
    weights = (1 << np.arange(depth - 1, -1, -1)).astype(np.uint8)
    vals = (bits * weights).sum(axis=2, dtype=np.uint8)
    return vals[:, :w * ch].reshape(h, w, ch)


def decode_png(data: bytes, plain: bool = False,
               rgb: bool = False) -> np.ndarray:
    """The pixels of a PNG file as PIL holds them (``np.asarray`` of the
    image), but a palette image's indices expanded through its palette
    to RGB [H, W, 3]: uint8 [H, W] for modes "L" (1-, 2- and 4-bit gray
    scaled to 0..255 as PIL scales them) and "1" (0 or 255), uint16
    [H, W] for "I;16", uint8 [H, W, 2 / 3 / 4] for "LA", "RGB", "RGBA"
    (16-bit colour by its high byte).  ``rgb=True``: uint8 [H, W, 3], as
    ``convert("RGB")``.  The filters are undone in C++, or with
    ``plain=True`` in the plain version.  A bad signature, CRC, filter
    type or size raises ``ValueError``."""
    (w, h, depth, ctype, method, filt, interlace), idat, plte = _chunks(data)
    m = mode(depth, ctype)
    if method or filt or interlace > 1 or not w or not h:
        raise ValueError(f"PNG compression method {method}, filter method "
                         f"{filt}, interlace {interlace}, size {w} x {h}")
    ch = _SAMPLES[ctype]
    bpp = max(1, depth * ch // 8)
    raw = np.frombuffer(zlib.decompress(idat), np.uint8)
    passes = (((0, 0, 1, 1),) if not interlace else _ADAM7)
    dtype = np.uint16 if depth == 16 else np.uint8
    px = np.empty((h, w, ch), dtype)
    at = 0
    for x0, y0, dx, dy in passes:
        pw, ph = -(-(w - x0) // dx), -(-(h - y0) // dy)
        if pw <= 0 or ph <= 0:
            continue
        rb = -(-pw * depth * ch // 8)
        n = ph * (1 + rb)
        if at + n > raw.size:
            raise ValueError("PNG image data of the wrong size")
        rows = _unfilter(raw[at:at + n].reshape(ph, 1 + rb), bpp, plain)
        px[y0::dy, x0::dx] = _samples(rows, pw, depth, ch)
        at += n
    if at != raw.size:
        raise ValueError("PNG image data of the wrong size")
    if ctype == 3:
        pal = np.zeros((256, 3), np.uint8)
        entries = np.frombuffer(plte, np.uint8)[:768]
        pal.reshape(-1)[:entries.size - entries.size % 3] = \
            entries[:entries.size - entries.size % 3]
        return pal[px[..., 0]]
    if depth == 16 and ctype != 0:
        px = (px >> 8).astype(np.uint8)
        if ctype == 4:  # PIL's LA;16B opens as RGBA
            px = np.concatenate([px[..., :1]] * 3 + [px[..., 1:]], axis=2)
    elif depth < 8:
        px = px * np.uint8({1: 255, 2: 0x55, 4: 0x11}[depth])
    if rgb:
        if m == "I;16":
            px = np.minimum(px, 255).astype(np.uint8)
        return np.ascontiguousarray(np.repeat(px[..., :1], 3, axis=2)
                                    if m in ("1", "L", "LA", "I;16")
                                    else px[..., :3])
    return px[..., 0] if ch == 1 else px


def read_png(path: str, plain: bool = False,
             rgb: bool = False) -> np.ndarray:
    """The pixels of the PNG file at ``path`` (see ``decode_png``)."""
    with open(path, "rb") as f:
        return decode_png(f.read(), plain=plain, rgb=rgb)
