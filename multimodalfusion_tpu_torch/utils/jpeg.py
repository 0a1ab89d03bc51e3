"""A baseline sequential JPEG encoder in numpy (the machine with the card
has no OpenCV or PIL): the port's stand-in for ``cv2.imwrite(".jpg")``
with OpenCV's defaults, for uint8 RGB images.

What it writes is what libjpeg writes by default: a JFIF 1.01 header,
quality 95 (the Annex K tables scaled as libjpeg scales them), YCbCr
with 4:2:0 chroma, the standard Huffman tables of Annex K.3 and one
interleaved scan.  It cannot equal libjpeg byte for byte: the colour
conversion, the 2 x 2 chroma means and the DCT are computed in float32
here (libjpeg: fixed point), then rounded once at quantisation.  The
entropy coding is vectorised over all blocks; the bits are packed with
``np.packbits`` and every 0xFF byte of the scan is stuffed with 0x00.
"""
from __future__ import annotations

import struct

import numpy as np

QUALITY = 95

_LUMA = np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99])
_CHROMA = np.full(64, 99)
_CHROMA[[0, 1, 2, 3, 8, 9, 10, 11, 16, 17, 18, 24, 25]] = [
    17, 18, 24, 47, 18, 21, 26, 66, 24, 26, 56, 47, 66]

# Annex K.3: (code counts of lengths 1..16, symbols) of DC and AC, luma
# and chroma
_DC_BITS = ((0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0),
            (0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0))
_DC_VALS = bytes(range(12))
_AC_BITS = ((0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7D),
            (0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77))
_AC_VALS = (bytes.fromhex(
    "01020300041105122131410613516107227114328191a1082342b1c11552d1f024"
    "33627282090a161718191a25262728292a3435363738393a434445464748494a53"
    "5455565758595a636465666768696a737475767778797a838485868788898a9293"
    "9495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5c6c7c8c9"
    "cad2d3d4d5d6d7d8d9dae1e2e3e4e5e6e7e8e9eaf1f2f3f4f5f6f7f8f9fa"),
    bytes.fromhex(
    "0001020311040521310612415107617113223281081442"
    "91a1b1c109233352f0156272d10a162434e125f11718191a262728292a35363738"
    "393a434445464748494a535455565758595a636465666768696a73747576777879"
    "7a82838485868788898a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6"
    "b7b8b9bac2c3c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae2e3e4e5e6e7e8e9eaf2f3"
    "f4f5f6f7f8f9fa"))


def _zigzag() -> np.ndarray:
    """Natural-order index of each zigzag position."""
    order = sorted(((u + v, v if (u + v) % 2 == 0 else u, u, v)
                    for u in range(8) for v in range(8)))
    return np.array([u * 8 + v for _, _, u, v in order])


ZIGZAG = _zigzag()


def quant_tables(quality: int = QUALITY):
    """libjpeg's tables for ``quality`` (natural order): the Annex K
    tables scaled by ``200 - 2 q`` percent (``5000 / q`` below 50),
    rounded, clamped to 1..255."""
    scale = 5000 // quality if quality < 50 else 200 - 2 * quality
    return [np.clip((t * scale + 50) // 100, 1, 255) for t in (_LUMA,
                                                               _CHROMA)]


def _huffman(bits, vals):
    """(code, length) of each symbol 0..255 for the table (bits, vals)."""
    code = np.zeros(256, np.int64)
    length = np.zeros(256, np.int64)
    c, k = 0, 0
    for n, count in enumerate(bits, start=1):
        for _ in range(count):
            code[vals[k]], length[vals[k]] = c, n
            c += 1
            k += 1
        c <<= 1
    return code, length


def _dct_matrix() -> np.ndarray:
    """The 2-D DCT of an 8 x 8 block as one [64, 64] matrix, its rows in
    zigzag order: ``coef_zigzag = K @ block.ravel()``."""
    k = np.arange(8)
    m = np.cos((2 * k[None, :] + 1) * k[:, None] * np.pi / 16) / 2
    m[0] /= np.sqrt(2)
    return np.kron(m, m)[ZIGZAG]


_DCT = _dct_matrix().astype(np.float32)
# JFIF's RGB -> YCbCr
_YCC = np.array([[0.299, 0.587, 0.114],
                 [-0.168735892, -0.331264108, 0.5],
                 [0.5, -0.418687589, -0.081312411]], np.float32)
_YCC_OFFSET = np.array([0, 128, 128], np.float32)


def _quantised(plane: np.ndarray, table: np.ndarray) -> np.ndarray:
    """Zigzag-ordered quantised DCT coefficients [by, bx, 64] of a float32
    plane [H, W] (multiples of 8), level-shifted by 128."""
    h, w = plane.shape
    b = plane.reshape(h // 8, 8, w // 8, 8).transpose(0, 2, 1, 3).reshape(
        -1, 64) - np.float32(128)
    q = np.rint((b @ _DCT.T) * (1 / table[ZIGZAG]).astype(np.float32))
    return q.astype(np.int32).reshape(h // 8, w // 8, 64)


def _size(v: np.ndarray) -> np.ndarray:
    """Bits of |v| (JPEG's magnitude category)."""
    a = np.abs(v)
    out = np.zeros(a.shape, np.int64)
    nz = a > 0
    out[nz] = np.floor(np.log2(a[nz])).astype(np.int64) + 1
    return out


def _extra(v: np.ndarray, size: np.ndarray) -> np.ndarray:
    """The magnitude bits JPEG appends: v, or v - 1 (ones' complement) for
    a negative v, in ``size`` bits."""
    return np.where(v < 0, v + (1 << size) - 1, v) & ((1 << size) - 1)


def _scan_items(blocks: np.ndarray, table: int, dc_prev: int):
    """(values, lengths, block) of every code of the blocks [N, 64] in
    order, with table ``table`` (0 luma, 1 chroma), the DC coded as the
    difference from the block before (``dc_prev`` before the first)."""
    n = blocks.shape[0]
    diff = np.diff(blocks[:, 0], prepend=dc_prev)
    dc_size = _size(diff)
    dc_code, dc_len = _huffman(_DC_BITS[table], _DC_VALS)
    ac_code, ac_len = _huffman(_AC_BITS[table], _AC_VALS[table])
    # DC items: key (block, 0)
    items_v = [(dc_code[dc_size] << dc_size) | _extra(diff, dc_size)]
    items_l = [dc_len[dc_size] + dc_size]
    items_k = [np.arange(n) * 256]
    ac = blocks[:, 1:]
    bi, ki = np.nonzero(ac)
    ki = ki + 1
    first = np.ones(len(bi), bool)
    first[1:] = bi[1:] != bi[:-1]
    prev = np.where(first, 0, np.roll(ki, 1))
    run = ki - prev - 1
    v = ac[bi, ki - 1]
    size = _size(v)
    # runs of 16 zeros or more: ZRL (0xF0) codes before the coefficient
    zrl = run // 16
    sym = ((run % 16) << 4) | size
    items_v.append((ac_code[sym] << size) | _extra(v, size))
    items_l.append(ac_len[sym] + size)
    items_k.append(bi * 256 + ki * 4 + 3)
    if zrl.any():
        rep = np.repeat(np.arange(len(bi)), zrl)
        sub = np.arange(len(rep)) - np.repeat(np.cumsum(zrl) - zrl, zrl)
        items_v.append(np.full(len(rep), ac_code[0xF0]))
        items_l.append(np.full(len(rep), ac_len[0xF0]))
        items_k.append(bi[rep] * 256 + ki[rep] * 4 + sub)
    # EOB when the block's last coefficient is zero
    last = np.full(n, 0)
    np.maximum.at(last, bi, ki)
    eob = np.flatnonzero(last < 63)
    items_v.append(np.full(len(eob), ac_code[0x00]))
    items_l.append(np.full(len(eob), ac_len[0x00]))
    items_k.append(eob * 256 + 255)
    keys = np.concatenate(items_k)
    order = np.argsort(keys, kind="stable")
    return (np.concatenate(items_v)[order], np.concatenate(items_l)[order],
            keys[order] // 256)


def _pack(values: np.ndarray, lengths: np.ndarray) -> bytes:
    """The bit string of the codes, MSB first, padded with ones, each 0xFF
    byte followed by 0x00."""
    total = int(lengths.sum())
    start = np.cumsum(lengths) - lengths
    owner = np.repeat(np.arange(len(lengths)), lengths)
    pos = np.arange(total) - start[owner]
    bits = (values[owner] >> (lengths[owner] - 1 - pos)) & 1
    pad = -total % 8
    bits = np.concatenate([bits.astype(np.uint8), np.ones(pad, np.uint8)])
    data = np.packbits(bits)
    ff = np.flatnonzero(data == 0xFF)
    return np.insert(data, ff + 1, 0).tobytes()


def _segment(marker: int, body: bytes) -> bytes:
    return struct.pack(">BBH", 0xFF, marker, len(body) + 2) + body


def encode_jpeg(rgb, chunk_rows: int = 64) -> bytes:
    """The JPEG file of a uint8 RGB image [H, W, 3] (see the module).  The
    scan is coded ``chunk_rows`` MCU rows at a time to bound memory."""
    a = np.asarray(rgb)
    if a.dtype != np.uint8 or a.ndim != 3 or a.shape[2] != 3 or a.size == 0:
        raise ValueError(f"encode_jpeg takes a non-empty uint8 [H, W, 3] "
                         f"array, got {a.dtype} {a.shape}")
    h, w = a.shape[:2]
    if h > 65535 or w > 65535:
        raise ValueError(f"a JPEG holds at most 65535 x 65535 pixels, got "
                         f"{w} x {h}")
    qy, qc = quant_tables()
    pw = -w % 16
    streams = []
    dc_prev = np.zeros(3, np.int64)
    for r0 in range(0, h, 16 * chunk_rows):
        band = a[r0:r0 + 16 * chunk_rows]
        # the edge repeated out to whole MCUs, as libjpeg pads
        px = np.pad(band, ((0, -band.shape[0] % 16), (0, pw), (0, 0)),
                    mode="edge")
        ycc = (px.reshape(-1, 3).astype(np.float32) @ _YCC.T
               + _YCC_OFFSET).reshape(px.shape)
        y = ycc[..., 0]
        sub = [(c[0::2, 0::2] + c[1::2, 0::2] + c[0::2, 1::2]
                + c[1::2, 1::2]) * np.float32(0.25)
               for c in (ycc[..., 1], ycc[..., 2])]
        qy_b = _quantised(y, qy)
        qcb = _quantised(sub[0], qc)
        qcr = _quantised(sub[1], qc)
        my, mx = qcb.shape[:2]
        # MCU order: Y00 Y01 Y10 Y11 Cb Cr
        yb = qy_b.reshape(my, 2, mx, 2, 64).transpose(0, 2, 1, 3, 4).reshape(
            my * mx, 4, 64)
        parts = []
        for comp, blocks, table in ((0, yb.reshape(-1, 64), 0),
                                    (1, qcb.reshape(-1, 64), 1),
                                    (2, qcr.reshape(-1, 64), 1)):
            v, l, blk = _scan_items(blocks, table, int(dc_prev[comp]))
            dc_prev[comp] = blocks[-1, 0]
            per = 4 if comp == 0 else 1
            parts.append((v, l, blk // per, blk % per, comp))
        keys = np.concatenate([mcu * 8 + (sub if comp == 0 else 3 + comp)
                               for _, _, mcu, sub, comp in parts])
        order = np.argsort(keys, kind="stable")
        streams.append((np.concatenate([p[0] for p in parts])[order],
                        np.concatenate([p[1] for p in parts])[order]))
    values = np.concatenate([s[0] for s in streams])
    lengths = np.concatenate([s[1] for s in streams])
    out = [b"\xff\xd8",
           _segment(0xE0, b"JFIF\0" + struct.pack(">BBBHHBB", 1, 1, 0, 1, 1,
                                                  0, 0))]
    for i, t in enumerate((qy, qc)):
        out.append(_segment(0xDB, bytes([i]) + bytes(t[ZIGZAG].tolist())))
    out.append(_segment(0xC0, struct.pack(">BHHB", 8, h, w, 3)
                        + bytes([1, 0x22, 0, 2, 0x11, 1, 3, 0x11, 1])))
    for tc, bits, vals in ((0x00, _DC_BITS[0], _DC_VALS),
                           (0x10, _AC_BITS[0], _AC_VALS[0]),
                           (0x01, _DC_BITS[1], _DC_VALS),
                           (0x11, _AC_BITS[1], _AC_VALS[1])):
        out.append(_segment(0xC4, bytes([tc]) + bytes(bits) + vals))
    out.append(_segment(0xDA, bytes([3, 1, 0x00, 2, 0x11, 3, 0x11, 0, 63,
                                     0])))
    out.append(_pack(values, lengths))
    out.append(b"\xff\xd9")
    return b"".join(out)


def write_jpeg(path: str, rgb) -> str:
    """Write ``rgb`` (see ``encode_jpeg``) to ``path``."""
    data = encode_jpeg(rgb)
    with open(path, "wb") as f:
        f.write(data)
    return path
