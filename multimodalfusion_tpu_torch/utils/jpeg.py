"""Baseline sequential JPEG, the port's stand-in for OpenCV's and PIL's
libjpeg (the machine with the card has neither): an encoder in numpy and
a decoder in C++ with its plain version in numpy.

The encoder (``encode_jpeg``) stands in for ``cv2.imwrite(".jpg")``
with OpenCV's defaults, for uint8 RGB images.

What it writes is what libjpeg writes by default: a JFIF 1.01 header,
quality 95 (the Annex K tables scaled as libjpeg scales them), YCbCr
with 4:2:0 chroma, the standard Huffman tables of Annex K.3 and one
interleaved scan.  It cannot equal libjpeg byte for byte: the colour
conversion, the 2 x 2 chroma means and the DCT are computed in float32
here (libjpeg: fixed point), then rounded once at quantisation.  The
entropy coding is vectorised over all blocks; the bits are packed with
``np.packbits`` and every 0xFF byte of the scan is stuffed with 0x00.

The decoder (``decode_jpeg``, ``decode_frames``) reads what PIL's
libjpeg-turbo decodes by default, bit for bit: SOF0 and SOF1 frames of 8
bits, 1 or 3 components, sampling factors 1..4 that divide the largest
(4:4:4, 4:2:2, 4:2:0, 4:4:0, ...), one or several scans, restart
intervals, several DQT / DHT segments, 16-bit quantisation tables, the
standard Huffman tables when a stream defines none (libjpeg-turbo's
Motion-JPEG rule), and abbreviated streams whose tables come from
elsewhere (a TIFF's JPEGTables).  It computes with libjpeg's accurate
integer IDCT (jidctint.c), libjpeg 6b's triangle ("fancy") upsampling
(jdsample.c) and its fixed-point YCbCr -> RGB tables (jdcolor.c).  The
colour transform is applied as libjpeg decides it (a JFIF marker, an
Adobe APP14 transform flag, the component ids), or as the caller says (a
TIFF's PhotometricInterpretation).  ``parse_jpeg`` reads the markers in
Python; the entropy decode, IDCT, upsampling and colour conversion run
in ``csrc/imgcodec.cpp`` (``mmf_jpeg_decode``, independent frames in
parallel threads), or, with ``plain=True``, in Python and numpy
(``_decode_plain``), the oracle of the tests and ``chip_smoke.py``.
Progressive (SOF2), lossless (SOF3: ``data/dicom.py`` decodes DICOM's),
arithmetic-coded and hierarchical frames, 12-bit samples and 2 or 4
components raise ``NotImplementedError`` naming the marker; progressive
JPEG is queued in ROADMAP.md.
"""
from __future__ import annotations

import ctypes
import re
import struct
from typing import List, NamedTuple, Optional, Sequence, Tuple

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



# ---------------------------------------------------------------------------
# the decoder
# ---------------------------------------------------------------------------

_SOF_NAMES = {0xC0: "SOF0", 0xC1: "SOF1", 0xC2: "SOF2 (progressive)",
              0xC3: "SOF3 (lossless)", 0xC5: "SOF5 (hierarchical)",
              0xC6: "SOF6 (hierarchical progressive)",
              0xC7: "SOF7 (hierarchical lossless)",
              0xC9: "SOF9 (arithmetic coding)",
              0xCA: "SOF10 (arithmetic progressive)",
              0xCB: "SOF11 (arithmetic lossless)",
              0xCD: "SOF13 (arithmetic hierarchical)",
              0xCE: "SOF14 (arithmetic hierarchical progressive)",
              0xCF: "SOF15 (arithmetic hierarchical lossless)"}
# the end of a scan's entropy-coded data: a marker other than RSTn
_SCAN_END = re.compile(rb"\xff[^\x00\xd0-\xd7\xff]")
_RST = re.compile(rb"\xff+[\xd0-\xd7]")
# where an interval's data ends: an FF that is not a stuffed FF 00
_DATA_END = re.compile(rb"\xff(?!\x00)")
# zero bytes read past an interval's data: more than one block can use
_PAD = 512


class Scan(NamedTuple):
    comps: Tuple[int, ...]      # frame component index of each
    dc: Tuple[Tuple[bytes, bytes], ...]  # (16 code counts, symbols) each
    ac: Tuple[Tuple[bytes, bytes], ...]
    restart: int                # restart interval in MCUs, 0 for none
    data: memoryview            # entropy-coded data, RSTn markers inside


class Frame(NamedTuple):
    width: int
    height: int
    h: Tuple[int, ...]          # sampling factors of each component
    v: Tuple[int, ...]
    qt: Tuple[np.ndarray, ...]  # each component's table, natural order
    scans: Tuple[Scan, ...]
    transform: bool             # YCbCr -> RGB


class _Tables:
    """Quantisation and Huffman tables and the restart interval as a
    stream defines them, marker by marker."""

    def __init__(self):
        self.q, self.dc, self.ac, self.restart = {}, {}, {}, 0

    def dqt(self, body: bytes) -> None:
        pos = 0
        while pos < len(body):
            pq, tq = body[pos] >> 4, body[pos] & 15
            n = 128 if pq else 64
            if pq > 1 or tq > 3 or pos + 1 + n > len(body):
                raise ValueError("bad JPEG DQT segment")
            zz = np.frombuffer(body, ">u2" if pq else "u1", 64, pos + 1)
            table = np.zeros(64, np.uint16)
            table[ZIGZAG] = zz
            self.q[tq] = table
            pos += 1 + n

    def dht(self, body: bytes) -> None:
        pos = 0
        while pos < len(body):
            if pos + 17 > len(body):
                raise ValueError("bad JPEG DHT segment")
            tc, th = body[pos] >> 4, body[pos] & 15
            bits = bytes(body[pos + 1:pos + 17])
            n = sum(bits)
            if tc > 1 or th > 3 or n > 256 or pos + 17 + n > len(body):
                raise ValueError("bad JPEG DHT segment")
            (self.ac if tc else self.dc)[th] = (bits,
                                                bytes(body[pos + 17:
                                                           pos + 17 + n]))
            pos += 17 + n

    def huffman(self, kind: str, slot: int) -> Tuple[bytes, bytes]:
        table = (self.ac if kind == "AC" else self.dc).get(slot)
        if table is None:
            if slot > 1:
                raise ValueError(f"JPEG scan uses {kind} Huffman table "
                                 f"{slot}, which the stream does not define")
            # libjpeg-turbo's rule for Motion-JPEG: the standard tables
            table = ((bytes(_AC_BITS[slot]), _AC_VALS[slot]) if kind == "AC"
                     else (bytes(_DC_BITS[slot]), _DC_VALS))
        return table


def _segments(data, pos: int):
    """(marker, body start, body end) from ``pos`` on; fill bytes
    skipped, no body for SOI, EOI and RSTn."""
    n = len(data)
    while pos < n:
        if data[pos] != 0xFF:
            raise ValueError(f"expected a JPEG marker at byte {pos}")
        while pos < n and data[pos] == 0xFF:
            pos += 1
        if pos >= n:
            break
        marker = data[pos]
        pos += 1
        if marker in (0xD8, 0xD9) or 0xD0 <= marker <= 0xD7:
            yield marker, pos, pos
            continue
        if pos + 2 > n:
            raise ValueError("truncated JPEG segment")
        (length,) = struct.unpack_from(">H", data, pos)
        if length < 2 or pos + length > n:
            raise ValueError(f"truncated JPEG segment {marker:#04x}")
        yield marker, pos + 2, pos + length
        pos += length


def parse_jpeg(data, tables=None, transform: Optional[bool] = None
               ) -> Frame:
    """The frame of the baseline JPEG stream ``data`` (bytes or a
    memoryview): its size, sampling, tables and scans.  ``tables``, a
    table-specification stream (a TIFF's JPEGTables), is read first.
    ``transform`` None: YCbCr -> RGB as libjpeg decides for a file
    (JFIF, Adobe APP14, component ids); True / False: as the caller
    says."""
    data = memoryview(data).cast("B")
    t = _Tables()
    if tables is not None:
        tables = bytes(tables)
        for marker, a, b in _segments(tables, 0):
            if marker == 0xDB:
                t.dqt(tables[a:b])
            elif marker == 0xC4:
                t.dht(tables[a:b])
            elif marker == 0xDD:
                (t.restart,) = struct.unpack_from(">H", tables, a)
            elif marker == 0xD9:
                break
    if bytes(data[:2]) != b"\xff\xd8":
        raise ValueError("not a JPEG stream (no SOI)")
    jfif, adobe = False, None
    size = ids = h = v = tq = None
    qt: List[Optional[np.ndarray]] = []
    scans = []
    pos = 2
    while True:
        seg = next(_segments(data, pos), None)
        if seg is None:
            break
        marker, a, b = seg
        pos = b
        body = bytes(data[a:b])
        if marker == 0xD9:
            break
        if marker == 0xE0 and body[:5] == b"JFIF\0":
            jfif = True
        elif marker == 0xEE and body[:5] == b"Adobe" and len(body) >= 12:
            adobe = body[11]
        elif marker == 0xDB:
            t.dqt(body)
        elif marker == 0xC4:
            t.dht(body)
        elif marker == 0xDD:
            (t.restart,) = struct.unpack(">H", body[:2])
        elif marker in (0xC0, 0xC1):
            if size is not None:
                raise ValueError("JPEG stream with two frames")
            precision, height, width, n = struct.unpack(">BHHB", body[:6])
            if precision != 8:
                raise NotImplementedError(
                    f"a {precision}-bit JPEG ({_SOF_NAMES[marker]}); the "
                    f"port decodes 8-bit samples, as PIL does")
            if n not in (1, 3):
                raise NotImplementedError(
                    f"a JPEG of {n} components ({_SOF_NAMES[marker]}); "
                    f"the port decodes 1 (gray) or 3 (YCbCr or RGB)")
            if height == 0 or width == 0:
                raise NotImplementedError(
                    "a JPEG whose height is set by a DNL marker")
            if len(body) < 6 + 3 * n:
                raise ValueError("truncated JPEG SOF segment")
            comp = [body[6 + 3 * i:9 + 3 * i] for i in range(n)]
            ids = [c[0] for c in comp]
            h = tuple(c[1] >> 4 for c in comp)
            v = tuple(c[1] & 15 for c in comp)
            tq = [c[2] for c in comp]
            hm, vm = max(h), max(v)
            if any(not 1 <= x <= 4 for x in h + v) or any(
                    hm % x for x in h) or any(vm % x for x in v):
                raise NotImplementedError(
                    f"JPEG sampling factors {list(zip(h, v))}; the port "
                    f"decodes factors 1..4 that divide the largest")
            size = (width, height)
            qt = [None] * n
        elif marker in _SOF_NAMES:
            raise NotImplementedError(
                f"a JPEG frame of marker {_SOF_NAMES[marker]}; the port "
                f"decodes baseline and extended sequential Huffman frames "
                f"(SOF0, SOF1)")
        elif marker == 0xDA:
            if size is None:
                raise ValueError("JPEG scan before its frame")
            ns = body[0]
            if not 1 <= ns <= len(ids) or len(body) < 4 + 2 * ns:
                raise ValueError(f"bad JPEG SOS segment ({ns} components)")
            sel = [body[1 + 2 * i:3 + 2 * i] for i in range(ns)]
            ss, se, ahl = body[1 + 2 * ns:4 + 2 * ns]
            if ss != 0 or se != 63 or ahl != 0:
                raise NotImplementedError(
                    "a JPEG scan of spectral selection or successive "
                    "approximation (progressive)")
            comps = []
            for cs, _ in sel:
                if cs not in ids:
                    raise ValueError(f"JPEG scan names component {cs}, "
                                     f"which the frame lacks")
                comps.append(ids.index(cs))
            for c in comps:
                if qt[c] is None:  # latched at the component's first scan
                    if tq[c] not in t.q:
                        raise ValueError(f"JPEG quantisation table {tq[c]} "
                                         f"is not defined")
                    qt[c] = t.q[tq[c]]
            end = _SCAN_END.search(data, b)
            end = len(data) if end is None else end.start()
            scans.append(Scan(
                tuple(comps),
                tuple(t.huffman("DC", x >> 4) for _, x in sel),
                tuple(t.huffman("AC", x & 15) for _, x in sel),
                t.restart, data[b:end]))
            pos = end
        elif marker == 0xDC:
            pass  # DNL after the first scan: the height is already set
        # APPn, COM and the rest carry nothing the decode needs
    if size is None or not scans:
        raise ValueError("JPEG stream without a frame and a scan")
    if any(q is None for q in qt):
        raise ValueError("a JPEG component that no scan codes")
    if len(scans) > 4:
        raise NotImplementedError(f"a JPEG of {len(scans)} scans")
    if transform is None:
        transform = len(ids) == 3 and _libjpeg_transform(jfif, adobe, ids)
    return Frame(size[0], size[1], h, v, tuple(qt), tuple(scans),
                 bool(transform and len(ids) == 3))


def _libjpeg_transform(jfif: bool, adobe: Optional[int], ids) -> bool:
    """libjpeg's default_decompress_parms for 3 components: JFIF implies
    YCbCr; an Adobe marker's transform 0 means RGB; else the component
    ids 'R', 'G', 'B' mean RGB and anything else YCbCr."""
    if jfif:
        return True
    if adobe is not None:
        return adobe != 0
    return list(ids) != [82, 71, 66]


# ---- the plain version: Python entropy decode, numpy IDCT and colour

_NAT = ZIGZAG.tolist()
# jidctint.c's constants (CONST_BITS 13, PASS1_BITS 2)
_F = dict(F0298=2446, F0390=3196, F0541=4433, F0765=6270, F0899=7373,
          F1175=9633, F1501=12299, F1847=15137, F1961=16069, F2053=16819,
          F2562=20995, F3072=25172)


def _lut(bits: bytes, vals: bytes) -> List[int]:
    """(length << 8 | symbol) of every 16-bit window, 0 where no code."""
    lut = np.zeros(1 << 16, np.int64)
    code = k = 0
    for n in range(1, 17):
        cnt = bits[n - 1]
        if cnt and code + cnt > (1 << n):
            raise ValueError("bad JPEG Huffman table")
        for _ in range(cnt):
            lo = code << (16 - n)
            lut[lo:lo + (1 << (16 - n))] = (n << 8) | vals[k]
            code += 1
            k += 1
        code <<= 1
    return lut.tolist()


def _windows(part: bytes) -> List[int]:
    """The 32 bits from each byte on, zeros past the end (``_PAD``
    bytes of them)."""
    b = np.frombuffer(part + bytes(_PAD + 4), np.uint8).astype(np.int64)
    return ((b[:-3] << 24) | (b[1:-2] << 16) | (b[2:-1] << 8)
            | b[3:]).tolist()


def _entropy_plain(f: Frame, s: Scan) -> List[np.ndarray]:
    """The quantised coefficients [blocks down, blocks across, 64]
    (natural order) of each component of scan ``s``."""
    hm, vm = max(f.h), max(f.v)
    dc = [_lut(*x) for x in s.dc]
    ac = [_lut(*x) for x in s.ac]
    if len(s.comps) == 1:
        c = s.comps[0]
        dw = -(-f.width * f.h[c] // hm)
        dh = -(-f.height * f.v[c] // vm)
        across, down = -(-dw // 8), -(-dh // 8)
        grids = [(down, across)]
        layout = [(0, 0, 0)]  # (slot, block row, block column) in a unit
        per = [(1, 1)]
    else:
        across = -(-f.width // (8 * hm))
        down = -(-f.height // (8 * vm))
        grids = [(down * f.v[c], across * f.h[c]) for c in s.comps]
        layout = [(k, by, bx) for k, c in enumerate(s.comps)
                  for by in range(f.v[c]) for bx in range(f.h[c])]
        per = [(f.v[c], f.h[c]) for c in s.comps]
    coefs = [[0] * (gy * gx * 64) for gy, gx in grids]
    # each restart interval's data, up to its first marker (the C++
    # reader reads zeros past it, as libjpeg does), unstuffed
    raw = bytes(s.data)
    parts = []
    for p in (_RST.split(raw) if s.restart else [raw]):
        end = _DATA_END.search(p)
        parts.append((p if end is None else p[:end.start()]).replace(
            b"\xff\x00", b"\xff"))
    units = across * down
    if s.restart and len(parts) < -(-units // s.restart):
        raise ValueError("JPEG scan with fewer restart intervals than "
                         "its MCUs need")
    nat = _NAT
    pi = 0
    win = _windows(parts[0])
    end_bits = 8 * len(parts[0])
    pos = 0
    pred = [0] * len(s.comps)
    left = s.restart
    for u in range(units):
        if s.restart:
            if not left:
                pi += 1
                win = _windows(parts[pi])
                end_bits = 8 * len(parts[pi])
                pos = 0
                pred = [0] * len(s.comps)
                left = s.restart
            left -= 1
        my, mx = divmod(u, across)
        for k, by, bx in layout:
            # past the data every bit is 0: decoding there does not
            # depend on the position
            pos = min(pos, end_bits)
            vy, hx = per[k]
            gx = grids[k][1]
            base = ((my * vy + by) * gx + mx * hx + bx) * 64
            out = coefs[k]
            e = dc[k][(win[pos >> 3] >> (16 - (pos & 7))) & 0xFFFF]
            if not e or (e & 0xFF) > 16:
                raise ValueError("corrupt JPEG data (a bad DC code)")
            pos += e >> 8
            t = e & 0xFF
            if t:
                x = (win[pos >> 3] >> (32 - (pos & 7) - t)) & ((1 << t) - 1)
                pos += t
                if x < (1 << (t - 1)):
                    x -= (1 << t) - 1
                pred[k] += x
            out[base] = ((pred[k] + 32768) & 0xFFFF) - 32768
            i = 1
            table = ac[k]
            while i < 64:
                e = table[(win[pos >> 3] >> (16 - (pos & 7))) & 0xFFFF]
                if not e:
                    raise ValueError("corrupt JPEG data (a bad AC code)")
                pos += e >> 8
                rs = e & 0xFF
                z = rs & 15
                if z:
                    i += rs >> 4
                    if i > 63:
                        raise ValueError("corrupt JPEG data (a run past "
                                         "the block)")
                    x = (win[pos >> 3] >> (32 - (pos & 7) - z)) & (
                        (1 << z) - 1)
                    pos += z
                    if x < (1 << (z - 1)):
                        x -= (1 << z) - 1
                    out[base + nat[i]] = x
                    i += 1
                elif rs == 0xF0:
                    i += 16
                else:
                    break
    return [np.array(c, np.int64).reshape(gy, gx, 64)
            for c, (gy, gx) in zip(coefs, grids)]


def _butterfly(i0, i1, i2, i3, i4, i5, i6, i7, half, shift):
    """One 1-D pass of jidctint.c on int64 arrays; returns the 8 outputs
    descaled by ``shift`` (rounding with ``half``)."""
    F = _F
    z1 = (i2 + i6) * F["F0541"]
    tmp2 = z1 - i6 * F["F1847"]
    tmp3 = z1 + i2 * F["F0765"]
    tmp0 = (i0 + i4) * 8192
    tmp1 = (i0 - i4) * 8192
    t10, t13 = tmp0 + tmp3, tmp0 - tmp3
    t11, t12 = tmp1 + tmp2, tmp1 - tmp2
    tmp0, tmp1, tmp2, tmp3 = i7, i5, i3, i1
    z1, z2 = tmp0 + tmp3, tmp1 + tmp2
    z3, z4 = tmp0 + tmp2, tmp1 + tmp3
    z5 = (z3 + z4) * F["F1175"]
    tmp0 = tmp0 * F["F0298"]
    tmp1 = tmp1 * F["F2053"]
    tmp2 = tmp2 * F["F3072"]
    tmp3 = tmp3 * F["F1501"]
    z1 = z1 * -F["F0899"]
    z2 = z2 * -F["F2562"]
    z3 = z3 * -F["F1961"] + z5
    z4 = z4 * -F["F0390"] + z5
    tmp0 = tmp0 + z1 + z3
    tmp1 = tmp1 + z2 + z4
    tmp2 = tmp2 + z2 + z3
    tmp3 = tmp3 + z1 + z4
    return [(x + half) >> shift for x in (
        t10 + tmp3, t11 + tmp2, t12 + tmp1, t13 + tmp0, t13 - tmp0,
        t12 - tmp1, t11 - tmp2, t10 - tmp3)]


def _idct_limit(x: np.ndarray) -> np.ndarray:
    """libjpeg's post-IDCT range limit, table[x & 1023]."""
    i = x & 1023
    return np.where(i < 128, i + 128, np.where(
        i < 512, 255, np.where(i < 896, 0, i - 896))).astype(np.uint8)


def _idct_plain(coef: np.ndarray, q: np.ndarray) -> np.ndarray:
    """jidctint.c's jpeg_idct_islow of blocks [..., 64] (natural order,
    dequantised by ``q`` here): uint8 samples [..., 8, 8]."""
    x = (coef * q.astype(np.int64)).reshape(coef.shape[:-1] + (8, 8))
    ws = np.stack(_butterfly(*(x[..., r, :] for r in range(8)), 1 << 10,
                             11), axis=-2)
    ws = ws.astype(np.int32).astype(np.int64)  # the int work array
    out = np.stack(_butterfly(*(ws[..., :, c] for c in range(8)), 1 << 17,
                              18), axis=-1)
    return _idct_limit(out)


def _shifted(p: np.ndarray, axis: int, step: int) -> np.ndarray:
    """``p`` moved one sample along ``axis``: entry i holds i - step
    (step 1) or i + 1 (step -1), the edge sample repeated."""
    n = p.shape[axis]
    idx = np.clip(np.arange(n) - step, 0, n - 1)
    return np.take(p, idx, axis=axis)


def _interleave(even: np.ndarray, odd: np.ndarray, axis: int):
    out = np.stack([even, odd], axis=axis + 1)
    shape = list(even.shape)
    shape[axis] *= 2
    return out.reshape(shape)


def _upsample_plain(p: np.ndarray, rh: int, rv: int) -> np.ndarray:
    """jdsample.c's upsampling of a component [dh, dw] (int64) by (rh,
    rv), fancy where libjpeg is (h2v1 and h2v2 wider than 2 samples,
    h1v2 always)."""
    dw = p.shape[1]
    if rh == 1 and rv == 1:
        return p
    if rh == 2 and rv == 1 and dw > 2:
        return _interleave((3 * p + _shifted(p, 1, 1) + 1) >> 2,
                           (3 * p + _shifted(p, 1, -1) + 2) >> 2, 1)
    if rh == 1 and rv == 2:
        return _interleave((3 * p + _shifted(p, 0, 1) + 1) >> 2,
                           (3 * p + _shifted(p, 0, -1) + 2) >> 2, 0)
    if rh == 2 and rv == 2 and dw > 2:
        rows = []
        for cs in (3 * p + _shifted(p, 0, 1), 3 * p + _shifted(p, 0, -1)):
            rows.append(_interleave((3 * cs + _shifted(cs, 1, 1) + 8) >> 4,
                                    (3 * cs + _shifted(cs, 1, -1) + 7) >> 4,
                                    1))
        return _interleave(rows[0], rows[1], 0)
    return np.repeat(np.repeat(p, rv, axis=0), rh, axis=1)


_X = np.arange(256, dtype=np.int64) - 128
_CR_R = (91881 * _X + 32768) >> 16
_CB_B = (116130 * _X + 32768) >> 16
_CR_G = -46802 * _X
_CB_G = -22554 * _X + 32768


def _decode_plain(f: Frame) -> np.ndarray:
    """The pixels of frame ``f``: uint8 [H, W] or [H, W, 3]."""
    hm, vm = max(f.h), max(f.v)
    n = len(f.h)
    mx, my = -(-f.width // (8 * hm)), -(-f.height // (8 * vm))
    planes = [np.zeros((my * f.v[c] * 8, mx * f.h[c] * 8), np.uint8)
              for c in range(n)]
    for s in f.scans:
        for c, coef in zip(s.comps, _entropy_plain(f, s)):
            gy, gx = coef.shape[:2]
            blocks = _idct_plain(coef, f.qt[c])
            planes[c][:gy * 8, :gx * 8] = blocks.transpose(
                0, 2, 1, 3).reshape(gy * 8, gx * 8)
    full = []
    for c in range(n):
        dw = -(-f.width * f.h[c] // hm)
        dh = -(-f.height * f.v[c] // vm)
        p = planes[c][:dh, :dw].astype(np.int64)
        full.append(_upsample_plain(p, hm // f.h[c], vm // f.v[c])
                    [:f.height, :f.width])
    if n == 1:
        return full[0].astype(np.uint8)
    y, cb, cr = full
    if f.transform:
        rgb = [y + _CR_R[cr], y + ((_CB_G[cb] + _CR_G[cr]) >> 16),
               y + _CB_B[cb]]
    else:
        rgb = full
    return np.clip(np.stack(rgb, axis=-1), 0, 255).astype(np.uint8)


# ---- the C++ version (csrc/imgcodec.cpp)

class _CScan(ctypes.Structure):
    _fields_ = [("data", ctypes.c_void_p), ("len", ctypes.c_int64),
                ("ncomp", ctypes.c_int32), ("restart", ctypes.c_int32),
                ("comp", ctypes.c_int32 * 4),
                ("dc_bits", (ctypes.c_uint8 * 16) * 4),
                ("dc_vals", (ctypes.c_uint8 * 256) * 4),
                ("ac_bits", (ctypes.c_uint8 * 16) * 4),
                ("ac_vals", (ctypes.c_uint8 * 256) * 4)]


class _CFrame(ctypes.Structure):
    _fields_ = [("width", ctypes.c_int32), ("height", ctypes.c_int32),
                ("ncomp", ctypes.c_int32), ("transform", ctypes.c_int32),
                ("h", ctypes.c_int32 * 4), ("v", ctypes.c_int32 * 4),
                ("qt", (ctypes.c_uint16 * 64) * 4),
                ("nscans", ctypes.c_int32), ("status", ctypes.c_int32),
                ("scans", _CScan * 4), ("out", ctypes.c_void_p),
                ("out_stride", ctypes.c_int64),
                ("out_rows", ctypes.c_int32), ("out_cols", ctypes.c_int32)]


_STATUS = {-1: "a frame the decoder does not take",
           -2: "a bad Huffman table", -3: "corrupt entropy-coded data"}


def _fill(cf: _CFrame, f: Frame, out: np.ndarray, keep: list) -> None:
    cf.width, cf.height, cf.ncomp = f.width, f.height, len(f.h)
    cf.transform = int(f.transform)
    for c in range(len(f.h)):
        cf.h[c], cf.v[c] = f.h[c], f.v[c]
        ctypes.memmove(cf.qt[c], f.qt[c].ctypes.data, 128)
    cf.nscans = len(f.scans)
    for i, s in enumerate(f.scans):
        cs = cf.scans[i]
        buf = np.frombuffer(s.data, np.uint8)
        keep.append(buf)
        cs.data, cs.len = buf.ctypes.data if buf.size else None, buf.size
        cs.ncomp, cs.restart = len(s.comps), s.restart
        for k, c in enumerate(s.comps):
            cs.comp[k] = c
            for dst_bits, dst_vals, (bits, vals) in (
                    (cs.dc_bits, cs.dc_vals, s.dc[k]),
                    (cs.ac_bits, cs.ac_vals, s.ac[k])):
                ctypes.memmove(dst_bits[k], bits, 16)
                ctypes.memmove(dst_vals[k], vals, len(vals))
    cf.out = out.ctypes.data
    cf.out_stride = out.strides[0]
    cf.out_rows, cf.out_cols = out.shape[:2]


def _check_out(f: Frame, out: np.ndarray) -> None:
    nc = len(f.h)
    if (out.dtype != np.uint8 or out.ndim != 3 or out.shape[2] != nc
            or out.strides[2] != 1 or out.strides[1] != nc
            or out.strides[0] < nc * out.shape[1]
            or not out.flags.writeable
            or out.shape[0] > f.height or out.shape[1] > f.width):
        raise ValueError(f"the output of a {f.width} x {f.height} JPEG of "
                         f"{nc} components must be uint8 [rows, cols, {nc}] "
                         f"with contiguous pixels, within the frame; got "
                         f"{out.dtype} {out.shape} strides {out.strides}")


def decode_frames(frames: Sequence[Frame], outs: Sequence[np.ndarray],
                  plain: bool = False) -> None:
    """Decode each frame into its ``out``, uint8 [rows, cols, components]
    (the frame's top-left corner: a TIFF's edge tile is cropped), e.g. a
    view into a page.  C++ by default, the frames in parallel threads
    (one per hardware thread); ``plain=True``: the
    numpy version, one frame after another.  A corrupt stream raises
    ``ValueError``."""
    if len(frames) != len(outs):
        raise ValueError(f"{len(frames)} frames but {len(outs)} outputs")
    for f, out in zip(frames, outs):
        _check_out(f, out)
    if plain:
        for f, out in zip(frames, outs):
            px = _decode_plain(f)
            out[...] = px.reshape(px.shape[:2] + (-1,))[:out.shape[0],
                                                         :out.shape[1]]
        return
    from multimodalfusion_tpu_torch import native
    lib = native.codec_lib()
    if lib.mmf_jpeg_frame_size() != ctypes.sizeof(_CFrame):
        raise RuntimeError("csrc/imgcodec.cpp's MmfJpegFrame and "
                           "utils/jpeg.py's _CFrame disagree")
    arr = (_CFrame * len(frames))()
    keep: list = []
    for cf, f, out in zip(arr, frames, outs):
        _fill(cf, f, out, keep)
    if lib.mmf_jpeg_decode(arr, len(frames), 0):
        bad = next(cf.status for cf in arr if cf.status)
        raise ValueError(f"JPEG decode failed: {_STATUS.get(bad, bad)}")


def decode_jpeg(data, tables=None, transform: Optional[bool] = None,
                plain: bool = False) -> np.ndarray:
    """The pixels of the JPEG stream ``data`` (see ``parse_jpeg``): uint8
    [H, W] for one component, [H, W, 3] for three."""
    f = parse_jpeg(data, tables, transform)
    out = np.empty((f.height, f.width, len(f.h)), np.uint8)
    decode_frames([f], [out], plain=plain)
    return out[..., 0] if len(f.h) == 1 else out


def read_jpeg(path: str, plain: bool = False) -> np.ndarray:
    """The pixels of the JPEG file at ``path`` (see ``decode_jpeg``)."""
    with open(path, "rb") as fh:
        return decode_jpeg(fh.read(), plain=plain)
