"""JPEG, the port's stand-in for OpenCV's and PIL's libjpeg (the machine
with the card has neither): a baseline encoder in numpy and a decoder of
sequential, progressive and lossless frames, Huffman- or
arithmetic-coded, in C++ with its plain version in numpy.

The encoder (``encode_jpeg``) stands in for ``cv2.imwrite(".jpg")``
with OpenCV's defaults, for uint8 RGB images.

What it writes is what libjpeg writes by default: a JFIF 1.01 header,
quality 95 (the Annex K tables scaled as libjpeg scales them), YCbCr
with 4:2:0 chroma, the standard Huffman tables of Annex K.3 and one
interleaved scan.  It cannot equal libjpeg byte for byte: the colour
conversion, the 2 x 2 chroma means and the DCT are computed in float32
here (libjpeg: fixed point), then rounded once at quantisation.  The
entropy coding is vectorised over all blocks; the codes are summed into
32-bit words (``_pack``) and every 0xFF byte of the scan is stuffed with
0x00.

The decoder (``decode_jpeg``, ``decode_frames``) reads what PIL's
libjpeg-turbo decodes in 8-bit frames, bit for bit: baseline, extended
sequential and progressive frames in Huffman coding (SOF0, SOF1, SOF2)
or in arithmetic coding (SOF9, SOF10), and lossless Huffman frames
(SOF3), of 1, 3 or 4 components, sampling factors 1..4 that divide
the largest (4:4:4, 4:2:2, 4:2:0, 4:4:0, ...), one or several scans, restart intervals in
every scan type, several DQT / DHT segments (a progressive stream's
Huffman tables are latched at each SOS), 16-bit quantisation tables, the
standard Huffman tables when a stream defines none (libjpeg-turbo's
Motion-JPEG rule), and abbreviated streams whose tables come from
elsewhere (a TIFF's JPEGTables).  A progressive frame's scans (DC first
and refinement, AC spectral selection and successive approximation with
EOB runs, jdphuff.c) build one coefficient array per component; a script
that leaves coefficients unrefined is smoothed as libjpeg-turbo 3.x
smooths it (jdcoefct.c's decompress_smooth_data, ``_smooth_plain``); a
script libjpeg refuses, or one it only warns about (a scan that does not
follow its predecessors), raises ``ValueError``.  It computes with
libjpeg's accurate integer IDCT (jidctint.c), libjpeg 6b's triangle
("fancy") upsampling (jdsample.c) and its fixed-point YCbCr -> RGB and
YCCK -> CMYK tables (jdcolor.c).  The colour transform is applied as
libjpeg decides it (a JFIF marker, an Adobe APP14 transform flag, the
component ids), or as the caller says (a TIFF's
PhotometricInterpretation).  Four components come out as PIL holds them,
inverted ("CMYK;I", with or without an Adobe marker); PIL refuses two,
and so does the port.  An arithmetic-coded frame (T.81 Annex D's QM
decoder and libjpeg-turbo's jdarith.c context models: statistics bins
of each table number, shared by the components of one table, the DAC
segment's conditioning L, U and Kx, T.81's defaults where a stream has
none; reset at each restart) fills the same coefficient arrays as a
Huffman one, and its progressive scans are smoothed alike.  A lossless
frame (jdlhuff.c, jddiffct.c, jdlossls.c) is decoded sample by sample:
predictors 1..7, the point transform, restart intervals of whole MCU
rows, subsampled components replicated; libjpeg-turbo converts no colour
in lossless mode, so a lossless frame it would convert (JFIF, an Adobe
transform) raises, as PIL raises.  ``parse_jpeg`` reads the markers in
Python; the entropy decode, smoothing, IDCT, upsampling and colour
conversion run in ``csrc/imgcodec.cpp`` (``mmf_jpeg_decode``,
independent frames in parallel threads), or, with ``plain=True``, in
Python and numpy (``_decode_plain``), the oracle of the tests and
``chip_smoke.py``.  SOF11 and the hierarchical frames, which
libjpeg-turbo does not decode, samples of other than 8 bits and 2
components raise ``NotImplementedError`` naming the marker or the count,
as PIL raises; so does a lossless or arithmetic-coded stream cut short
(``ValueError``).  One difference from PIL is deliberate: PIL reads a
file in 64 KiB blocks and libjpeg's arithmetic decoder cannot wait for
the next one, so PIL refuses an arithmetic-coded ``.jpg`` larger than
that block, while libtiff, which hands libjpeg a tile whole, decodes
any; the port decodes the whole stream, as libjpeg does when given it.
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
    """The bit string of the codes (each at most 32 bits), MSB first,
    padded with ones, each 0xFF byte followed by 0x00.  Each code is added
    into the one or two 32-bit words its bits fall in (the codes do not
    overlap, so the sums are ORs, exact in float64)."""
    values = np.asarray(values, np.int64)
    lengths = np.asarray(lengths, np.int64)
    total = int(lengths.sum())
    pad = -total % 8
    values = np.append(values, (1 << pad) - 1)
    end = np.cumsum(np.append(lengths, pad))
    last = np.maximum(end - 1, 0)
    shifted = values << (31 - (last & 31))
    word = last >> 5
    n = (total + pad) // 32 + 2
    words = (np.bincount(word, shifted & 0xFFFFFFFF, n)
             + np.bincount(np.maximum(word - 1, 0), shifted >> 32, n))
    data = words.astype(np.uint64).astype(">u4").view(np.uint8)[
        :(total + pad) // 8]
    ff = np.flatnonzero(data == 0xFF)
    return np.insert(data, ff + 1, 0).tobytes()


def _segment(marker: int, body: bytes) -> bytes:
    return struct.pack(">BBH", 0xFF, marker, len(body) + 2) + body


def _coefficient_chunks(a: np.ndarray, chunk_rows: int):
    """The quantised coefficients that ``encode_jpeg`` codes, ``chunk_rows``
    MCU rows at a time: (Y, Cb, Cr) [block rows, block cols, 64] in
    zigzag order, the edge repeated out to whole MCUs, as libjpeg pads."""
    qy, qc = quant_tables()
    pw = -a.shape[1] % 16
    for r0 in range(0, a.shape[0], 16 * chunk_rows):
        band = a[r0:r0 + 16 * chunk_rows]
        px = np.pad(band, ((0, -band.shape[0] % 16), (0, pw), (0, 0)),
                    mode="edge")
        ycc = (px.reshape(-1, 3).astype(np.float32) @ _YCC.T
               + _YCC_OFFSET).reshape(px.shape)
        sub = [(c[0::2, 0::2] + c[1::2, 0::2] + c[0::2, 1::2]
                + c[1::2, 1::2]) * np.float32(0.25)
               for c in (ycc[..., 1], ycc[..., 2])]
        yield (_quantised(ycc[..., 0], qy), _quantised(sub[0], qc),
               _quantised(sub[1], qc))


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
    streams = []
    dc_prev = np.zeros(3, np.int64)
    for qy_b, qcb, qcr in _coefficient_chunks(a, chunk_rows):
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


# a frame's coding, by its SOF marker
HUFFMAN, ARITHMETIC, LOSSLESS = 0, 1, 2
_SOF_CODING = {0xC0: (HUFFMAN, False), 0xC1: (HUFFMAN, False),
               0xC2: (HUFFMAN, True), 0xC9: (ARITHMETIC, False),
               0xCA: (ARITHMETIC, True), 0xC3: (LOSSLESS, False)}


class Scan(NamedTuple):
    comps: Tuple[int, ...]      # frame component index of each
    # (16 code counts, symbols) of each component, as the tables stood at
    # this scan's SOS; None where the scan uses no table of that class
    # (an arithmetic-coded scan uses none)
    dc: Tuple[Optional[Tuple[bytes, bytes]], ...]
    ac: Tuple[Optional[Tuple[bytes, bytes]], ...]
    restart: int                # restart interval in MCUs, 0 for none
    data: memoryview            # entropy-coded data, RSTn markers inside
    ss: int                     # spectral selection, zigzag positions
    se: int                     # (lossless: Ss is the predictor)
    ah: int                     # successive approximation: the bit
    al: int                     # position before and after this scan
    # (lossless: Al is the point transform)
    # arithmetic coding: each component's (DC, AC) table numbers, whose
    # statistics bins components of one table share, and the DAC
    # conditioning as it stood at this SOS: (L, U) of its DC table, Kx of
    # its AC table
    tbl: Tuple[Tuple[int, int], ...] = ()
    cond: Tuple[Tuple[int, int, int], ...] = ()


class Frame(NamedTuple):
    width: int
    height: int
    h: Tuple[int, ...]          # sampling factors of each component
    v: Tuple[int, ...]
    qt: Tuple[np.ndarray, ...]  # each component's table, natural order
    scans: Tuple[Scan, ...]
    transform: bool             # YCbCr -> RGB (3), YCCK -> CMYK (4)
    progressive: bool           # SOF2, SOF10
    coding: int = HUFFMAN       # HUFFMAN, ARITHMETIC or LOSSLESS


class _Tables:
    """Quantisation and Huffman tables, the arithmetic conditioning and
    the restart interval as a stream defines them, marker by marker."""

    def __init__(self):
        self.q, self.dc, self.ac, self.restart = {}, {}, {}, 0
        self.dac_dc, self.dac_ac = {}, {}

    def dac(self, body: bytes) -> None:
        """A DAC segment (jdmarker.c's get_dac): (Tc << 4 | Tb, value)
        pairs; a DC table's value is U << 4 | L with L <= U, an AC
        table's is Kx."""
        if len(body) % 2:
            raise ValueError("bad JPEG DAC segment (odd length)")
        for i in range(0, len(body), 2):
            index, val = body[i], body[i + 1]
            if index >= 32:
                raise ValueError(f"bad JPEG DAC table index {index}")
            if index >= 16:
                self.dac_ac[index - 16] = val
            elif (val & 15) > (val >> 4):
                raise ValueError(f"bad JPEG DAC value {val:#04x} (L > U)")
            else:
                self.dac_dc[index] = (val & 15, val >> 4)

    def conditioning(self, dc: int, ac: int) -> Tuple[int, int, int]:
        """(L, U, Kx) of DC table ``dc`` and AC table ``ac``: T.81's
        defaults (0, 1, 5) where no DAC defined them."""
        return self.dac_dc.get(dc, (0, 1)) + (self.dac_ac.get(ac, 5),)

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
    """The frame of the JPEG stream ``data`` (bytes or a memoryview): its
    size, sampling, tables and scans.  ``tables``, a table-specification
    stream (a TIFF's JPEGTables), is read first.  ``transform`` None:
    YCbCr -> RGB (3 components) or YCCK -> CMYK (4) as libjpeg decides
    for a file (JFIF, Adobe APP14, component ids); True / False: as the
    caller says.  A progressive scan script is checked as libjpeg checks
    it (``_check_scan``)."""
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
        # the stream's own SOI resets the arithmetic conditioning
        # (jdmarker.c's get_soi), so a DAC in the tables stream counts
        # for nothing
    if bytes(data[:2]) != b"\xff\xd8":
        raise ValueError("not a JPEG stream (no SOI)")
    jfif, adobe = False, None
    size = ids = h = v = tq = marker_sof = None
    progressive = False
    coding = HUFFMAN
    qt: List[Optional[np.ndarray]] = []
    coef_bits: List[List[int]] = []
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
        elif marker == 0xCC:
            t.dac(body)
        elif marker in _SOF_CODING:
            if size is not None:
                raise ValueError("JPEG stream with two frames")
            precision, height, width, n = struct.unpack(">BHHB", body[:6])
            if precision != 8:
                raise NotImplementedError(
                    f"a {precision}-bit JPEG ({_SOF_NAMES[marker]}); the "
                    f"port decodes 8-bit samples, as PIL does")
            if n not in (1, 3, 4):
                raise NotImplementedError(
                    f"a JPEG of {n} components ({_SOF_NAMES[marker]}); "
                    f"the port decodes 1 (gray), 3 (YCbCr or RGB) or 4 "
                    f"(CMYK or YCCK), as PIL does")
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
            coding, progressive = _SOF_CODING[marker]
            marker_sof = marker
            qt = [None] * n if coding != LOSSLESS else [
                np.zeros(64, np.uint16)] * n
            coef_bits = [[-1] * 64 for _ in range(n)]
        elif marker in _SOF_NAMES:
            raise NotImplementedError(
                f"a JPEG frame of marker {_SOF_NAMES[marker]}, which "
                f"libjpeg-turbo (so PIL) does not decode either; the port "
                f"decodes sequential and progressive frames in Huffman or "
                f"arithmetic coding (SOF0, SOF1, SOF2, SOF9, SOF10) and "
                f"Huffman lossless frames (SOF3)")
        elif marker == 0xDA:
            if size is None:
                raise ValueError("JPEG scan before its frame")
            ns = body[0]
            if not 1 <= ns <= len(ids) or len(body) < 4 + 2 * ns:
                raise ValueError(f"bad JPEG SOS segment ({ns} components)")
            sel = [body[1 + 2 * i:3 + 2 * i] for i in range(ns)]
            ss, se, ahl = body[1 + 2 * ns:4 + 2 * ns]
            ah, al = ahl >> 4, ahl & 15
            comps = []
            for cs, _ in sel:
                if cs not in ids:
                    raise ValueError(f"JPEG scan names component {cs}, "
                                     f"which the frame lacks")
                comps.append(ids.index(cs))
            if coding == LOSSLESS:
                _check_lossless_scan(comps, ss, se, ah, al, t.restart, h,
                                     v, size)
            elif progressive:
                _check_scan(comps, ss, se, ah, al, coef_bits)
            elif (ss, se, ah, al) != (0, 63, 0, 0):
                raise NotImplementedError(
                    f"a scan of spectral selection or successive "
                    f"approximation ({ss}..{se}, {ah}, {al}) in a "
                    f"sequential JPEG frame")
            for c in comps:
                if qt[c] is None and coding != LOSSLESS:
                    # latched at the component's first scan
                    if tq[c] not in t.q:
                        raise ValueError(f"JPEG quantisation table {tq[c]} "
                                         f"is not defined")
                    qt[c] = t.q[tq[c]]
            end = _SCAN_END.search(data, b)
            if end is None and coding != HUFFMAN:
                # PIL raises on a stream cut short (libjpeg's arithmetic
                # decoder cannot wait for more data; PIL's loader wants
                # the EOI); so does the port for these codings
                raise ValueError(f"a truncated JPEG stream: the "
                                 f"{_SOF_NAMES[marker_sof]} scan's data "
                                 f"runs to its end, with no marker after it")
            end = len(data) if end is None else end.start()
            uses_dc = (ss == 0 and ah == 0 and coding == HUFFMAN) or (
                coding == LOSSLESS)
            uses_ac = se > 0 and coding == HUFFMAN
            tbl = tuple((x >> 4, x & 15) for _, x in sel)
            scans.append(Scan(
                tuple(comps),
                tuple(t.huffman("DC", x >> 4) if uses_dc else None
                      for _, x in sel),
                tuple(t.huffman("AC", x & 15) if uses_ac else None
                      for _, x in sel),
                t.restart, data[b:end], ss, se, ah, al,
                tbl if coding == ARITHMETIC else (),
                tuple(t.conditioning(d, a) for d, a in tbl)
                if coding == ARITHMETIC else ()))
            pos = end
        elif marker == 0xDC:
            pass  # DNL after the first scan: the height is already set
        # APPn, COM and the rest carry nothing the decode needs
    if size is None or not scans:
        raise ValueError("JPEG stream without a frame and a scan")
    if any(q is None for q in qt):
        raise ValueError("a JPEG component that no scan codes")
    if not progressive and len(scans) > 4:
        raise NotImplementedError(f"a sequential JPEG of {len(scans)} "
                                  f"scans")
    if transform is None:
        transform = _libjpeg_transform(jfif, adobe, ids, coding == LOSSLESS)
    transform = bool(transform and len(ids) in (3, 4))
    if transform and coding == LOSSLESS:
        raise NotImplementedError(
            f"a lossless JPEG (SOF3) of {len(ids)} components to be "
            f"converted from {'YCbCr' if len(ids) == 3 else 'YCCK'}: "
            f"libjpeg-turbo converts no colour in lossless mode (PIL "
            f"raises), and neither does the port")
    return Frame(size[0], size[1], h, v, tuple(qt), tuple(scans),
                 transform, progressive, coding)


def _check_scan(comps, ss, se, ah, al, coef_bits) -> None:
    """A progressive scan's parameters as libjpeg checks them
    (jdphuff.c's start_pass_phuff_decoder): a DC scan (Ss = 0) has Se =
    0; an AC scan has Ss <= Se <= 63 and one component; a refinement (Ah
    > 0) has Al = Ah - 1; Al <= 13.  libjpeg refuses those.  It only
    warns where a scan does not follow its predecessors (an AC scan
    before the component's DC, or Ah other than the last Al of each
    coefficient), and decodes on; the port refuses these too, as it
    refuses corrupt entropy-coded data.  ``coef_bits`` (each component's
    last Al of each coefficient, -1 before any scan) is brought up to
    date."""
    what = f"({ss}..{se}, Ah {ah}, Al {al})"
    if (se != 0 if ss == 0 else (ss > se or se > 63 or len(comps) != 1)) \
            or (ah and al != ah - 1) or al > 13:
        raise ValueError(f"a progressive JPEG scan of bad parameters "
                         f"{what}")
    for c in comps:
        bits = coef_bits[c]
        if ss and bits[0] < 0:
            raise ValueError(f"a progressive JPEG AC scan {what} of "
                             f"component {c} before its DC scan")
        if any(ah != max(bits[k], 0) for k in range(ss, se + 1)):
            raise ValueError(f"a progressive JPEG scan {what} that does "
                             f"not follow the scans before it")
        bits[ss:se + 1] = [al] * (se + 1 - ss)


def _libjpeg_transform(jfif: bool, adobe: Optional[int], ids,
                       lossless: bool = False) -> bool:
    """libjpeg's default_decompress_parms.  Three components: JFIF implies
    YCbCr; an Adobe marker's transform 0 means RGB; else the component
    ids 'R', 'G', 'B' mean RGB and anything else YCbCr, or RGB in a
    lossless frame (libjpeg-turbo 3.x).  Four: YCCK when an Adobe
    marker's transform is not 0, else CMYK."""
    if len(ids) == 4:
        return adobe is not None and adobe != 0
    if len(ids) != 3:
        return False
    if jfif:
        return True
    if adobe is not None:
        return adobe != 0
    return list(ids) != [82, 71, 66] and not lossless


def _check_lossless_scan(comps, ss, se, ah, al, restart, h, v,
                         size) -> None:
    """A lossless scan as libjpeg-turbo 3.x checks it (jdlossls.c,
    start_pass_lossless, 8-bit samples): predictor Ss 1..7, Se 0, Ah 0,
    point transform Al below the precision, a restart interval of whole
    MCU rows."""
    if not 1 <= ss <= 7 or se or ah or al >= 8:
        raise ValueError(f"a lossless JPEG scan of bad parameters "
                         f"(predictor {ss}, Se {se}, Ah {ah}, Pt {al})")
    hm, vm = max(h), max(v)
    if len(comps) == 1:
        across = -(-size[0] * h[comps[0]] // hm)
    else:
        across = -(-size[0] // hm)
    if restart % across:
        raise ValueError(f"a lossless JPEG restart interval of {restart} "
                         f"MCUs, not a multiple of the {across} MCUs of a "
                         f"row (libjpeg refuses it)")


# T.81 Table D.2 (libjpeg's jaricom.c): for each probability state, its
# Qe value, the next state after an LPS and after an MPS, and whether an
# LPS switches the sense of the MPS; packed as libjpeg packs them, Qe << 16
# | next MPS << 8 | switch << 7 | next LPS.  The last state, 113, is the
# fixed probability 0.5 of the sign and refinement bits.
_QE = (
    (0x5A1D, 1, 1, 1), (0x2586, 14, 2, 0), (0x1114, 16, 3, 0),
    (0x080B, 18, 4, 0), (0x03D8, 20, 5, 0), (0x01DA, 23, 6, 0),
    (0x00E5, 25, 7, 0), (0x006F, 28, 8, 0), (0x0036, 30, 9, 0),
    (0x001A, 33, 10, 0), (0x000D, 35, 11, 0), (0x0006, 9, 12, 0),
    (0x0003, 10, 13, 0), (0x0001, 12, 13, 0), (0x5A7F, 15, 15, 1),
    (0x3F25, 36, 16, 0), (0x2CF2, 38, 17, 0), (0x207C, 39, 18, 0),
    (0x17B9, 40, 19, 0), (0x1182, 42, 20, 0), (0x0CEF, 43, 21, 0),
    (0x09A1, 45, 22, 0), (0x072F, 46, 23, 0), (0x055C, 48, 24, 0),
    (0x0406, 49, 25, 0), (0x0303, 51, 26, 0), (0x0240, 52, 27, 0),
    (0x01B1, 54, 28, 0), (0x0144, 56, 29, 0), (0x00F5, 57, 30, 0),
    (0x00B7, 59, 31, 0), (0x008A, 60, 32, 0), (0x0068, 62, 33, 0),
    (0x004E, 63, 34, 0), (0x003B, 32, 35, 0), (0x002C, 33, 9, 0),
    (0x5AE1, 37, 37, 1), (0x484C, 64, 38, 0), (0x3A0D, 65, 39, 0),
    (0x2EF1, 67, 40, 0), (0x261F, 68, 41, 0), (0x1F33, 69, 42, 0),
    (0x19A8, 70, 43, 0), (0x1518, 72, 44, 0), (0x1177, 73, 45, 0),
    (0x0E74, 74, 46, 0), (0x0BFB, 75, 47, 0), (0x09F8, 77, 48, 0),
    (0x0861, 78, 49, 0), (0x0706, 79, 50, 0), (0x05CD, 48, 51, 0),
    (0x04DE, 50, 52, 0), (0x040F, 50, 53, 0), (0x0363, 51, 54, 0),
    (0x02D4, 52, 55, 0), (0x025C, 53, 56, 0), (0x01F8, 54, 57, 0),
    (0x01A4, 55, 58, 0), (0x0160, 56, 59, 0), (0x0125, 57, 60, 0),
    (0x00F6, 58, 61, 0), (0x00CB, 59, 62, 0), (0x00AB, 61, 63, 0),
    (0x008F, 61, 32, 0), (0x5B12, 65, 65, 1), (0x4D04, 80, 66, 0),
    (0x412C, 81, 67, 0), (0x37D8, 82, 68, 0), (0x2FE8, 83, 69, 0),
    (0x293C, 84, 70, 0), (0x2379, 86, 71, 0), (0x1EDF, 87, 72, 0),
    (0x1AA9, 87, 73, 0), (0x174E, 72, 74, 0), (0x1424, 72, 75, 0),
    (0x119C, 74, 76, 0), (0x0F6B, 74, 77, 0), (0x0D51, 75, 78, 0),
    (0x0BB6, 77, 79, 0), (0x0A40, 77, 48, 0), (0x5832, 80, 81, 1),
    (0x4D1C, 88, 82, 0), (0x438E, 89, 83, 0), (0x3BDD, 90, 84, 0),
    (0x34EE, 91, 85, 0), (0x2EAE, 92, 86, 0), (0x299A, 93, 87, 0),
    (0x2516, 86, 71, 0), (0x5570, 88, 89, 1), (0x4CA9, 95, 90, 0),
    (0x44D9, 96, 91, 0), (0x3E22, 97, 92, 0), (0x3824, 99, 93, 0),
    (0x32B4, 99, 94, 0), (0x2E17, 93, 86, 0), (0x56A8, 95, 96, 1),
    (0x4F46, 101, 97, 0), (0x47E5, 102, 98, 0), (0x41CF, 103, 99, 0),
    (0x3C3D, 104, 100, 0), (0x375E, 99, 93, 0), (0x5231, 105, 102, 0),
    (0x4C0F, 106, 103, 0), (0x4639, 107, 104, 0), (0x415E, 103, 99, 0),
    (0x5627, 105, 106, 1), (0x50E7, 108, 107, 0), (0x4B85, 109, 103, 0),
    (0x5597, 110, 109, 0), (0x504F, 111, 107, 0), (0x5A10, 110, 111, 1),
    (0x5522, 112, 109, 0), (0x59EB, 112, 111, 1), (0x5A1D, 113, 113, 0))
_ARITAB = tuple(qe << 16 | nmps << 8 | sw << 7 | nlps
                for qe, nlps, nmps, sw in _QE)


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


def _scan_units(f: Frame, s: Scan):
    """(units, units across, blocks) of scan ``s``: its MCUs, or the
    blocks of its one component over ceil(w_c / 8) x ceil(h_c / 8), in
    raster order; ``blocks(u)`` lists unit u's (scan component, block
    row, block column) on the component's MCU-padded grid."""
    hm, vm = max(f.h), max(f.v)
    if len(s.comps) == 1:
        c = s.comps[0]
        across = -(-(-(-f.width * f.h[c] // hm)) // 8)
        down = -(-(-(-f.height * f.v[c] // vm)) // 8)

        def blocks(u):
            return [(0,) + divmod(u, across)]
    else:
        across = -(-f.width // (8 * hm))
        down = -(-f.height // (8 * vm))
        layout = [(k, f.v[c], f.h[c], by, bx) for k, c in enumerate(s.comps)
                  for by in range(f.v[c]) for bx in range(f.h[c])]

        def blocks(u):
            my, mx = divmod(u, across)
            return [(k, my * vy + by, mx * hx + bx)
                    for k, vy, hx, by, bx in layout]
    return across * down, across, blocks


def _scan_parts(s: Scan, units: int) -> List[bytes]:
    """Each restart interval's data, up to its first marker (the C++
    reader reads zeros past it, as libjpeg does), unstuffed."""
    raw = bytes(s.data)
    parts = []
    for p in (_RST.split(raw) if s.restart else [raw]):
        end = _DATA_END.search(p)
        parts.append((p if end is None else p[:end.start()]).replace(
            b"\xff\x00", b"\xff"))
    if s.restart and len(parts) < -(-units // s.restart):
        raise ValueError("JPEG scan with fewer restart intervals than "
                         "its MCUs need")
    return parts


def _grids(f: Frame) -> List[Tuple[int, int]]:
    """Each component's MCU-padded block grid (rows, columns)."""
    hm, vm = max(f.h), max(f.v)
    mx, my = -(-f.width // (8 * hm)), -(-f.height // (8 * vm))
    return [(my * f.v[c], mx * f.h[c]) for c in range(len(f.h))]


def _i16(x: int) -> int:
    """``x`` stored in a JCOEF (int16), as C truncates."""
    return ((x + 32768) & 0xFFFF) - 32768


def _entropy_plain(f: Frame, s: Scan, coefs: List[List[int]]) -> None:
    """Entropy-decode scan ``s`` into ``coefs``, each component's
    coefficients (natural order) over its MCU-padded grid as one flat
    list: a sequential scan (every coefficient of its blocks), or one of
    the four progressive kinds (jdphuff.c): DC first (point transform
    Al), DC refinement (one bit), AC first over Ss..Se (EOB runs), AC
    refinement (correction bits on coefficients already nonzero, zero
    runs that skip them).  Past the data every bit is 0; a bad code or a
    run past the band raises ``ValueError``.  An arithmetic-coded frame's
    scans go to ``_entropy_arith_plain``."""
    if f.coding == ARITHMETIC:
        return _entropy_arith_plain(f, s, coefs)
    units, across, blocks = _scan_units(f, s)
    parts = _scan_parts(s, units)
    grids = _grids(f)
    kind = ("seq" if not f.progressive else
            ("dc" if not s.ah else "dcr") if s.ss == 0 else
            ("ac" if not s.ah else "acr"))
    dc = [_lut(*x) for x in s.dc] if kind in ("seq", "dc") else None
    ac = [_lut(*x) for x in s.ac] if kind in ("seq", "ac", "acr") else None
    nat, ss, se, al = _NAT, s.ss, s.se, s.al
    p1, m1 = 1 << al, -1 << al
    pi = 0
    win = _windows(parts[0])
    end_bits = 8 * len(parts[0])
    pos = 0
    pred = [0] * len(s.comps)
    eobrun = 0
    left = s.restart
    for u in range(units):
        if s.restart:
            if not left:
                pi += 1
                win = _windows(parts[pi])
                end_bits = 8 * len(parts[pi])
                pos = 0
                pred = [0] * len(s.comps)
                eobrun = 0
                left = s.restart
            left -= 1
        for k, by, bx in blocks(u):
            # past the data every bit is 0: decoding there does not
            # depend on the position
            pos = min(pos, end_bits)
            c = s.comps[k]
            base = (by * grids[c][1] + bx) * 64
            out = coefs[c]
            if kind == "dcr":
                if (win[pos >> 3] >> (31 - (pos & 7))) & 1:
                    out[base] |= p1
                pos += 1
                continue
            if kind in ("seq", "dc"):
                e = dc[k][(win[pos >> 3] >> (16 - (pos & 7))) & 0xFFFF]
                if not e or (e & 0xFF) > 16:
                    raise ValueError("corrupt JPEG data (a bad DC code)")
                pos += e >> 8
                t = e & 0xFF
                if t:
                    x = (win[pos >> 3] >> (32 - (pos & 7) - t)) & (
                        (1 << t) - 1)
                    pos += t
                    if x < (1 << (t - 1)):
                        x -= (1 << t) - 1
                    pred[k] += x
                out[base] = _i16(pred[k] << al)
                if kind == "dc":
                    continue
            table = ac[k]
            if kind == "acr":
                pos, eobrun = _refine_block(out, base, table, win, pos, ss,
                                            se, p1, m1, eobrun)
                continue
            if eobrun:
                eobrun -= 1
                continue
            i = ss or 1
            while i <= se:
                e = table[(win[pos >> 3] >> (16 - (pos & 7))) & 0xFFFF]
                if not e:
                    raise ValueError("corrupt JPEG data (a bad AC code)")
                pos += e >> 8
                rs = e & 0xFF
                z = rs & 15
                r = rs >> 4
                if z:
                    i += r
                    if i > se:
                        raise ValueError("corrupt JPEG data (a run past "
                                         "the block)")
                    x = (win[pos >> 3] >> (32 - (pos & 7) - z)) & (
                        (1 << z) - 1)
                    pos += z
                    if x < (1 << (z - 1)):
                        x -= (1 << z) - 1
                    out[base + nat[i]] = _i16(x << al)
                    i += 1
                elif r == 15:
                    i += 16
                else:
                    if kind == "ac":  # EOBr: 2^r + r more bits blocks
                        eobrun = 1 << r
                        if r:
                            eobrun += (win[pos >> 3] >> (
                                32 - (pos & 7) - r)) & ((1 << r) - 1)
                            pos += r
                        eobrun -= 1
                    break


def _refine_block(out, base, table, win, pos, ss, se, p1, m1, eobrun):
    """One block of an AC refinement scan (jdphuff.c's
    decode_mcu_AC_refine): (bit position, EOB run left) after it; corrupt
    data raises ``ValueError``."""
    bad = ValueError("corrupt JPEG data (a bad AC refinement)")
    nat = _NAT
    k = ss
    if not eobrun:
        while k <= se:
            e = table[(win[pos >> 3] >> (16 - (pos & 7))) & 0xFFFF]
            if not e:
                raise bad
            pos += e >> 8
            r, z = (e & 0xFF) >> 4, e & 15
            s = 0
            if z:
                if z != 1:  # a newly nonzero coefficient has size 1
                    raise bad
                s = p1 if (win[pos >> 3] >> (31 - (pos & 7))) & 1 else m1
                pos += 1
            elif r != 15:
                eobrun = 1 << r
                if r:
                    eobrun += (win[pos >> 3] >> (32 - (pos & 7) - r)) & (
                        (1 << r) - 1)
                    pos += r
                break
            # past r coefficients still zero, a correction bit on each
            # nonzero one on the way
            while k <= se:
                x = out[base + nat[k]]
                if x:
                    if (win[pos >> 3] >> (31 - (pos & 7))) & 1 and \
                            not x & p1:
                        out[base + nat[k]] = _i16(x + (p1 if x >= 0 else
                                                       m1))
                    pos += 1
                else:
                    r -= 1
                    if r < 0:
                        break
                k += 1
            else:
                if s:  # no zero coefficient left for the new one
                    raise bad
            if s:
                out[base + nat[k]] = s
            k += 1
    if eobrun:
        # the rest of the band: a correction bit on each nonzero one
        while k <= se:
            x = out[base + nat[k]]
            if x:
                if (win[pos >> 3] >> (31 - (pos & 7))) & 1 and not x & p1:
                    out[base + nat[k]] = _i16(x + (p1 if x >= 0 else m1))
                pos += 1
            k += 1
        eobrun -= 1
    return pos, eobrun


class _Arith:
    """T.81 Annex D's decoder of one restart interval (jdarith.c's
    arith_decode): the C and A registers over the interval's unstuffed
    bytes, zeros past them, as libjpeg reads past a marker."""

    __slots__ = ("data", "pos", "c", "a", "ct")

    def __init__(self, data: bytes):
        self.data, self.pos, self.c, self.a, self.ct = data, 0, 0, 0, -16

    def bit(self, st, i: int) -> int:
        """The next decision of statistics bin ``st[i]``, which it
        updates."""
        a, c, ct = self.a, self.c, self.ct
        while a < 0x8000:
            ct -= 1
            if ct < 0:
                pos = self.pos
                c = (c << 8) | (self.data[pos] if pos < len(self.data)
                                else 0)
                self.pos = pos + 1
                ct += 8
                if ct < 0:
                    ct += 1
                    if ct == 0:
                        a = 0x8000
            a <<= 1
        sv = st[i]
        e = _ARITAB[sv & 0x7F]
        qe = e >> 16
        a -= qe
        temp = a << ct
        if c >= temp:
            c -= temp
            if a < qe:
                st[i] = (sv & 0x80) ^ ((e >> 8) & 0xFF)
            else:
                st[i] = (sv & 0x80) ^ (e & 0xFF)
                sv ^= 0x80
            a = qe
        elif a < 0x8000:
            if a < qe:
                st[i] = (sv & 0x80) ^ (e & 0xFF)
                sv ^= 0x80
            else:
                st[i] = (sv & 0x80) ^ ((e >> 8) & 0xFF)
        self.a, self.c, self.ct = a, c, ct
        return sv >> 7


def _arith_value(r: _Arith, st, at: int, ac_base: Optional[int]) -> int:
    """Figures F.23 and F.24: a nonzero value's magnitude, its category
    from bin ``at`` on (AC: a second decision there, then bins
    ``ac_base`` on; DC: bins 20 on) and its bits 14 bins further."""
    m = r.bit(st, at)
    if m:
        if ac_base is None:
            at = 20
            more = r.bit(st, at)
        else:
            more = r.bit(st, at)
            if more:
                m = 2
                at = ac_base
                more = r.bit(st, at)
        while more:
            m <<= 1
            if m == 0x8000:
                raise ValueError("corrupt JPEG data (an arithmetic-coded "
                                 "magnitude past 15 bits)")
            at += 1
            more = r.bit(st, at)
    v = m
    at += 14
    m >>= 1
    while m:
        if r.bit(st, at):
            v |= m
        m >>= 1
    return v + 1


def _entropy_arith_plain(f: Frame, s: Scan, coefs: List[List[int]]) -> None:
    """Entropy-decode arithmetic-coded scan ``s`` into ``coefs`` (see
    ``_entropy_plain``), as libjpeg-turbo's jdarith.c: statistics bins of
    each table number (64 DC, 256 AC) and a fixed bin of probability 0.5
    (sign and refinement bits), reset with the DC predictions and their
    conditioning contexts at the scan's start and at each restart; a
    sequential scan, or DC first, DC refinement, AC first, AC refinement.
    A run past the band or a magnitude past 15 bits raises
    ``ValueError``."""
    units, across, blocks = _scan_units(f, s)
    parts = _scan_parts(s, units)
    grids = _grids(f)
    kind = ("seq" if not f.progressive else
            ("dc" if not s.ah else "dcr") if s.ss == 0 else
            ("ac" if not s.ah else "acr"))
    nat, al = _NAT, s.al
    ss, se = (1, 63) if kind == "seq" else (s.ss, s.se)
    p1, m1 = 1 << al, -1 << al
    n = len(s.comps)
    overflow = ValueError("corrupt JPEG data (an arithmetic-coded run past "
                          "the band)")
    left = s.restart
    pi = -1
    for u in range(units):
        if pi < 0 or (s.restart and not left):
            pi += 1
            r = _Arith(parts[pi])
            dc_st = {d: bytearray(64) for d, _ in s.tbl}
            ac_st = {a: bytearray(256) for _, a in s.tbl}
            fixed = bytearray([113])
            pred, ctx = [0] * n, [0] * n
            left = s.restart
        left -= 1
        for k, by, bx in blocks(u):
            c = s.comps[k]
            base = (by * grids[c][1] + bx) * 64
            out = coefs[c]
            if kind == "dcr":
                if r.bit(fixed, 0):
                    out[base] |= p1
                continue
            L, U, K = s.cond[k]
            if kind in ("seq", "dc"):
                st = dc_st[s.tbl[k][0]]
                at = ctx[k]
                if not r.bit(st, at):
                    ctx[k] = 0
                else:
                    sign = r.bit(st, at + 1)
                    v = _arith_value(r, st, at + 2 + sign, None)
                    m = 1 << (v - 1).bit_length() >> 1
                    ctx[k] = (0 if m < (1 << L) >> 1 else
                              12 + 4 * sign if m > (1 << U) >> 1 else
                              4 + 4 * sign)
                    pred[k] = (pred[k] + (-v if sign else v)) & 0xFFFF
                out[base] = _i16(pred[k] << al)
                if kind == "dc":
                    continue
            st = ac_st[s.tbl[k][1]]
            if kind == "acr":
                kex = se
                while kex > 0 and not out[base + nat[kex]]:
                    kex -= 1
                i = ss
                while i <= se:
                    at = 3 * (i - 1)
                    if i > kex and r.bit(st, at):
                        break  # EOB
                    while True:
                        x = out[base + nat[i]]
                        if x:
                            if r.bit(st, at + 2):
                                out[base + nat[i]] = _i16(
                                    x + (m1 if x < 0 else p1))
                            break
                        if r.bit(st, at + 1):
                            out[base + nat[i]] = m1 if r.bit(fixed, 0) \
                                else p1
                            break
                        at += 3
                        i += 1
                        if i > se:
                            raise overflow
                    i += 1
                continue
            i = ss
            while i <= se:
                at = 3 * (i - 1)
                if r.bit(st, at):
                    break  # EOB
                while not r.bit(st, at + 1):
                    at += 3
                    i += 1
                    if i > se:
                        raise overflow
                sign = r.bit(fixed, 0)
                v = _arith_value(r, st, at + 2, 189 if i <= K else 217)
                out[base + nat[i]] = _i16((-v if sign else v) << al)
                i += 1


# zigzag positions 1..9 in natural order: the coefficients libjpeg's
# block smoothing estimates (AC01, AC10, AC20, AC11, AC02, AC03, AC12,
# AC21, AC30)
_SMOOTH_NAT = (1, 8, 16, 9, 2, 3, 10, 17, 24)


def _smoothing_on(f: Frame, coef_bits) -> bool:
    """jdcoefct.c's smoothing_ok after the last scan: a progressive frame
    whose DC and first 9 AC quantisers are nonzero and whose every
    component has a DC scan, with a coefficient among zigzag 1..9 of
    some component not fully refined (its last Al > 0, or never sent)."""
    if not f.progressive:
        return False
    for c, bits in enumerate(coef_bits):
        if f.qt[c][0] == 0 or any(f.qt[c][p] == 0 for p in _SMOOTH_NAT) \
                or bits[0] < 0:
            return False
    return any(bits[k] for bits in coef_bits for k in range(1, 10))


def _smooth_cols(n: int) -> np.ndarray:
    """The 5 block columns (two left, the block, two right) that
    decompress_smooth_data's sliding registers hold at each of ``n``
    block columns: the row's edge repeated."""
    reg, out = [0] * 5, []
    for b in range(n):
        if b == 0 and b < n - 1:
            reg[3] = reg[4] = 1
        if b + 1 < n - 1:
            reg[4] = b + 2
        out.append(list(reg))
        reg = reg[1:] + reg[4:]
    return np.array(out, np.int64).reshape(n, 5)


def _smooth_rows(n: int, v: int, total: int) -> np.ndarray:
    """The 5 block rows (two above, the block, two below) that
    decompress_smooth_data reads for each of a component's ``n`` block
    rows: its image_block_row arithmetic, in which the last iMCU row
    counts its rows as if every iMCU row had as many (``total`` iMCU rows
    of ``v`` block rows)."""
    out = []
    for r in range(n):
        i, br = divmod(r, v)
        rows = v if i < total - 1 else (n % v or v)
        ibr, ibrs = i * rows + br, rows * total
        prev = r - 1 if ibr > 0 else r
        nxt = r + 1 if ibr < ibrs - 1 else r
        out.append([r - 2 if ibr > 1 else prev, prev, r, nxt,
                    r + 2 if ibr < ibrs - 2 else nxt])
    return np.array(out, np.int64).reshape(n, 5)


def _smooth_pred(num: np.ndarray, q: int, al: int) -> np.ndarray:
    """An estimate num / (q << 8), rounded half away from zero, clamped
    below 2^Al when Al > 0."""
    pred = ((q << 7) + np.abs(num)) // (q << 8)
    if al > 0:
        pred = np.minimum(pred, (1 << al) - 1)
    return np.where(num >= 0, pred, -pred)


def _smooth_plain(f: Frame, c: int, coef: np.ndarray, bits) -> np.ndarray:
    """jdcoefct.c's decompress_smooth_data (libjpeg-turbo 3.x) on
    component ``c``'s coefficients [rows, cols, 64] (its MCU-padded
    grid): each of its ceil(h_c / 8) x ceil(w_c / 8) blocks gets an
    estimate of each of zigzag 1..9 that is still 0 and not fully
    refined, from the DC values of the 5 x 5 blocks around it; when none
    of 1..9 was ever sent, a 5 x 5 estimate of its DC too."""
    hm, vm = max(f.h), max(f.v)
    n_rows = -(-(-(-f.height * f.v[c] // vm)) // 8)
    n_cols = -(-(-(-f.width * f.h[c] // hm)) // 8)
    total = -(-f.height // (8 * vm))
    rows = _smooth_rows(n_rows, f.v[c], total)
    cols = _smooth_cols(n_cols)
    dc = coef[..., 0].astype(np.int64)
    # D[i][j]: libjpeg's DC(5 i + j + 1), rows above to below, columns
    # left to right
    D = [[dc[rows[:, i]][:, cols[:, j]] for j in range(5)] for i in range(5)]
    q = [int(x) for x in f.qt[c]]
    work = coef.copy()
    blk = work[:n_rows, :n_cols]
    change_dc = all(bits[k] == -1 for k in range(1, 10))

    def w(*terms):
        return sum(m * D[i][j] for m, i, j in terms) * q[0]

    if change_dc:
        nums = [
            w((-1, 0, 0), (-1, 0, 1), (1, 0, 3), (1, 0, 4), (-3, 1, 0),
              (13, 1, 1), (-13, 1, 3), (3, 1, 4), (-3, 2, 0), (38, 2, 1),
              (-38, 2, 3), (3, 2, 4), (-3, 3, 0), (13, 3, 1), (-13, 3, 3),
              (3, 3, 4), (-1, 4, 0), (-1, 4, 1), (1, 4, 3), (1, 4, 4)),
            w((-1, 0, 0), (-3, 0, 1), (-3, 0, 2), (-3, 0, 3), (-1, 0, 4),
              (-1, 1, 0), (13, 1, 1), (38, 1, 2), (13, 1, 3), (-1, 1, 4),
              (1, 3, 0), (-13, 3, 1), (-38, 3, 2), (-13, 3, 3), (1, 3, 4),
              (1, 4, 0), (3, 4, 1), (3, 4, 2), (3, 4, 3), (1, 4, 4)),
            w((1, 0, 2), (2, 1, 1), (7, 1, 2), (2, 1, 3), (-5, 2, 1),
              (-14, 2, 2), (-5, 2, 3), (2, 3, 1), (7, 3, 2), (2, 3, 3),
              (1, 4, 2)),
            w((-1, 0, 0), (1, 0, 4), (9, 1, 1), (-9, 1, 3), (-9, 3, 1),
              (9, 3, 3), (1, 4, 0), (-1, 4, 4)),
            w((2, 1, 1), (-5, 1, 2), (2, 1, 3), (1, 2, 0), (7, 2, 1),
              (-14, 2, 2), (7, 2, 3), (1, 2, 4), (2, 3, 1), (-5, 3, 2),
              (2, 3, 3)),
            w((1, 1, 1), (-1, 1, 3), (2, 2, 1), (-2, 2, 3), (1, 3, 1),
              (-1, 3, 3)),
            w((1, 1, 1), (-3, 1, 2), (1, 1, 3), (-1, 3, 1), (3, 3, 2),
              (-1, 3, 3)),
            w((1, 1, 1), (-1, 1, 3), (-3, 2, 1), (3, 2, 3), (1, 3, 1),
              (-1, 3, 3)),
            w((1, 1, 1), (2, 1, 2), (1, 1, 3), (-1, 3, 1), (-2, 3, 2),
              (-1, 3, 3))]
    else:
        nums = [
            w((-7, 2, 0), (50, 2, 1), (-50, 2, 3), (7, 2, 4)),
            w((-7, 0, 2), (50, 1, 2), (-50, 3, 2), (7, 4, 2)),
            w((-1, 0, 2), (13, 1, 2), (-24, 2, 2), (13, 3, 2), (-1, 4, 2)),
            w((1, 1, 4), (1, 3, 0), (-10, 3, 1), (10, 3, 3), (-1, 0, 1),
              (-1, 3, 4), (1, 4, 1), (-1, 4, 3), (1, 0, 3), (-1, 1, 0),
              (10, 1, 1), (-10, 1, 3)),
            w((-1, 2, 0), (13, 2, 1), (-24, 2, 2), (13, 2, 3), (-1, 2, 4))]
    for k, num in enumerate(nums, start=1):
        pos = _SMOOTH_NAT[k - 1]
        if bits[k] != 0:
            cur = blk[..., pos]
            blk[..., pos] = np.where(cur == 0, _smooth_pred(
                num, q[pos], bits[k]), cur)
    if change_dc:
        num = w((-2, 0, 0), (-6, 0, 1), (-8, 0, 2), (-6, 0, 3), (-2, 0, 4),
                (-6, 1, 0), (6, 1, 1), (42, 1, 2), (6, 1, 3), (-6, 1, 4),
                (-8, 2, 0), (42, 2, 1), (152, 2, 2), (42, 2, 3), (-8, 2, 4),
                (-6, 3, 0), (6, 3, 1), (42, 3, 2), (6, 3, 3), (-6, 3, 4),
                (-2, 4, 0), (-6, 4, 1), (-8, 4, 2), (-6, 4, 3), (-2, 4, 4))
        blk[..., 0] = _smooth_pred(num, q[0], 0)
    # the estimates are stored in JCOEFs
    return ((work + 32768) & 0xFFFF) - 32768


def _coefficients_plain(f: Frame) -> List[np.ndarray]:
    """Each component's quantised coefficients [rows, cols, 64] (natural
    order) over its MCU-padded grid after every scan; a progressive
    frame's smoothed as libjpeg smooths them when its scans leave
    coefficients unrefined."""
    grids = _grids(f)
    coefs = [[0] * (gy * gx * 64) for gy, gx in grids]
    coef_bits = [[-1] * 64 for _ in grids]
    for s in f.scans:
        _entropy_plain(f, s, coefs)
        for c in s.comps:
            coef_bits[c][s.ss:s.se + 1] = [s.al] * (s.se + 1 - s.ss)
    out = [np.array(x, np.int64).reshape(gy, gx, 64)
           for x, (gy, gx) in zip(coefs, grids)]
    if _smoothing_on(f, coef_bits):
        out = [_smooth_plain(f, c, x, coef_bits[c])
               for c, x in enumerate(out)]
    return out


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


def _lossless_plain(f: Frame) -> List[np.ndarray]:
    """Each component's samples [ceil(H v / v_max), ceil(W h / h_max)]
    (uint8) of a lossless frame, as libjpeg-turbo 3.x decodes them
    (jdlhuff.c, jddiffct.c, jdlossls.c): each scan's differences in MCU
    order (one sample an MCU in a one-component scan, h x v of each
    component in an interleaved one; SSSS 16 is 32768), then each
    component's rows undifferenced over its own width (T.81 H.1.2.1:
    the first row of the scan and of each restart interval from the left,
    its first sample from 2^(7 - Pt); the first column from above; the
    rest by the scan's predictor), modulo 2^16, shifted left by the
    point transform and kept to 8 bits.  MCU padding is decoded and
    dropped.  A bad code raises ``ValueError``."""
    hm, vm = max(f.h), max(f.v)
    size = [(-(-f.height * f.v[c] // vm), -(-f.width * f.h[c] // hm))
            for c in range(len(f.h))]
    planes = [np.zeros(sz, np.uint8) for sz in size]
    for s in f.scans:
        one = len(s.comps) == 1
        samp = [(1, 1) if one else (f.h[c], f.v[c]) for c in s.comps]
        if one:
            my, mx = size[s.comps[0]]
        else:
            my, mx = -(-f.height // vm), -(-f.width // hm)
        parts = _scan_parts(s, mx * my)
        luts = [_lut(*t) for t in s.dc]
        diff = [np.zeros((my * v, mx * h), np.int64) for h, v in samp]
        layout = [(k, y, x) for k, (h, v) in enumerate(samp)
                  for y in range(v) for x in range(h)]
        rows_per = s.restart // mx if s.restart else my
        bad = ValueError("corrupt JPEG data (a bad lossless code)")
        for r in range(my):
            if r % rows_per == 0:
                part = parts[r // rows_per]
                win, end_bits, pos = _windows(part), 8 * len(part), 0
            for x in range(mx):
                for k, yy, xx in layout:
                    pos = min(pos, end_bits)
                    e = luts[k][(win[pos >> 3] >> (16 - (pos & 7))) & 0xFFFF]
                    if not e or (e & 0xFF) > 16:
                        raise bad
                    pos += e >> 8
                    t = e & 0xFF
                    if t == 16:
                        d = 32768
                    elif t:
                        d = (win[pos >> 3] >> (32 - (pos & 7) - t)) & (
                            (1 << t) - 1)
                        pos += t
                        if d < (1 << (t - 1)):
                            d -= (1 << t) - 1
                    else:
                        d = 0
                    h, v = samp[k]
                    diff[k][r * v + yy, x * h + xx] = d
        initial = 1 << (7 - s.al)
        for k, c in enumerate(s.comps):
            rows, cols = size[c]
            v = samp[k][1]
            dk = diff[k][:rows, :cols]
            out = np.zeros((rows, cols), np.int64)
            for y in range(rows):
                first = y % (rows_per * v) == 0
                prev = out[y - 1] if y else None
                cur = out[y]
                for x in range(cols):
                    if first:
                        p = initial if x == 0 else cur[x - 1]
                    elif x == 0:
                        p = prev[0]
                    else:
                        p = _predict(s.ss, int(cur[x - 1]), int(prev[x]),
                                     int(prev[x - 1]))
                    cur[x] = (p + dk[y, x]) & 0xFFFF
            planes[c] = ((out << s.al) & 0xFF).astype(np.uint8)
    return planes


def _predict(psv: int, a: int, b: int, c: int) -> int:
    """T.81 Table H.1's prediction from Ra (left), Rb (above) and Rc
    (above left)."""
    return (a, b, c, a + b - c, a + ((b - c) >> 1), b + ((a - c) >> 1),
            (a + b) >> 1)[psv - 1]


def _decode_plain(f: Frame) -> np.ndarray:
    """The pixels of frame ``f``: uint8 [H, W] or [H, W, 3 or 4].  A
    lossless frame's subsampled components are replicated (libjpeg-turbo
    upsamples no other way in lossless mode)."""
    hm, vm = max(f.h), max(f.v)
    n = len(f.h)
    full = []
    if f.coding == LOSSLESS:
        for c, p in enumerate(_lossless_plain(f)):
            full.append(np.repeat(np.repeat(p.astype(np.int64), vm // f.v[c],
                                            0), hm // f.h[c], 1)
                        [:f.height, :f.width])
    for c, coef in enumerate(_coefficients_plain(f)
                             if f.coding != LOSSLESS else ()):
        gy, gx = coef.shape[:2]
        plane = _idct_plain(coef, f.qt[c]).transpose(0, 2, 1, 3).reshape(
            gy * 8, gx * 8)
        dw = -(-f.width * f.h[c] // hm)
        dh = -(-f.height * f.v[c] // vm)
        p = plane[:dh, :dw].astype(np.int64)
        full.append(_upsample_plain(p, hm // f.h[c], vm // f.v[c])
                    [:f.height, :f.width])
    if n == 1:
        return full[0].astype(np.uint8)
    if f.transform:
        y, cb, cr = full[:3]
        rgb = [y + _CR_R[cr], y + ((_CB_G[cb] + _CR_G[cr]) >> 16),
               y + _CB_B[cb]]
        # YCCK: libjpeg's ycck_cmyk_convert, 255 - (R, G, B)
        full = (rgb if n == 3 else
                [255 - np.clip(x, 0, 255) for x in rgb] + full[3:])
    px = np.clip(np.stack(full, axis=-1), 0, 255).astype(np.uint8)
    # four components as PIL holds them: "CMYK;I", inverted
    return 255 - px if n == 4 else px


# ---- the C++ version (csrc/imgcodec.cpp)

class _CScan(ctypes.Structure):
    _fields_ = [("data", ctypes.c_void_p), ("len", ctypes.c_int64),
                ("ncomp", ctypes.c_int32), ("restart", ctypes.c_int32),
                ("comp", ctypes.c_int32 * 4),
                ("ss", ctypes.c_int32), ("se", ctypes.c_int32),
                ("ah", ctypes.c_int32), ("al", ctypes.c_int32),
                ("dc_bits", (ctypes.c_uint8 * 16) * 4),
                ("dc_vals", (ctypes.c_uint8 * 256) * 4),
                ("ac_bits", (ctypes.c_uint8 * 16) * 4),
                ("ac_vals", (ctypes.c_uint8 * 256) * 4),
                ("dc_tbl", ctypes.c_int32 * 4), ("ac_tbl", ctypes.c_int32 * 4),
                ("cond_l", ctypes.c_int32 * 4), ("cond_u", ctypes.c_int32 * 4),
                ("cond_k", ctypes.c_int32 * 4)]


class _CFrame(ctypes.Structure):
    _fields_ = [("width", ctypes.c_int32), ("height", ctypes.c_int32),
                ("ncomp", ctypes.c_int32), ("transform", ctypes.c_int32),
                ("h", ctypes.c_int32 * 4), ("v", ctypes.c_int32 * 4),
                ("qt", (ctypes.c_uint16 * 64) * 4),
                ("nscans", ctypes.c_int32), ("status", ctypes.c_int32),
                ("progressive", ctypes.c_int32),
                ("coding", ctypes.c_int32),
                ("scans", ctypes.POINTER(_CScan)), ("out", ctypes.c_void_p),
                ("out_stride", ctypes.c_int64),
                ("out_rows", ctypes.c_int32), ("out_cols", ctypes.c_int32)]


_STATUS = {-1: "a frame the decoder does not take",
           -2: "a bad Huffman table", -3: "corrupt entropy-coded data"}


def _fill(cf: _CFrame, f: Frame, out: np.ndarray, keep: list) -> None:
    cf.width, cf.height, cf.ncomp = f.width, f.height, len(f.h)
    cf.transform = int(f.transform)
    cf.progressive = int(f.progressive)
    cf.coding = f.coding
    for c in range(len(f.h)):
        cf.h[c], cf.v[c] = f.h[c], f.v[c]
        ctypes.memmove(cf.qt[c], f.qt[c].ctypes.data, 128)
    cf.nscans = len(f.scans)
    scans = (_CScan * len(f.scans))()
    keep.append(scans)
    cf.scans = scans
    for cs, s in zip(scans, f.scans):
        buf = np.frombuffer(s.data, np.uint8)
        keep.append(buf)
        cs.data, cs.len = buf.ctypes.data if buf.size else None, buf.size
        cs.ncomp, cs.restart = len(s.comps), s.restart
        cs.ss, cs.se, cs.ah, cs.al = s.ss, s.se, s.ah, s.al
        for k, c in enumerate(s.comps):
            cs.comp[k] = c
            if s.tbl:
                cs.dc_tbl[k], cs.ac_tbl[k] = s.tbl[k]
                cs.cond_l[k], cs.cond_u[k], cs.cond_k[k] = s.cond[k]
            for dst_bits, dst_vals, table in (
                    (cs.dc_bits, cs.dc_vals, s.dc[k]),
                    (cs.ac_bits, cs.ac_vals, s.ac[k])):
                if table is not None:
                    ctypes.memmove(dst_bits[k], table[0], 16)
                    ctypes.memmove(dst_vals[k], table[1], len(table[1]))
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
    [H, W] for one component, [H, W, 3] for three, [H, W, 4] CMYK for
    four, inverted as PIL holds them ("CMYK;I")."""
    f = parse_jpeg(data, tables, transform)
    out = np.empty((f.height, f.width, len(f.h)), np.uint8)
    decode_frames([f], [out], plain=plain)
    return out[..., 0] if len(f.h) == 1 else out


def read_jpeg(path: str, plain: bool = False) -> np.ndarray:
    """The pixels of the JPEG file at ``path`` (see ``decode_jpeg``)."""
    with open(path, "rb") as fh:
        return decode_jpeg(fh.read(), plain=plain)
