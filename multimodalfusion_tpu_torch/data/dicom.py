"""Minimal DICOM reader (and writer) for CT series: the port's own copy
of multimodalfusion_tpu/data/dicom.py, which reads what the reference
reads through ``pydicom`` (ref utils/ct_preprocess_utils.py:4,14-34
load_scan; datasets/dataset_raw.py:51-89):

  * Part-10 files (128-byte preamble + 'DICM') and bare datasets;
  * Explicit VR Little Endian (1.2.840.10008.1.2.1) and
    Implicit VR Little Endian (1.2.840.10008.1.2);
  * Explicit VR Big Endian (1.2.840.10008.1.2.2, retired but present in
    old archives);
  * Deflated Explicit VR LE (1.2.840.10008.1.2.1.99) via zlib;
  * encapsulated (compressed) PixelData: RLE Lossless
    (1.2.840.10008.1.2.5, a PackBits decoder per PS3.5 Annex G) and JPEG
    Lossless (…1.2.4.70 SV1, the most common compressed syntax of
    clinical CT archives, and …1.2.4.57 with any predictor), whose
    entropy decode runs in C++ (``native.jpeg_lossless_decode``), and
    Baseline JPEG (…1.2.4.50, 8-bit; a progressive, arithmetic-coded
    (SOF9, SOF10) or lossless (SOF3) frame tagged .50 too, as PIL
    decodes it) and JPEG 2000 (…1.2.4.90 lossless,
    …1.2.4.91), which the JAX package decodes through PIL, here through
    the port's own decoders (``utils/jpeg.py``, ``csrc/imgcodec.cpp``;
    ``utils/j2k.py``, ``csrc/j2k.cpp``: PIL's pixels bit for bit, its
    shift of a 12-bit component to 16 bits and its offset of a signed
    one included), monochrome frames only, as in JAX;
  * defined- and undefined-length sequences are skipped structurally.

``read_file`` returns a ``DicomSlice`` whose attributes are those the
pipeline reads from a pydicom Dataset (``pixel_array``,
``ImagePositionPatient``, ``ImageOrientationPatient``,
``RescaleIntercept``/``RescaleSlope``, ``PixelSpacing``,
``SliceThickness``).  ``write_ct_slice`` writes Part-10 files for tests
and synthetic cohorts.
"""
from __future__ import annotations

import os
import re
import struct
from typing import Dict, List, Optional, Tuple

import numpy as np

from multimodalfusion_tpu_torch import native
from multimodalfusion_tpu_torch.utils import j2k, jpeg

EXPLICIT_VR_LE = "1.2.840.10008.1.2.1"
IMPLICIT_VR_LE = "1.2.840.10008.1.2"
EXPLICIT_VR_BE = "1.2.840.10008.1.2.2"  # retired; dataset (not meta) is BE
DEFLATED_EXPLICIT_VR_LE = "1.2.840.10008.1.2.1.99"
RLE_LOSSLESS = "1.2.840.10008.1.2.5"
JPEG_BASELINE = "1.2.840.10008.1.2.4.50"
JPEG_EXTENDED = "1.2.840.10008.1.2.4.51"
JPEG_LOSSLESS_P14 = "1.2.840.10008.1.2.4.57"  # any predictor SV
JPEG_LOSSLESS_SV1 = "1.2.840.10008.1.2.4.70"
JPEG2000_LOSSLESS = "1.2.840.10008.1.2.4.90"
JPEG2000 = "1.2.840.10008.1.2.4.91"

# encapsulated-PixelData syntaxes this reader recognizes.  RLE, JPEG
# Lossless, Baseline JPEG and JPEG 2000 decode here; JPEG Extended (.51,
# 12-bit lossy), which PIL cannot parse either, raises with a clear error.
_PIL_SYNTAXES = {JPEG_BASELINE, JPEG2000_LOSSLESS, JPEG2000}
_ENCAPSULATED = _PIL_SYNTAXES | {RLE_LOSSLESS, JPEG_LOSSLESS_SV1,
                                 JPEG_LOSSLESS_P14, JPEG_EXTENDED}

# tags the CT pipeline needs (group, element) -> (name, VR)
_TAGS = {
    (0x0008, 0x0060): ("Modality", "CS"),
    (0x0018, 0x0050): ("SliceThickness", "DS"),
    (0x0020, 0x0032): ("ImagePositionPatient", "DS"),
    (0x0020, 0x0037): ("ImageOrientationPatient", "DS"),
    (0x0028, 0x0002): ("SamplesPerPixel", "US"),
    (0x0028, 0x0008): ("NumberOfFrames", "IS"),
    (0x0028, 0x0010): ("Rows", "US"),
    (0x0028, 0x0011): ("Columns", "US"),
    (0x0028, 0x0030): ("PixelSpacing", "DS"),
    (0x0028, 0x0100): ("BitsAllocated", "US"),
    (0x0028, 0x0103): ("PixelRepresentation", "US"),
    (0x0028, 0x1052): ("RescaleIntercept", "DS"),
    (0x0028, 0x1053): ("RescaleSlope", "DS"),
    (0x7FE0, 0x0010): ("PixelData", "OW"),
}

# VRs with a 2-byte reserved field + 4-byte length in explicit VR
_LONG_VRS = {b"OB", b"OW", b"OF", b"OL", b"OD", b"SQ", b"UC", b"UR",
             b"UT", b"UN"}

# a JPEG marker inside an entropy-coded segment: FF not followed by 00
_MARKER = re.compile(rb"\xff[^\x00]", re.DOTALL)


class DicomSlice:
    """pydicom-Dataset-shaped view over the parsed element dict."""

    def __init__(self, elements: Dict[str, object], path: str = ""):
        self._elements = dict(elements)
        self.path = path
        # pipeline code assigns SliceThickness (ref load_scan :28-33)
        for name, value in elements.items():
            setattr(self, name, value)

    @property
    def pixel_array(self) -> np.ndarray:
        # the CT pipeline consumes one 2-D frame per file (ref
        # load_scan :14-27 stacks per-file slices); decoding only frame
        # 1 of a multi-frame object would silently drop slices
        n_frames = int(self._elements.get("NumberOfFrames", 1) or 1)
        if n_frames > 1:
            raise NotImplementedError(
                f"multi-frame DICOM (NumberOfFrames={n_frames}) — this "
                "reader handles one frame per file; split the object "
                "or convert the series to NIfTI (data/nifti.py)")
        rows = int(self._elements["Rows"])
        cols = int(self._elements["Columns"])
        bits = int(self._elements.get("BitsAllocated", 16))
        signed = int(self._elements.get("PixelRepresentation", 0)) == 1
        if bits == 16:
            dtype = np.int16 if signed else np.uint16
        elif bits == 8:
            dtype = np.int8 if signed else np.uint8
        else:
            raise NotImplementedError(f"BitsAllocated={bits}")
        fragments = self._elements.get("PixelDataFragments")
        if fragments is not None:
            return _decode_encapsulated(
                fragments, self._elements.get("TransferSyntaxUID", ""),
                rows, cols, bits, signed)
        raw = self._elements.get("PixelData")
        if raw is None:
            raise AttributeError("no PixelData")
        np_dtype = np.dtype(dtype)
        if self._elements.get("TransferSyntaxUID") == EXPLICIT_VR_BE:
            np_dtype = np_dtype.newbyteorder(">")
        arr = np.frombuffer(raw, dtype=np_dtype, count=rows * cols)
        # hand downstream HU math a native-order array either way
        return arr.reshape(rows, cols).astype(dtype, copy=False)


# ---------------------------------------------------------------------------
# encapsulated (compressed) PixelData codecs
# ---------------------------------------------------------------------------

class _BitReader:
    """MSB-first bit reader over an entropy-coded segment with the
    JPEG byte-stuffing (FF 00 -> FF) already removed."""

    def __init__(self, data: bytes):
        self._data = data
        self._pos = 0          # byte index
        self._bit = 0          # bits consumed of current byte (0..7)

    def get_bit(self) -> int:
        b = (self._data[self._pos] >> (7 - self._bit)) & 1
        self._bit += 1
        if self._bit == 8:
            self._bit = 0
            self._pos += 1
        return b

    def get_bits(self, n: int) -> int:
        v = 0
        for _ in range(n):
            v = (v << 1) | self.get_bit()
        return v


def _build_huffman(counts: bytes, symbols: bytes) -> Dict[Tuple[int, int], int]:
    """Canonical Huffman codes from a DHT segment's BITS/HUFFVAL lists
    (T.81 Annex C.2): (code length, code) -> symbol."""
    table: Dict[Tuple[int, int], int] = {}
    code, k = 0, 0
    for length in range(1, 17):
        for _ in range(counts[length - 1]):
            if code >= (1 << length):
                raise ValueError("non-canonical Huffman table in "
                                 "lossless-JPEG DHT (code space of "
                                 f"length {length} exhausted)")
            table[(length, code)] = symbols[k]
            k += 1
            code += 1
        code <<= 1
    return table


def _huff_decode(reader: _BitReader, table: Dict[Tuple[int, int], int]) -> int:
    code, length = 0, 0
    while length < 17:
        code = (code << 1) | reader.get_bit()
        length += 1
        sym = table.get((length, code))
        if sym is not None:
            return sym
    raise ValueError("invalid Huffman code in lossless-JPEG scan")


def _predict(row_above, row_cur, x: int, y: int, psv: int,
             default: int) -> int:
    """Sample prediction per T.81 H.1.2: first sample of the scan uses
    the precision default, the rest of line 1 predicts from Ra, the
    first column predicts from Rb, interior samples per the selection
    value (SV1 == Ra, the DICOM-ubiquitous case)."""
    if y == 0:
        return default if x == 0 else int(row_cur[x - 1])
    if x == 0:
        return int(row_above[0])
    ra = int(row_cur[x - 1])
    rb = int(row_above[x])
    rc = int(row_above[x - 1])
    if psv == 1:
        return ra
    if psv == 2:
        return rb
    if psv == 3:
        return rc
    if psv == 4:
        return ra + rb - rc
    if psv == 5:
        return ra + ((rb - rc) >> 1)
    if psv == 6:
        return rb + ((ra - rc) >> 1)
    if psv == 7:
        return (ra + rb) >> 1
    raise NotImplementedError(f"lossless-JPEG predictor {psv}")


def _decode_jpeg_lossless(blob: bytes, rows: int, cols: int) -> np.ndarray:
    """Decode a single-component lossless JPEG frame (ITU T.81 process
    14; SOF3).  DICOM's JPEG Lossless SV1 transfer syntax
    (1.2.840.10008.1.2.4.70) is this with predictor selection value 1
    — but any SV 1..7 decodes.  Returns uint16 (rows, cols)."""
    if blob[:2] != b"\xff\xd8":
        raise ValueError("lossless-JPEG frame missing SOI")
    pos = 2
    huff: Dict[int, Tuple[bytes, bytes]] = {}  # id -> (BITS, HUFFVAL)
    precision = lines = samples = None
    psv = point_transform = None
    table_id = 0
    restart_interval = 0
    entropy: Optional[bytes] = None
    n = len(blob)
    while pos + 2 <= n and entropy is None:
        if blob[pos] != 0xFF:
            raise ValueError(f"expected a JPEG marker at byte {pos}")
        marker = blob[pos + 1]
        if marker == 0xFF:                 # 0xFF fill byte (T.81 B.1.1.2):
            pos += 1                       # the NEXT byte pair may be the
            continue                       # real marker — consume one byte
        pos += 2
        if marker == 0x01 or 0xD0 <= marker <= 0xD7:
            continue                       # TEM / stray RST
        if marker == 0xD9:                 # EOI before any scan
            break
        seg_len = struct.unpack(">H", blob[pos:pos + 2])[0]
        seg = blob[pos + 2:pos + seg_len]
        pos += seg_len
        if marker == 0xC4:                 # DHT (may hold several tables)
            o = 0
            while o < len(seg):
                tc_th = seg[o]
                counts = seg[o + 1:o + 17]
                total = sum(counts)
                symbols = seg[o + 17:o + 17 + total]
                # validate HERE (the slices silently shorten on a
                # truncated segment, and the C++ decoder trusts them)
                if len(counts) < 16 or len(symbols) < total:
                    raise ValueError("truncated DHT segment in "
                                     "lossless-JPEG frame")
                huff[tc_th & 0x0F] = (counts, symbols)
                o += 17 + total
        elif marker == 0xC3:               # SOF3: lossless, Huffman
            precision = seg[0]
            lines, samples = struct.unpack(">HH", seg[1:5])
            if seg[5] != 1:
                raise NotImplementedError(
                    f"lossless JPEG with {seg[5]} components — the CT "
                    "pipeline consumes monochrome slices only")
        elif marker in (0xC0, 0xC1, 0xC2, 0xC5, 0xC6, 0xC7, 0xC9,
                        0xCA, 0xCB, 0xCD, 0xCE, 0xCF):
            raise NotImplementedError(
                f"JPEG SOF{marker - 0xC0} frame — only lossless "
                "Huffman (SOF3) is supported in this syntax")
        elif marker == 0xDD:               # DRI
            restart_interval = struct.unpack(">H", seg[:2])[0]
        elif marker == 0xDA:               # SOS
            ns = seg[0]
            table_id = seg[2] >> 4         # DC/lossless table selector
            psv = seg[1 + 2 * ns]
            point_transform = seg[3 + 2 * ns] & 0x0F
            if ns != 1:
                raise NotImplementedError(
                    "multi-component lossless-JPEG scan")
            if restart_interval:
                raise NotImplementedError(
                    "lossless JPEG with restart markers (DRI > 0) — "
                    "convert the series to RLE/NIfTI (data/nifti.py)")
            # entropy-coded data runs to the next real marker (an FF
            # not followed by a stuffed 00), else to the last byte
            m = _MARKER.search(blob, pos)
            end = m.start() if m else max(pos, n - 1)
            entropy = blob[pos:end].replace(b"\xff\x00", b"\xff")
    if entropy is None or precision is None or psv is None:
        raise ValueError("lossless-JPEG frame missing SOF3/SOS")
    if (lines, samples) != (rows, cols):
        raise ValueError(
            f"lossless-JPEG frame {(lines, samples)} does not match "
            f"Rows/Columns ({rows}, {cols})")
    raw = huff.get(table_id)
    if raw is None:
        raise ValueError(f"scan references undefined Huffman table "
                         f"{table_id}")
    counts, symbols = raw
    default = 1 << (precision - 1 - point_transform)
    arr = native.jpeg_lossless_decode(entropy, counts, symbols, rows,
                                      cols, psv, default)
    if arr is not None:
        return arr << np.uint16(point_transform)
    # the C++ decoder rejected the stream: decode it again here only to
    # raise the precise error
    _decode_jpeg_lossless_python(entropy, counts, symbols, rows, cols, psv,
                                 default)
    raise ValueError("malformed lossless-JPEG scan (rejected by the "
                     "native decoder)")


def _decode_jpeg_lossless_python(entropy: bytes, counts: bytes,
                                 symbols: bytes, rows: int, cols: int,
                                 psv: int, default: int) -> np.ndarray:
    """The per-sample decode of ``mmf_jpeg_lossless_decode`` in Python,
    raising a precise error where a stream is malformed; the tests' oracle
    of the C++ decoder.  Returns uint16 (rows, cols) before the point
    transform."""
    table = _build_huffman(counts, symbols)
    reader = _BitReader(entropy)
    out = np.empty((rows, cols), np.int64)
    for y in range(rows):
        row_above = out[y - 1] if y else None
        row_cur = out[y]
        for x in range(cols):
            ssss = _huff_decode(reader, table)
            if ssss > 16:                  # SSSS categories end at 16
                raise ValueError(f"invalid SSSS symbol {ssss} in "
                                 "lossless-JPEG scan")
            if ssss == 0:
                diff = 0
            elif ssss == 16:
                diff = 32768
            else:
                v = reader.get_bits(ssss)
                diff = v if v >= (1 << (ssss - 1)) else v - (1 << ssss) + 1
            pred = _predict(row_above, row_cur, x, y, psv, default)
            # reconstruction is modulo 2**16 regardless of precision
            # (T.81 H.1.2.1)
            row_cur[x] = (pred + diff) & 0xFFFF
    return out.astype(np.uint16)


def _encode_jpeg_lossless(pixels: np.ndarray, psv: int = 1) -> bytes:
    """Encode one uint16 frame as lossless JPEG under any predictor
    selection value 1..7 (writer/tests counterpart of
    ``_decode_jpeg_lossless``), the JAX package's encoder's bytes, in
    numpy throughout.  Lossless reconstruction means the decoder's
    neighbours Ra/Rb/Rc equal the original samples, so the prediction
    surface vectorizes directly from ``pixels``."""
    if not 1 <= psv <= 7:
        raise ValueError(f"predictor selection value {psv} not in 1..7")
    pixels = np.ascontiguousarray(pixels, np.uint16)
    rows, cols = pixels.shape
    p = pixels.astype(np.int64)
    # T.81 H.1.2 boundaries regardless of SV: the first sample predicts
    # from 2**(P-1), the rest of row 0 from the left neighbour, and
    # column 0 from the row above; interior samples use the SV.
    pred = np.empty_like(p)
    pred[0, 1:] = p[0, :-1]
    pred[1:, 0] = p[:-1, 0]
    pred[0, 0] = 1 << 15
    ra, rb, rc = p[1:, :-1], p[:-1, 1:], p[:-1, :-1]
    pred[1:, 1:] = {1: lambda: ra,
                    2: lambda: rb,
                    3: lambda: rc,
                    4: lambda: ra + rb - rc,
                    5: lambda: ra + ((rb - rc) >> 1),
                    6: lambda: rb + ((ra - rc) >> 1),
                    7: lambda: (ra + rb) >> 1}[psv]()
    diffs = ((p - pred) & 0xFFFF).ravel()
    diffs = np.where(diffs >= 32768, diffs - 65536, diffs)
    diffs[diffs == -32768] = 32768      # category-16 sentinel

    # SSSS category: the bit length of |diff| (16 for the sentinel)
    cats = np.frexp(np.abs(diffs).astype(np.float64))[1].astype(np.int64)
    freq = np.bincount(cats, minlength=17)
    # fixed canonical table covering categories 0..16: short codes for
    # the frequent small categories, Kraft sum < 1 so no all-ones code
    lengths = [2, 2, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 16, 16]
    order = np.argsort(-freq, kind="stable")       # frequent -> short
    sym_len = {int(order[i]): lengths[i] for i in range(17)}
    counts = [0] * 16
    for L in sym_len.values():
        counts[L - 1] += 1
    symbols = sorted(range(17), key=lambda s: (sym_len[s], s))
    code_len = np.zeros(17, np.int64)
    code_val = np.zeros(17, np.int64)
    code, k = 0, 0
    for length in range(1, 17):
        for _ in range(counts[length - 1]):
            code_len[symbols[k]], code_val[symbols[k]] = length, code
            k += 1
            code += 1
        code <<= 1

    # each sample: its category's code, then (for 0 < SSSS < 16) SSSS
    # magnitude bits, ones' complement for a negative diff
    mag_len = np.where((cats > 0) & (cats < 16), cats, 0)
    mag = np.where(diffs >= 0, diffs, diffs + (1 << mag_len) - 1) \
        & ((1 << mag_len) - 1)
    lens = np.stack([code_len[cats], mag_len], 1).ravel()
    vals = np.stack([code_val[cats], mag], 1).ravel()
    # expand every (length, value) field MSB first into one bit string,
    # pad the last byte with ones, then stuff a 00 after every FF byte
    ends = np.cumsum(lens)
    pos_in = np.arange(int(ends[-1])) - np.repeat(ends - lens, lens)
    bits = (np.repeat(vals, lens) >> (np.repeat(lens, lens) - 1 - pos_in)) & 1
    bits = np.concatenate([bits.astype(np.uint8),
                           np.ones(-len(bits) % 8, np.uint8)])
    out = np.packbits(bits).tobytes().replace(b"\xff", b"\xff\x00")

    dht = bytes([0x00] + counts) + bytes(symbols)
    sof = struct.pack(">BHHB", 16, rows, cols, 1) + bytes([1, 0x11, 0])
    sos = bytes([1, 1, 0x00, psv, 0, 0x00])  # comp 1/table 0, Ss=SV
    return (b"\xff\xd8"
            + b"\xff\xc4" + struct.pack(">H", len(dht) + 2) + dht
            + b"\xff\xc3" + struct.pack(">H", len(sof) + 2) + sof
            + b"\xff\xda" + struct.pack(">H", len(sos) + 2) + sos
            + out + b"\xff\xd9")


def _encode_jpeg_lossless_sv1(pixels: np.ndarray) -> bytes:
    """The SV1 (DICOM …1.2.4.70) pin of ``_encode_jpeg_lossless``."""
    return _encode_jpeg_lossless(pixels, psv=1)


def _packbits_decode(data: bytes, expected: int) -> bytes:
    """PackBits per PS3.5 G.3.1 (identical to TIFF PackBits)."""
    out = bytearray()
    i, n = 0, len(data)
    while i < n and len(out) < expected:
        ctrl = data[i]
        i += 1
        if ctrl < 128:                      # literal run of ctrl+1 bytes
            out += data[i:i + ctrl + 1]
            i += ctrl + 1
        elif ctrl > 128:                    # replicate next byte 257-ctrl
            out += data[i:i + 1] * (257 - ctrl)
            i += 1
        # ctrl == 128: no-op
    return bytes(out[:expected])


def _run_length_at(data: bytes, i: int, cap: int = 128) -> int:
    run = 1
    while i + run < len(data) and run < cap and data[i + run] == data[i]:
        run += 1
    return run


def _packbits_encode(data: bytes) -> bytes:
    """PackBits encoder (writer/tests): replicate runs >= 3, literals
    otherwise, both capped at 128."""
    out = bytearray()
    i, n = 0, len(data)
    while i < n:
        run = _run_length_at(data, i)
        if run >= 3:
            out += bytes([257 - run, data[i]])
            i += run
            continue
        j = i
        while j < n and j - i < 128 and _run_length_at(data, j, 3) < 3:
            j += 1
        out += bytes([j - i - 1]) + data[i:j]
        i = j
    return bytes(out)


def _decode_rle_frame(frame: bytes, rows: int, cols: int,
                      bits: int) -> np.ndarray:
    """DICOM RLE Lossless frame (PS3.5 Annex G): a 64-byte header of
    16 LE uint32 (segment count + offsets), then PackBits byte planes,
    MSB plane first for 16-bit composite pixels."""
    header = struct.unpack("<16I", frame[:64])
    n_seg = header[0]
    offsets = list(header[1:1 + n_seg]) + [len(frame)]
    npix = rows * cols
    planes = [
        np.frombuffer(_packbits_decode(frame[offsets[k]:offsets[k + 1]],
                                       npix), dtype=np.uint8)
        for k in range(n_seg)]
    if bits == 8 and n_seg >= 1:
        return planes[0].reshape(rows, cols)
    if bits == 16 and n_seg >= 2:
        composite = (planes[0].astype(np.uint16) << 8) \
            | planes[1].astype(np.uint16)
        return composite.reshape(rows, cols)
    raise ValueError(f"RLE frame with {n_seg} segments for "
                     f"BitsAllocated={bits}")


def _decode_encapsulated(fragments, transfer_syntax: str, rows: int,
                         cols: int, bits: int,
                         signed: bool) -> np.ndarray:
    """Decode single-frame encapsulated PixelData (fragment list from
    the item stream, Basic Offset Table already dropped)."""
    blob = b"".join(fragments)
    if transfer_syntax == RLE_LOSSLESS:
        # PS3.5 Annex G: RLE encodes exactly one frame per fragment, so
        # >1 fragment means a multi-frame object (the NumberOfFrames
        # guard catches declared ones; this catches undeclared ones)
        if len(fragments) > 1:
            raise NotImplementedError(
                f"RLE PixelData with {len(fragments)} fragments is "
                "multi-frame — this reader handles one frame per file")
        arr = _decode_rle_frame(blob, rows, cols, bits)
    elif transfer_syntax in (JPEG_LOSSLESS_SV1, JPEG_LOSSLESS_P14):
        # .70 is process 14 pinned to SV1; .57 is the same process with
        # the predictor free — the decoder reads the SOS's SV either way
        arr = _decode_jpeg_lossless(blob, rows, cols)
        if bits == 8:
            arr = arr.astype(np.uint8)
    elif transfer_syntax in _PIL_SYNTAXES:
        # JAX hands the frame to PIL: any failure to decode is a
        # NotImplementedError there, and so here
        decoder = (jpeg.decode_jpeg if transfer_syntax == JPEG_BASELINE
                   else j2k.decode)
        try:
            arr = decoder(blob)
        except (ValueError, NotImplementedError) as exc:
            raise NotImplementedError(
                f"the port's decoder cannot decode this "
                f"{transfer_syntax} frame ({exc!r}) — convert the series "
                f"to RLE/NIfTI (data/nifti.py)") from exc
        if arr.ndim != 2:
            raise NotImplementedError(
                f"decoded frame has shape {arr.shape} (SamplesPerPixel "
                "> 1 / color) — the CT pipeline consumes monochrome "
                "slices only")
        if arr.shape != (rows, cols):
            raise ValueError(
                f"decoded frame {arr.shape} does not match "
                f"Rows/Columns ({rows}, {cols})")
    else:
        raise NotImplementedError(
            f"transfer syntax {transfer_syntax} has no decoder in this "
            "package (JPEG Extended carries 12-bit lossy JPEG, which PIL "
            "cannot parse either) — convert the series to RLE/JPEG "
            "Lossless/JPEG 2000 or NIfTI (data/nifti.py)")
    if bits == 16:
        arr = arr.astype(np.uint32).astype(np.uint16)
        return arr.view(np.int16).copy() if signed else arr
    return arr.astype(np.int8 if signed else np.uint8)


def _parse_value(vr: str, raw: bytes, e: str = "<"):
    if vr == "DS":
        parts = raw.decode("ascii", "ignore").strip("\x00 ").split("\\")
        vals = [float(p) for p in parts if p.strip()]
        return vals if len(vals) != 1 else vals[0]
    if vr == "IS":
        parts = raw.decode("ascii", "ignore").strip("\x00 ").split("\\")
        vals = [int(p) for p in parts if p.strip()]
        return vals if len(vals) != 1 else vals[0]
    if vr == "US":
        return struct.unpack(e + "H", raw[:2])[0]
    if vr == "CS":
        return raw.decode("ascii", "ignore").strip("\x00 ")
    return raw


def _elem_header(buf: bytes, pos: int, explicit: bool, e: str = "<"):
    """Parse one data-element header -> (group, elem, vr, length, vpos).
    Item/delimiter tags (group FFFE) always use the implicit 4-byte
    length layout regardless of the dataset's transfer syntax.  ``e`` is
    the dataset's byte order ('<' LE, '>' BE — VR bytes are unaffected,
    tag/length fields swap)."""
    group, elem = struct.unpack(e + "HH", buf[pos:pos + 4])
    if group == 0xFFFE or not explicit:
        length = struct.unpack(e + "I", buf[pos + 4:pos + 8])[0]
        vr_s = _TAGS.get((group, elem), ("", "UN"))[1]
        return group, elem, vr_s, length, pos + 8
    vr = buf[pos + 4:pos + 6]
    if vr in _LONG_VRS:
        length = struct.unpack(e + "I", buf[pos + 8:pos + 12])[0]
        return group, elem, vr.decode("ascii", "ignore"), length, pos + 12
    length = struct.unpack(e + "H", buf[pos + 6:pos + 8])[0]
    return group, elem, vr.decode("ascii", "ignore"), length, pos + 8


def _skip_sequence(buf: bytes, pos: int, explicit: bool,
                   e: str = "<") -> int:
    """Skip an undefined-length sequence VALUE: a stream of items
    (FFFE,E000) ending at the sequence delimiter (FFFE,E0DD).
    Defined-length items skip by length; undefined-length items contain
    ordinary data elements (parsed with ``_elem_header``, recursing for
    nested undefined-length sequences) until their item delimiter
    (FFFE,E00D)."""
    n = len(buf)
    while pos + 8 <= n:
        group, elem, _, length, vpos = _elem_header(buf, pos, explicit, e)
        if (group, elem) == (0xFFFE, 0xE0DD):      # sequence delimiter
            return vpos
        if (group, elem) != (0xFFFE, 0xE000):
            raise ValueError(
                f"expected an item tag inside a sequence, got "
                f"({group:04x},{elem:04x})")
        if length != 0xFFFFFFFF:
            pos = vpos + length                     # defined-length item
            continue
        # undefined-length item: walk its dataset elements
        pos = vpos
        while pos + 8 <= n:
            g2, e2, _, l2, v2 = _elem_header(buf, pos, explicit, e)
            if (g2, e2) == (0xFFFE, 0xE00D):        # item delimiter
                pos = v2
                break
            pos = _skip_sequence(buf, v2, explicit, e) \
                if l2 == 0xFFFFFFFF else v2 + l2
    return pos


def _read_fragments(buf: bytes, pos: int, explicit: bool):
    """Read the encapsulated-PixelData item stream -> (fragment bytes
    list, end position).

    PS3.5 A.4 mandates the first item be the Basic Offset Table
    (possibly zero-length), but non-conformant writers omit it; the
    first item is only dropped when it plausibly IS a BOT — empty, or
    u32-aligned with a 0 first entry (frame 1's offset is always 0;
    no codec bitstream starts with four zero bytes: RLE's first u32 is
    a 1..15 segment count, JPEG starts FFD8, J2K FF4F/jP box)."""
    items = []
    n = len(buf)
    while pos + 8 <= n:
        group, elem, _, length, vpos = _elem_header(buf, pos, explicit)
        if (group, elem) == (0xFFFE, 0xE0DD):
            if items and (len(items[0]) == 0 or (
                    len(items[0]) % 4 == 0 and
                    struct.unpack("<I", items[0][:4])[0] == 0)):
                items = items[1:]       # drop the offset table
            return items, vpos
        if (group, elem) != (0xFFFE, 0xE000) or length == 0xFFFFFFFF:
            raise ValueError(
                f"malformed encapsulated PixelData item at byte {pos}")
        items.append(buf[vpos:vpos + length])
        pos = vpos + length
    raise ValueError("encapsulated PixelData missing its sequence "
                     "delimiter")


def _walk(buf: bytes, pos: int, explicit: bool, stop_group=None,
          e: str = "<"):
    """Yield (group, elem, vr, raw_value, next_pos) element stream."""
    n = len(buf)
    while pos + 8 <= n:
        group = struct.unpack(e + "H", buf[pos:pos + 2])[0]
        if stop_group is not None and group != stop_group:
            return
        group, elem, vr_s, length, vpos = _elem_header(buf, pos,
                                                       explicit, e)
        if length == 0xFFFFFFFF:
            if vr_s not in ("SQ", "UN", "OW", "OB"):
                raise ValueError(
                    f"undefined length on VR {vr_s} at tag "
                    f"({group:04x},{elem:04x})")
            if (group, elem) == (0x7FE0, 0x0010):
                # encapsulated PixelData: item 1 is the Basic Offset
                # Table, the rest are frame fragments (PS3.5 A.4;
                # encapsulated syntaxes are all little-endian)
                fragments, end = _read_fragments(buf, vpos, explicit)
                yield group, elem, vr_s, fragments, end
                pos = end
                continue
            end = _skip_sequence(buf, vpos, explicit, e)
            yield group, elem, vr_s, None, end
            pos = end
            continue
        yield group, elem, vr_s, buf[vpos:vpos + length], vpos + length
        pos = vpos + length


def read_file(path: str) -> DicomSlice:
    """Parse one DICOM file into a DicomSlice."""
    with open(path, "rb") as f:
        buf = f.read()
    pos = 0
    transfer_syntax = EXPLICIT_VR_LE
    if len(buf) > 132 and buf[128:132] == b"DICM":
        pos = 132
        # file meta group (0002) is ALWAYS explicit VR LE
        meta_end = pos
        for group, elem, vr, raw, nxt in _walk(buf, pos, True,
                                               stop_group=0x0002):
            meta_end = nxt
            if (group, elem) == (0x0002, 0x0010):
                transfer_syntax = raw.decode("ascii",
                                             "ignore").strip("\x00 ")
        pos = meta_end
    known = {EXPLICIT_VR_LE, IMPLICIT_VR_LE, EXPLICIT_VR_BE,
             DEFLATED_EXPLICIT_VR_LE} | _ENCAPSULATED
    if transfer_syntax not in known:
        raise NotImplementedError(
            f"transfer syntax {transfer_syntax} (unsupported "
            f"compression) — convert the series to NIfTI "
            f"(data/nifti.py)")
    if transfer_syntax == DEFLATED_EXPLICIT_VR_LE:
        import zlib
        # raw deflate stream (no zlib header), PS3.5 A.5
        buf = zlib.decompress(buf[pos:], -15)
        pos = 0
    # every syntax except implicit VR encodes the dataset explicit-VR;
    # only the retired BE syntax swaps the dataset's byte order (the
    # file-meta group stays LE either way, PS3.5 §7.1)
    explicit = transfer_syntax != IMPLICIT_VR_LE
    e = ">" if transfer_syntax == EXPLICIT_VR_BE else "<"

    elements: Dict[str, object] = {
        "TransferSyntaxUID": transfer_syntax}
    for group, elem, vr, raw, _ in _walk(buf, pos, explicit, e=e):
        name_vr = _TAGS.get((group, elem))
        if name_vr is None or raw is None:
            continue
        name, default_vr = name_vr
        use_vr = vr if (explicit and vr not in ("UN", "")) else default_vr
        if name == "PixelData":
            if isinstance(raw, list):
                elements["PixelDataFragments"] = raw
            else:
                elements[name] = raw
        else:
            elements[name] = _parse_value(use_vr, raw, e)
    return DicomSlice(elements, path)


def read_series(path: str) -> List[DicomSlice]:
    """Read every .dcm file in a directory, sorted by the z component of
    ImagePositionPatient (ref load_scan :14-27)."""
    names = sorted(n for n in os.listdir(path) if ".dcm" in n.lower())
    slices = [read_file(os.path.join(path, n)) for n in names]
    slices.sort(key=lambda s: float(s.ImagePositionPatient[2]))
    return slices


# ---------------------------------------------------------------------------
# minimal writer (tests / interchange)
# ---------------------------------------------------------------------------

def _enc_element(group: int, elem: int, vr: str, value: bytes) -> bytes:
    # PS3.5 padding: text VRs pad with space, UI (and binary) with NUL
    if len(value) % 2:
        value += b" " if vr in ("DS", "IS", "CS") else b"\x00"
    head = struct.pack("<HH", group, elem)
    if vr.encode() in _LONG_VRS:
        return head + vr.encode() + b"\x00\x00" + struct.pack(
            "<I", len(value)) + value
    return head + vr.encode() + struct.pack("<H", len(value)) + value


def _ds(*vals) -> bytes:
    return "\\".join(f"{v:g}" for v in vals).encode()


def _encapsulate(frame: bytes) -> bytes:
    """Encapsulated OB PixelData: undefined length, empty Basic Offset
    Table item, one frame fragment, sequence delimiter (PS3.5 A.4)."""
    if len(frame) % 2:
        frame += b"\x00"
    return (struct.pack("<HH", 0x7FE0, 0x0010) + b"OB\x00\x00"
            + struct.pack("<I", 0xFFFFFFFF)
            + struct.pack("<HHI", 0xFFFE, 0xE000, 0)
            + struct.pack("<HHI", 0xFFFE, 0xE000, len(frame)) + frame
            + struct.pack("<HHI", 0xFFFE, 0xE0DD, 0))


def _rle_encode_frame(pixels: np.ndarray) -> bytes:
    """RLE Lossless frame for one int16 slice: MSB + LSB byte planes,
    each PackBits-encoded, behind the 64-byte offset header."""
    v = np.ascontiguousarray(pixels, np.int16).view(np.uint16)
    segs = [_packbits_encode((v >> 8).astype(np.uint8).tobytes()),
            _packbits_encode((v & 0xFF).astype(np.uint8).tobytes())]
    segs = [s + b"\x00" * (len(s) % 2) for s in segs]  # even segments
    offsets = [64, 64 + len(segs[0])]
    header = struct.pack("<16I", 2, *offsets, *([0] * 13))
    return header + segs[0] + segs[1]


def write_ct_slice(path: str, pixels: np.ndarray, z: float,
                   spacing: Tuple[float, float] = (1.0, 1.0),
                   thickness: float = 1.0, intercept: float = -1024.0,
                   slope: float = 1.0,
                   orientation=(1, 0, 0, 0, 1, 0),
                   implicit: bool = False,
                   compression: Optional[str] = None,
                   jpeg_psv: int = 1) -> str:
    """Write a single-frame 16-bit CT slice as a Part-10 DICOM file.

    compression: None (uncompressed), 'rle' (RLE Lossless),
    'jpeg_lossless' (JPEG Lossless, a T.81 process-14 encoder —
    ``jpeg_psv`` picks the predictor: 1 writes the DICOM-ubiquitous SV1
    syntax …1.2.4.70, any other value 2..7 writes the predictor-free
    syntax …1.2.4.57), 'jpeg2000' (JPEG 2000 Lossless …1.2.4.90, the
    port's encoder with the settings PIL's openjpeg writes: a JP2 box, 5
    levels, 64 x 64 code-blocks, one layer), or 'deflated' (Deflated
    Explicit VR LE).
    """
    pixels = np.ascontiguousarray(pixels, np.int16)
    rows, cols = pixels.shape
    if implicit and compression:
        raise ValueError("encapsulated/deflated syntaxes are "
                         "explicit-VR only")

    body = b""
    if implicit:
        def enc(group, elem, vr, value):
            if len(value) % 2:
                value += b" " if vr in ("DS", "IS", "CS") else b"\x00"
            return struct.pack("<HHI", group, elem, len(value)) + value
    else:
        enc = _enc_element
    body += enc(0x0008, 0x0060, "CS", b"CT")
    body += enc(0x0018, 0x0050, "DS", _ds(thickness))
    body += enc(0x0020, 0x0032, "DS", _ds(0.0, 0.0, z))
    body += enc(0x0020, 0x0037, "DS", _ds(*orientation))
    body += enc(0x0028, 0x0002, "US", struct.pack("<H", 1))
    body += enc(0x0028, 0x0010, "US", struct.pack("<H", rows))
    body += enc(0x0028, 0x0011, "US", struct.pack("<H", cols))
    body += enc(0x0028, 0x0030, "DS", _ds(*spacing))
    body += enc(0x0028, 0x0100, "US", struct.pack("<H", 16))
    body += enc(0x0028, 0x0103, "US", struct.pack("<H", 1))
    body += enc(0x0028, 0x1052, "DS", _ds(intercept))
    body += enc(0x0028, 0x1053, "DS", _ds(slope))

    if compression == "rle":
        ts = RLE_LOSSLESS
        body += _encapsulate(_rle_encode_frame(pixels))
    elif compression == "jpeg_lossless":
        ts = JPEG_LOSSLESS_SV1 if jpeg_psv == 1 else JPEG_LOSSLESS_P14
        # encode the two's-complement uint16 view; modulo-2**16
        # reconstruction makes the int16 round-trip exact
        body += _encapsulate(_encode_jpeg_lossless(
            pixels.view(np.uint16), psv=jpeg_psv))
    elif compression == "jpeg2000":
        ts = JPEG2000_LOSSLESS
        # lossless J2K of the two's-complement uint16 view round-trips
        # int16 exactly
        body += _encapsulate(j2k.encode(pixels.view(np.uint16)))
    elif compression == "deflated":
        import zlib
        ts = DEFLATED_EXPLICIT_VR_LE
        body += _enc_element(0x7FE0, 0x0010, "OW", pixels.tobytes())
        co = zlib.compressobj(wbits=-15)
        body = co.compress(body) + co.flush()
    elif compression is None:
        ts = IMPLICIT_VR_LE if implicit else EXPLICIT_VR_LE
        body += enc(0x7FE0, 0x0010, "OW", pixels.tobytes())
    else:
        raise ValueError(f"unknown compression {compression!r}")

    meta = _enc_element(0x0002, 0x0010, "UI", ts.encode())
    with open(path, "wb") as f:
        f.write(b"\x00" * 128 + b"DICM" + meta + body)
    return path
