"""A reader of baseline, compressed and tiled TIFF files and a writer of
uncompressed ones, in numpy, the standard library and the port's own
decoders: the port's stand-in for PIL and libtiff under the WSI slide
reader (the machine with the card has no PIL).

The reader takes the headers PIL opens (``PREFIXES``): classic TIFF,
little- and big-endian, and little-endian BigTIFF (8-byte offsets and
counts, 20-byte IFD entries, field types 16-18, offsets past 4 GiB); a
big-endian BigTIFF, which PIL 12.1.0 misreads, raises
``BigEndianBigTIFFError`` (an ``OSError``).  It reads every page of the
main IFD chain (SubIFDs are not followed, as PIL does not follow them),
image data in strips or in tiles (tags 322-325; edge tiles are
cropped), chunky or planar (``PlanarConfiguration`` 2: one chunk list a
sample, plane after plane), and the page layouts PIL opens
(TiffImagePlugin's OPEN_INFO, fill order 1): bilevel and 8-bit gray,
min-is-black or min-is-white; 16-bit gray; LA; 8-bit RGB, with or
without a fourth sample (ExtraSamples, tag 338: unassociated alpha,
associated alpha, unspecified); 16-bit RGB; palette (1, 2, 4 or 8 bits,
with its ColorMap, tag 320); CMYK; each with one of these compressions
(tag 259):

- 1, none;
- 5, LZW, with ``Predictor`` (tag 317) 1 or 2 (horizontal differencing);
- 8 and 32946, Deflate (``zlib``), with predictor 1 or 2;
- 32773, PackBits;
- 34925, LZMA (the standard library's ``lzma``, the xz container libtiff
  writes), with predictor 1 or 2;
- 50000, ZSTD (``utils/zstd.py``, the port's own Zstandard decoder, as
  libtiff's libzstd decodes each chunk: its first frame, no
  dictionary, a window of at most 2^27 bytes unless the frame declares
  a content size that fits the chunk), with predictor 1 or 2;
- 7, JPEG (``utils/jpeg.py``, baseline or progressive streams, as
  libtiff decodes both for PIL): 8-bit gray, or 3 components with
  photometric 2 (RGB, no colour transform) or 6 (YCbCr, converted to
  RGB as libtiff asks libjpeg to for PIL; the subsampling is the
  stream's, and must match ``YCbCrSubsampling``, tag 530, when that is
  present), with the tables in each stream or in ``JPEGTables`` (tag
  347).

``read_page`` returns uint8 RGB as PIL's ``convert("RGB")`` does after
its unpacker (``to_rgb``): grayscale repeated, 16-bit gray saturated at
255, 16-bit RGB by its high byte, alpha dropped (associated alpha
divided out first, as is a compressed planar page's fourth sample
without ExtraSamples, which libtiff's RGBA reader counts associated),
palette through the ColorMap, CMYK as ``cmyk_to_rgb``.  LZW, PackBits
and ZSTD chunks and JPEG streams decode in C++ (``csrc/imgcodec.cpp``),
many chunks in parallel threads, Deflate in ``zlib`` on a thread pool;
``read_page(..., plain=True)`` decodes them with the plain versions
(``lzw_decode_plain``, ``packbits_decode_plain``, ``zstd_decode_plain``,
the JPEG decoder's), one chunk after another, as the tests and
``chip_smoke.py`` do to hold the C++ to them.  A chunk the C++ cannot
decode raises; it never gives way to the plain version.  ``read_pages``
reads only the page headers (sizes and the mode PIL would decode each
page in), so a caller can budget the decode first.  Other compressions
(CCITT, old-style JPEG, JPEG 2000, Aperio's JPEG 2000 tiles 33003 and
33005, ...), fill order 2, floating-point prediction and other layouts
raise ``NotImplementedError`` naming the file and the tag, as do the
uncompressed planar pages PIL's raw reader has no mode for; ROADMAP.md
queues them.

``read_tiles`` decodes a chosen set of a tiled page's tiles into given
views, by the same codec routes, without the rest of the page (the
Aperio reader's route, ``data/wsi.OpenSlideBackend``); a tile of byte
count 0, which a scanner leaves missing, reads 0 there.  Each ``Page``
keeps its ``ImageDescription`` and ``NewSubfileType``.

The writer (``write_tiff``) writes uint8 RGB pages [H, W, 3],
uncompressed, one strip a page, little-endian, as PIL writes a
multi-page TIFF (``save_all``).
"""
from __future__ import annotations

import concurrent.futures
import ctypes
import os
import struct
import zlib
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np

from multimodalfusion_tpu_torch.utils import jpeg, zstd

# tags
_WIDTH, _LENGTH, _BITS, _COMPRESSION, _PHOTOMETRIC = 256, 257, 258, 259, 262
_STRIP_OFFSETS, _SAMPLES, _ROWS_PER_STRIP, _STRIP_BYTES = 273, 277, 278, 279
_PLANAR, _PREDICTOR, _TILE_WIDTH, _TILE_LENGTH = 284, 317, 322, 323
_TILE_OFFSETS, _TILE_BYTES, _JPEG_TABLES, _YCBCR_SUB = 324, 325, 347, 530
_FILL_ORDER, _COLORMAP, _EXTRA = 266, 320, 338
_SUBFILE_TYPE, _DESCRIPTION = 254, 270
# field type -> (struct code, size)
_TYPES = {1: ("B", 1), 2: ("c", 1), 3: ("H", 2), 4: ("I", 4), 6: ("b", 1),
          7: ("B", 1), 8: ("h", 2), 9: ("i", 4), 13: ("I", 4), 16: ("Q", 8),
          17: ("q", 8), 18: ("Q", 8)}
# the headers PIL opens (TiffImagePlugin.PREFIXES): classic TIFF; two
# malformed ones that it reads as classic TIFF in the byte order of their
# first two bytes; BigTIFF, little- and big-endian
PREFIXES = (b"II*\0", b"MM\0*", b"II\0*", b"MM*\0", b"II+\0", b"MM\0+")
BIG_ENDIAN_BIGTIFF = b"MM\0+"
# compressions read, by tag 259 value
NONE, LZW, JPEG, DEFLATE, PACKBITS, ADOBE_DEFLATE = 1, 5, 7, 8, 32773, 32946
LZMA, ZSTD = 34925, 50000
COMPRESSIONS = {NONE: "none", LZW: "LZW", JPEG: "JPEG", DEFLATE: "Deflate",
                ADOBE_DEFLATE: "Deflate", PACKBITS: "PackBits", LZMA: "LZMA",
                ZSTD: "ZSTD"}
# compressions named when refused
_REFUSED = {33003: "Aperio JPEG 2000, YCbCr", 33005: "Aperio JPEG 2000, RGB"}
# (PhotometricInterpretation, BitsPerSample, ExtraSamples) -> the mode PIL
# opens the page in (TiffImagePlugin's OPEN_INFO, fill order 1, unsigned
# integer samples); "RGBa": associated alpha, which PIL divides out
_LAYOUTS = {
    (0, (1,), ()): "1", (1, (1,), ()): "1",
    (0, (8,), ()): "L", (1, (8,), ()): "L",
    (0, (16,), ()): "I;16", (1, (16,), ()): "I;16",
    (1, (8, 8), (2,)): "LA",
    (2, (8, 8, 8), ()): "RGB", (2, (8, 8, 8, 8), (0,)): "RGB",
    (2, (8, 8, 8, 8), ()): "RGBA", (2, (8, 8, 8, 8), (2,)): "RGBA",
    (2, (8, 8, 8, 8), (1,)): "RGBa",
    (2, (16, 16, 16), ()): "RGB",
    (3, (1,), ()): "P", (3, (2,), ()): "P", (3, (4,), ()): "P",
    (3, (8,), ()): "P",
    (5, (8, 8, 8, 8), ()): "CMYK",
}


class Page(NamedTuple):
    width: int
    height: int
    mode: str                   # the mode PIL decodes the page in
    dtype: np.dtype             # of one sample, in the file's byte order
    samples: int
    chunks: List[tuple]         # (offset, byte count) of each strip / tile
    compression: int = NONE
    predictor: int = 1
    tile: Optional[Tuple[int, int]] = None  # (width, length); None: strips
    rows_per_strip: int = 0
    jpeg_tables: Optional[bytes] = None
    photometric: int = 2
    ycbcr_sub: Optional[Tuple[int, int]] = None
    planar: int = 1             # 2: one chunk list a sample, plane by plane
    bits: int = 8               # of each sample (1, 2, 4, 8 or 16)
    extra: Tuple[int, ...] = ()  # ExtraSamples
    colormap: Optional[np.ndarray] = None  # palette [2^bits, 3] uint8
    # False: the file's header is one libtiff refuses (see ``_header``),
    # so PIL, which hands libtiff every compressed page, decodes none
    libtiff_header: bool = True
    description: Optional[str] = None  # ImageDescription, to its first NUL
    subfile_type: int = 0       # NewSubfileType


def _read_at(f, pos: int, n: int, path: str) -> bytes:
    # checked against the file's size first: a BigTIFF count can ask for
    # more bytes than any file holds
    if pos + n > os.fstat(f.fileno()).st_size:
        raise OSError(f"{path}: truncated TIFF file (wanted {n} bytes at "
                      f"{pos})")
    f.seek(pos)
    return f.read(n)


def _fields(f, order: str, at: int, path: str, big: bool = False):
    """The tags of the IFD at ``at`` (tag -> tuple of values, None for a
    field type of no use here) and the offset of the next IFD.  A classic
    IFD has a 2-byte entry count, 12-byte entries (a 4-byte count and a
    value that fits in 4 bytes, else its offset) and a 4-byte link;
    ``big``: BigTIFF's 8-byte entry count, 20-byte entries (an 8-byte
    count, 8 bytes of value or offset) and 8-byte link, as PIL reads
    them."""
    word, room = ("Q", 8) if big else ("I", 4)
    head = 8 if big else 2
    entry = 4 + 2 * room
    (n,) = struct.unpack(order + ("Q" if big else "H"),
                         _read_at(f, at, head, path))
    block = _read_at(f, at + head, entry * n + room, path)
    tags = {}
    for i in range(n):
        tag, typ, count = struct.unpack_from(order + "HH" + word, block,
                                             entry * i)
        if typ not in _TYPES:
            tags[tag] = None  # rationals and the like
            continue
        code, size = _TYPES[typ]
        value = entry * (i + 1) - room
        if count * size <= room:
            raw = block[value:value + count * size]
        else:
            (pos,) = struct.unpack_from(order + word, block, value)
            raw = _read_at(f, pos, count * size, path)
        tags[tag] = (raw if typ == 7 else
                     struct.unpack(f"{order}{count}{code}", raw))
    (nxt,) = struct.unpack_from(order + word, block, entry * n)
    return tags, nxt


def _page(tags: dict, path: str) -> Page:
    def one(tag, default=None):
        v = tags.get(tag)
        if v is None:
            if default is None:
                raise NotImplementedError(f"{path}: TIFF page without tag "
                                          f"{tag}")
            return default
        return v[0]

    compression = one(_COMPRESSION, 1)
    if compression not in COMPRESSIONS:
        what = (f" ({_REFUSED[compression]})" if compression in _REFUSED
                else "")
        raise NotImplementedError(
            f"{path}: TIFF Compression (tag {_COMPRESSION}) = "
            f"{compression}{what}; the port reads none (1), LZW (5), JPEG "
            f"(7), Deflate (8, 32946), PackBits (32773), LZMA (34925) and "
            f"ZSTD (50000)")
    planar = one(_PLANAR, 1)
    if planar not in (1, 2):
        raise NotImplementedError(f"{path}: TIFF PlanarConfiguration (tag "
                                  f"{_PLANAR}) = {planar}; the port reads "
                                  f"1 (chunky) and 2 (planar)")
    if one(_FILL_ORDER, 1) != 1:
        raise NotImplementedError(f"{path}: TIFF FillOrder (tag "
                                  f"{_FILL_ORDER}) = {one(_FILL_ORDER)}; "
                                  f"the port reads 1")
    predictor = one(_PREDICTOR, 1)
    if compression not in (LZW, DEFLATE, ADOBE_DEFLATE, LZMA, ZSTD):
        predictor = 1  # libtiff applies it with these only
    if predictor not in (1, 2):
        raise NotImplementedError(f"{path}: TIFF Predictor (tag "
                                  f"{_PREDICTOR}) = {predictor}; the port "
                                  f"reads 1 and 2")
    samples = one(_SAMPLES, 1)
    bits = tuple(tags.get(_BITS) or (1,))
    if len(bits) == 1 and samples > 1:
        bits = bits * samples  # PIL repeats a single value
    photometric = one(_PHOTOMETRIC)
    extra = tuple(tags.get(_EXTRA) or ())
    layout = _LAYOUTS.get((photometric, bits, extra))
    if photometric == 6 and samples == 3 and set(bits) == {8} and (
            compression == JPEG):
        layout = "RGB"
    if compression == JPEG and (layout not in ("RGB", "L") or photometric
                                == 0 or (planar == 2 and photometric == 6)):
        layout = None  # as before: JPEG of 8-bit gray, RGB or YCbCr
    if layout is None or len(bits) != samples:
        raise NotImplementedError(
            f"{path}: TIFF page with PhotometricInterpretation (tag "
            f"{_PHOTOMETRIC}) {photometric}, SamplesPerPixel (tag "
            f"{_SAMPLES}) {samples}, BitsPerSample (tag {_BITS}) {bits}, "
            f"ExtraSamples (tag {_EXTRA}) {extra}, Compression "
            f"{compression}; the port reads the layouts PIL reads of "
            f"bilevel, 8- and 16-bit gray, LA, 8-bit RGB with or without "
            f"alpha, 16-bit RGB, palette and CMYK pages, and YCbCr in JPEG")
    if planar == 2 and compression == NONE and extra in ((0,), (1,)):
        raise NotImplementedError(
            f"{path}: an uncompressed planar TIFF page with ExtraSamples "
            f"(tag {_EXTRA}) {extra}, which PIL's raw reader has no mode "
            f"for (it raises)")
    if layout == "RGBA" and not extra and planar == 2 and (
            compression != NONE):
        # libtiff's RGBA reader, which PIL takes for compressed planar
        # pages, counts a fourth sample without ExtraSamples associated
        layout, extra = "RGBa", (1,)
    mode = "RGBA" if layout == "RGBa" else layout
    dtype = np.dtype("u2") if bits[0] == 16 else np.dtype("u1")
    colormap = None
    if photometric == 3:
        cmap = tags.get(_COLORMAP)
        n = 1 << bits[0]
        if not cmap or len(cmap) != 3 * n:
            raise NotImplementedError(f"{path}: a TIFF palette page "
                                      f"without its ColorMap (tag "
                                      f"{_COLORMAP}) of {3 * n} entries")
        # PIL's palette: each 16-bit entry // 256, red then green then
        # blue
        colormap = (np.asarray(cmap, np.int64).reshape(3, n).T
                    // 256).astype(np.uint8)
    tile = None
    if _TILE_WIDTH in tags or _TILE_OFFSETS in tags:
        tile = (one(_TILE_WIDTH), one(_TILE_LENGTH))
        offsets, counts = tags.get(_TILE_OFFSETS), tags.get(_TILE_BYTES)
        what = (f"TileOffsets (tag {_TILE_OFFSETS}) and TileByteCounts "
                f"(tag {_TILE_BYTES})")
        if not tile[0] or not tile[1]:
            raise OSError(f"{path}: TIFF tiles of {tile[0]} x {tile[1]} "
                          f"(tags {_TILE_WIDTH}, {_TILE_LENGTH})")
    else:
        offsets, counts = tags.get(_STRIP_OFFSETS), tags.get(_STRIP_BYTES)
        what = (f"StripOffsets (tag {_STRIP_OFFSETS}) and StripByteCounts "
                f"(tag {_STRIP_BYTES})")
    if not offsets or not counts or len(offsets) != len(counts):
        raise NotImplementedError(f"{path}: TIFF page without {what}")
    sub = tags.get(_YCBCR_SUB)
    tables = tags.get(_JPEG_TABLES)
    desc = tags.get(_DESCRIPTION)
    if desc is not None:
        desc = b"".join(desc).split(b"\0", 1)[0].decode("utf-8", "replace")
    return Page(one(_WIDTH), one(_LENGTH), mode, dtype, samples,
                list(zip(offsets, counts)), compression, predictor, tile,
                one(_ROWS_PER_STRIP, 0xFFFFFFFF), tables and bytes(tables),
                photometric, tuple(sub[:2]) if sub else None, planar,
                bits[0], extra, colormap, description=desc,
                subfile_type=one(_SUBFILE_TYPE, 0))


class BigEndianBigTIFFError(OSError):
    """A big-endian BigTIFF (header ``MM\\0+``), which the port refuses:
    PIL 12.1.0 takes only a third header byte of 43 for BigTIFF, parses
    this file as classic TIFF (its first IFD at 0x00080000) and fails."""


def _header(path: str):
    """(byte order, offset of the first IFD, BigTIFF?, whether libtiff
    opens the header) of the TIFF at ``path``.  PIL opens every header
    of ``PREFIXES`` but ``MM\\0+`` (a third byte of 43 is its BigTIFF
    test), reads BigTIFF's first offset from bytes 8-16 and checks
    neither the offset size at bytes 4-6 nor the zeros after it.  libtiff
    opens only ``II*\\0``, ``MM\\0*`` and a BigTIFF with offset size 8 and
    those zeros."""
    with open(path, "rb") as f:
        head = f.read(16)
    if head[:4] == BIG_ENDIAN_BIGTIFF:
        raise BigEndianBigTIFFError(
            f"{path}: a big-endian BigTIFF (header MM\\0+), which PIL "
            f"12.1.0 parses as classic TIFF and cannot read, nor can the "
            f"port; re-write it little-endian (II+\\0)")
    if head[:4] not in PREFIXES:
        raise ValueError(f"{path}: not a TIFF file")
    order = "<" if head[:2] == b"II" else ">"
    big = head[2] == 43
    if len(head) < (16 if big else 8):
        raise OSError(f"{path}: truncated TIFF header")
    if big:
        return (order, struct.unpack("<Q", head[8:16])[0], True,
                head[4:8] == b"\x08\0\0\0")
    return (order, struct.unpack(order + "I", head[4:8])[0], False,
            head[:4] in (b"II*\0", b"MM\0*"))


def read_pages(path: str) -> List[Page]:
    """The pages of the TIFF at ``path``, from their headers only: the
    main IFD chain (SubIFDs, tag 330, are not followed: PIL's ``seek``
    walks only the main chain)."""
    order, at, big, libtiff_header = _header(path)
    pages, seen = [], set()
    with open(path, "rb") as f:
        while at:
            if at in seen:
                raise OSError(f"{path}: a loop in the IFD chain at {at}")
            seen.add(at)
            tags, at = _fields(f, order, at, path, big)
            page = _page(tags, path)
            pages.append(page._replace(dtype=page.dtype.newbyteorder(order),
                                       libtiff_header=libtiff_header))
    return pages


# ---- the chunk decoders: plain versions, and the C++ batch

def _codes(data: bytes) -> Tuple[List[int], int]:
    """The 24 bits from each byte on (zeros past the end), and the bit
    count."""
    b = np.frombuffer(bytes(data) + b"\0\0\0", np.uint8).astype(np.int64)
    return ((b[:-2] << 16) | (b[1:-1] << 8) | b[2:]).tolist(), 8 * len(data)


def lzw_decode_plain(data: bytes, cap: int) -> bytes:
    """TIFF LZW (MSB-first codes, Clear 256, EOI 257, the width growing
    one code early, as libtiff decodes): at most ``cap`` bytes.  The
    plain version of ``mmf_tiff_chunks_decode``'s LZW; a code that names
    no entry raises ``ValueError``."""
    win, total = _codes(data)
    out = bytearray()
    table: List[bytes] = [bytes([i]) for i in range(256)] + [b"", b""]
    bit, width, prev = 0, 9, None
    while len(out) < cap and bit + width <= total:
        code = (win[bit >> 3] >> (24 - (bit & 7) - width)) & (
            (1 << width) - 1)
        bit += width
        if code == 257:
            break
        if code == 256:
            del table[258:]
            width, prev = 9, None
            continue
        if prev is None:
            if code > 255:
                raise ValueError("corrupt LZW data (a first code past 255)")
            out += table[code]
            prev = table[code]
            continue
        n = len(table)
        if code < n:
            s = table[code]
        elif code == n and n < 4096:
            s = prev + prev[:1]
        else:
            raise ValueError(f"corrupt LZW data (code {code} of {n})")
        if n < 4096:
            table.append(prev + s[:1])
            if len(table) >= (1 << width) - 1 and width < 12:
                width += 1
        out += s
        prev = s
    return bytes(out[:cap])


def packbits_decode_plain(data: bytes, cap: int) -> bytes:
    """PackBits (a header byte n: n + 1 literal bytes, or the next byte
    1 - n times; -128 skipped): at most ``cap`` bytes.  The plain version
    of ``mmf_tiff_chunks_decode``'s PackBits; a run past the end of the
    data raises ``ValueError``."""
    out = bytearray()
    i, n = 0, len(data)
    while i < n and len(out) < cap:
        h = data[i] - 256 if data[i] > 127 else data[i]
        i += 1
        if h >= 0:
            if i + h + 1 > n:
                raise ValueError("corrupt PackBits data (a literal run "
                                 "past the end)")
            out += data[i:i + h + 1]
            i += h + 1
        elif h != -128:
            if i >= n:
                raise ValueError("corrupt PackBits data (a repeat run "
                                 "past the end)")
            out += bytes([data[i]]) * (1 - h)
            i += 1
    return bytes(out[:cap])


def zstd_decode_plain(data: bytes, cap: int) -> bytes:
    """A ZSTD chunk as libtiff reads it: its first frame, at most ``cap``
    bytes (``zstd.decompress``).  The plain version of
    ``mmf_tiff_chunks_decode``'s ZSTD."""
    return zstd.decompress(data, cap, one_frame=True)


def decode_chunks(codec: int, chunks: Sequence[bytes],
                  outs: Sequence) -> List[int]:
    """LZW (5), PackBits (32773) or ZSTD (50000) of each chunk into its
    ``out`` (a writable C-contiguous uint8 array, filled up to its size)
    in C++, in parallel threads (one per hardware thread): the bytes
    written to each.  A malformed chunk raises ``ValueError``; a ZSTD
    frame that names a dictionary ``NotImplementedError``, and one whose
    window passes 2^27 bytes ``ValueError``, each as
    ``zstd.decompress`` words it."""
    from multimodalfusion_tpu_torch import native
    n = len(chunks)
    if len(outs) != n or any(
            not isinstance(o, np.ndarray) or o.dtype != np.uint8
            or not o.flags.c_contiguous or not o.flags.writeable
            for o in outs):
        raise ValueError(f"{n} chunks need as many writable C-contiguous "
                         f"uint8 outputs")
    srcs = [np.frombuffer(c, np.uint8) for c in chunks]
    c_srcs = (ctypes.c_void_p * n)(*[s.ctypes.data for s in srcs])
    c_lens = (ctypes.c_int64 * n)(*[s.size for s in srcs])
    c_dsts = (ctypes.c_void_p * n)(*[o.ctypes.data for o in outs])
    c_caps = (ctypes.c_int64 * n)(*[o.size for o in outs])
    c_outs = (ctypes.c_int64 * n)()
    if native.codec_lib().mmf_tiff_chunks_decode(
            codec, c_srcs, c_lens, c_dsts, c_caps, c_outs, n, 0) != 0:
        raise ValueError(f"no C++ decoder for TIFF compression {codec}")
    done = list(c_outs)
    bad = [i for i, d in enumerate(done) if d < 0]
    if bad:
        i = bad[0]
        if codec == ZSTD and done[i] in (-2, -3):
            # a frame header refused: the plain decoder words why
            try:
                zstd_decode_plain(chunks[i], outs[i].size)
            except (ValueError, NotImplementedError) as e:
                raise type(e)(f"{e} (chunk {i})") from None
        raise ValueError(f"corrupt {COMPRESSIONS[codec]} data in chunk {i}")
    return done


# ---- pages

def _layout(page: Page):
    """(y, x, rows, cols) of each chunk's pixels on the page, and the
    decoded shape [rows, cols] of each chunk."""
    if page.tile:
        tw, th = page.tile
        places = [(y, x, min(th, page.height - y), min(tw, page.width - x))
                  for y in range(0, page.height, th)
                  for x in range(0, page.width, tw)]
        shapes = [(th, tw)] * len(places)
    else:
        rps = max(1, min(page.rows_per_strip, page.height))
        places = [(y, 0, min(rps, page.height - y), page.width)
                  for y in range(0, page.height, rps)]
        shapes = [(p[2], page.width) for p in places]
    return places, shapes


def _chunk_bytes(path: str, page: Page, n: int) -> List[bytes]:
    if len(page.chunks) < n:
        raise OSError(f"{path}: a TIFF page of {n} strips or tiles lists "
                      f"{len(page.chunks)}")
    out = []
    with open(path, "rb") as f:
        for offset, count in page.chunks[:n]:
            out.append(_read_at(f, offset, count, path))
    return out


def _jpeg_frames(path: str, page: Page, shapes, chunks) -> list:
    """The parsed JPEG frames of ``chunks``, each checked against its
    chunk's decoded shape [rows, cols] and the sampling libtiff takes."""
    nc = page.samples
    frames = []
    want_sub = page.ycbcr_sub
    for (th, tw), data in zip(shapes, chunks):
        f = jpeg.parse_jpeg(data, page.jpeg_tables,
                            transform=page.photometric == 6)
        if (f.width, f.height) != (tw, th) or len(f.h) != nc:
            raise OSError(f"{path}: a JPEG chunk of {f.width} x {f.height} "
                          f"x {len(f.h)} where the page holds {tw} x {th} x "
                          f"{nc}")
        # libtiff's JPEGPreDecode: the first component sampled as the
        # page says (photometric 6: YCbCrSubsampling, else the first
        # stream's), every other 1 x 1
        sub = (1, 1) if page.photometric != 6 else want_sub
        if sub is None:
            sub = want_sub = (f.h[0], f.v[0])
        if (f.h[0], f.v[0]) != sub or any(
                (a, b) != (1, 1) for a, b in zip(f.h[1:], f.v[1:])):
            raise OSError(f"{path}: improper JPEG sampling factors "
                          f"{list(zip(f.h, f.v))} (libtiff expects {sub} "
                          f"then 1 x 1)")
        frames.append(f)
    return frames


def _jpeg_page(path: str, page: Page, places, shapes, chunks,
               plain) -> np.ndarray:
    out = np.empty((page.height, page.width, page.samples), np.uint8)
    jpeg.decode_frames(_jpeg_frames(path, page, shapes, chunks),
                       [out[y:y + rows, x:x + cols]
                        for y, x, rows, cols in places], plain=plain)
    return out


def _unpack_bits(raw: np.ndarray, rows: int, cols: int,
                 bits: int) -> np.ndarray:
    """Samples [rows, cols] (uint8) of ``bits`` bits (1, 2 or 4), packed
    MSB first, each row padded to whole bytes."""
    rowbytes = -(-cols * bits // 8)
    b = np.unpackbits(raw[:rows * rowbytes].reshape(rows, rowbytes),
                      axis=1)[:, :cols * bits]
    if bits == 1:
        return b
    weights = (1 << np.arange(bits - 1, -1, -1)).astype(np.uint8)
    return (b.reshape(rows, cols, bits) * weights).sum(-1, dtype=np.uint8)


def _check_codec_header(path: str, page: Page) -> None:
    if page.compression != NONE and not page.libtiff_header:
        raise OSError(f"{path}: a compressed TIFF page in a file whose "
                      f"header libtiff refuses (PIL decodes compressed "
                      f"pages through libtiff, and raises)")


def _chunk_samples(path: str, page: Page, shapes, chunks, per: int,
                   plain: bool) -> List[np.ndarray]:
    """The samples [rows, cols, per] of each chunk (not JPEG; 1-, 2- and
    4-bit samples unpacked to a byte each; the predictor undone), decoded
    to the chunk's shape [rows, cols]."""
    sizes = [r * -(-c * per * page.bits // 8) for r, c in shapes]
    buf = np.zeros(sum(sizes), np.uint8)
    starts = np.cumsum([0] + sizes[:-1]).tolist()
    outs = [buf[a:a + n] for a, n in zip(starts, sizes)]
    if page.compression == NONE:
        done = []
        for o, data in zip(outs, chunks):
            k = min(len(data), o.size)
            o[:k] = np.frombuffer(data, np.uint8, k)
            done.append(k)
    elif page.compression in (DEFLATE, ADOBE_DEFLATE, LZMA):
        if page.compression == LZMA:
            import lzma  # only LZMA pages need the module

        def inflate(i):
            dec = (zlib.decompressobj() if page.compression != LZMA
                   else lzma.LZMADecompressor())
            raw = dec.decompress(chunks[i], sizes[i])
            outs[i][:len(raw)] = np.frombuffer(raw, np.uint8)
            return len(raw)
        if plain:
            done = [inflate(i) for i in range(len(chunks))]
        else:
            with concurrent.futures.ThreadPoolExecutor(
                    os.cpu_count() or 1) as pool:
                done = list(pool.map(inflate, range(len(chunks))))
    elif plain:
        fn = {LZW: lzw_decode_plain, PACKBITS: packbits_decode_plain,
              ZSTD: zstd_decode_plain}[page.compression]
        done = []
        for o, data in zip(outs, chunks):
            raw = fn(data, o.size)
            o[:len(raw)] = np.frombuffer(raw, np.uint8)
            done.append(len(raw))
    else:
        done = decode_chunks(page.compression, chunks, outs)
    short = [i for i, (d, n) in enumerate(zip(done, sizes)) if d < n]
    if short:
        i = short[0]
        raise OSError(f"{path}: TIFF chunk {i} "
                      f"({COMPRESSIONS[page.compression]}) decodes to "
                      f"{done[i]} of {sizes[i]} bytes")
    arrays = []
    for o, (th, tw) in zip(outs, shapes):
        if page.bits < 8:
            px = _unpack_bits(o, th, tw, page.bits)[..., None]
        else:
            px = o.view(page.dtype).reshape(th, tw, per)
        if page.predictor == 2:
            px = np.cumsum(px.astype(page.dtype.newbyteorder("=")), axis=1,
                           dtype=page.dtype.newbyteorder("="))
        arrays.append(px)
    return arrays


def _pixels(path: str, page: Page, plain: bool):
    """The page's samples [H, W, samples] in its dtype (file order; 1-,
    2- and 4-bit samples unpacked to a byte each)."""
    _check_codec_header(path, page)
    places, shapes = _layout(page)
    item = page.dtype.itemsize
    spp = page.samples
    # a planar page's chunks hold one sample each, plane after plane
    planes, per = (spp, 1) if page.planar == 2 and spp > 1 else (1, spp)
    if page.compression == NONE and not page.tile and planes == 1 and (
            page.bits >= 8):
        n = page.width * page.height * spp
        out = np.empty(n, page.dtype)
        at = 0
        with open(path, "rb") as f:
            for offset, count in page.chunks:
                take = min(count // item, n - at)
                f.seek(offset)
                got = f.readinto(memoryview(out[at:at + take]).cast("B"))
                if got != take * item:
                    raise OSError(f"{path}: truncated TIFF strip at "
                                  f"{offset}")
                at += take
                if at == n:
                    break
        if at != n:
            raise OSError(f"{path}: TIFF strips hold {at} of {n} samples")
        return out.reshape(page.height, page.width, spp)
    chunks = _chunk_bytes(path, page, len(places) * planes)
    if page.compression == JPEG:
        if planes == 1:
            return _jpeg_page(path, page, places, shapes, chunks, plain)
        k = len(places)
        return np.concatenate([_jpeg_page(
            path, page._replace(samples=1), places, shapes,
            chunks[p * k:(p + 1) * k], plain) for p in range(planes)],
            axis=2)
    arrays = _chunk_samples(path, page, shapes * planes, chunks, per, plain)
    out = np.empty((page.height, page.width, spp), page.dtype)
    for i, px in enumerate(arrays):
        y, x, rows, cols = places[i % len(places)]
        plane = slice(None) if planes == 1 else slice(i // len(places),
                                                      i // len(places) + 1)
        out[y:y + rows, x:x + cols, plane] = px[:rows, :cols]
    return out


def tile_grid(page: Page) -> Tuple[int, int]:
    """(tiles across, tiles down) of a tiled page."""
    tw, th = page.tile
    return -(-page.width // tw), -(-page.height // th)


def read_tiles(path: str, page: Page, tiles: Sequence[int],
               outs: Sequence[np.ndarray], plain: bool = False) -> None:
    """Decode the tiles ``tiles`` (indices into the tiled ``page``'s grid,
    row by row) of the file at ``path`` into ``outs``: each a writable
    uint8 RGB array [rows, cols, 3] of the tile as the page holds it
    (cropped at the page's right and bottom edges), the pixels
    ``read_page`` gives there.  The codecs are ``read_page``'s: the JPEG
    tiles of all ``tiles`` in one ``jpeg.decode_frames`` call (C++, one
    thread per hardware thread, straight into ``outs`` for 3-component
    pages), the others as ``read_page`` decodes them; ``plain=True``: the
    plain versions, one tile after another.  A tile whose byte count is 0
    (a missing tile, as a scanner leaves one) reads 0 in every sample."""
    if not page.tile:
        raise ValueError(f"{path}: read_tiles takes a tiled page")
    _check_codec_header(path, page)
    across, down = tile_grid(page)
    k = across * down
    planes, per = ((page.samples, 1) if page.planar == 2
                   and page.samples > 1 else (1, page.samples))
    if len(page.chunks) < k * planes:
        raise OSError(f"{path}: a TIFF page of {k * planes} tiles lists "
                      f"{len(page.chunks)}")
    tw, th = page.tile
    present = []
    for t, o in zip(tiles, outs):
        if not 0 <= t < k:
            raise ValueError(f"{path}: tile {t} of {k}")
        rows, cols = min(th, page.height - t // across * th), min(
            tw, page.width - t % across * tw)
        if o.shape != (rows, cols, 3) or o.dtype != np.uint8:
            raise ValueError(f"{path}: tile {t} is {rows} x {cols} x 3 "
                             f"uint8, its output {o.dtype} {o.shape}")
        if all(page.chunks[t + p * k][1] for p in range(planes)):
            present.append((t, o))
        else:
            o[...] = 0
    if not present:
        return
    chunks = []
    with open(path, "rb") as f:
        for p in range(planes):
            for t, _ in present:
                offset, count = page.chunks[t + p * k]
                chunks.append(_read_at(f, offset, count, path))
    shapes = [(th, tw)] * len(present)
    views = [o for _, o in present]
    if page.compression == JPEG and planes == 1 and page.samples == 3:
        jpeg.decode_frames(_jpeg_frames(path, page, shapes, chunks), views,
                           plain=plain)
        return
    n = len(present)
    if page.compression == JPEG:  # gray streams: of a gray or planar page
        arrays = [np.empty(o.shape[:2] + (1,), np.uint8)
                  for _ in range(planes) for o in views]
        jpeg.decode_frames(_jpeg_frames(path, page._replace(samples=1),
                                        shapes * planes, chunks), arrays,
                           plain=plain)
    else:
        arrays = _chunk_samples(path, page, shapes * planes, chunks, per,
                                plain)
    samples = [np.concatenate(arrays[i::n], axis=2) for i in range(n)]
    for o, px in zip(views, samples):
        o[...] = to_rgb(page, px[:o.shape[0], :o.shape[1]])


def cmyk_to_rgb(cmyk: np.ndarray) -> np.ndarray:
    """uint8 CMYK [..., 4] as PIL's ``convert("RGB")`` maps it
    (Convert.c's cmyk2rgb): each of R, G, B = (255 - K) - C * (255 - K) /
    255, the product rounded by MULDIV255."""
    c = cmyk.astype(np.int32)
    nk = 255 - c[..., 3:]
    t = c[..., :3] * nk + 128
    return (nk - (((t >> 8) + t) >> 8)).astype(np.uint8)


def to_rgb(page: Page, px: np.ndarray) -> np.ndarray:
    """The samples of ``page`` ([H, W, samples], from ``_pixels``) as
    PIL's ``convert("RGB")`` gives them after its unpacker (TiffImagePlugin
    's rawmode): 16-bit RGB by its high byte; alpha dropped, associated
    alpha divided out first (unpackRGBa: 0 where alpha is 0, else each of
    R, G, B * 255 // alpha, at most 255); CMYK by ``cmyk_to_rgb``; palette
    through the ColorMap; bilevel 0 or 255, min-is-white inverted, 8-bit
    min-is-white too; 16-bit gray saturated at 255; gray repeated."""
    mode = page.mode
    if mode in ("RGB", "RGBA"):
        rgb = px[..., :3]
        if page.bits == 16:
            return (rgb >> 8).astype(np.uint8)
        if page.extra == (1,):
            a = px[..., 3:4].astype(np.int32)
            div = rgb.astype(np.int32) * 255 // np.maximum(a, 1)
            rgb = np.where(a == 0, 0, np.where(a == 255, rgb, np.minimum(
                div, 255))).astype(np.uint8)
        return np.ascontiguousarray(rgb)
    if mode == "CMYK":
        return cmyk_to_rgb(px)
    if mode == "P":
        return page.colormap[px[..., 0]]
    gray = px[..., 0]
    if mode == "I;16":
        gray = np.minimum(gray, 255).astype(np.uint8)
    elif mode == "1":
        gray = np.where(gray != (page.photometric == 0), 255, 0).astype(
            np.uint8)
    elif page.photometric == 0:
        gray = 255 - gray
    return np.repeat(gray[..., None], 3, axis=2)


def read_page(path: str, page: Page, plain: bool = False) -> np.ndarray:
    """uint8 RGB [H, W, 3] of ``page`` of the file at ``path`` (see
    ``to_rgb``).  LZW, PackBits, ZSTD and JPEG decode in C++ (one thread
    per hardware thread), or with ``plain=True`` in their plain versions."""
    return to_rgb(page, _pixels(path, page, plain))


def write_tiff(path: str, pages: Sequence[np.ndarray]) -> str:
    """Write uint8 RGB arrays [H, W, 3] as the pages of an uncompressed
    little-endian TIFF at ``path`` (classic TIFF: under 4 GiB)."""
    pages = [np.ascontiguousarray(p) for p in pages]
    for p in pages:
        if p.dtype != np.uint8 or p.ndim != 3 or p.shape[2] != 3:
            raise ValueError(f"write_tiff takes uint8 [H, W, 3] pages, got "
                             f"{p.dtype} {p.shape}")
    n_tags = 10
    ifd_size = 2 + 12 * n_tags + 4 + 6  # and BitsPerSample's three shorts
    total = 8 + sum(p.nbytes + ifd_size for p in pages)
    if total >= 1 << 32:
        raise ValueError(f"{path}: {total} bytes do not fit a classic TIFF")
    with open(path, "wb") as f:
        f.write(b"II*\0" + struct.pack("<I", 8 + pages[0].nbytes))
        at = 8
        for i, p in enumerate(pages):
            h, w = p.shape[:2]
            data_at, ifd_at = at, at + p.nbytes
            nxt = ifd_at + ifd_size if i + 1 < len(pages) else 0
            bits_at = ifd_at + 2 + 12 * n_tags + 4
            # when there is a next page, its pixels come right after this
            # IFD; the chain points at that page's IFD
            if nxt:
                nxt += pages[i + 1].nbytes
            f.write(memoryview(p).cast("B"))
            entries = [(_WIDTH, 4, 1, w), (_LENGTH, 4, 1, h),
                       (_BITS, 3, 3, bits_at), (_COMPRESSION, 3, 1, 1),
                       (_PHOTOMETRIC, 3, 1, 2), (_STRIP_OFFSETS, 4, 1,
                                                 data_at),
                       (_SAMPLES, 3, 1, 3), (_ROWS_PER_STRIP, 4, 1, h),
                       (_STRIP_BYTES, 4, 1, p.nbytes), (_PLANAR, 3, 1, 1)]
            ifd = struct.pack("<H", n_tags)
            for tag, typ, count, value in entries:
                packed = (struct.pack("<HH", value, 0) if typ == 3
                          and count == 1 else struct.pack("<I", value))
                ifd += struct.pack("<HHI", tag, typ, count) + packed
            ifd += struct.pack("<I", nxt) + struct.pack("<HHH", 8, 8, 8)
            f.write(ifd)
            at = ifd_at + ifd_size
    return path
