"""A reader and a writer of baseline uncompressed TIFF files, in numpy and
the standard library: the port's stand-in for PIL under the WSI slide
reader (the machine with the card has no PIL).

The reader takes little- and big-endian files, every page of the IFD
chain, image data in strips, and 8-bit RGB, 8-bit grayscale or 16-bit
grayscale pages (``PhotometricInterpretation`` 1 or 2, chunky planar
configuration).  ``read_page`` returns uint8 RGB as PIL's
``convert("RGB")`` does: grayscale repeated, 16-bit values saturated at
255.  ``read_pages`` reads only the page headers (sizes and the mode PIL
would decode each page in), so a caller can budget the decode first.
Compression other than 1, tiles and any other layout raise
``NotImplementedError`` naming the file and the tag.

The writer (``write_tiff``) writes uint8 RGB pages [H, W, 3],
uncompressed, one strip a page, little-endian, as PIL writes a
multi-page TIFF (``save_all``).
"""
from __future__ import annotations

import struct
from typing import List, NamedTuple, Sequence

import numpy as np

# tags
_WIDTH, _LENGTH, _BITS, _COMPRESSION, _PHOTOMETRIC = 256, 257, 258, 259, 262
_STRIP_OFFSETS, _SAMPLES, _ROWS_PER_STRIP, _STRIP_BYTES = 273, 277, 278, 279
_PLANAR, _TILE_WIDTH, _TILE_OFFSETS = 284, 322, 324
# field type -> (struct code, size)
_TYPES = {1: ("B", 1), 2: ("c", 1), 3: ("H", 2), 4: ("I", 4), 6: ("b", 1),
          7: ("B", 1), 8: ("h", 2), 9: ("i", 4), 16: ("Q", 8)}


class Page(NamedTuple):
    width: int
    height: int
    mode: str                   # the mode PIL decodes the page in
    dtype: np.dtype             # of one sample
    samples: int
    strips: List[tuple]         # (offset, byte count)


def _read_at(f, pos: int, n: int, path: str) -> bytes:
    f.seek(pos)
    data = f.read(n)
    if len(data) != n:
        raise OSError(f"{path}: truncated TIFF file (wanted {n} bytes at "
                      f"{pos})")
    return data


def _fields(f, order: str, at: int, path: str):
    """The tags of the IFD at ``at`` (tag -> tuple of values, None for a
    field type of no use here) and the offset of the next IFD."""
    (n,) = struct.unpack(order + "H", _read_at(f, at, 2, path))
    block = _read_at(f, at + 2, 12 * n + 4, path)
    tags = {}
    for i in range(n):
        tag, typ, count = struct.unpack_from(order + "HHI", block, 12 * i)
        if typ not in _TYPES:
            tags[tag] = None  # rationals and the like
            continue
        code, size = _TYPES[typ]
        if count * size <= 4:
            raw = block[12 * i + 8:12 * i + 8 + count * size]
        else:
            (pos,) = struct.unpack_from(order + "I", block, 12 * i + 8)
            raw = _read_at(f, pos, count * size, path)
        tags[tag] = struct.unpack(f"{order}{count}{code}", raw)
    (nxt,) = struct.unpack_from(order + "I", block, 12 * n)
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

    if _TILE_WIDTH in tags or _TILE_OFFSETS in tags:
        raise NotImplementedError(f"{path}: a tiled TIFF page (tag "
                                  f"{_TILE_WIDTH}); the port reads strips")
    compression = one(_COMPRESSION, 1)
    if compression != 1:
        raise NotImplementedError(f"{path}: TIFF Compression (tag "
                                  f"{_COMPRESSION}) = {compression}; the "
                                  f"port reads uncompressed pages only")
    if one(_PLANAR, 1) != 1:
        raise NotImplementedError(f"{path}: TIFF PlanarConfiguration (tag "
                                  f"{_PLANAR}) = 2; the port reads chunky "
                                  f"pages")
    samples = one(_SAMPLES, 1)
    bits = tags.get(_BITS) or (1,)
    photometric = one(_PHOTOMETRIC)
    if photometric == 2 and samples == 3 and set(bits) == {8}:
        mode, dtype = "RGB", np.dtype("u1")
    elif photometric == 1 and samples == 1 and bits[0] in (8, 16):
        mode, dtype = ("L", np.dtype("u1")) if bits[0] == 8 else (
            "I;16", np.dtype("u2"))
    else:
        raise NotImplementedError(
            f"{path}: TIFF page with PhotometricInterpretation (tag "
            f"{_PHOTOMETRIC}) {photometric}, SamplesPerPixel (tag "
            f"{_SAMPLES}) {samples}, BitsPerSample (tag {_BITS}) "
            f"{tuple(bits)}; the port reads 8-bit RGB and 8- or 16-bit "
            f"grayscale")
    offsets = tags.get(_STRIP_OFFSETS)
    counts = tags.get(_STRIP_BYTES)
    if not offsets or not counts or len(offsets) != len(counts):
        raise NotImplementedError(f"{path}: TIFF page without StripOffsets "
                                  f"(tag {_STRIP_OFFSETS}) and "
                                  f"StripByteCounts (tag {_STRIP_BYTES})")
    return Page(one(_WIDTH), one(_LENGTH), mode, dtype, samples,
                list(zip(offsets, counts)))


def _header(path: str):
    with open(path, "rb") as f:
        head = f.read(8)
    if head[:4] == b"II*\0":
        order = "<"
    elif head[:4] == b"MM\0*":
        order = ">"
    else:
        raise ValueError(f"{path}: not a TIFF file")
    return order, struct.unpack(order + "I", head[4:8])[0]


def read_pages(path: str) -> List[Page]:
    """The pages of the TIFF at ``path``, from their headers only."""
    order, at = _header(path)
    pages, seen = [], set()
    with open(path, "rb") as f:
        while at:
            if at in seen:
                raise OSError(f"{path}: a loop in the IFD chain at {at}")
            seen.add(at)
            tags, at = _fields(f, order, at, path)
            page = _page(tags, path)
            pages.append(page._replace(dtype=page.dtype.newbyteorder(order)))
    return pages


def read_page(path: str, page: Page) -> np.ndarray:
    """uint8 RGB [H, W, 3] of ``page`` of the file at ``path``."""
    n = page.width * page.height * page.samples
    out = np.empty(n, page.dtype)
    at = 0
    with open(path, "rb") as f:
        for offset, count in page.strips:
            take = min(count // page.dtype.itemsize, n - at)
            f.seek(offset)
            got = f.readinto(memoryview(out[at:at + take]).cast("B"))
            if got != take * page.dtype.itemsize:
                raise OSError(f"{path}: truncated TIFF strip at {offset}")
            at += take
            if at == n:
                break
    if at != n:
        raise OSError(f"{path}: TIFF strips hold {at} of {n} samples")
    if page.mode == "RGB":
        return out.reshape(page.height, page.width, 3)
    gray = out.reshape(page.height, page.width)
    if page.mode == "I;16":
        gray = np.minimum(gray, 255).astype(np.uint8)
    return np.repeat(gray[..., None], 3, axis=2)


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
