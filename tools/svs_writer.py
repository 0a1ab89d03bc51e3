"""Write Aperio ``.svs`` slides, and their twins, for tests: the test coder
of the slides that ``tests/test_torch_svs.py`` and ``chip_smoke.py`` hold
the port's Aperio reader (``utils/aperio.py``, ``data/wsi.py``'s
``OpenSlideBackend``) to.  No real ``.svs`` is in the repository.

An Aperio slide is a classic little-endian TIFF whose pages are, in file
order, as Aperio's scanners write them and openslide's Aperio code
reads them:

- level 0: tiled (240 x 240, Aperio's tile) JPEG, the tables of its tiles
  in ``JPEGTables`` (tag 347), NewSubfileType 0 and the slide's
  ``ImageDescription``: ``Aperio Image Library ...``, then ``|key =
  value`` fields (AppMag 20, MPP 0.4990);
- the thumbnail: one JPEG strip;
- the reduced levels: tiled like level 0, NewSubfileType 1;
- the label (LZW strips, NewSubfileType 1) and the macro (one JPEG strip,
  NewSubfileType 9), each named by the first word of its description's
  second line.

Every JPEG stream comes from the ``encode`` function the caller gives
(rgb uint8 [H, W, 3] -> a JPEG file's bytes: PIL's encoder in the tests,
the port's ``utils/jpeg.encode_jpeg`` on the card), the label's LZW strip
from ``lzw`` (rgb -> the bytes of one TIFF LZW strip).  Photometric 6
(YCbCr: the streams' subsampling written in ``YCbCrSubsampling``) or 2
(RGB, which
libtiff decodes without a colour transform whatever the stream codes, so
its streams must be 4:4:4).  ``missing`` names tiles written with
offset and byte count 0, as a scanner leaves a tile it skipped.

``write_twin`` writes the same levels' tile bytes as a plain tiled TIFF:
no associated pages, no description, no NewSubfileType.  ``write_ifd``
and ``split_tables`` are also ``chip_smoke.py``'s IFD and JPEGTables
writers.

Loaded by file path (``importlib.util.spec_from_file_location``); the
package never imports it.
"""
import concurrent.futures
import multiprocessing
import os
import struct
from typing import Callable, Iterable, List, NamedTuple, Optional, Tuple

import numpy as np

TILE = 240
FIRST_LINE = "Aperio Image Library v12.0.15"
# the environment of the encoding workers: one BLAS thread each (a BLAS
# pool in every worker, on matrices of one tile, costs more than it gives)
_WORKER_ENV = {"OPENBLAS_NUM_THREADS": "1", "OMP_NUM_THREADS": "1",
               "MKL_NUM_THREADS": "1"}


class Level(NamedTuple):
    width: int
    height: int
    tiles: List[bytes]  # JPEG files, row-major, each ``TILE`` x ``TILE``


def split_tables(stream: bytes) -> Tuple[bytes, bytes]:
    """(JPEGTables: SOI, the DQT and DHT segments, EOI; the stream without
    them)."""
    tables, rest, pos = [b"\xff\xd8"], [b"\xff\xd8"], 2
    while True:
        marker = stream[pos + 1]
        (n,) = struct.unpack_from(">H", stream, pos + 2)
        if marker == 0xDA:
            rest.append(stream[pos:])
            break
        (tables if marker in (0xDB, 0xC4) else rest).append(
            stream[pos:pos + 2 + n])
        pos += 2 + n
    return b"".join(tables) + b"\xff\xd9", b"".join(rest)


def _sampling(stream: bytes) -> Tuple[int, int]:
    """(h, v) sampling of the first component of a JPEG's frame."""
    pos = 2
    while True:
        marker = stream[pos + 1]
        (n,) = struct.unpack_from(">H", stream, pos + 2)
        if 0xC0 <= marker <= 0xCF and marker not in (0xC4, 0xC8, 0xCC):
            b = stream[pos + 11]
            return b >> 4, b & 15
        pos += 2 + n


def write_ifd(f, entries, link: int) -> int:
    """Append to the little-endian TIFF ``f`` one IFD of ``entries``
    ((tag, field type 2, 3, 4 or 7, values; type 2 a ``str``)) at the next
    even offset, point the link at offset ``link`` to it, and return the
    offset of its own link to a next IFD."""
    entries = sorted(entries)
    ifd = f.tell() + f.tell() % 2
    f.write(b"\0" * (ifd - f.tell()))
    extra = ifd + 2 + 12 * len(entries) + 4
    body, blobs = struct.pack("<H", len(entries)), b""
    for tag, typ, vals in entries:
        if typ == 2:
            raw = vals.encode() + b"\0"
            count = len(raw)
        else:
            raw = struct.pack(f"<{len(vals)}{'HIB'[(3, 4, 7).index(typ)]}",
                              *vals)
            count = len(vals)
        if len(raw) <= 4:
            field = raw.ljust(4, b"\0")
        else:
            field = struct.pack("<I", extra + len(blobs))
            blobs += raw + b"\0" * (len(raw) % 2)
        body += struct.pack("<HHI", tag, typ, count) + field
    f.write(body + b"\0\0\0\0" + blobs)
    end = f.tell()
    f.seek(link)
    f.write(struct.pack("<I", ifd))
    f.seek(end)
    return ifd + 2 + 12 * len(entries)


def _tile_images(level: np.ndarray) -> Iterable[np.ndarray]:
    """The tiles of ``level``, row-major, the edge ones filled out by
    repeating the last row and column."""
    h, w = level.shape[:2]
    for y in range(0, h, TILE):
        for x in range(0, w, TILE):
            t = level[y:y + TILE, x:x + TILE]
            if t.shape[:2] != (TILE, TILE):
                t = np.pad(t, ((0, TILE - t.shape[0]),
                               (0, TILE - t.shape[1]), (0, 0)), mode="edge")
            yield np.ascontiguousarray(t)


def encode_levels(levels, encode: Callable,
                  processes: int = 0) -> List[Level]:
    """Each of ``levels`` (uint8 RGB) cut into tiles, each coded by
    ``encode``: in this process, or in one pool of ``processes`` spawned
    workers (``encode`` must then be a module's function, which they
    import)."""
    def coded(tiles):
        out, at = [], 0
        for lv in levels:
            n = -(-lv.shape[0] // TILE) * -(-lv.shape[1] // TILE)
            out.append(Level(lv.shape[1], lv.shape[0], tiles[at:at + n]))
            at += n
        return out

    every = (t for lv in levels for t in _tile_images(lv))
    if not processes:
        return coded([encode(t) for t in every])
    saved = {k: os.environ.get(k) for k in _WORKER_ENV}
    os.environ.update(_WORKER_ENV)
    try:
        with concurrent.futures.ProcessPoolExecutor(
                processes, mp_context=multiprocessing.get_context(
                    "spawn")) as pool:
            return coded(list(pool.map(encode, every, chunksize=32)))
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _description(width: int, height: int) -> str:
    """Level 0's ImageDescription as Aperio writes it: the library's line,
    the image line, then the ``|key = value`` fields of a 20x scan."""
    return (f"{FIRST_LINE} \r\n{width}x{height} [0,0 {width}x{height}] "
            f"({TILE}x{TILE}) JPEG/RGB Q=70|AppMag = 20|MPP = 0.4990")


def _write(path: str, pages) -> str:
    """``pages``: (entries without the chunk tags, chunks, tiled)."""
    with open(path, "wb") as f:
        f.write(b"II*\0\0\0\0\0")
        link = 4
        for entries, chunks, tiled in pages:
            offsets, counts = [], []
            for c in chunks:
                if c is None:  # a missing tile
                    offsets.append(0)
                    counts.append(0)
                    continue
                f.write(b"\0" * (f.tell() % 2))
                offsets.append(f.tell())
                counts.append(len(c))
                f.write(c)
            tags = ((324, 325) if tiled else (273, 279))
            link = write_ifd(f, entries + [(tags[0], 4, offsets),
                                           (tags[1], 4, counts)], link)
    return path


def _level_pages(levels, photometric, missing=(), kinds=None):
    """The tiled pages of ``levels``: their tables split out."""
    pages = []
    for k, lv in enumerate(levels):
        split = [split_tables(t) for t in lv.tiles]
        tables = split[0][0]
        if any(t != tables for t, _ in split):
            raise ValueError(f"level {k}: tiles coded with other tables")
        sampling = _sampling(lv.tiles[0])
        if photometric == 2 and sampling != (1, 1):
            raise ValueError(f"photometric 2 takes 4:4:4 streams, level {k}"
                             f" has {sampling}")
        chunks = [None if (k, i) in missing else s
                  for i, (_, s) in enumerate(split)]
        entries = [(256, 4, [lv.width]), (257, 4, [lv.height]),
                   (258, 3, [8, 8, 8]), (259, 3, [7]),
                   (262, 3, [photometric]), (277, 3, [3]), (284, 3, [1]),
                   (322, 4, [TILE]), (323, 4, [TILE]),
                   (347, 7, list(tables))]
        if photometric == 6:
            entries.append((530, 3, list(sampling)))
        if kinds is not None:
            entries += [(254, 4, [kinds[k][0]]), (270, 2, kinds[k][1])]
        pages.append((entries, chunks, True))
    return pages


def _strip_page(rgb: np.ndarray, data: bytes, compression: int,
                photometric: int, subfile: int, desc: str):
    h, w = rgb.shape[:2]
    entries = [(254, 4, [subfile]), (256, 4, [w]), (257, 4, [h]),
               (258, 3, [8, 8, 8]), (259, 3, [compression]),
               (262, 3, [photometric]), (270, 2, desc), (277, 3, [3]),
               (278, 4, [h]), (284, 3, [1])]
    if compression == 7 and photometric == 6:
        entries.append((530, 3, list(_sampling(data))))
    return entries, [data], False


def write_svs(path: str, levels: List[Level], encode: Callable,
              photometric: int = 6,
              thumbnail: Optional[np.ndarray] = None,
              label: Optional[np.ndarray] = None, lzw: Callable = None,
              macro: Optional[np.ndarray] = None, missing=()) -> str:
    """The Aperio slide of ``levels`` (``encode_levels``', level 0 first)
    at ``path``: level 0 with the description of a 20x scan, the
    ``thumbnail``, the other levels, the ``label`` (LZW by ``lzw``) and the
    ``macro`` (each a uint8 RGB array, left out when None); the tiles
    ``missing`` ((level, tile index) pairs) written with byte count 0."""
    w0, h0 = levels[0].width, levels[0].height
    kinds = [(0, _description(w0, h0))] + [
        (1, f"{FIRST_LINE} \r\n{w0}x{h0} [0,0 {w0}x{h0}] ({TILE}x{TILE}) -> "
            f"{lv.width}x{lv.height} JPEG/RGB Q=70") for lv in levels[1:]]
    tiled = _level_pages(levels, photometric, set(missing), kinds)
    pages = tiled[:1]
    if thumbnail is not None:
        pages.append(_strip_page(
            thumbnail, encode(thumbnail), 7, photometric, 0,
            f"{FIRST_LINE} \r\n{w0}x{h0} -> {thumbnail.shape[1]}x"
            f"{thumbnail.shape[0]} - "))
    pages += tiled[1:]
    if label is not None:
        pages.append(_strip_page(
            label, lzw(np.ascontiguousarray(label)), 5, 2, 1,
            f"{FIRST_LINE}\nlabel {label.shape[1]}x{label.shape[0]}"))
    if macro is not None:
        pages.append(_strip_page(
            macro, encode(macro), 7, photometric, 9,
            f"{FIRST_LINE}\nmacro {macro.shape[1]}x{macro.shape[0]}"))
    return _write(path, pages)


def write_twin(path: str, levels: List[Level]) -> str:
    """``levels``' tile bytes (YCbCr streams) as a plain tiled TIFF at
    ``path``: photometric 6, no associated pages, no description, no
    NewSubfileType."""
    return _write(path, _level_pages(levels, 6))
