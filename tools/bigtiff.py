"""Re-pack a classic TIFF as BigTIFF, keeping every strip's or tile's
bytes: the test coder of the BigTIFF slides that ``tests/`` and
``chip_smoke.py`` hold the port's reader (``utils/tiff.py``) to.  PIL
writes only uncompressed BigTIFF (its libtiff route ignores
``big_tiff=True``), so the compressed ones are made here from classic
files written by PIL, by the tests' IFD writers, by
``tools/zstd_writer.py`` or by ``utils/tiff.write_tiff``.

``repack(src, dst, ...)`` reads the main IFD chain of the classic TIFF
``src`` (either byte order) and writes ``dst`` as BigTIFF: the header
``II+\\0`` (``order="<"``) or ``MM\\0+`` (``order=">"``), offset size 8,
an 8-byte first-IFD offset; each IFD an 8-byte entry count, 20-byte
entries (tag, type, 8-byte count, then the value when it fits in 8
bytes, else its offset) and an 8-byte link to the next.  Every tag keeps
its type and values, written in ``order``; the strip or tile offsets and
byte counts take ``offset_type`` (16, LONG8, by default; 4, LONG, or 3,
SHORT, where they fit).  Tags that point into ``src`` (SubIFDs, the Exif,
GPS and Interoperability IFDs, FreeOffsets and FreeByteCounts) are
dropped.  What it writes beyond that:

- ``order=">"``: 8-bit chunks are copied as they are (their bytes do not
  depend on the byte order); uncompressed 16-bit samples are swapped; a
  compressed page of wider samples raises, since its decoded bytes
  follow the file's order;
- ``gap=k``: page ``k``'s chunks go past ``GAP_AT`` (4 GiB and 4 KiB),
  behind a hole made with ``seek``, so the file is sparse where the
  filesystem allows; the IFDs stay before the hole, or with
  ``ifds_past_gap`` follow the chunks (where PIL 12.1.0 decodes a
  compressed page to zeros: it hands libtiff the IFD's offset in 32
  bits);
- ``subifds={p: [k, ...]}``: pages ``k`` leave the main chain and become
  the SubIFDs (tag 330, type ``subifd_type``: 18, IFD8, or 16) of page
  ``p``, with NewSubfileType 1 (reduced resolution), as bfconvert writes
  a pyramid's reduced levels.

PIL 12.1.0 reads only the little-endian output: it takes a header's
third byte 43 for BigTIFF, which ``MM\\0+`` does not have, and parses
that file as classic TIFF.

Loaded by file path (``importlib.util.spec_from_file_location``) or run
as a script; the package never imports it:

    python tools/bigtiff.py IN.tiff OUT.btf [--order '>'] [--gap K]
        [--ifds_past_gap] [--subifds P:K,K...] [--offset_type 3|4|16]
"""
import argparse
import struct
import sys
from typing import Dict, List, Optional, Sequence

import numpy as np

GAP_AT = (1 << 32) + 4096
# field type -> (struct code of one value, values a field holds)
_CODES = {1: ("B", 1), 2: ("B", 1), 3: ("H", 1), 4: ("I", 1),
          5: ("I", 2), 6: ("b", 1), 7: ("B", 1), 8: ("h", 1), 9: ("i", 1),
          10: ("i", 2), 11: ("f", 1), 12: ("d", 1), 13: ("I", 1),
          16: ("Q", 1), 17: ("q", 1), 18: ("Q", 1)}
_DROPPED = (288, 289, 330, 34665, 34853, 40965)
_CHUNK_TAGS = ((273, 279), (324, 325))  # (offsets, byte counts)


def _read_classic(data: bytes):
    """(byte order, [{tag: (type, values)} of each page of the main
    chain]) of a classic TIFF."""
    order = {b"II*\0": "<", b"MM\0*": ">"}.get(data[:4])
    if order is None:
        raise ValueError(f"not a classic TIFF (header {data[:4]!r})")
    (at,) = struct.unpack_from(order + "I", data, 4)
    pages, seen = [], set()
    while at:
        if at in seen:
            raise ValueError(f"a loop in the IFD chain at {at}")
        seen.add(at)
        (n,) = struct.unpack_from(order + "H", data, at)
        tags = {}
        for i in range(n):
            e = at + 2 + 12 * i
            tag, typ, count = struct.unpack_from(order + "HHI", data, e)
            if typ not in _CODES:
                raise ValueError(f"tag {tag}: field type {typ}")
            code, per = _CODES[typ]
            size = struct.calcsize(code) * per * count
            if size > 4:
                (e,) = struct.unpack_from(order + "I", data, e + 8)
            else:
                e += 8
            tags[tag] = (typ, struct.unpack_from(
                f"{order}{per * count}{code}", data, e))
        pages.append(tags)
        (at,) = struct.unpack_from(order + "I", data, at + 2 + 12 * n)
    return order, pages


def _chunks(tags) -> Optional[tuple]:
    for off, cnt in _CHUNK_TAGS:
        if off in tags:
            return off, cnt
    return None


def _swap16(tags) -> bool:
    """Whether the page's chunk bytes change with the byte order."""
    bits = max(tags.get(258, (3, (1,)))[1])
    if bits <= 8:
        return False
    if tags.get(259, (3, (1,)))[1][0] != 1 or bits != 16:
        raise ValueError(f"a compressed or {bits}-bit page cannot change "
                         f"its byte order without being coded again")
    return True


def _ifd(order: str, tags, at: int, link: int) -> bytes:
    """The bytes of one BigTIFF IFD written at ``at``: its entries, the
    link ``link`` to the next IFD, then the values that do not fit in 8
    bytes."""
    entries = sorted(tags.items())
    extra = at + 8 + 20 * len(entries) + 8
    body, blobs = struct.pack(order + "Q", len(entries)), b""
    for tag, (typ, vals) in entries:
        code, per = _CODES[typ]
        raw = struct.pack(f"{order}{len(vals)}{code}", *vals)
        if len(raw) <= 8:
            field = raw.ljust(8, b"\0")
        else:
            field = struct.pack(order + "Q", extra + len(blobs))
            blobs += raw + b"\0" * (-len(raw) % 8)
        body += struct.pack(order + "HHQ", tag, typ, len(vals) // per) + field
    return body + struct.pack(order + "Q", link) + blobs


def repack(src: str, dst: str, order: str = "<", gap: Optional[int] = None,
           subifds: Optional[Dict[int, Sequence[int]]] = None,
           offset_type: int = 16, subifd_type: int = 18,
           ifds_past_gap: bool = False) -> str:
    """Write the classic TIFF ``src`` as the BigTIFF ``dst`` (see the
    module's docstring); returns ``dst``."""
    if order not in ("<", ">"):
        raise ValueError(f"order {order!r}: '<' or '>'")
    if offset_type not in (3, 4, 16) or subifd_type not in (16, 18):
        raise ValueError(f"offset type {offset_type}, SubIFDs type "
                         f"{subifd_type}")
    with open(src, "rb") as f:
        data = f.read()
    src_order, pages = _read_classic(data)
    subifds = {p: list(ks) for p, ks in (subifds or {}).items()}
    moved = [k for ks in subifds.values() for k in ks]
    if len(set(moved)) != len(moved) or any(
            not 0 <= k < len(pages) for k in moved + list(subifds)) or set(
            moved) & set(subifds):
        raise ValueError(f"SubIFDs {subifds} of {len(pages)} pages")
    chunks = []  # each page's chunk bytes, in ``order``
    for k, tags in enumerate(pages):
        tags = {t: v for t, v in tags.items() if t not in _DROPPED}
        if _chunks(tags) is None:
            raise ValueError(f"page {k} has no strips or tiles")
        off, cnt = _chunks(tags)
        swap = order != src_order and _swap16(tags)
        chunks.append([
            np.frombuffer(data[o:o + n], src_order + "u2").astype(
                order + "u2").tobytes() if swap else data[o:o + n]
            for o, n in zip(tags[off][1], tags[cnt][1])])
        if k in moved:
            tags[254] = (4, (1,))
        pages[k] = tags
    chain = [k for k in range(len(pages)) if k not in moved]
    place = [k for p in chain for k in [p] + subifds.get(p, [])]

    def ifd_tags(k, offsets, where):
        tags = dict(pages[k])
        off, cnt = _chunks(tags)
        tags[off] = (offset_type, tuple(offsets))
        tags[cnt] = (offset_type, tuple(len(c) for c in chunks[k]))
        if k in subifds:
            tags[330] = (subifd_type, tuple(where.get(s, 0)
                                            for s in subifds[k]))
        return tags

    # where each chunk and IFD goes: the pages' chunks in order, the gap
    # page's past GAP_AT, the IFDs before them (or after, past 4 GiB)
    pos, chunk_at, where = 16, {}, {}

    def place_chunks(pages_):
        nonlocal pos
        for k in pages_:
            chunk_at[k] = []
            for c in chunks[k]:
                pos += pos % 2
                chunk_at[k].append(pos)
                pos += len(c)

    def place_ifds():
        nonlocal pos
        for k in place:
            pos += -pos % 8
            where[k] = pos
            pos += len(_ifd(order, ifd_tags(k, [0] * len(chunks[k]), {}),
                            0, 0))

    limit = {3: 0xFFFF, 4: 0xFFFFFFFF, 16: (1 << 64) - 1}[offset_type]
    if any(len(c) > limit for cs in chunks for c in cs):
        raise ValueError(f"a chunk's byte count needs a wider type than "
                         f"{offset_type}")
    place_chunks([k for k in range(len(pages)) if k != gap])
    if not ifds_past_gap:
        place_ifds()
    if gap is not None:
        pos = max(GAP_AT, pos)
        place_chunks([gap])
    if ifds_past_gap:
        place_ifds()
    if any(max(at) > limit for at in chunk_at.values()):
        raise ValueError(f"the chunks' offsets need a wider type than "
                         f"{offset_type}")
    with open(dst, "wb") as f:
        f.write((b"II+\0" if order == "<" else b"MM\0+")
                + struct.pack(order + "HHQ", 8, 0, where[chain[0]]))
        for k in sorted(chunk_at, key=lambda k: chunk_at[k][:1]):
            for at, c in zip(chunk_at[k], chunks[k]):
                f.seek(at)
                f.write(c)
        for k in place:
            nxt = chain.index(k) + 1 if k in chain else len(chain)
            f.seek(where[k])
            f.write(_ifd(order, ifd_tags(k, chunk_at[k], where), where[k],
                         where[chain[nxt]] if nxt < len(chain) else 0))
    return dst


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("src", help="a classic TIFF")
    ap.add_argument("dst")
    ap.add_argument("--order", default="<", choices=("<", ">"))
    ap.add_argument("--gap", type=int, default=None,
                    help="the page whose chunks go past 4 GiB")
    ap.add_argument("--subifds", default="",
                    help="PARENT:PAGE,PAGE... (pages made SubIFDs)")
    ap.add_argument("--offset_type", type=int, default=16,
                    choices=(3, 4, 16))
    ap.add_argument("--ifds_past_gap", action="store_true")
    a = ap.parse_args(argv)
    subifds = {}
    if a.subifds:
        parent, kids = a.subifds.split(":")
        subifds[int(parent)] = [int(k) for k in kids.split(",")]
    repack(a.src, a.dst, a.order, a.gap, subifds, a.offset_type,
           ifds_past_gap=a.ifds_past_gap)
    return 0


if __name__ == "__main__":
    sys.exit(main())
