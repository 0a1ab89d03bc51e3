"""The version-2 metadata structures of an HDF5 file (File Format
Specification version 3.0), read for ``data/hdf5.py``: what h5py writes
with ``libver`` "v108" and later, with ``track_order``, and for groups or
attribute lists of more than 8 members.

- ``checked``: a block read whole, its signature and its Jenkins lookup3
  checksum verified;
- ``BTree2``: a version-2 B-tree (``BTHD``, ``BTIN``, ``BTLF``) of any
  depth: every record in key order, or the one record a comparison
  finds, descending as HDF5 does;
- ``FractalHeap``: a fractal heap (``FRHP``; the root a direct block
  ``FHDB`` or an indirect block ``FHIB`` over the doubling table): the
  managed object a heap ID names;
- ``fixed_array`` and ``extensible_array``: the chunk indexes of the data
  layout message version 4 (``FAHD``, ``FADB`` and its pages; ``EAHD``,
  ``EAIB``, ``EASB``, ``EADB`` and their pages): every element.

Each takes the ``hdf5.File`` whose bytes it reads (``_bytes``, the
offset and length sizes ``_so`` and ``_sl``, ``_undefined``, ``path``).
A block whose signature or checksum does not hold raises ``CorruptBlock``
(an ``OSError``); a structure the port does not take (huge or tiny heap
objects, a filtered heap) raises ``NotImplementedError`` naming it.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

from multimodalfusion_tpu_torch.utils.lookup3 import hashlittle


class CorruptBlock(OSError):
    """A version-2 metadata block whose signature or checksum does not
    hold: HDF5 refuses to load it."""


def checked(f, addr: int, size: int, sig: bytes, skip: int = -1,
            what: str = "") -> bytes:
    """The ``size`` bytes of the block at ``addr``: they start with
    ``sig`` and end with the lookup3 checksum of the rest.  With ``skip``,
    the checksum sits at that offset instead and is computed over the
    whole block with its four bytes zeroed (a fractal heap's direct
    block).  ``what`` names the block in errors (default: its
    signature)."""
    what = what or sig.decode()
    try:
        raw = f._bytes(addr, size)
    except OSError as e:
        raise CorruptBlock(f"{f.path}: the {what} at {addr} runs past the "
                           f"end of the file") from e
    if raw[:4] != sig:
        raise CorruptBlock(f"{f.path}: no {what} at {addr}")
    if skip < 0:
        body, stored = raw[:-4], raw[-4:]
    else:
        body = raw[:skip] + b"\0\0\0\0" + raw[skip + 4:]
        stored = raw[skip:skip + 4]
    if hashlittle(body) != int.from_bytes(stored, "little"):
        raise CorruptBlock(f"{f.path}: the checksum of the {what} at "
                           f"{addr} does not hold (incorrect metadata "
                           f"checksum)")
    return raw


def _uint(raw: bytes, pos: int, n: int) -> int:
    return int.from_bytes(raw[pos:pos + n], "little")


def _enc_size(n: int) -> int:
    """Bytes HDF5 gives a count of at most ``n`` (H5VM_limit_enc_size)."""
    return (max(n, 1).bit_length() - 1) // 8 + 1


def _version(f, raw: bytes, addr: int, want: int = 0) -> None:
    if raw[4] != want:
        raise CorruptBlock(f"{f.path}: {raw[:4].decode()} block of version "
                           f"{raw[4]} at {addr}")


class BTree2:
    """The version-2 B-tree whose header is at ``addr``; its records are
    raw bytes of ``record_size`` each."""

    def __init__(self, f, addr: int, types: Tuple[int, ...]):
        so, sl = f._so, f._sl
        raw = checked(f, addr, 4 + 1 + 1 + 4 + 2 + 2 + 1 + 1 + so + 2 + sl + 4,
                      b"BTHD")
        _version(f, raw, addr)
        self.f, self.type = f, raw[5]
        if self.type not in types:
            raise CorruptBlock(f"{f.path}: version-2 B-tree of type "
                               f"{self.type} at {addr}, expected {types}")
        self.node_size = _uint(raw, 6, 4)
        self.record_size = _uint(raw, 10, 2)
        self.depth = _uint(raw, 12, 2)
        self.root = _uint(raw, 16, so)
        self.root_records = _uint(raw, 16 + so, 2)
        self.total = _uint(raw, 18 + so, sl)
        # the width of a child's record count (the leaves hold the most)
        # and of its subtree's total, by depth (H5B2__hdr_init)
        leaf_max = (self.node_size - 10) // self.record_size
        self._nrec_size = _enc_size(leaf_max)
        self._cum_size, cum = [0], [leaf_max]
        for d in range(1, self.depth + 1):
            ptr = so + self._nrec_size + self._cum_size[d - 1]
            most = (self.node_size - 10 - ptr) // (self.record_size + ptr)
            cum.append((most + 1) * cum[d - 1] + most)
            self._cum_size.append(_enc_size(cum[d]))

    def _node(self, addr: int, n: int, depth: int):
        """(records, [(child address, child record count)]) of the node at
        ``addr`` holding ``n`` records, ``depth`` above the leaves."""
        f, rs = self.f, self.record_size
        if depth == 0:
            raw = checked(f, addr, 6 + n * rs + 4, b"BTLF")
            kids = []
        else:
            ptr = f._so + self._nrec_size + self._cum_size[depth - 1]
            raw = checked(f, addr, 6 + n * rs + (n + 1) * ptr + 4, b"BTIN")
            at = 6 + n * rs
            kids = [(_uint(raw, at + i * ptr, f._so),
                     _uint(raw, at + i * ptr + f._so, self._nrec_size))
                    for i in range(n + 1)]
        _version(f, raw, addr)
        if raw[5] != self.type:
            raise CorruptBlock(f"{f.path}: B-tree node of type {raw[5]} at "
                               f"{addr} in a tree of type {self.type}")
        return [raw[6 + i * rs:6 + (i + 1) * rs] for i in range(n)], kids

    def records(self) -> List[bytes]:
        """Every record, in the tree's key order."""
        out: List[bytes] = []
        if self.total == 0 or self.f._undefined(self.root):
            return out

        def walk(addr, n, depth):
            recs, kids = self._node(addr, n, depth)
            for i, rec in enumerate(recs):
                if kids:
                    walk(*kids[i], depth - 1)
                out.append(rec)
            if kids:
                walk(*kids[-1], depth - 1)

        walk(self.root, self.root_records, self.depth)
        return out

    def find(self, cmp: Callable[[bytes], int]) -> Optional[bytes]:
        """The record for which ``cmp`` gives 0, or None: ``cmp(record)``
        is negative when the key sorts before ``record``; one node a
        level, from the root down."""
        if self.total == 0 or self.f._undefined(self.root):
            return None
        addr, n, depth = self.root, self.root_records, self.depth
        while True:
            recs, kids = self._node(addr, n, depth)
            child = len(recs)
            for i, rec in enumerate(recs):
                c = cmp(rec)
                if c == 0:
                    return rec
                if c < 0:
                    child = i
                    break
            if not kids:
                return None
            (addr, n), depth = kids[child], depth - 1


def name_hash(name: str) -> int:
    """The hash of a link or attribute name that B-tree types 5 and 8
    order by."""
    return hashlittle(name.encode("utf-8"))


class FractalHeap:
    """The fractal heap whose header is at ``addr``: ``get(heap_id)`` is
    the managed object the ID names."""

    def __init__(self, f, addr: int):
        so, sl = f._so, f._sl
        head = f._bytes(addr, 9)
        filter_len = _uint(head, 7, 2)
        size = 4 + 1 + 2 + 2 + 1 + 4 + 12 * sl + 2 * so + 2 + 2 + 2 + so + 2
        if filter_len:
            size += sl + 4 + filter_len
        raw = checked(f, addr, size + 4, b"FRHP")
        _version(f, raw, addr)
        if filter_len:
            raise NotImplementedError(f"{f.path}: a filtered fractal heap at "
                                      f"{addr}")
        self.f, self.addr = f, addr
        self.flags = raw[9]
        max_man = _uint(raw, 10, 4)
        pos = 14 + 10 * sl + 2 * so  # past the heap's statistics
        self.width = _uint(raw, pos, 2)
        self.start = _uint(raw, pos + 2, sl)
        max_direct = _uint(raw, pos + 2 + sl, sl)
        max_index = _uint(raw, pos + 2 + 2 * sl, 2)
        self.root = _uint(raw, pos + 6 + 2 * sl, so)
        self.root_rows = _uint(raw, pos + 6 + 2 * sl + so, 2)
        if (self.width & (self.width - 1) or self.start & (self.start - 1)
                or max_direct & (max_direct - 1) or not self.width
                or not self.start or max_direct < self.start):
            raise CorruptBlock(f"{f.path}: fractal heap at {addr} with a "
                               f"doubling table of width {self.width}, "
                               f"blocks {self.start}..{max_direct}")
        # the doubling table (H5HF__dtable_init): rows 0 and 1 of blocks
        # of the starting size, each later row twice the one before
        self.off_size = (max_index + 7) // 8
        self.len_size = min((max_direct.bit_length() - 1 + 7) // 8,
                            _enc_size(max_man))
        self.first_row_bits = (self.start.bit_length() - 1
                               + self.width.bit_length() - 1)
        self.max_direct_rows = (max_direct.bit_length()
                                - self.start.bit_length()) + 2
        rows = max(max_index - self.first_row_bits + 1, 2)
        self.row_size = [self.start] + [self.start << max(r - 1, 0)
                                        for r in range(1, rows)]
        self.row_off = [0] + [(self.start * self.width) << (r - 1)
                              for r in range(1, rows)]
        self._blocks: Dict[int, bytes] = {}
        self._iblocks: Dict[int, List[int]] = {}

    def _row_col(self, off: int) -> Tuple[int, int]:
        if off < self.start * self.width:
            return 0, off // self.start
        high = off.bit_length() - 1
        row = high - self.first_row_bits + 1
        if row >= len(self.row_size):
            raise CorruptBlock(f"{self.f.path}: fractal heap offset {off} "
                               f"past the heap at {self.addr}")
        return row, (off - (1 << high)) // self.row_size[row]

    def _iblock(self, addr: int, rows: int, block_off: int) -> List[int]:
        """The child addresses of the indirect block at ``addr``."""
        if addr in self._iblocks:
            return self._iblocks[addr]
        f, so = self.f, self.f._so
        n = rows * self.width
        head = 4 + 1 + so + self.off_size
        raw = checked(f, addr, head + n * so + 4, b"FHIB")
        _version(f, raw, addr)
        if (_uint(raw, 5, so) != self.addr
                or _uint(raw, 5 + so, self.off_size) != block_off):
            raise CorruptBlock(f"{f.path}: FHIB at {addr} names another "
                               f"heap or offset")
        kids = [_uint(raw, head + i * so, so) for i in range(n)]
        self._iblocks[addr] = kids
        return kids

    def _dblock(self, addr: int, size: int, block_off: int) -> bytes:
        if addr in self._blocks:
            return self._blocks[addr]
        f, so = self.f, self.f._so
        at = 4 + 1 + so + self.off_size
        if self.flags & 0x02:
            raw = checked(f, addr, size, b"FHDB", skip=at)
        else:
            raw = f._bytes(addr, size)
            if raw[:4] != b"FHDB":
                raise CorruptBlock(f"{f.path}: no FHDB block at {addr}")
        _version(f, raw, addr)
        if (_uint(raw, 5, so) != self.addr
                or _uint(raw, 5 + so, self.off_size) != block_off):
            raise CorruptBlock(f"{f.path}: FHDB at {addr} names another "
                               f"heap or offset")
        self._blocks[addr] = raw
        return raw

    def get(self, heap_id: bytes) -> bytes:
        f = self.f
        if heap_id[0] >> 6:
            raise CorruptBlock(f"{f.path}: heap ID of version "
                               f"{heap_id[0] >> 6}")
        kind = (heap_id[0] >> 4) & 3
        if kind == 1:
            raise NotImplementedError(f"{f.path}: a huge fractal-heap "
                                      f"object")
        if kind == 2:
            raise NotImplementedError(f"{f.path}: a tiny fractal-heap "
                                      f"object")
        if kind != 0:
            raise CorruptBlock(f"{f.path}: heap ID of type {kind}")
        off = _uint(heap_id, 1, self.off_size)
        n = _uint(heap_id, 1 + self.off_size, self.len_size)
        if self.root_rows == 0:
            addr, size, block_off = self.root, self.start, 0
        else:
            addr, rows, base = self.root, self.root_rows, 0
            while True:
                row, col = self._row_col(off - base)
                kids = self._iblock(addr, rows, base)
                if row * self.width + col >= len(kids):
                    raise CorruptBlock(f"{f.path}: fractal heap offset "
                                       f"{off} past its indirect block")
                child = kids[row * self.width + col]
                child_off = (base + self.row_off[row]
                             + col * self.row_size[row])
                if row < self.max_direct_rows:
                    addr, size, block_off = child, self.row_size[row], \
                        child_off
                    break
                addr, base = child, child_off
                rows = (self.row_size[row].bit_length() - 1
                        - self.first_row_bits + 1)
        if f._undefined(addr):
            raise CorruptBlock(f"{f.path}: fractal heap object at offset "
                               f"{off} in a block never written")
        raw = self._dblock(addr, size, block_off)
        at = off - block_off
        if at + n > len(raw) or at < 4 + 1 + f._so + self.off_size:
            raise CorruptBlock(f"{f.path}: fractal heap object of {n} bytes "
                               f"at {off} outside its block")
        return raw[at:at + n]


def fixed_array(f, addr: int) -> Tuple[int, List[Optional[bytes]]]:
    """(client ID, the elements) of the fixed array whose header is at
    ``addr``: each element's raw bytes, or None in a page never
    written."""
    so, sl = f._so, f._sl
    raw = checked(f, addr, 4 + 1 + 1 + 1 + 1 + sl + so + 4, b"FAHD")
    _version(f, raw, addr)
    client, esize, page_bits = raw[5], raw[6], raw[7]
    n = _uint(raw, 8, sl)
    dblock = _uint(raw, 8 + sl, so)
    if f._undefined(dblock) or n == 0:
        return client, [None] * n
    page = 1 << page_bits
    head = 4 + 1 + 1 + so
    if n <= page:
        body = checked(f, dblock, head + n * esize + 4, b"FADB")
        _fadb_check(f, body, dblock, addr, client)
        return client, [body[head + i * esize:head + (i + 1) * esize]
                        for i in range(n)]
    npages = -(-n // page)
    bitmap_len = (npages + 7) // 8
    prefix = checked(f, dblock, head + bitmap_len + 4, b"FADB")
    _fadb_check(f, prefix, dblock, addr, client)
    bitmap = prefix[head:head + bitmap_len]
    out: List[Optional[bytes]] = []
    at = dblock + head + bitmap_len + 4
    for p in range(npages):
        count = min(page, n - p * page)
        if bitmap[p // 8] & (0x80 >> (p % 8)):
            body = _page(f, at, count * esize)
            out += [body[i * esize:(i + 1) * esize] for i in range(count)]
        else:
            out += [None] * count
        at += page * esize + 4
    return client, out


def _fadb_check(f, raw, addr, header, client):
    _version(f, raw, addr)
    if raw[5] != client or _uint(raw, 6, f._so) != header:
        raise CorruptBlock(f"{f.path}: FADB at {addr} names another array")


def _page(f, addr: int, size: int) -> bytes:
    """The elements of a data block page: ``size`` bytes and the lookup3
    checksum of them after."""
    raw = f._bytes(addr, size + 4)
    if hashlittle(raw[:size]) != int.from_bytes(raw[size:], "little"):
        raise CorruptBlock(f"{f.path}: the checksum of the data block page "
                           f"at {addr} does not hold (incorrect metadata "
                           f"checksum)")
    return raw[:size]


def extensible_array(f, addr: int) -> Tuple[int, List[Optional[bytes]]]:
    """(client ID, the elements up to the largest index ever set) of the
    extensible array whose header is at ``addr``: each element's raw
    bytes, or None where no block holds it."""
    so, sl = f._so, f._sl
    raw = checked(f, addr, 4 + 1 + 1 + 6 + 6 * sl + so + 4, b"EAHD")
    _version(f, raw, addr)
    client, esize, max_bits, iblock_n, dblk_min, sblk_min, page_bits = \
        raw[5:12]
    max_set = _uint(raw, 12 + 4 * sl, sl)
    iblock = _uint(raw, 12 + 6 * sl, so)
    if not dblk_min or dblk_min & (dblk_min - 1) or not sblk_min \
            or sblk_min & (sblk_min - 1):
        raise CorruptBlock(f"{f.path}: EAHD at {addr} with data blocks of "
                           f"{dblk_min} and super blocks of {sblk_min}")
    out: List[Optional[bytes]] = [None] * max_set
    if f._undefined(iblock) or max_set == 0:
        return client, out
    # the super blocks (H5EA__hdr_init): super block u holds 2^(u//2)
    # data blocks of 2^((u+1)//2) * dblk_min elements
    nsblks = 1 + max_bits - (dblk_min.bit_length() - 1)
    info, start, first = [], 0, 0
    for u in range(nsblks):
        ndblks, nelmts = 1 << (u // 2), (1 << ((u + 1) // 2)) * dblk_min
        info.append((ndblks, nelmts, start, first))
        start += ndblks * nelmts
        first += ndblks
    in_iblock = 2 * (sblk_min.bit_length() - 1)
    n_dblk_addrs = 2 * (sblk_min - 1)
    n_sblk_addrs = nsblks - in_iblock
    off_size = (max_bits + 7) // 8
    head = 4 + 1 + 1 + so
    size = head + iblock_n * esize + (n_dblk_addrs + n_sblk_addrs) * so + 4
    body = checked(f, iblock, size, b"EAIB")
    _ea_check(f, body, iblock, addr, client, b"EAIB")
    for i in range(min(iblock_n, max_set)):
        out[i] = body[head + i * esize:head + (i + 1) * esize]
    at = head + iblock_n * esize
    dblk_addrs = [_uint(body, at + i * so, so) for i in range(n_dblk_addrs)]
    at += n_dblk_addrs * so
    sblk_addrs = [_uint(body, at + i * so, so) for i in range(n_sblk_addrs)]
    page = 1 << page_bits

    def dblock(daddr, nelmts, base, bitmap=None):
        if f._undefined(daddr):
            return
        dhead = head + off_size
        if nelmts <= page:
            d = checked(f, daddr, dhead + nelmts * esize + 4, b"EADB")
            _ea_check(f, d, daddr, addr, client, b"EADB")
            for i in range(min(nelmts, max_set - base)):
                out[base + i] = d[dhead + i * esize:dhead + (i + 1) * esize]
            return
        if bitmap is None:
            raise NotImplementedError(
                f"{f.path}: a paged data block under the extensible "
                f"array's index block at {addr}")
        d = checked(f, daddr, dhead + 4, b"EADB")
        _ea_check(f, d, daddr, addr, client, b"EADB")
        pat = daddr + dhead + 4
        for p in range(nelmts // page):
            lo = base + p * page
            if lo < max_set and bitmap(p):
                body = _page(f, pat, page * esize)
                for i in range(min(page, max_set - lo)):
                    out[lo + i] = body[i * esize:(i + 1) * esize]
            pat += page * esize + 4

    for u, (ndblks, nelmts, start, first) in enumerate(info):
        base0 = iblock_n + start
        if base0 >= max_set:
            break
        if u < in_iblock:
            for j in range(ndblks):
                dblock(dblk_addrs[first + j], nelmts,
                       base0 + j * nelmts)
            continue
        saddr = sblk_addrs[u - in_iblock]
        if f._undefined(saddr):
            continue
        npages = nelmts // page if nelmts > page else 0
        init_len = (npages + 7) // 8 if npages else 0
        shead = head + off_size
        s = checked(f, saddr, shead + ndblks * init_len + ndblks * so + 4,
                    b"EASB")
        _ea_check(f, s, saddr, addr, client, b"EASB")
        # one bitmap over the pages of all the super block's data blocks
        bits = s[shead:shead + ndblks * init_len]
        at = shead + ndblks * init_len
        for j in range(ndblks):
            dblock(_uint(s, at + j * so, so), nelmts, base0 + j * nelmts,
                   (lambda p, j=j: bits[(j * npages + p) // 8]
                    & (0x80 >> ((j * npages + p) % 8))) if npages else None)
    return client, out


def _ea_check(f, raw, addr, header, client, sig):
    _version(f, raw, addr)
    if raw[5] != client or _uint(raw, 6, f._so) != header:
        raise CorruptBlock(f"{f.path}: {sig.decode()} at {addr} names "
                           f"another array")
