"""A read-only parser of the HDF5 files h5py writes, and a write-once
writer of plain ones, in numpy and the standard library (the port's
stand-in for h5py, which the machine with the card lacks).

The reader takes h5py's default ("earliest") format and what h5py writes
with ``libver`` "v108", "v110", "v112", "v114" or "latest", with
``track_order``, and with more than 8 members or attributes:

- superblock version 0 or 1, after a user block or not, and versions 2
  and 3 (their checksum; a superblock extension, whose messages a read
  needs none of); a version-3 file whose consistency flags say a writer
  holds it open raises ``OSError``, as HDF5 refuses it to a reader that
  is not SWMR;
- object headers of version 1, with continuation blocks, and version 2
  (``OHDR``, continuation blocks ``OCHK``; stored times, attribute phase
  change values and message creation order); every version-2 metadata
  block's Jenkins lookup3 checksum is verified (``data/hdf5_blocks.py``);
- groups stored as symbol tables: a version-1 B-tree of type 0 over
  symbol-table nodes (``SNOD``) and the group's local heap of names; and
  groups of links: compact (link messages in the header) or dense (a
  fractal heap under a version-2 B-tree of type 5, by the name's hash,
  and of type 6 by creation order), hard links followed;
- datasets: their dataspace, datatype (little-endian IEEE float and
  fixed-point integers), fill value and data layout: message version 3
  (compact, contiguous, and chunked over a version-1 B-tree of type 1 of
  any depth) and version 4, whose chunk index is a single chunk
  (filtered or not), implicit, a fixed array (paged or not), an
  extensible array (super blocks, paged data blocks) or a version-2
  B-tree (types 10 and 11); a chunk that was never written reads as the
  fill value;
- a chunked dataset's filter pipeline (message versions 1 and 2) of the
  filters h5py writes without plugins: deflate (1, ``zlib``, what
  ``compression="gzip"`` writes), shuffle (2), fletcher32 (3) and lzf
  (32000; the C++ decoder ``native.lzf_decode``, or with ``plain`` the
  Python one, ``utils/lzf.py``), undone in reverse order, skipping those
  a chunk's filter mask names; a fletcher32 checksum that does not hold
  raises ``OSError``, as h5py does;
- an object's attributes (``File.attrs``, ``File.attr_get``): attribute
  messages of version 1, 2 or 3, compact or dense (a fractal heap under
  version-2 B-trees of types 8 and 9), holding scalars or arrays of those
  numbers, fixed-length strings, or variable-length strings kept in a
  global heap collection (``GCOL``), as h5py stores a Python ``str``.

It raises ``NotImplementedError``, naming what is missing, for what it
does not take: soft, external and user-defined links, virtual datasets
(layout class 3) and external data files (message 0x0007), shared
messages and a shared-message table (0x000F), huge and tiny fractal-heap
objects and filtered fractal heaps, other filters (szip 4, nbit 5,
scale-offset 6 and the plugins' ids, each named), partial edge chunks
stored unfiltered (a layout flag h5py never sets), big-endian and other
datatypes.  ROADMAP.md queues them.  A file that is truncated or is not
HDF5, or a member of a family or multi-driver file (driver information),
raises ``OSError``, as h5py does, and a name the file does not hold
``KeyError``.  An lzf chunk that does not decode to its chunk's size
raises ``OSError``.
A metadata block whose checksum does not hold raises what h5py raises
where it meets it: ``KeyError`` on the way to an object's header (h5py
cannot open the object), ``OSError`` in a chunk index, ``RuntimeError``
in a name's existence check, and ``attr_get`` gives its default.  The
JAX package's loader counts ``(OSError, KeyError)`` as a missing
radiology bag, so the port reaches the same verdict on the same files.

The writer (``write``) makes a superblock-0 file whose root group holds
contiguous datasets, each with the attributes given for it (int64 and
float64 scalars and arrays, and ``str`` as a variable-length UTF-8
string in one global heap collection, as h5py writes them); h5py reads
it back bit for bit.  It writes a file once and has no append mode.

Format reference: the HDF5 File Format Specification, version 3.0
(superblocks 0-3, object headers 1 and 2, B-trees 1 and 2, symbol table,
local, global and fractal heaps, fixed and extensible arrays, and
messages 0x0001 dataspace, 0x0002 link info, 0x0003 datatype, 0x0004/
0x0005 fill value, 0x0006 link, 0x0008 layout, 0x000A group info, 0x000B
filter pipeline, 0x000C attribute, 0x0010 continuation, 0x0011 symbol
table, 0x0015 attribute info).
"""
from __future__ import annotations

import itertools
import struct
import zlib
from typing import Dict, List, Mapping, NamedTuple, Optional, Tuple

import numpy as np

from multimodalfusion_tpu_torch.data import hdf5_blocks as blocks

SIGNATURE = b"\x89HDF\r\n\x1a\n"

# object header message types
_DATASPACE, _DATATYPE, _FILL_OLD, _FILL = 0x0001, 0x0003, 0x0004, 0x0005
_LINK_INFO, _LINK, _LAYOUT, _GROUP_INFO = 0x0002, 0x0006, 0x0008, 0x000A
_FILTERS, _CONTINUATION, _SYMBOL_TABLE = 0x000B, 0x0010, 0x0011
_ATTRIBUTE, _EXTERNAL, _SHARED_TABLE = 0x000C, 0x0007, 0x000F
_DRIVER_INFO, _ATTR_INFO = 0x0014, 0x0015
# the messages that may be shared (stored once, elsewhere)
_SHAREABLE = (_DATASPACE, _DATATYPE, _FILL, _FILTERS, _ATTRIBUTE)
# link types of a link message
_HARD, _SOFT, _EXTERNAL_LINK = 0, 1, 64


class _Dataset(NamedTuple):
    shape: Tuple[int, ...]
    dtype: np.dtype
    fill: bytes                 # one element, or b"" for zeros
    layout: tuple               # ("compact", raw) | ("contiguous", addr,
                                # size) | ("chunked", index, chunk shape)
    filters: tuple = ()         # the pipeline's filter ids, in order
    maxshape: Tuple[Optional[int], ...] = ()  # None: unlimited


class File:
    """An HDF5 file read whole into memory: ``f["name"]`` or
    ``f["group/name"]`` is the dataset as a numpy array; ``"name" in f``
    says whether the root group (or a path) holds it.  Use as a context
    manager or call ``close``; nothing is read lazily.  lzf chunks go
    through the C++ decoder (``native.lzf_decode``), or with ``plain``
    through ``utils/lzf.decompress``."""

    def __init__(self, path: str, plain: bool = False):
        with open(path, "rb") as fh:
            self._buf = fh.read()
        self.path = path
        self.plain = plain
        self._parse_superblock()

    def __enter__(self) -> "File":
        return self

    def __exit__(self, *exc) -> bool:
        self.close()
        return False

    def close(self) -> None:
        self._buf = b""

    # -- raw access ------------------------------------------------------

    def _bytes(self, addr: int, n: int) -> bytes:
        """``n`` bytes at file address ``addr`` (relative to the base)."""
        start = self._base + addr
        if addr < 0 or start + n > len(self._buf):
            raise OSError(f"{self.path}: truncated HDF5 file (wanted "
                          f"{n} bytes at {start}, the file has "
                          f"{len(self._buf)})")
        return self._buf[start:start + n]

    def _unpack(self, fmt: str, addr: int) -> tuple:
        return struct.unpack("<" + fmt, self._bytes(addr, struct.calcsize(
            "<" + fmt)))

    def _undefined(self, addr: int) -> bool:
        return addr == (1 << (8 * self._so)) - 1

    def _offset(self, data: bytes, pos: int) -> int:
        return int.from_bytes(data[pos:pos + self._so], "little")

    def _length(self, data: bytes, pos: int) -> int:
        return int.from_bytes(data[pos:pos + self._sl], "little")

    # -- superblock ------------------------------------------------------

    def _parse_superblock(self) -> None:
        base = 0
        while base + 8 <= len(self._buf):
            if self._buf[base:base + 8] == SIGNATURE:
                break
            base = 512 if base == 0 else base * 2
        else:
            raise OSError(f"{self.path}: not an HDF5 file (no signature)")
        self._base = base
        head = self._buf[base:base + 24]
        if len(head) < 24:
            raise OSError(f"{self.path}: truncated HDF5 superblock")
        version = head[8]
        if version not in (0, 1, 2, 3):
            raise OSError(f"{self.path}: unknown HDF5 superblock version "
                          f"{version}")
        if version >= 2:
            self._so, self._sl = head[9], head[10]
        else:
            self._so, self._sl = head[13], head[14]
        if self._so not in (2, 4, 8) or self._sl not in (2, 4, 8):
            raise OSError(f"{self.path}: bad offset/length sizes "
                          f"{self._so}/{self._sl}")
        if version >= 2:
            # base address, superblock extension, end of file, root group
            # object header, checksum
            self._base = 0
            sb = blocks.checked(self, base, 12 + 4 * self._so + 4,
                                SIGNATURE[:4], what="superblock")
            # the consistency flags of version 3: a file a writer holds
            # open (write or SWMR-write access) is refused, as HDF5
            # refuses it to a reader that is not SWMR
            if version == 3 and sb[11] & 0x05:
                raise OSError(f"{self.path}: file is already open for write "
                              f"(its consistency flags are {sb[11]:#x}; "
                              f"h5clear clears them)")
            self._base = self._offset(sb, 12)
            ext = self._offset(sb, 12 + self._so)
            eof = self._offset(sb, 12 + 2 * self._so)
            self._root = self._offset(sb, 12 + 3 * self._so)
        else:
            pos = 24 + (4 if version == 1 else 0)
            # base address, free space, end of file, driver info; then the
            # root group's symbol table entry
            n = 4 * self._so + self._entry_size()
            sb = self._buf[base + pos:base + pos + n]
            if len(sb) < n:
                raise OSError(f"{self.path}: truncated HDF5 superblock")
            # addresses count from the base address (the superblock's,
            # after a user block)
            self._base = self._offset(sb, 0)
            ext = None
            eof = self._offset(sb, 2 * self._so)
            if not self._undefined(self._offset(sb, 3 * self._so)):
                raise OSError(f"{self.path}: a driver information block (a "
                              f"file of HDF5's family or multi driver, which "
                              f"h5py opens only with that driver)")
            self._root = self._offset(sb, 4 * self._so + self._so)
        # the end-of-file address, as h5py writes it, counts from the
        # start of the file
        if eof > len(self._buf):
            raise OSError(f"{self.path}: truncated HDF5 file (end of file "
                          f"address {eof}, the file has {len(self._buf)} "
                          f"bytes)")
        if ext is not None and not self._undefined(ext):
            # the superblock extension: B-tree K values and file space
            # info, which a read needs none of; driver info names a family
            # or multi-file driver; a shared-message table stores messages
            # once for many objects
            for mtype, _ in self._messages(ext):
                if mtype == _DRIVER_INFO:
                    raise OSError(f"{self.path}: a driver information "
                                  f"message (a file of HDF5's family or "
                                  f"multi driver, which h5py opens only with "
                                  f"that driver)")
                if mtype == _SHARED_TABLE:
                    raise NotImplementedError(
                        f"{self.path}: a shared-message table (message "
                        f"0x000F, h5py's shared object header messages); "
                        f"the port reads files without one")

    def _entry_size(self) -> int:
        """A symbol table entry: name offset, object header address, cache
        type (4), reserved (4), scratch pad (16)."""
        return 2 * self._so + 24

    # -- object headers --------------------------------------------------

    def _messages(self, addr: int) -> List[Tuple[int, bytes]]:
        """(type, data) of every message of the object header at ``addr``
        (version 1, or version 2: ``OHDR``), continuation blocks
        included."""
        if self._bytes(addr, 4) == b"OHDR":
            return self._messages_v2(addr)
        version, _, n_msgs, _, size = self._unpack("BBHII", addr)
        if version != 1:
            raise blocks.CorruptBlock(f"{self.path}: unknown object header "
                                      f"version {version} at {addr}")
        blocks_ = [(addr + 16, size)]
        out: List[Tuple[int, bytes]] = []
        while blocks_ and len(out) < n_msgs:
            start, size = blocks_.pop(0)
            block = self._bytes(start, size)
            pos = 0
            while pos + 8 <= size and len(out) < n_msgs:
                mtype, msize, flags = struct.unpack_from("<HHB", block, pos)
                data = block[pos + 8:pos + 8 + msize]
                if len(data) < msize:
                    raise OSError(f"{self.path}: object header message "
                                  f"runs past its block at {start}")
                pos += 8 + msize
                self._not_shared(mtype, flags, addr)
                out.append((mtype, data))
                if mtype == _CONTINUATION:
                    blocks_.append((self._offset(data, 0),
                                    self._length(data, self._so)))
        return out

    def _messages_v2(self, addr: int) -> List[Tuple[int, bytes]]:
        head = self._bytes(addr, 6)
        if head[4] != 2:
            raise blocks.CorruptBlock(f"{self.path}: OHDR of version "
                                      f"{head[4]} at {addr}")
        flags = head[5]
        # stored times, attribute phase change values, then chunk 0's size
        pos = 6 + (16 if flags & 0x20 else 0) + (4 if flags & 0x10 else 0)
        width = 1 << (flags & 3)
        chunk0 = int.from_bytes(self._bytes(addr + pos, width), "little")
        pos += width
        mhead = 6 if flags & 0x04 else 4  # message creation order stored
        out: List[Tuple[int, bytes]] = []
        todo = [(addr, pos, pos + chunk0 + 4, b"OHDR")]
        while todo:
            start, pos, size, sig = todo.pop(0)
            block = blocks.checked(self, start, size, sig)
            end = size - 4
            # a gap too small for a message ends the block
            while pos + mhead <= end:
                mtype, msize, mflags = struct.unpack_from("<BHB", block, pos)
                data = block[pos + mhead:pos + mhead + msize]
                if pos + mhead + msize > end:
                    raise blocks.CorruptBlock(
                        f"{self.path}: object header message runs past "
                        f"its block at {start}")
                pos += mhead + msize
                self._not_shared(mtype, mflags, addr)
                out.append((mtype, data))
                if mtype == _CONTINUATION:
                    todo.append((self._offset(data, 0), 4,
                                 self._length(data, self._so), b"OCHK"))
        return out

    def _not_shared(self, mtype: int, flags: int, addr: int) -> None:
        if flags & 0x02 and mtype in _SHAREABLE:
            raise NotImplementedError(
                f"{self.path}: a shared message (type 0x{mtype:04X}) in the "
                f"object header at {addr}; the port reads unshared ones")

    # -- groups ----------------------------------------------------------

    def _link_value(self, data: bytes, order: bool = False):
        """(name, object header address) of a link message, and with
        ``order`` its creation order (None when not stored); for a soft,
        external or user-defined link the link's kind stands in place of
        the address (``_lookup`` raises ``NotImplementedError`` on it)."""
        if data[0] != 1:
            raise OSError(f"{self.path}: link message version {data[0]}")
        flags = data[1]
        pos = 2
        kind, created = _HARD, None
        if flags & 0x08:
            kind, pos = data[pos], pos + 1
        if flags & 0x04:
            created = int.from_bytes(data[pos:pos + 8], "little")
            pos += 8
        if flags & 0x10:
            pos += 1  # the name's character set
        width = 1 << (flags & 3)
        n = int.from_bytes(data[pos:pos + width], "little")
        pos += width
        name = data[pos:pos + n].decode("utf-8")
        pos += n
        target = (self._offset(data, pos) if kind == _HARD else "soft"
                  if kind == _SOFT else "external" if kind == _EXTERNAL_LINK
                  else f"user-defined {kind}")
        return (name, target, created) if order else (name, target)

    def _link_storage(self, msgs):
        """('symbols', b-tree, heap) of a symbol-table group; ('compact',
        link messages, creation order tracked) or ('dense', heap, name
        index, creation-order index or None) of a group of links; None
        when the object is no group."""
        for mtype, data in msgs:
            if mtype == _SYMBOL_TABLE:
                return ("symbols", self._offset(data, 0),
                        self._offset(data, self._so))
            if mtype == _LINK_INFO:
                flags = data[1]
                pos = 2 + (8 if flags & 0x01 else 0)
                heap = self._offset(data, pos)
                if self._undefined(heap):
                    return ("compact", [d for t, d in msgs if t == _LINK],
                            bool(flags & 0x01))
                order = (self._offset(data, pos + 2 * self._so)
                         if flags & 0x02 else None)
                return ("dense", heap, self._offset(data, pos + self._so),
                        None if order is None or self._undefined(order)
                        else order)
        return None

    def _group_links(self, addr: int, msgs=None) -> Dict[str, object]:
        """name -> object header address (or a link's kind) of each member
        of the group whose object header is at ``addr``, in h5py's order:
        by creation order where the group tracks it, else by name."""
        msgs = self._messages(addr) if msgs is None else msgs
        store = self._link_storage(msgs)
        if store is None:
            raise KeyError(f"{self.path}: object at {addr} is not a group")
        if store[0] == "symbols":
            links: Dict[str, object] = {}
            self._walk_group_btree(store[1], self._heap_data(store[2]),
                                   links)
            return dict(sorted(links.items()))
        if store[0] == "compact":
            links = [self._link_value(d, order=True) for d in store[1]]
            if store[2]:
                links.sort(key=lambda link: link[2] or 0)
            else:
                links.sort()
            return {name: target for name, target, _ in links}
        # dense: the creation-order index (B-tree type 6: the order, then
        # the heap ID) where there is one, else the name index (type 5)
        heap = blocks.FractalHeap(self, store[1])
        if store[3] is not None:
            tree = blocks.BTree2(self, store[3], (6,))
            return dict(self._link_value(heap.get(rec[8:]))
                        for rec in tree.records())
        tree = blocks.BTree2(self, store[2], (5,))
        return dict(sorted(self._link_value(heap.get(rec[4:]))
                           for rec in tree.records()))

    def _member(self, addr: int, name: str):
        """The object header address (or a link's kind) of member ``name``
        of the group at ``addr``, or None."""
        msgs = self._messages(addr)
        store = self._link_storage(msgs)
        if store is None or store[0] != "dense":
            return self._group_links(addr, msgs).get(name)
        # a dense group: the name index (B-tree type 5: the name's hash,
        # then the heap ID)
        found = self._find_named(
            blocks.FractalHeap(self, store[1]),
            blocks.BTree2(self, store[2], (5,)), name,
            lambda rec: rec[:4], lambda rec: rec[4:], self._link_value)
        return None if found is None else found[1]

    def _find_named(self, heap, tree, name: str, hash_of, id_of, decode):
        """``decode(object)`` of the heap object that the name index
        ``tree`` holds for ``name`` (its hash first, then the name, as
        HDF5's lookup compares them), or None.  ``decode`` gives (name,
        value)."""
        want, key = blocks.name_hash(name), name.encode("utf-8")
        found = []

        def cmp(rec):
            h = int.from_bytes(hash_of(rec), "little")
            if h != want:
                return -1 if want < h else 1
            got = decode(heap.get(id_of(rec)))
            if got[0] == name:
                found.append(got)
                return 0
            return -1 if key < got[0].encode("utf-8") else 1

        return found[0] if tree.find(cmp) is not None else None

    def _heap_data(self, addr: int) -> bytes:
        if self._bytes(addr, 4) != b"HEAP":
            raise OSError(f"{self.path}: no local heap at {addr}")
        head = self._bytes(addr + 8, 2 * self._sl + self._so)
        size = self._length(head, 0)
        return self._bytes(self._offset(head, 2 * self._sl), size)

    def _btree_node(self, addr: int, node_type: int, key: int):
        """(level, children, keys) of the version-1 B-tree node at addr
        whose keys take ``key`` bytes; keys as raw bytes."""
        if self._bytes(addr, 4) != b"TREE":
            raise OSError(f"{self.path}: no B-tree node at {addr}")
        ntype, level, used = self._unpack("BBH", addr + 4)
        if ntype != node_type:
            raise OSError(f"{self.path}: B-tree node of type {ntype} at "
                          f"{addr}, expected {node_type}")
        pos = addr + 8 + 2 * self._so
        raw = self._bytes(pos, used * (key + self._so) + key)
        keys, children = [], []
        for i in range(used):
            at = i * (key + self._so)
            keys.append(raw[at:at + key])
            children.append(self._offset(raw, at + key))
        return level, children, keys

    def _walk_group_btree(self, addr: int, heap: bytes,
                          links: Dict[str, object]) -> None:
        level, children, _ = self._btree_node(addr, 0, self._sl)
        for child in children:
            if level > 0:
                self._walk_group_btree(child, heap, links)
                continue
            if self._bytes(child, 4) != b"SNOD":
                raise OSError(f"{self.path}: no symbol table node at "
                              f"{child}")
            (n,) = self._unpack("H", child + 6)
            es = self._entry_size()
            raw = self._bytes(child + 8, n * es)
            for i in range(n):
                name_at = self._offset(raw, i * es)
                end = heap.index(b"\0", name_at)
                # cache type 2: a soft link, its value in the local heap
                (cache,) = struct.unpack_from("<I", raw, i * es + 2 * self._so)
                links[heap[name_at:end].decode("utf-8")] = (
                    "soft" if cache == 2 else
                    self._offset(raw, i * es + self._so))

    def _lookup(self, name: str) -> int:
        addr = self._root
        parts = [p for p in name.split("/") if p]
        for i, part in enumerate(parts):
            target = self._member(addr, part)
            if target is None:
                raise KeyError(f"{self.path}: no object "
                               f"{'/'.join(parts[:i + 1])!r}")
            if isinstance(target, str):
                raise NotImplementedError(
                    f"{self.path}: {'/'.join(parts[:i + 1])!r} is "
                    f"{'an' if target[0] in 'aeiou' else 'a'} {target} "
                    f"link; the port follows hard links only")
            addr = target
        return addr

    def keys(self) -> List[str]:
        """The names in the root group, as h5py lists them: by creation
        order where the group tracks it, else sorted by name."""
        return list(self._group_links(self._root))

    def __contains__(self, name: str) -> bool:
        try:
            self._lookup(name)
        except KeyError:
            return False
        except blocks.CorruptBlock as e:
            # h5py's link-existence check fails so (a RuntimeError)
            raise RuntimeError(f"{self.path}: unable to check link "
                               f"existence of {name!r} ({e})") from e
        return True

    # -- attributes ------------------------------------------------------

    def attrs(self, name: str) -> Dict[str, object]:
        """The attributes of the object ``name``, by name (sorted, as h5py
        lists them): numbers as numpy scalars or arrays, strings as
        ``str``.  Compact ones are messages of the object header; dense
        ones (more than 8, in a version-2 header) sit in a fractal heap
        under a name index (B-tree type 8) and, where the object tracks
        their order, a creation-order index (type 9), which must name the
        same attributes."""
        out = {}
        for mtype, data in self._messages(self._lookup(name)):
            if mtype == _ATTRIBUTE:
                key, value = self._attribute(data, name)
                out[key] = value
            elif mtype == _ATTR_INFO:
                dense = self._dense_attrs(data)
                if dense is None:
                    continue
                heap, tree, order = dense
                ids = [self._attr_id(tree, rec, name)
                       for rec in tree.records()]
                if order is not None and sorted(
                        self._attr_id(order, rec, name)
                        for rec in order.records()) != sorted(ids):
                    raise blocks.CorruptBlock(
                        f"{self.path}: the attribute indexes of {name!r} "
                        f"name other attributes")
                for heap_id in ids:
                    key, value = self._attribute(heap.get(heap_id), name)
                    out[key] = value
        return dict(sorted(out.items()))

    def attr_get(self, name: str, key: str, default=None):
        """The attribute ``key`` of the object ``name``, or ``default``,
        as h5py's ``attrs.get`` gives it: an attribute that cannot be
        opened (absent, or its storage corrupt) gives ``default``."""
        try:
            msgs = self._messages(self._lookup(name))
        except blocks.CorruptBlock as e:
            raise KeyError(f"{self.path}: unable to open object {name!r} "
                           f"({e})") from e
        for mtype, data in msgs:
            if mtype == _ATTRIBUTE:
                got, value = self._attribute(data, name)
                if got == key:
                    return value
            elif mtype == _ATTR_INFO:
                try:
                    dense = self._dense_attrs(data)
                    if dense is None:
                        continue
                    heap, tree = dense[:2]
                    found = self._find_named(
                        heap, tree, key, lambda rec: rec[-4:],
                        lambda rec: self._attr_id(tree, rec, name),
                        lambda obj: self._attribute(obj, name))
                except blocks.CorruptBlock:
                    return default
                if found is not None:
                    return found[1]
        return default

    def _dense_attrs(self, data: bytes):
        """(fractal heap, name index, creation-order index or None) of an
        attribute info message, or None when the attributes are
        compact."""
        pos = 2 + (2 if data[1] & 0x01 else 0)
        heap = self._offset(data, pos)
        if self._undefined(heap):
            return None
        order = None
        if data[1] & 0x02:
            addr = self._offset(data, pos + 2 * self._so)
            if not self._undefined(addr):
                order = blocks.BTree2(self, addr, (9,))
        return (blocks.FractalHeap(self, heap),
                blocks.BTree2(self, self._offset(data, pos + self._so), (8,)),
                order)

    def _attr_id(self, tree, rec: bytes, obj: str) -> bytes:
        """The heap ID of a type-8 or type-9 record (then its message
        flags, creation order and, type 8, the name's hash)."""
        at = tree.record_size - (9 if tree.type == 8 else 5)
        if rec[at] & 0x02:
            raise NotImplementedError(
                f"{self.path}: a shared attribute on {obj!r}")
        return rec[:at]

    def _attribute(self, data: bytes, obj: str):
        version = data[0]
        if version not in (1, 2, 3):
            raise NotImplementedError(f"{self.path}: attribute message "
                                      f"version {version} on {obj!r}")
        if version > 1 and data[1] & 0x03:
            raise NotImplementedError(
                f"{self.path}: an attribute of {obj!r} with a shared "
                f"datatype or dataspace")
        n_name, n_type, n_space = struct.unpack_from("<HHH", data, 2)
        # version 1 pads each field to 8 bytes; version 3 adds the name's
        # character set
        pos = 9 if version == 3 else 8
        pad = _pad_len if version == 1 else (lambda n: n)
        key = data[pos:pos + n_name].split(b"\0")[0].decode("utf-8")
        pos += pad(n_name)
        dtype_msg = data[pos:pos + n_type]
        pos += pad(n_type)
        shape = self._dataspace(data[pos:pos + n_space])[0]
        pos += pad(n_space)
        raw = data[pos:]
        cls = dtype_msg[0] & 0x0F
        count = int(np.prod(shape, dtype=np.int64))
        if cls == 9:  # variable length
            if int.from_bytes(dtype_msg[1:4], "little") & 0x0F != 1:
                raise NotImplementedError(
                    f"{self.path}: attribute {key!r} of {obj!r} is a "
                    f"variable-length sequence; the port reads strings")
            esz = 4 + self._so + 4
            values = []
            for i in range(count):
                at = i * esz
                (n,) = struct.unpack_from("<I", raw, at)
                heap = self._offset(raw, at + 4)
                (index,) = struct.unpack_from("<I", raw, at + 4 + self._so)
                values.append(self._global_heap_object(heap, index)[:n]
                              .decode("utf-8"))
            return key, (values[0] if shape == () else
                         np.array(values, object).reshape(shape))
        if cls == 3:  # fixed-length string
            (size,) = struct.unpack_from("<I", dtype_msg, 4)
            values = [raw[i * size:(i + 1) * size].split(b"\0")[0].decode(
                "utf-8") for i in range(count)]
            return key, (values[0] if shape == () else
                         np.array(values, object).reshape(shape))
        dtype = _datatype(dtype_msg, self.path)
        arr = np.frombuffer(raw[:count * dtype.itemsize], dtype).reshape(
            shape).copy()
        return key, (arr[()] if shape == () else arr)

    def _global_heap_object(self, addr: int, index: int) -> bytes:
        """The data of object ``index`` of the global heap collection at
        ``addr``."""
        if self._bytes(addr, 4) != b"GCOL":
            raise OSError(f"{self.path}: no global heap collection at "
                          f"{addr}")
        size = self._length(self._bytes(addr + 8, self._sl), 0)
        block = self._bytes(addr, size)
        pos = 8 + self._sl
        while pos + 8 + self._sl <= size:
            (idx,) = struct.unpack_from("<H", block, pos)
            n = self._length(block, pos + 8)
            if idx == 0:
                break
            if idx == index:
                return block[pos + 8 + self._sl:pos + 8 + self._sl + n]
            pos += 8 + self._sl + _pad_len(n)
        raise OSError(f"{self.path}: no object {index} in the global heap "
                      f"collection at {addr}")

    # -- datasets --------------------------------------------------------

    def __getitem__(self, name: str) -> np.ndarray:
        try:
            ds = self._dataset(self._lookup(name), name)
        except blocks.CorruptBlock as e:
            # a metadata block on the way to the object's header, or the
            # header itself: h5py cannot open the object (a KeyError)
            raise KeyError(f"{self.path}: unable to open object {name!r} "
                           f"({e})") from e
        return self._read(ds)

    def _dataset(self, addr: int, name: str) -> _Dataset:
        shape = dtype = layout = None
        fill, filters, maxshape = b"", (), ()
        msgs = self._messages(addr)
        if self._link_storage(msgs) is not None:
            raise KeyError(f"{self.path}: {name!r} is a group, not a "
                           f"dataset")
        for mtype, data in msgs:
            if mtype == _DATASPACE:
                shape, maxshape = self._dataspace(data)
            elif mtype == _DATATYPE:
                dtype = _datatype(data, self.path)
            elif mtype == _FILL_OLD and not fill:
                (size,) = struct.unpack_from("<I", data, 0)
                fill = data[4:4 + size]
            elif mtype == _FILL:
                fill = _fill_value(data, self.path) or fill
            elif mtype == _LAYOUT:
                layout = data
            elif mtype == _FILTERS:
                filters = _filter_pipeline(data, self.path, name)
            elif mtype == _EXTERNAL:
                raise NotImplementedError(
                    f"{self.path}: dataset {name!r} keeps its data in "
                    f"external files (the external data files message); "
                    f"the port reads data inside the file")
        if shape is None or dtype is None or layout is None:
            raise KeyError(f"{self.path}: {name!r} is not a dataset")
        if fill and len(fill) != dtype.itemsize:
            raise OSError(f"{self.path}: fill value of {len(fill)} bytes "
                          f"for a {dtype} dataset {name!r}")
        layout = self._layout(layout, shape, dtype, name)
        if filters and layout[0] != "chunked":
            raise OSError(f"{self.path}: filters on the {layout[0]} "
                          f"dataset {name!r}")
        return _Dataset(shape, dtype, fill, layout, filters, maxshape)

    def _dataspace(self, data: bytes):
        """(dims, max dims: None where unlimited) of a dataspace
        message."""
        version, rank, flags = data[0], data[1], data[2]
        if version == 1:
            pos = 8
        elif version == 2:
            if data[3] == 2:
                raise NotImplementedError(
                    f"{self.path}: a null dataspace")
            pos = 4
        else:
            raise NotImplementedError(f"{self.path}: dataspace message "
                                      f"version {version}")
        dims = tuple(self._length(data, pos + i * self._sl)
                     for i in range(rank))
        if not flags & 0x01:
            return dims, dims
        unlimited = (1 << (8 * self._sl)) - 1
        pos += rank * self._sl
        maxdims = tuple(self._length(data, pos + i * self._sl)
                        for i in range(rank))
        return dims, tuple(None if m == unlimited else m for m in maxdims)

    def _layout(self, data: bytes, shape, dtype, name) -> tuple:
        version, cls = data[0], data[1]
        if version not in (3, 4):
            raise NotImplementedError(
                f"{self.path}: dataset {name!r} has a layout message of "
                f"version {version}; the port reads versions 3 and 4")
        if cls == 0:
            (size,) = struct.unpack_from("<H", data, 2)
            return ("compact", data[4:4 + size])
        if cls == 1:
            return ("contiguous", self._offset(data, 2),
                    self._length(data, 2 + self._so))
        if cls == 3:
            raise NotImplementedError(
                f"{self.path}: dataset {name!r} is a virtual dataset (layout "
                f"class 3); the port reads data inside the file")
        if cls != 2:
            raise NotImplementedError(f"{self.path}: layout class {cls}")
        if version == 3:
            ndim = data[2]
            btree = self._offset(data, 3)
            dims = struct.unpack_from(f"<{ndim}I", data, 3 + self._so)
            index = ("btree1", btree)
        else:
            flags, ndim, enc = data[2], data[3], data[4]
            if flags & 0x01:
                raise NotImplementedError(
                    f"{self.path}: dataset {name!r} stores its partial edge "
                    f"chunks unfiltered (layout flag 0x01), which h5py "
                    f"does not write")
            pos = 5
            dims = tuple(int.from_bytes(data[pos + i * enc:
                                             pos + (i + 1) * enc], "little")
                         for i in range(ndim))
            pos += ndim * enc
            kind = data[pos]
            pos += 1
            if kind == 1:  # a single chunk; its size and mask if filtered
                if flags & 0x02:
                    size = self._length(data, pos)
                    (mask,) = struct.unpack_from("<I", data, pos + self._sl)
                    pos += self._sl + 4
                else:
                    size = mask = None
                index = ("single", self._offset(data, pos), size, mask)
            elif kind in (2, 3, 4, 5):
                # the creation parameters are read from the index's own
                # header; skip them here
                pos += {2: 0, 3: 1, 4: 5, 5: 6}[kind]
                index = ({2: "implicit", 3: "fixed", 4: "extensible",
                          5: "btree2"}[kind], self._offset(data, pos))
            else:
                raise NotImplementedError(
                    f"{self.path}: dataset {name!r} has chunk index type "
                    f"{kind}")
        if len(dims) != len(shape) + 1 or dims[-1] != dtype.itemsize:
            raise OSError(f"{self.path}: chunk dims {dims} do not fit "
                          f"dataset {name!r} {shape} {dtype}")
        if 0 in dims:
            raise OSError(f"{self.path}: chunk dims {dims} of dataset "
                          f"{name!r}")
        return ("chunked", index, tuple(dims[:-1]))

    def _filled(self, ds: _Dataset) -> np.ndarray:
        if ds.fill and any(ds.fill):
            value = np.frombuffer(ds.fill, ds.dtype)[0]
            return np.full(ds.shape, value, ds.dtype)
        return np.zeros(ds.shape, ds.dtype)

    def _read(self, ds: _Dataset) -> np.ndarray:
        n = int(np.prod(ds.shape, dtype=np.int64)) * ds.dtype.itemsize
        kind = ds.layout[0]
        if kind == "compact":
            return np.frombuffer(ds.layout[1][:n], ds.dtype).reshape(
                ds.shape).copy()
        if kind == "contiguous":
            addr = ds.layout[1]
            if self._undefined(addr) or n == 0:
                return self._filled(ds)
            return np.frombuffer(self._bytes(addr, n), ds.dtype).reshape(
                ds.shape).copy()
        out = self._filled(ds)
        index, chunk = ds.layout[1:]
        if self._undefined(index[1]) or out.size == 0:
            return out
        csize = int(np.prod(chunk, dtype=np.int64)) * ds.dtype.itemsize
        for offset, addr, size, mask in self._chunks(ds, index, chunk,
                                                     csize):
            if self._undefined(addr):
                continue
            raw = self._bytes(addr, size)
            # undo the pipeline last filter first; bit i of the mask
            # says filter i was skipped for this chunk
            for i in range(len(ds.filters) - 1, -1, -1):
                if not mask >> i & 1:
                    raw = self._unfilter(ds.filters[i], raw,
                                         out.dtype.itemsize, csize)
            if len(raw) != csize:
                raise OSError(f"{self.path}: chunk of {len(raw)} bytes, "
                              f"expected {csize}")
            data = np.frombuffer(raw, out.dtype).reshape(chunk)
            dst = tuple(slice(o, min(o + c, s))
                        for o, c, s in zip(offset, chunk, out.shape))
            src = tuple(slice(0, d.stop - d.start) for d in dst)
            out[dst] = data[src]
        return out

    def _unfilter(self, fid: int, raw: bytes, itemsize: int,
                  csize: int) -> bytes:
        if fid != LZF:
            return _unfilter(fid, raw, itemsize, self.path)
        try:
            if self.plain:
                from multimodalfusion_tpu_torch.utils import lzf
                return lzf.decompress(raw, csize)
            from multimodalfusion_tpu_torch import native
            return native.lzf_decode(raw, csize)
        except ValueError as e:
            raise OSError(f"{self.path}: an lzf chunk does not decode "
                          f"({e})") from e

    def _chunks(self, ds: _Dataset, index: tuple, chunk, csize: int):
        """(element offset, address, stored size, filter mask) of every
        chunk the index holds; an undefined address for one never
        written."""
        kind, addr = index[0], index[1]
        if kind == "btree1":
            yield from self._btree1_chunks(addr, len(chunk))
            return
        rank = len(chunk)
        if kind == "single":
            size = csize if index[2] is None else index[2]
            yield (0,) * rank, addr, size, index[3] or 0
            return
        if kind == "btree2":
            tree = blocks.BTree2(self, addr, (10, 11))
            at = tree.record_size - 8 * rank
            for rec in tree.records():
                scaled = struct.unpack_from(f"<{rank}Q", rec, at)
                caddr = self._offset(rec, 0)
                if tree.type == 11:
                    size = int.from_bytes(rec[self._so:at - 4], "little")
                    (mask,) = struct.unpack_from("<I", rec, at - 4)
                else:
                    size, mask = csize, 0
                yield (tuple(s * c for s, c in zip(scaled, chunk)), caddr,
                       size, mask)
            return
        # the other indexes number the chunks in row-major order over the
        # largest extent (the extensible array: its unlimited axis first)
        maxshape = tuple(s if m is None else m
                         for s, m in zip(ds.shape, ds.maxshape or ds.shape))
        counts = [-(-m // c) for m, c in zip(maxshape, chunk)]
        axes = list(range(rank))
        if kind == "extensible":
            unlim = [i for i, m in enumerate(ds.maxshape) if m is None]
            if len(unlim) != 1:
                raise OSError(f"{self.path}: an extensible array index on a "
                              f"dataset with {len(unlim)} unlimited axes")
            axes = unlim + [i for i in axes if i != unlim[0]]
        down = [1] * rank
        for j in range(rank - 2, -1, -1):
            down[j] = down[j + 1] * counts[axes[j + 1]]
        extent = [-(-s // c) for s, c in zip(ds.shape, chunk)]
        if kind == "implicit":
            for scaled in itertools.product(*(range(n) for n in extent)):
                i = sum(scaled[axes[j]] * down[j] for j in range(rank))
                yield (tuple(s * c for s, c in zip(scaled, chunk)),
                       addr + i * csize, csize, 0)
            return
        read = (blocks.fixed_array if kind == "fixed"
                else blocks.extensible_array)
        client, entries = read(self, addr)
        for i, e in enumerate(entries):
            if e is None:
                continue
            scaled = [0] * rank
            for j in range(rank):
                q = i // down[j]
                scaled[axes[j]] = q if j == 0 else q % counts[axes[j]]
            if any(s >= n for s, n in zip(scaled, extent)):
                continue  # a chunk past the current extent
            caddr = self._offset(e, 0)
            if client == 1:  # filtered: the stored size and the mask
                size = int.from_bytes(e[self._so:-4], "little")
                mask = int.from_bytes(e[-4:], "little")
            else:
                size, mask = csize, 0
            yield (tuple(s * c for s, c in zip(scaled, chunk)), caddr, size,
                   mask)

    def _btree1_chunks(self, addr: int, rank: int):
        # a chunk's key: its size, filter mask and offset (one more
        # dimension than the dataset's, for the element)
        level, children, keys = self._btree_node(addr, 1, 8 + 8 * (rank + 1))
        for child, key in zip(children, keys):
            if level > 0:
                yield from self._btree1_chunks(child, rank)
                continue
            size, mask = struct.unpack_from("<II", key, 0)
            yield (struct.unpack_from(f"<{rank}Q", key, 8), child, size,
                   mask)


# filter ids of the pipeline message (HDF5 H5Zpublic.h; lzf: h5py's)
DEFLATE, SHUFFLE, FLETCHER32, LZF = 1, 2, 3, 32000
_FILTER_NAMES = {4: "szip", 5: "nbit", 6: "scale-offset", 32001: "blosc",
                 32004: "lz4", 32008: "bitshuffle", 32015: "zstd"}


def _filter_pipeline(data: bytes, path: str, name: str) -> tuple:
    """The filter ids of a filter pipeline message (versions 1 and 2);
    any filter but deflate, shuffle, fletcher32 and lzf raises
    ``NotImplementedError`` naming its id."""
    version, n = data[0], data[1]
    if version not in (1, 2):
        raise NotImplementedError(f"{path}: filter pipeline message "
                                  f"version {version} on {name!r}")
    pos = 8 if version == 1 else 2
    ids = []
    for _ in range(n):
        (fid,) = struct.unpack_from("<H", data, pos)
        pos += 2
        name_len = 0
        if version == 1 or fid >= 256:
            (name_len,) = struct.unpack_from("<H", data, pos)
            pos += 2
        _, n_values = struct.unpack_from("<HH", data, pos)
        pos += 4
        pos += (name_len + 7) // 8 * 8 if version == 1 else name_len
        pos += 4 * n_values
        if version == 1 and n_values % 2:
            pos += 4
        if fid not in (DEFLATE, SHUFFLE, FLETCHER32, LZF):
            what = _FILTER_NAMES.get(fid, "a third-party filter")
            raise NotImplementedError(
                f"{path}: dataset {name!r} uses HDF5 filter {fid} ({what}); "
                f"the port reads deflate (1), shuffle (2), fletcher32 (3) "
                f"and lzf (32000)")
        ids.append(fid)
    return tuple(ids)


def fletcher32(data: bytes) -> int:
    """HDF5's H5_checksum_fletcher32 of ``data``: big-endian 16-bit words
    summed in blocks of 360, each sum folded to 17 bits after a block
    (an odd last byte is a word's high byte), then folded once more."""
    words = np.frombuffer(data, ">u2", len(data) // 2).astype(np.int64)
    s1 = s2 = 0
    for a in range(0, len(words), 360):
        w = words[a:a + 360]
        n = len(w)
        # sum1 grows by each word; sum2 by sum1 after each word
        s2 += n * s1 + int((w * np.arange(n, 0, -1)).sum())
        s1 += int(w.sum())
        s1 = (s1 & 0xFFFF) + (s1 >> 16)
        s2 = (s2 & 0xFFFF) + (s2 >> 16)
    if len(data) % 2:
        s1 += data[-1] << 8
        s2 += s1
        s1 = (s1 & 0xFFFF) + (s1 >> 16)
        s2 = (s2 & 0xFFFF) + (s2 >> 16)
    s1 = (s1 & 0xFFFF) + (s1 >> 16)
    s2 = (s2 & 0xFFFF) + (s2 >> 16)
    return (s2 << 16) | s1


def _unfilter(fid: int, raw: bytes, itemsize: int, path: str) -> bytes:
    """One filter of the pipeline undone on a chunk's bytes."""
    if fid == DEFLATE:
        try:
            return zlib.decompress(raw)
        except zlib.error as e:
            raise OSError(f"{path}: a deflated chunk does not inflate "
                          f"({e})") from e
    if fid == SHUFFLE:
        if itemsize == 1:
            return raw
        n = len(raw) // itemsize
        body = np.frombuffer(raw, np.uint8, n * itemsize)
        return (body.reshape(itemsize, n).T.tobytes()
                + raw[n * itemsize:])
    # fletcher32: the chunk's last 4 bytes hold the checksum, little
    # endian; HDF5 also takes it byte-reversed (files of HDF5 < 1.6.3)
    if len(raw) < 4:
        raise OSError(f"{path}: a fletcher32 chunk of {len(raw)} bytes")
    body, stored = raw[:-4], int.from_bytes(raw[-4:], "little")
    want = fletcher32(body)
    if stored not in (want, int.from_bytes(want.to_bytes(4, "little"),
                                           "big")):
        raise OSError(f"{path}: fletcher32 checksum of a chunk does not "
                      f"hold (Data error detected by Fletcher32 checksum)")
    return body


def _datatype(data: bytes, path: str) -> np.dtype:
    cls, version = data[0] & 0x0F, data[0] >> 4
    bits = int.from_bytes(data[1:4], "little")
    (size,) = struct.unpack_from("<I", data, 4)
    if bits & 1:
        raise NotImplementedError(f"{path}: a big-endian datatype")
    if cls == 0:
        if size not in (1, 2, 4, 8):
            raise NotImplementedError(f"{path}: a {size}-byte integer")
        return np.dtype(f"<{'i' if bits & 0x08 else 'u'}{size}")
    if cls == 1:
        if size not in (2, 4, 8):
            raise NotImplementedError(f"{path}: a {size}-byte float")
        return np.dtype(f"<f{size}")
    raise NotImplementedError(f"{path}: datatype class {cls} (version "
                              f"{version}); the port reads integers and "
                              f"IEEE floats")


def _fill_value(data: bytes, path: str) -> bytes:
    """The fill value a fill value message (type 5) defines, or b""."""
    version = data[0]
    if version in (1, 2):
        defined = data[3]
        if version == 2 and not defined:
            return b""
        (size,) = struct.unpack_from("<I", data, 4)
        return data[8:8 + size]
    if version == 3:
        flags = data[1]
        if not flags & 0x20:
            return b""
        (size,) = struct.unpack_from("<I", data, 2)
        return data[6:6 + size]
    raise NotImplementedError(f"{path}: fill value message version "
                              f"{version}")


def read(path: str, name: str) -> np.ndarray:
    """The dataset ``name`` of the file at ``path``."""
    with File(path) as f:
        return f[name]


# ---------------------------------------------------------------------------
# the writer
# ---------------------------------------------------------------------------

_UNDEF = b"\xff" * 8


def _pad8(b: bytes) -> bytes:
    return b + b"\0" * (-len(b) % 8)


def _header(messages: List[Tuple[int, bytes]]) -> bytes:
    """A version-1 object header holding ``messages`` (each padded to 8)."""
    body = b"".join(struct.pack("<HHB3x", t, len(_pad8(d)), 0) + _pad8(d)
                    for t, d in messages)
    return struct.pack("<BBHII4x", 1, 0, len(messages), 1, len(body)) + body


def _datatype_message(dtype: np.dtype) -> bytes:
    size = dtype.itemsize
    if dtype.kind in "iu":
        bits = 0x08 if dtype.kind == "i" else 0
        return (struct.pack("<B3sI", 0x10, bits.to_bytes(3, "little"), size)
                + struct.pack("<HH", 0, 8 * size))
    if dtype.kind == "f" and size in (2, 4, 8):
        exp, mant, bias = {2: (5, 10, 15), 4: (8, 23, 127),
                           8: (11, 52, 1023)}[size]
        # little-endian, mantissa normalised with an implied leading 1
        # (bits 4-5 = 2), the sign at the top bit (bits 8-15)
        bits = (2 << 4) | ((8 * size - 1) << 8)
        return (struct.pack("<B3sI", 0x11, bits.to_bytes(3, "little"), size)
                + struct.pack("<HHBBBBI", 0, 8 * size, mant, exp, 0, mant,
                              bias))
    raise NotImplementedError(f"dtype {dtype}: the writer writes integers "
                              f"and IEEE floats")


def _pad_len(n: int) -> int:
    return n + (-n % 8)


def _attribute_message(key: str, value, heap_ref: Optional[bytes]
                       ) -> bytes:
    """An attribute message (version 1): ``value`` an int64 or float64
    scalar or array, or a ``str`` whose 16-byte global heap reference is
    ``heap_ref``."""
    name = key.encode("utf-8") + b"\0"
    if isinstance(value, str):
        # a variable-length UTF-8 string of bytes (the base type: uint8)
        dtype = (struct.pack("<B3sI", 0x19, (0x0101).to_bytes(3, "little"),
                             16) + _datatype_message(np.dtype("u1")))
        shape, data = (), heap_ref
    else:
        a = np.asarray(value)
        if a.dtype.kind in "iu":
            a = a.astype("<i8")
        elif a.dtype.kind == "f":
            a = a.astype("<f8")
        else:
            raise NotImplementedError(f"attribute {key!r} of dtype "
                                      f"{a.dtype}: the writer writes "
                                      f"numbers and str")
        dtype, shape, data = _datatype_message(a.dtype), a.shape, a.tobytes()
    space = struct.pack("<BBB5x", 1, len(shape), 1 if shape else 0) + b"".join(
        struct.pack("<Q", d) for d in shape) * 2
    return (struct.pack("<BxHHH", 1, len(name), len(dtype), len(space))
            + _pad8(name) + _pad8(dtype) + _pad8(space) + data)


def write(path: str, arrays: Mapping[str, np.ndarray],
          attrs: Optional[Mapping[str, Mapping[str, object]]] = None) -> str:
    """Write a new HDF5 file at ``path`` (superblock 0, 8-byte offsets) whose
    root group holds one contiguous dataset per entry of ``arrays``
    (little-endian integers or floats, any shape), each with the
    attributes ``attrs[name]`` (see ``_attribute_message``).  Overwrites
    ``path``."""
    attrs = dict(attrs or {})
    names = sorted(arrays)
    unknown = sorted(set(attrs) - set(names))
    if unknown:
        raise KeyError(f"attributes for datasets {unknown} not written")
    data = {}
    for k in names:
        if not k or "/" in k or "\0" in k:
            raise ValueError(f"dataset name {k!r}")
        a = np.asarray(arrays[k])
        data[k] = a.astype(a.dtype.newbyteorder("<"), order="C", copy=False)
    leaf_k = max(4, -(-len(names) // 2))
    # the local heap: "" at 0, then each name, each padded to 8 bytes
    heap_data, name_at = b"\0" * 8, {}
    for k in names:
        name_at[k] = len(heap_data)
        heap_data += _pad8(k.encode("utf-8") + b"\0")
    # the strings go in one global heap collection after the datasets
    strings = [(k, a, v.encode("utf-8")) for k in names
               for a, v in sorted((attrs.get(k) or {}).items())
               if isinstance(v, str)]

    sb_size = 8 + 16 + 4 * 8 + 40
    root_oh = sb_size
    root_oh_size = len(_header([(_SYMBOL_TABLE, b"\0" * 16)]))
    btree = root_oh + root_oh_size
    internal_k = 16
    btree_size = 24 + (2 * internal_k + 1) * 8 + 2 * internal_k * 8
    snod = btree + btree_size
    snod_size = 8 + 2 * leaf_k * 40
    heap = snod + snod_size
    heap_size = 32
    heap_seg = heap + heap_size
    pos = heap_seg + len(heap_data)

    def messages(k, layout, heap_refs):
        a = data[k]
        dspace = struct.pack("<BBB5x", 1, a.ndim, 0) + b"".join(
            struct.pack("<Q", d) for d in a.shape)
        # fill value v2: allocated late, written if set, the library's
        # default (zeros), as h5py writes it
        fill = struct.pack("<BBBBI", 2, 2, 2, 1, 0)
        return ([(_DATASPACE, dspace),
                 (_DATATYPE, _datatype_message(a.dtype)), (_FILL, fill),
                 (_LAYOUT, layout)]
                + [(_ATTRIBUTE, _attribute_message(
                    key, v, heap_refs.get((k, key))))
                   for key, v in sorted((attrs.get(k) or {}).items())])

    no_refs = {(k, a): b"\0" * 16 for k, a, _ in strings}
    headers, data_at = {}, {}
    for k in names:
        oh_size = len(_header(messages(k, b"\0" * 18, no_refs)))
        headers[k] = pos
        data_at[k] = pos + oh_size
        pos = data_at[k] + len(_pad8(data[k].tobytes()))
    gcol = pos
    refs, objects = {}, b""
    for i, (k, a, raw) in enumerate(strings, start=1):
        refs[(k, a)] = struct.pack("<IQI", len(raw), gcol, i)
        objects += struct.pack("<HH4xQ", i, 0, len(raw)) + _pad8(raw)
    if strings:
        # a collection holds at least 4096 bytes; the rest is object 0,
        # the free space, its size counting its own 16-byte header
        size = max(4096, 16 + len(objects) + 16)
        objects += struct.pack("<HH4xQ", 0, 0, size - 16 - len(objects))
        gcol_block = b"GCOL" + struct.pack("<B3xQ", 1, size) + objects
        gcol_block += b"\0" * (size - len(gcol_block))
        pos += size
    eof = pos

    out = bytearray()
    out += SIGNATURE + struct.pack("<BBBBBBBxHHI", 0, 0, 0, 0, 0, 8, 8,
                                   leaf_k, internal_k, 0)
    out += struct.pack("<Q", 0) + _UNDEF + struct.pack("<Q", eof) + _UNDEF
    out += struct.pack("<QQII", 0, root_oh, 1, 0) + struct.pack(
        "<QQ", btree, heap)
    out += _header([(_SYMBOL_TABLE, struct.pack("<QQ", btree, heap))])
    # the group's B-tree: one leaf node over one symbol table node; key 0
    # is the empty name, key 1 the last name of the node
    node = (b"TREE" + struct.pack("<BBH", 0, 0, 1) + _UNDEF + _UNDEF
            + struct.pack("<QQQ", 0, snod,
                          name_at[names[-1]] if names else 0))
    out += node + b"\0" * (btree_size - len(node))
    entries = b"".join(struct.pack("<QQII16x", name_at[k], headers[k], 0, 0)
                       for k in names)
    node = b"SNOD" + struct.pack("<BBH", 1, 0, len(names)) + entries
    out += node + b"\0" * (snod_size - len(node))
    # no free block: the library's "null" free-list offset is 1
    out += b"HEAP" + struct.pack("<B3xQQQ", 0, len(heap_data), 1, heap_seg)
    out += heap_data
    for k in names:
        a = data[k]
        # an empty dataset has no storage: an undefined address
        layout = struct.pack("<BB8sQ", 3, 1, _UNDEF if a.nbytes == 0 else
                             struct.pack("<Q", data_at[k]), a.nbytes)
        out += _header(messages(k, layout, refs))
        out += _pad8(a.tobytes())
    if strings:
        out += gcol_block
    with open(path, "wb") as fh:
        fh.write(bytes(out))
    return path
