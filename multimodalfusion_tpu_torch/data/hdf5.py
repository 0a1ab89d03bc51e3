"""A read-only parser of the HDF5 files h5py writes by default, and a
write-once writer of plain ones, in numpy and the standard library (the
port's stand-in for h5py, which the machine with the card lacks).

The reader takes what h5py's default ("earliest") file format holds:

- superblock version 0 or 1, after a user block or not;
- version-1 object headers, with continuation blocks;
- groups stored as symbol tables: a version-1 B-tree of type 0 over
  symbol-table nodes (``SNOD``) and the group's local heap of names;
- datasets: their dataspace, datatype (little-endian IEEE float and
  fixed-point integers), fill value and data layout (message version 3:
  compact, contiguous, and chunked over a version-1 B-tree of type 1 of
  any depth); a chunk that was never written reads as the fill value;
- a chunked dataset's filter pipeline (message versions 1 and 2) of the
  filters h5py writes without plugins: deflate (1, ``zlib``, what
  ``compression="gzip"`` writes), shuffle (2) and fletcher32 (3), undone
  in reverse order, skipping those a chunk's filter mask names; a
  fletcher32 checksum that does not hold raises ``OSError``, as h5py
  does;
- a dataset's attributes (``File.attrs``): attribute messages of version
  1 or 3 holding scalars or arrays of those numbers, fixed-length strings,
  or variable-length strings kept in a global heap collection (``GCOL``),
  as h5py stores a Python ``str``.

It raises ``NotImplementedError``, naming what is missing, for what it
does not take: other filters (szip 4, nbit 5, scale-offset 6, lzf 32000
and the plugins' ids, each named), superblock versions 2 and 3 and
version-2 object headers (h5py's ``libver="latest"``), the newer chunk
indexes and layout versions, other datatypes.  ROADMAP.md queues the
``libver="latest"`` layouts.  A file that is truncated or is not HDF5
raises ``OSError``, and a name the file does not hold ``KeyError``: the
JAX package's loader counts ``(OSError, KeyError)`` as a missing
radiology bag, so the port reaches the same verdict on the same files.

The writer (``write``) makes a superblock-0 file whose root group holds
contiguous datasets, each with the attributes given for it (int64 and
float64 scalars and arrays, and ``str`` as a variable-length UTF-8
string in one global heap collection, as h5py writes them); h5py reads
it back bit for bit.  It writes a file once and has no append mode.

Format reference: the HDF5 File Format Specification, version 2.0
(superblock 0/1, object header 1, B-tree 1, symbol table, local heap,
global heap, and messages 0x0001 dataspace, 0x0003 datatype, 0x0004/
0x0005 fill value, 0x0008 layout, 0x000B filter pipeline, 0x000C
attribute, 0x0010 continuation, 0x0011 symbol table).
"""
from __future__ import annotations

import struct
import zlib
from typing import Dict, List, Mapping, NamedTuple, Optional, Tuple

import numpy as np

SIGNATURE = b"\x89HDF\r\n\x1a\n"

# object header message types
_DATASPACE, _DATATYPE, _FILL_OLD, _FILL = 0x0001, 0x0003, 0x0004, 0x0005
_LINK_INFO, _LINK, _LAYOUT, _GROUP_INFO = 0x0002, 0x0006, 0x0008, 0x000A
_FILTERS, _CONTINUATION, _SYMBOL_TABLE = 0x000B, 0x0010, 0x0011
_ATTRIBUTE = 0x000C


class _Dataset(NamedTuple):
    shape: Tuple[int, ...]
    dtype: np.dtype
    fill: bytes                 # one element, or b"" for zeros
    layout: tuple               # ("compact", raw) | ("contiguous", addr,
                                # size) | ("chunked", btree, chunk shape)
    filters: tuple = ()         # the pipeline's filter ids, in order


class File:
    """An HDF5 file read whole into memory: ``f["name"]`` or
    ``f["group/name"]`` is the dataset as a numpy array; ``"name" in f``
    says whether the root group (or a path) holds it.  Use as a context
    manager or call ``close``; nothing is read lazily."""

    def __init__(self, path: str):
        with open(path, "rb") as fh:
            self._buf = fh.read()
        self.path = path
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
        if version in (2, 3):
            raise NotImplementedError(
                f"{self.path}: HDF5 superblock version {version} (h5py's "
                f"libver='latest' format); the port reads versions 0 and 1")
        if version not in (0, 1):
            raise OSError(f"{self.path}: unknown HDF5 superblock version "
                          f"{version}")
        self._so, self._sl = head[13], head[14]
        if self._so not in (2, 4, 8) or self._sl not in (2, 4, 8):
            raise OSError(f"{self.path}: bad offset/length sizes "
                          f"{self._so}/{self._sl}")
        pos = 24 + (4 if version == 1 else 0)
        # base address, free space, end of file, driver info; then the root
        # group's symbol table entry
        n = 4 * self._so + self._entry_size()
        sb = self._buf[base + pos:base + pos + n]
        if len(sb) < n:
            raise OSError(f"{self.path}: truncated HDF5 superblock")
        # addresses count from the base address (the superblock's, after a
        # user block); the end-of-file address, as h5py writes it, counts
        # from the start of the file
        self._base = self._offset(sb, 0)
        eof = self._offset(sb, 2 * self._so)
        if eof > len(self._buf):
            raise OSError(f"{self.path}: truncated HDF5 file (end of file "
                          f"address {eof}, the file has {len(self._buf)} "
                          f"bytes)")
        self._root = self._offset(sb, 4 * self._so + self._so)

    def _entry_size(self) -> int:
        """A symbol table entry: name offset, object header address, cache
        type (4), reserved (4), scratch pad (16)."""
        return 2 * self._so + 24

    # -- object headers --------------------------------------------------

    def _messages(self, addr: int) -> List[Tuple[int, bytes]]:
        """(type, data) of every message of the version-1 object header at
        ``addr``, continuation blocks included."""
        if self._bytes(addr, 4) == b"OHDR":
            raise NotImplementedError(
                f"{self.path}: version-2 object header (h5py's "
                f"libver='latest' format); the port reads version 1")
        version, _, n_msgs, _, size = self._unpack("BBHII", addr)
        if version != 1:
            raise OSError(f"{self.path}: unknown object header version "
                          f"{version} at {addr}")
        blocks = [(addr + 16, size)]
        out: List[Tuple[int, bytes]] = []
        while blocks and len(out) < n_msgs:
            start, size = blocks.pop(0)
            block = self._bytes(start, size)
            pos = 0
            while pos + 8 <= size and len(out) < n_msgs:
                mtype, msize, _ = struct.unpack_from("<HHB", block, pos)
                data = block[pos + 8:pos + 8 + msize]
                if len(data) < msize:
                    raise OSError(f"{self.path}: object header message "
                                  f"runs past its block at {start}")
                pos += 8 + msize
                out.append((mtype, data))
                if mtype == _CONTINUATION:
                    blocks.append((self._offset(data, 0),
                                   self._length(data, self._so)))
        return out

    # -- groups ----------------------------------------------------------

    def _group_links(self, addr: int, msgs=None) -> Dict[str, int]:
        """name -> object header address of each member of the group whose
        object header is at ``addr``."""
        msgs = self._messages(addr) if msgs is None else msgs
        for mtype, data in msgs:
            if mtype == _SYMBOL_TABLE:
                btree = self._offset(data, 0)
                heap = self._offset(data, self._so)
                links: Dict[str, int] = {}
                self._walk_group_btree(btree, self._heap_data(heap), links)
                return links
            if mtype in (_LINK_INFO, _LINK, _GROUP_INFO):
                raise NotImplementedError(
                    f"{self.path}: a group stored as links (the newer group "
                    f"format); the port reads symbol-table groups")
        raise KeyError(f"{self.path}: object at {addr} is not a group")

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
                          links: Dict[str, int]) -> None:
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
                links[heap[name_at:end].decode("utf-8")] = self._offset(
                    raw, i * es + self._so)

    def _lookup(self, name: str) -> int:
        addr = self._root
        parts = [p for p in name.split("/") if p]
        for i, part in enumerate(parts):
            links = self._group_links(addr)
            if part not in links:
                raise KeyError(f"{self.path}: no object "
                               f"{'/'.join(parts[:i + 1])!r}")
            addr = links[part]
        return addr

    def keys(self) -> List[str]:
        """The names in the root group, sorted as HDF5 stores them."""
        return sorted(self._group_links(self._root))

    def __contains__(self, name: str) -> bool:
        try:
            self._lookup(name)
        except KeyError:
            return False
        return True

    # -- datasets --------------------------------------------------------

    def __getitem__(self, name: str) -> np.ndarray:
        addr = self._lookup(name)
        return self._read(self._dataset(addr, name))

    def attrs(self, name: str) -> Dict[str, object]:
        """The attributes of the object ``name``, by name (sorted, as h5py
        lists them): numbers as numpy scalars or arrays, strings as
        ``str``."""
        out = {}
        for mtype, data in self._messages(self._lookup(name)):
            if mtype == _ATTRIBUTE:
                key, value = self._attribute(data, name)
                out[key] = value
        return dict(sorted(out.items()))

    def _attribute(self, data: bytes, obj: str):
        version = data[0]
        if version == 1:
            n_name, n_type, n_space = struct.unpack_from("<HHH", data, 2)
            pos = 8
            pad = _pad_len
        elif version == 3:
            n_name, n_type, n_space = struct.unpack_from("<HHH", data, 2)
            pos = 9
            pad = lambda n: n  # noqa: E731 (version 3 packs the fields)
        else:
            raise NotImplementedError(f"{self.path}: attribute message "
                                      f"version {version} on {obj!r}")
        key = data[pos:pos + n_name].split(b"\0")[0].decode("utf-8")
        pos += pad(n_name)
        dtype_msg = data[pos:pos + n_type]
        pos += pad(n_type)
        shape = self._dataspace(data[pos:pos + n_space])
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

    def _dataset(self, addr: int, name: str) -> _Dataset:
        shape = dtype = layout = None
        fill, filters = b"", ()
        for mtype, data in self._messages(addr):
            if mtype == _DATASPACE:
                shape = self._dataspace(data)
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
            elif mtype == _SYMBOL_TABLE:
                raise KeyError(f"{self.path}: {name!r} is a group, not a "
                               f"dataset")
        if shape is None or dtype is None or layout is None:
            raise KeyError(f"{self.path}: {name!r} is not a dataset")
        if fill and len(fill) != dtype.itemsize:
            raise OSError(f"{self.path}: fill value of {len(fill)} bytes "
                          f"for a {dtype} dataset {name!r}")
        layout = self._layout(layout, shape, dtype, name)
        if filters and layout[0] != "chunked":
            raise OSError(f"{self.path}: filters on the {layout[0]} "
                          f"dataset {name!r}")
        return _Dataset(shape, dtype, fill, layout, filters)

    def _dataspace(self, data: bytes) -> Tuple[int, ...]:
        version, rank = data[0], data[1]
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
        return tuple(self._length(data, pos + i * self._sl)
                     for i in range(rank))

    def _layout(self, data: bytes, shape, dtype, name) -> tuple:
        version, cls = data[0], data[1]
        if version != 3:
            raise NotImplementedError(
                f"{self.path}: dataset {name!r} has a layout message of "
                f"version {version} (version 4 holds the newer chunk "
                f"indexes of h5py's libver='latest'); the port reads "
                f"version 3")
        if cls == 0:
            (size,) = struct.unpack_from("<H", data, 2)
            return ("compact", data[4:4 + size])
        if cls == 1:
            return ("contiguous", self._offset(data, 2),
                    self._length(data, 2 + self._so))
        if cls == 2:
            ndim = data[2]
            btree = self._offset(data, 3)
            pos = 3 + self._so
            dims = struct.unpack_from(f"<{ndim}I", data, pos)
            if len(dims) != len(shape) + 1 or dims[-1] != dtype.itemsize:
                raise OSError(f"{self.path}: chunk dims {dims} do not fit "
                              f"dataset {name!r} {shape} {dtype}")
            return ("chunked", btree, tuple(dims[:-1]))
        raise NotImplementedError(f"{self.path}: layout class {cls}")

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
        btree, chunk = ds.layout[1], ds.layout[2]
        if self._undefined(btree) or out.size == 0:
            return out
        csize = int(np.prod(chunk, dtype=np.int64)) * ds.dtype.itemsize
        self._read_chunks(btree, chunk, csize, out, ds.filters)
        return out

    def _read_chunks(self, addr: int, chunk, csize: int, out: np.ndarray,
                     filters: tuple = ()) -> None:
        # a chunk's key: its size, filter mask and offset (one more
        # dimension than the dataset's, for the element)
        level, children, keys = self._btree_node(addr, 1,
                                                 8 + 8 * (len(chunk) + 1))
        for child, key in zip(children, keys):
            if level > 0:
                self._read_chunks(child, chunk, csize, out, filters)
                continue
            size, mask = struct.unpack_from("<II", key, 0)
            raw = self._bytes(child, size)
            # undo the pipeline last filter first; bit i of the mask
            # says filter i was skipped for this chunk
            for i in range(len(filters) - 1, -1, -1):
                if not mask >> i & 1:
                    raw = _unfilter(filters[i], raw, out.dtype.itemsize,
                                    self.path)
            if len(raw) != csize:
                raise OSError(f"{self.path}: chunk of {len(raw)} bytes, "
                              f"expected {csize}")
            offset = struct.unpack_from(f"<{len(chunk)}Q", key, 8)
            data = np.frombuffer(raw, out.dtype).reshape(chunk)
            dst = tuple(slice(o, min(o + c, s))
                        for o, c, s in zip(offset, chunk, out.shape))
            src = tuple(slice(0, d.stop - d.start) for d in dst)
            out[dst] = data[src]


# filter ids of the pipeline message (HDF5 H5Zpublic.h)
DEFLATE, SHUFFLE, FLETCHER32 = 1, 2, 3
_FILTER_NAMES = {4: "szip", 5: "nbit", 6: "scale-offset", 32000: "lzf",
                 32001: "blosc", 32004: "lz4", 32008: "bitshuffle",
                 32015: "zstd"}


def _filter_pipeline(data: bytes, path: str, name: str) -> tuple:
    """The filter ids of a filter pipeline message (versions 1 and 2);
    any filter but deflate, shuffle and fletcher32 raises
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
        if fid not in (DEFLATE, SHUFFLE, FLETCHER32):
            what = _FILTER_NAMES.get(fid, "a third-party filter")
            raise NotImplementedError(
                f"{path}: dataset {name!r} uses HDF5 filter {fid} ({what}); "
                f"the port reads deflate (1), shuffle (2) and fletcher32 "
                f"(3)")
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
