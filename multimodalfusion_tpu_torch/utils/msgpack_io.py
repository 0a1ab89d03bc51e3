"""A reader and writer of the msgpack files that flax's
``serialization.to_bytes`` makes, in pure Python with ``struct`` and
numpy (the port's stand-in for the ``msgpack`` package, which the machine
with the card lacks).

The JAX package writes every checkpoint as such a file
(``s_{k}_*_checkpoint.msgpack``, JAX engine/train.py:420-440): a nested
map of str keys whose leaves are arrays.  The reader takes msgpack's nil,
bool, int, float, str, bin, array, map and ext types, and flax's two ext
types for arrays: 1, an ndarray packed as msgpack of ``(shape, dtype
name, C-order bytes)``, and 3, a numpy scalar packed the same way.
Arrays come back as numpy arrays of the named dtype, except ``bfloat16``
(numpy has none), which comes back as a ``torch.bfloat16`` tensor.  msgpack
arrays come back as lists, as ``msgpack.unpackb`` returns them.

It raises ``NotImplementedError``, naming what is missing, for flax's
chunked arrays (a map with ``__msgpack_chunked_array__``, written for an
array over 2**30 bytes), for its native complex numbers (ext type 2) and
for any other ext type, and ``ValueError`` for bytes that are not
msgpack.

``packb`` writes the same format, choosing each encoding as
``msgpack.packb(tree, use_bin_type=True)`` does and each map's keys in
the dict's order, so a tree of dicts, lists, scalars and numpy arrays
gives the bytes ``flax.serialization.to_bytes`` writes for it.

Format reference: the MessagePack specification (github.com/msgpack/
msgpack/blob/master/spec.md); flax/serialization.py for the ext types.
"""
from __future__ import annotations

import struct
from typing import Any, Tuple

import numpy as np
import torch

_EXT_NDARRAY, _EXT_COMPLEX, _EXT_NPSCALAR = 1, 2, 3
_CHUNKED = "__msgpack_chunked_array__"


class _Reader:
    def __init__(self, data: bytes, raw: bool = False):
        self.data = memoryview(data)
        self.pos = 0
        self.raw = raw     # str as bytes (flax's ndarray payload) or text

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError(f"msgpack: truncated at byte {self.pos} "
                             f"(wants {n} more of {len(self.data)})")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def str_(self, n: int):
        b = bytes(self.take(n))
        return b if self.raw else b.decode("utf-8")

    def ext(self, n: int):
        code = self.unpack(">b")
        return _decode_ext(code, bytes(self.take(n)))

    def array(self, n: int):
        return [self.value() for _ in range(n)]

    def map(self, n: int):
        out = {}
        for _ in range(n):
            k = self.value()
            out[k] = self.value()
        if _CHUNKED in out:
            raise NotImplementedError(
                "msgpack: flax's chunked array (an array over 2**30 bytes "
                "split into __msgpack_chunked_array__ chunks) is not read")
        return out

    def value(self) -> Any:
        b = self.unpack(">B")
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self.array(b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return self.str_(b & 0x1F)
        if b in _FIXED:
            return _FIXED[b](self)
        raise ValueError(f"msgpack: byte 0x{b:02x} at {self.pos - 1} is "
                         f"not a msgpack type")


_FIXED = {
    0xC0: lambda r: None,
    0xC2: lambda r: False,
    0xC3: lambda r: True,
    0xC4: lambda r: bytes(r.take(r.unpack(">B"))),
    0xC5: lambda r: bytes(r.take(r.unpack(">H"))),
    0xC6: lambda r: bytes(r.take(r.unpack(">I"))),
    0xC7: lambda r: r.ext(r.unpack(">B")),
    0xC8: lambda r: r.ext(r.unpack(">H")),
    0xC9: lambda r: r.ext(r.unpack(">I")),
    0xCA: lambda r: r.unpack(">f"),
    0xCB: lambda r: r.unpack(">d"),
    0xCC: lambda r: r.unpack(">B"),
    0xCD: lambda r: r.unpack(">H"),
    0xCE: lambda r: r.unpack(">I"),
    0xCF: lambda r: r.unpack(">Q"),
    0xD0: lambda r: r.unpack(">b"),
    0xD1: lambda r: r.unpack(">h"),
    0xD2: lambda r: r.unpack(">i"),
    0xD3: lambda r: r.unpack(">q"),
    0xD4: lambda r: r.ext(1),
    0xD5: lambda r: r.ext(2),
    0xD6: lambda r: r.ext(4),
    0xD7: lambda r: r.ext(8),
    0xD8: lambda r: r.ext(16),
    0xD9: lambda r: r.str_(r.unpack(">B")),
    0xDA: lambda r: r.str_(r.unpack(">H")),
    0xDB: lambda r: r.str_(r.unpack(">I")),
    0xDC: lambda r: r.array(r.unpack(">H")),
    0xDD: lambda r: r.array(r.unpack(">I")),
    0xDE: lambda r: r.map(r.unpack(">H")),
    0xDF: lambda r: r.map(r.unpack(">I")),
}


def _ndarray(payload: bytes):
    """flax's ``_ndarray_from_bytes``: msgpack of (shape, dtype name,
    C-order bytes)."""
    shape, name, buf = _Reader(payload, raw=True).value()
    shape = tuple(shape)
    if name == b"bfloat16":
        if not buf:
            return torch.empty(shape, dtype=torch.bfloat16)
        return torch.frombuffer(bytearray(buf),
                                dtype=torch.bfloat16).reshape(shape)
    return np.frombuffer(buf, dtype=np.dtype(name.decode())).reshape(
        shape).copy()


def _decode_ext(code: int, payload: bytes):
    if code == _EXT_NDARRAY:
        return _ndarray(payload)
    if code == _EXT_NPSCALAR:
        arr = _ndarray(payload)
        return arr.reshape(()) if isinstance(arr, torch.Tensor) else arr[()]
    if code == _EXT_COMPLEX:
        raise NotImplementedError("msgpack: flax's native complex number "
                                  "(ext type 2) is not read")
    raise NotImplementedError(f"msgpack: ext type {code} is not read "
                              f"(flax writes 1, 2 and 3)")


def unpackb(data: bytes) -> Any:
    """The tree ``flax.serialization.msgpack_restore(data)`` returns."""
    r = _Reader(data)
    out = r.value()
    if r.pos != len(r.data):
        raise ValueError(f"msgpack: {len(r.data) - r.pos} bytes after the "
                         f"value")
    return out


def read(path: str) -> Any:
    """The tree of a flax msgpack checkpoint file."""
    with open(path, "rb") as f:
        return unpackb(f.read())


# ---------------------------------------------------------------------------
# writer
# ---------------------------------------------------------------------------

def _len_header(n: int, fix: Tuple[int, int], codes, widths) -> bytes:
    """The header of a str/bin/array/map of length n: its fix form when
    ``fix`` = (base, limit) allows, else the narrowest of ``codes``."""
    if fix and n < fix[1]:
        return bytes([fix[0] | n])
    for code, fmt in zip(codes, widths):
        if n < 1 << (8 * struct.calcsize(fmt)):
            return bytes([code]) + struct.pack(fmt, n)
    raise ValueError(f"msgpack: length {n} too large")


def _int(v: int) -> bytes:
    if 0 <= v <= 0x7F or -32 <= v < 0:
        return struct.pack(">b" if v < 0 else ">B", v)
    if v >= 0:
        for code, fmt in ((0xCC, ">B"), (0xCD, ">H"), (0xCE, ">I"),
                          (0xCF, ">Q")):
            if v < 1 << (8 * struct.calcsize(fmt)):
                return bytes([code]) + struct.pack(fmt, v)
    else:
        for code, fmt in ((0xD0, ">b"), (0xD1, ">h"), (0xD2, ">i"),
                          (0xD3, ">q")):
            if v >= -(1 << (8 * struct.calcsize(fmt) - 1)):
                return bytes([code]) + struct.pack(fmt, v)
    raise ValueError(f"msgpack: int {v} out of range")


def _ext(code: int, payload: bytes) -> bytes:
    fixext = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    n = len(payload)
    head = (bytes([fixext[n]]) if n in fixext else
            _len_header(n, None, (0xC7, 0xC8, 0xC9), (">B", ">H", ">I")))
    return head + struct.pack(">b", code) + payload


def _array_payload(arr: np.ndarray) -> bytes:
    return packb((list(arr.shape), arr.dtype.name, arr.tobytes("C")))


def _pack(v: Any, out: list) -> None:
    if v is None:
        out.append(b"\xc0")
    elif v is True or v is False:
        out.append(b"\xc3" if v else b"\xc2")
    elif isinstance(v, int):
        out.append(_int(v))
    elif isinstance(v, float):
        out.append(b"\xcb" + struct.pack(">d", v))
    elif isinstance(v, str):
        b = v.encode("utf-8")
        out.append(_len_header(len(b), (0xA0, 32), (0xD9, 0xDA, 0xDB),
                               (">B", ">H", ">I")) + b)
    elif isinstance(v, (bytes, bytearray)):
        out.append(_len_header(len(v), None, (0xC4, 0xC5, 0xC6),
                               (">B", ">H", ">I")) + bytes(v))
    elif isinstance(v, (list, tuple)):
        out.append(_len_header(len(v), (0x90, 16), (0xDC, 0xDD),
                               (">H", ">I")))
        for x in v:
            _pack(x, out)
    elif isinstance(v, dict):
        out.append(_len_header(len(v), (0x80, 16), (0xDE, 0xDF),
                               (">H", ">I")))
        for k, x in v.items():
            _pack(k, out)
            _pack(x, out)
    elif isinstance(v, np.ndarray):
        out.append(_ext(_EXT_NDARRAY, _array_payload(v)))
    elif isinstance(v, np.generic):
        out.append(_ext(_EXT_NPSCALAR, _array_payload(np.asarray(v))))
    else:
        raise TypeError(f"msgpack: cannot pack {type(v).__name__}")


def packb(tree: Any) -> bytes:
    """The bytes ``flax.serialization.msgpack_serialize(tree,
    in_place=True)`` (which ``to_bytes`` calls) writes for a tree of dicts (str keys), lists, tuples, None, bools, ints, floats,
    strs, bytes and numpy arrays and scalars under 2**30 bytes."""
    out: list = []
    _pack(tree, out)
    return b"".join(out)
