"""LZF decompression (liblzf's ``lzf_decompress``) in Python: the plain
version of the port's C++ decoder (``mmf_lzf_decode`` in
``csrc/imgcodec.cpp``, bound as ``native.lzf_decode``), which reads the
chunks h5py's built-in lzf filter (HDF5 filter 32000) writes.

The stream is a run of instructions, each starting with a control byte:

- below 32, a literal run: the next ``ctrl + 1`` bytes are copied out;
- otherwise a back-reference: ``len = ctrl >> 5``, extended by the next
  byte when it is 7; the distance back is ``((ctrl & 31) << 8)`` plus the
  next byte plus 1; ``len + 2`` bytes are copied from there, one at a
  time (the copy may overlap what it writes).

A stream that ends inside an instruction, reaches back before the start
of the output, or writes more than ``size`` bytes raises ``ValueError``.
"""
from __future__ import annotations


def decompress(data: bytes, size: int) -> bytes:
    """The bytes the LZF stream ``data`` decodes to, at most ``size``."""
    src = bytes(data)
    out = bytearray()
    i, n = 0, len(src)
    while i < n:
        ctrl = src[i]
        i += 1
        if ctrl < 32:
            run = ctrl + 1
            if len(out) + run > size:
                raise ValueError("lzf: output past its size")
            if i + run > n:
                raise ValueError("lzf: a literal run past the end of the "
                                 "input")
            out += src[i:i + run]
            i += run
            continue
        length = ctrl >> 5
        if length == 7:
            if i >= n:
                raise ValueError("lzf: a back-reference past the end of "
                                 "the input")
            length += src[i]
            i += 1
        if i >= n:
            raise ValueError("lzf: a back-reference past the end of the "
                             "input")
        dist = ((ctrl & 31) << 8) + src[i] + 1
        i += 1
        length += 2
        ref = len(out) - dist
        if len(out) + length > size:
            raise ValueError("lzf: output past its size")
        if ref < 0:
            raise ValueError("lzf: a back-reference before the start of "
                             "the output")
        if dist >= length:
            out += out[ref:ref + length]
        else:
            # an overlapping copy repeats the last ``dist`` bytes
            pattern = out[ref:]
            reps = -(-length // dist)
            out += (pattern * reps)[:length]
    return bytes(out)
