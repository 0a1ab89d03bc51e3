"""The port's native host libraries.

``csrc/bagio.cpp`` (``lib()``): threaded collation of ragged bags into a
padded batch, the threaded float32 -> bfloat16 cast, parallel whole-file
reads.  No path of the port calls ``f32_to_bf16`` or ``read_files``
yet; their ``*_plain`` versions are the oracles of the tests and of
``chip_smoke.py``.

``csrc/imgcodec.cpp`` (``codec_lib()``): the image decoders that stand in
for PIL's libtiff, libpng, libjpeg-turbo and libzstd -- TIFF LZW,
PackBits and ZSTD chunks, PNG row filters and JPEG frames (Huffman or
arithmetic coding, sequential, progressive or lossless), threaded over
independent chunks, and the lossless-JPEG DICOM frames (JAX native.py's
``jpeg_lossless_decode``), on the lossless frames' predictor loop.
Their wrappers and plain versions live with the readers
(``utils/tiff.py``, ``utils/png.py``, ``utils/jpeg.py``,
``utils/zstd.py``); ``zstd_decode`` decodes a whole Zstandard byte
string, ``lzf_decode`` an LZF chunk of an h5 file (``utils/lzf.py``).

``csrc/j2k.cpp`` (``j2k_lib()``): the hot loops of the JPEG 2000 codec
that stands in for PIL's openjpeg (``utils/j2k.py``, which holds their
plain versions): ``j2k_decode_blocks`` (tier 1 of many code-blocks, over
host threads), ``j2k_idwt`` (the inverse 5/3 or 9/7 DWT of a
tile-component) and ``j2k_encode_blocks`` (tier 1 of the lossless
encoder).

Each library is built with g++ at its first use into
``<checkout>/build/native/<name>-<hash>.so``, where the hash covers the
source and the flags, and loaded with ctypes.  A failed build raises with
the compiler's output: there is no silent numpy fallback.  Nothing here
runs at import time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from typing import List, Optional, Sequence, Union

import numpy as np
import torch

PKG_DIR = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(PKG_DIR, "csrc", "bagio.cpp")
CODEC_SRC = os.path.join(PKG_DIR, "csrc", "imgcodec.cpp")
J2K_SRC = os.path.join(PKG_DIR, "csrc", "j2k.cpp")
BUILD_DIR = os.path.join(os.path.dirname(PKG_DIR), "build", "native")
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-pthread", "-std=c++17")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_codec_lib: Optional[ctypes.CDLL] = None
_j2k_lib: Optional[ctypes.CDLL] = None


def build(src: str = SRC, build_dir: str = BUILD_DIR) -> str:
    """Path of the built library of ``src``, compiling it first when no
    build of this exact source and these flags exists."""
    with open(src, "rb") as f:
        digest = hashlib.sha256(" ".join(CXX_FLAGS).encode() + f.read())
    name = os.path.splitext(os.path.basename(src))[0]
    so = os.path.join(build_dir, f"{name}-{digest.hexdigest()[:12]}.so")
    if os.path.exists(so):
        return so
    os.makedirs(build_dir, exist_ok=True)
    fd, tmp = tempfile.mkstemp(prefix=f".{name}-", suffix=".so",
                               dir=build_dir)
    os.close(fd)
    try:
        proc = subprocess.run(["g++", *CXX_FLAGS, "-o", tmp, src],
                              capture_output=True, text=True)
    except FileNotFoundError as e:
        os.unlink(tmp)
        raise RuntimeError(f"g++ not found: {src} cannot be built") from e
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"g++ failed on {src}:\n{proc.stderr}")
    os.replace(tmp, so)  # atomic: a concurrent loader sees all or nothing
    return so


def lib() -> ctypes.CDLL:
    """The loaded library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            loaded = ctypes.CDLL(build())
            loaded.mmf_pad_bags_f32.argtypes = [
                ctypes.POINTER(ctypes.c_void_p),
                ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
                ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_int]
            loaded.mmf_pad_bags_f32.restype = None
            loaded.mmf_f32_to_bf16.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                ctypes.c_int]
            loaded.mmf_f32_to_bf16.restype = None
            loaded.mmf_read_files.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_int64, ctypes.c_int]
            loaded.mmf_read_files.restype = ctypes.c_int64
            _lib = loaded
        return _lib


def codec_lib() -> ctypes.CDLL:
    """The loaded image decoder library (``csrc/imgcodec.cpp``), built on
    first use."""
    global _codec_lib
    with _lock:
        if _codec_lib is None:
            loaded = ctypes.CDLL(build(CODEC_SRC))
            loaded.mmf_tiff_chunks_decode.argtypes = [
                ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_int64, ctypes.c_int]
            loaded.mmf_tiff_chunks_decode.restype = ctypes.c_int
            loaded.mmf_png_unfilter.argtypes = [
                ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
                ctypes.c_int, ctypes.c_void_p]
            loaded.mmf_png_unfilter.restype = ctypes.c_int64
            loaded.mmf_jpeg_decode.argtypes = [ctypes.c_void_p,
                                               ctypes.c_int64, ctypes.c_int]
            loaded.mmf_jpeg_decode.restype = ctypes.c_int
            loaded.mmf_jpeg_frame_size.restype = ctypes.c_int64
            loaded.mmf_jpeg_lossless_decode.argtypes = [
                ctypes.c_char_p, ctypes.c_int64, ctypes.c_char_p,
                ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.c_void_p]
            loaded.mmf_jpeg_lossless_decode.restype = ctypes.c_int
            loaded.mmf_zstd_decode.argtypes = [
                ctypes.c_char_p, ctypes.c_int64,
                ctypes.POINTER(ctypes.c_void_p),
                ctypes.POINTER(ctypes.c_int64),
                ctypes.POINTER(ctypes.c_int64)]
            loaded.mmf_zstd_decode.restype = ctypes.c_int
            loaded.mmf_zstd_free.argtypes = [ctypes.c_void_p]
            loaded.mmf_zstd_free.restype = None
            loaded.mmf_lzf_decode.argtypes = [
                ctypes.c_char_p, ctypes.c_int64, ctypes.c_void_p,
                ctypes.c_int64, ctypes.POINTER(ctypes.c_int64)]
            loaded.mmf_lzf_decode.restype = ctypes.c_int
            _codec_lib = loaded
        return _codec_lib


def zstd_decode(data: bytes) -> bytes:
    """Every Zstandard frame of ``data`` decoded by the C++ decoder
    (``mmf_zstd_decode``), as ``utils/zstd.decompress`` (its plain
    version) decodes them: a corrupt stream raises ``ValueError``, a
    frame that names a dictionary ``NotImplementedError``, a window over
    2^27 bytes ``ValueError``."""
    from multimodalfusion_tpu_torch.utils import zstd
    data = bytes(data)
    out, n, detail = ctypes.c_void_p(), ctypes.c_int64(), ctypes.c_int64()
    lib_ = codec_lib()
    rc = lib_.mmf_zstd_decode(data, len(data), ctypes.byref(out),
                              ctypes.byref(n), ctypes.byref(detail))
    if rc == -2:
        raise zstd.dictionary_error(detail.value)
    if rc == -3:
        raise zstd.window_error(detail.value)
    if rc:
        raise ValueError("corrupt Zstandard data")
    try:
        return ctypes.string_at(out, n.value) if n.value else b""
    finally:
        lib_.mmf_zstd_free(out)


def lzf_decode(data: bytes, size: int) -> bytes:
    """The LZF stream ``data`` decoded by the C++ decoder
    (``mmf_lzf_decode``) into at most ``size`` bytes, as
    ``utils/lzf.decompress`` (its plain version) decodes it: a corrupt
    stream, or one that decodes past ``size``, raises ``ValueError``."""
    data = bytes(data)
    out = ctypes.create_string_buffer(max(int(size), 1))
    n = ctypes.c_int64()
    rc = codec_lib().mmf_lzf_decode(data, len(data), out, int(size),
                                    ctypes.byref(n))
    if rc == -2:
        raise ValueError("lzf: output past its size")
    if rc:
        raise ValueError("lzf: corrupt stream")
    return out.raw[:n.value]


class _J2kBlock(ctypes.Structure):
    """csrc/j2k.cpp's MmfJ2kBlock: one code-block to decode."""
    _fields_ = [("data", ctypes.c_void_p), ("len", ctypes.c_int64),
                ("seg_len", ctypes.c_void_p), ("seg_passes", ctypes.c_void_p),
                ("nsegs", ctypes.c_int32), ("w", ctypes.c_int32),
                ("h", ctypes.c_int32), ("orient", ctypes.c_int32),
                ("bpno", ctypes.c_int32), ("numbps", ctypes.c_int32),
                ("roishift", ctypes.c_int32), ("style", ctypes.c_int32),
                ("reversible", ctypes.c_int32), ("stepsize", ctypes.c_float),
                ("out", ctypes.c_void_p), ("out_stride", ctypes.c_int64),
                ("status", ctypes.c_int32)]


class _J2kEnc(ctypes.Structure):
    """csrc/j2k.cpp's MmfJ2kEnc: one code-block to encode."""
    _fields_ = [("coef", ctypes.c_void_p), ("w", ctypes.c_int32),
                ("h", ctypes.c_int32), ("orient", ctypes.c_int32),
                ("style", ctypes.c_int32), ("out", ctypes.c_void_p),
                ("len", ctypes.c_int64), ("rates", ctypes.c_int32 * 96),
                ("npasses", ctypes.c_int32), ("planes", ctypes.c_int32),
                ("status", ctypes.c_int32)]


def j2k_lib() -> ctypes.CDLL:
    """The loaded JPEG 2000 library (``csrc/j2k.cpp``), built on first
    use; its structs are checked against ctypes'."""
    global _j2k_lib
    with _lock:
        if _j2k_lib is None:
            loaded = ctypes.CDLL(build(J2K_SRC))
            loaded.mmf_j2k_block_size.restype = ctypes.c_int64
            loaded.mmf_j2k_enc_size.restype = ctypes.c_int64
            if (loaded.mmf_j2k_block_size() != ctypes.sizeof(_J2kBlock)
                    or loaded.mmf_j2k_enc_size() != ctypes.sizeof(_J2kEnc)):
                raise RuntimeError("csrc/j2k.cpp's structs and native.py's "
                                   "_J2kBlock / _J2kEnc disagree")
            loaded.mmf_j2k_decode_blocks.argtypes = [
                ctypes.c_void_p, ctypes.c_int64, ctypes.c_int]
            loaded.mmf_j2k_decode_blocks.restype = ctypes.c_int
            loaded.mmf_j2k_idwt.argtypes = [
                ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
                ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
            loaded.mmf_j2k_idwt.restype = ctypes.c_int
            loaded.mmf_j2k_encode_blocks.argtypes = [
                ctypes.c_void_p, ctypes.c_int64, ctypes.c_int]
            loaded.mmf_j2k_encode_blocks.restype = ctypes.c_int
            loaded.mmf_j2k_free.argtypes = [ctypes.c_void_p]
            loaded.mmf_j2k_free.restype = None
            _j2k_lib = loaded
        return _j2k_lib


def j2k_decode_blocks(jobs: Sequence, n_threads: int = 0) -> None:
    """Tier 1 of JPEG 2000 code-blocks (``utils/j2k.BlockJob``s): each
    block's coefficients decoded, ROI-unshifted and halved (5/3) or scaled
    by its half step (9/7) into its ``out`` view, as
    ``j2k.decode_blocks_plain`` does; the blocks over ``n_threads`` host
    threads (<= 0: one per hardware thread).  Counts one call in
    ``j2k_decode_blocks.calls``."""
    lib_ = j2k_lib()
    arr = (_J2kBlock * len(jobs))()
    keep = []
    for cb, job in zip(arr, jobs):
        out = job.out
        want = np.int32 if job.reversible else np.float32
        if (out.dtype != want or out.ndim != 2 or out.strides[1]
                != out.itemsize or out.shape != (job.h, job.w)):
            raise ValueError(f"a code-block's output must be {want.__name__} "
                             f"[{job.h}, {job.w}] with contiguous rows; got "
                             f"{out.dtype} {out.shape} strides {out.strides}")
        data = np.frombuffer(job.data, np.uint8)
        lens = np.asarray(job.seg_lens, np.int32)
        passes = np.asarray(job.seg_passes, np.int32)
        keep += [data, lens, passes]
        cb.data = data.ctypes.data if data.size else None
        cb.len = data.size
        cb.seg_len, cb.seg_passes = lens.ctypes.data, passes.ctypes.data
        cb.nsegs = lens.size
        cb.w, cb.h, cb.orient = job.w, job.h, job.orient
        cb.bpno, cb.numbps, cb.roishift = job.bpno, job.numbps, job.roishift
        cb.style, cb.reversible = job.style, int(job.reversible)
        cb.stepsize = job.stepsize
        cb.out = out.ctypes.data
        cb.out_stride = out.strides[0] // out.itemsize
    rc = lib_.mmf_j2k_decode_blocks(arr, len(jobs), n_threads)
    j2k_decode_blocks.calls += 1
    if rc:
        raise ValueError(f"JPEG 2000 tier-1 decode failed (status {rc})")


j2k_decode_blocks.calls = 0


def j2k_idwt(plane: np.ndarray, tc, n_threads: int = 0) -> None:
    """The inverse DWT of one tile-component (``plane``: int32 for 5/3,
    float32 for 9/7, [h, w] in the subband layout, rows contiguous) in
    place, as ``j2k.idwt_plain`` does; rows, then columns, of each level
    split across ``n_threads`` host threads.  Counts one call in
    ``j2k_idwt.calls``."""
    rev = tc.coding.reversible
    if (plane.dtype != (np.int32 if rev else np.float32) or plane.ndim != 2
            or plane.strides[1] != plane.itemsize):
        raise ValueError(f"j2k_idwt needs {'int32' if rev else 'float32'} "
                         f"[h, w] with contiguous rows; got {plane.dtype} "
                         f"{plane.shape}")
    res = np.array([[r.x0, r.y0, r.x1, r.y1] for r in tc.resolutions],
                   np.int32)
    lib_ = j2k_lib()
    lib_.mmf_j2k_idwt(plane.ctypes.data, plane.strides[0] // plane.itemsize,
                      int(rev), res.ctypes.data, len(res), n_threads)
    j2k_idwt.calls += 1


j2k_idwt.calls = 0


def j2k_encode_blocks(coefs: Sequence[np.ndarray], orients: Sequence[int],
                      style: int, n_threads: int = 0) -> list:
    """Tier 1 of the lossless JPEG 2000 encoder for each code-block
    (int32 [h, w] C-contiguous coefficients, ROI shift applied) of band
    orientation ``orients[i]``: ``j2k.EncodedBlock``s equal to
    ``j2k.t1_encode_plain``'s, over ``n_threads`` host threads.  Counts one
    call in ``j2k_encode_blocks.calls``."""
    from multimodalfusion_tpu_torch.utils import j2k
    lib_ = j2k_lib()
    arr = (_J2kEnc * len(coefs))()
    for ce, cf, o in zip(arr, coefs, orients):
        if cf.dtype != np.int32 or cf.ndim != 2 or not cf.flags.c_contiguous:
            raise ValueError(f"j2k_encode_blocks takes int32 [h, w] "
                             f"C-contiguous; got {cf.dtype} {cf.shape}")
        ce.coef = cf.ctypes.data
        ce.h, ce.w = cf.shape
        ce.orient, ce.style = o, style
    rc = lib_.mmf_j2k_encode_blocks(arr, len(coefs), n_threads)
    j2k_encode_blocks.calls += 1
    out = []
    try:
        for ce in arr:
            if ce.status:
                continue
            data = ctypes.string_at(ce.out, ce.len) if ce.len else b""
            rates = list(ce.rates[:ce.npasses])
            out.append(j2k.EncodedBlock(
                data, j2k.clip_rates(rates, j2k.segment_ends(ce.npasses,
                                                             style)),
                ce.planes))
    finally:
        for ce in arr:
            if ce.out:
                lib_.mmf_j2k_free(ce.out)
    if rc:
        raise ValueError(f"JPEG 2000 tier-1 encode failed (status {rc}: a "
                         "code-block with 31 or more bit-planes)")
    return out


j2k_encode_blocks.calls = 0


def pad_bags_into(bags: Sequence[Optional[np.ndarray]], out: np.ndarray,
                  mask: np.ndarray) -> None:
    """Write the bags (``None`` or [n_i, D] float32, C-contiguous) into
    ``out`` [B, n_pad, D] and ``mask`` [B, n_pad] (float32, C-contiguous):
    each bag's rows, zeros after them, and 1.0 / 0.0 in the mask, one
    thread per hardware thread (at most one per bag).  Rows past n_pad
    are dropped."""
    B, n_pad, D = out.shape
    if (len(bags) != B or mask.shape != (B, n_pad)
            or out.dtype != np.float32 or mask.dtype != np.float32
            or not (out.flags.c_contiguous and mask.flags.c_contiguous)):
        raise ValueError(f"out must be float32 [B, n_pad, D] and mask "
                         f"[B, n_pad] for {len(bags)} bags, C-contiguous; "
                         f"got {out.dtype} {out.shape}, {mask.dtype} "
                         f"{mask.shape}")
    ptrs = (ctypes.c_void_p * B)()
    lens = (ctypes.c_int64 * B)()
    for i, b in enumerate(bags):
        if b is None or b.shape[0] == 0:
            continue
        if (b.ndim != 2 or b.shape[1] != D or b.dtype != np.float32
                or not b.flags.c_contiguous):
            raise ValueError(f"bag {i}: expected float32 [n, {D}] "
                             f"C-contiguous, got {b.dtype} {b.shape}")
        ptrs[i] = b.ctypes.data
        lens[i] = b.shape[0]
    lib().mmf_pad_bags_f32(ptrs, lens, B, n_pad, D, out.ctypes.data,
                           mask.ctypes.data, 0)


def _host_f32(x: Union[np.ndarray, torch.Tensor]) -> tuple:
    """(address, element count) of a C-contiguous float32 array on the
    host: a numpy array or a CPU tensor.  Anything else raises."""
    if isinstance(x, torch.Tensor):
        if x.device.type != "cpu":
            raise ValueError(f"f32_to_bf16 casts host arrays; got a tensor "
                             f"on {x.device}")
        if x.dtype != torch.float32 or not x.is_contiguous():
            raise ValueError(f"f32_to_bf16 needs contiguous float32; got "
                             f"{x.dtype} contiguous={x.is_contiguous()}")
        return x.data_ptr(), x.numel()
    if not isinstance(x, np.ndarray):
        raise TypeError(f"f32_to_bf16 takes a numpy array or a CPU tensor, "
                        f"not {type(x).__name__}")
    if x.dtype != np.float32 or not x.flags.c_contiguous:
        raise ValueError(f"f32_to_bf16 needs C-contiguous float32; got "
                         f"{x.dtype} c_contiguous={x.flags.c_contiguous}")
    return x.ctypes.data, x.size


def f32_to_bf16(x: Union[np.ndarray, torch.Tensor],
                n_threads: int = 0) -> torch.Tensor:
    """``x`` (C-contiguous float32, numpy or a CPU tensor) rounded to
    nearest even as a CPU bfloat16 tensor of its shape, a NaN as its sign
    | 0x7FC0 (JAX native.py:119; PyTorch's own cast keeps more of the
    payload).  ``n_threads`` <= 0: one thread per hardware thread, each
    converting at least 2**20 elements."""
    src, n = _host_f32(x)
    out = torch.empty(tuple(x.shape), dtype=torch.bfloat16)
    lib().mmf_f32_to_bf16(src, out.data_ptr(), n, n_threads)
    return out


def f32_to_bf16_plain(x: Union[np.ndarray, torch.Tensor]) -> torch.Tensor:
    """``f32_to_bf16`` on numpy uint32 bits: the oracle of the tests and
    ``chip_smoke.py``."""
    _host_f32(x)
    bits = np.asarray(x).view(np.uint32)
    out = ((bits + 0x7FFF + ((bits >> 16) & 1)) >> 16).astype(np.uint16)
    nan = ((bits & 0x7F800000) == 0x7F800000) & ((bits & 0x007FFFFF) != 0)
    out[nan] = ((bits[nan] >> 16) & 0x8000) | 0x7FC0
    return torch.from_numpy(out.view(np.int16)).view(torch.bfloat16)


def read_files(paths: Sequence[Union[str, os.PathLike]],
               sizes: Sequence[int],
               n_threads: int = 0) -> Optional[List[np.ndarray]]:
    """The first ``sizes[i]`` bytes of each file as uint8 arrays, read in
    parallel: each thread reads a contiguous range of files, at most one
    thread a file (``n_threads`` <= 0: one per hardware thread).  None
    when any file is missing or shorter than its size (JAX
    native.py:152)."""
    if len(paths) != len(sizes):
        raise ValueError(f"{len(paths)} paths but {len(sizes)} sizes")
    n = len(paths)
    bufs = [np.empty(int(s), np.uint8) for s in sizes]
    c_paths = (ctypes.c_char_p * n)(*[os.fsencode(p) for p in paths])
    c_sizes = (ctypes.c_int64 * n)(*[int(s) for s in sizes])
    c_bufs = (ctypes.c_void_p * n)(*[b.ctypes.data for b in bufs])
    done = lib().mmf_read_files(c_paths, c_sizes, c_bufs, n, n_threads)
    return bufs if done == n else None


def read_files_plain(paths: Sequence[Union[str, os.PathLike]],
                     sizes: Sequence[int]) -> Optional[List[np.ndarray]]:
    """``read_files`` by Python reads, one file after another: the oracle
    of the tests and ``chip_smoke.py``."""
    if len(paths) != len(sizes):
        raise ValueError(f"{len(paths)} paths but {len(sizes)} sizes")
    out = []
    for p, s in zip(paths, sizes):
        try:
            with open(p, "rb") as f:
                data = f.read(int(s))
        except FileNotFoundError:
            return None
        if len(data) != s:
            return None
        out.append(np.frombuffer(data, np.uint8))
    return out


def jpeg_lossless_decode(entropy: bytes, counts: bytes, symbols: bytes,
                         rows: int, cols: int, psv: int,
                         default_pred: int) -> Optional[np.ndarray]:
    """T.81 process-14 entropy decode and prediction of one frame (JAX
    native.py:133-150): the entropy-coded bytes with the stuffing removed,
    the DHT's 16 code counts and its symbols (their lengths checked by the
    caller), the predictor selection value and the first sample's
    prediction.  Returns uint16 [rows, cols] without the point transform,
    or None when the stream is malformed (the caller then raises the
    precise error).  Counts one call in ``jpeg_lossless_decode.calls``.
    It runs ``csrc/imgcodec.cpp``'s predictor loop, which the lossless
    JPEG frames of ``utils/jpeg.py`` run too."""
    out = np.empty((rows, cols), np.uint16)
    rc = codec_lib().mmf_jpeg_lossless_decode(
        bytes(entropy), len(entropy), bytes(counts), bytes(symbols), rows,
        cols, psv, default_pred, out.ctypes.data)
    jpeg_lossless_decode.calls += 1
    return out if rc == 0 else None


jpeg_lossless_decode.calls = 0
