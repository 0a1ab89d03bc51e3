"""The port's Zstandard decoders -- the plain version
(``utils/zstd.decompress``) and the C++ one (``native.zstd_decode``,
``mmf_zstd_decode`` in ``csrc/imgcodec.cpp``) -- held to libzstd through
the ``zstandard`` module, and to each other, exactly (tolerance 0):

- frames libzstd writes at levels 1, 3, 9 (libtiff's default), 19 and
  22, with and without a checksum and a content size; inputs over 128
  KiB (several blocks); a match from more than a block back; long
  distance matching; skippable frames; concatenated frames; RLE and
  raw blocks; a cap (libtiff's full chunk buffer);
- corrupt streams (a wrong checksum, a truncated block, bad FSE table
  descriptions, a dictionary ID, a window over 2^27) raise the stated
  error in both decoders, and random damage gives both the same outcome;
- ``tools/zstd_writer.py``'s frames, which libzstd and both decoders
  decode to the input, through every table mode the writer has;
- the committed fixtures of ``multimodalfusion_tpu_torch/testdata/zstd``
  decode to their MANIFEST digests.
"""
import hashlib
import importlib.util
import io
import json
import os
import struct
from collections import Counter

import numpy as np
import pytest
import zstandard

from multimodalfusion_tpu_torch import native
from multimodalfusion_tpu_torch.utils import tiff, zstd

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(ROOT, "multimodalfusion_tpu_torch", "testdata",
                        "zstd")


def _writer():
    spec = importlib.util.spec_from_file_location(
        "zstd_writer", os.path.join(ROOT, "tools", "zstd_writer.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


zw = _writer()


def _data(n: int, seed: int) -> bytes:
    """``n`` seeded bytes in parts: words of a small vocabulary, noise,
    runs, a 12-symbol alphabet and image-like residuals."""
    rng = np.random.default_rng(seed)
    words = [rng.integers(97, 123, rng.integers(2, 9), np.uint8).tobytes()
             for _ in range(200)]
    parts = [b" ".join(words[i] for i in rng.integers(0, 200, n // 12)),
             rng.integers(0, 256, n // 8, np.uint8).tobytes(),
             b"".join(bytes([int(b)]) * int(k) for b, k in zip(
                 rng.integers(0, 256, 64), rng.integers(1, 200, 64))),
             rng.integers(0, 12, n // 8, np.uint8).tobytes(),
             (rng.integers(-6, 7, n // 4) % 256).astype(np.uint8).tobytes()]
    out = b"".join(parts)
    while len(out) < n:
        out += out[:n - len(out)]
    return out[:n]


def _libzstd(frame: bytes) -> bytes:
    return zstandard.ZstdDecompressor().stream_reader(
        io.BytesIO(frame), read_across_frames=True).read()


def _both(frame: bytes, want: bytes) -> None:
    assert zstd.decompress(frame) == want
    assert native.zstd_decode(frame) == want


def _blocks(frame: bytes):
    """(type, size) of each block of the single frame ``frame``."""
    fh = zstd.frame_header(frame)
    pos, out = fh.size, []
    while True:
        bh = int.from_bytes(frame[pos:pos + 3], "little")
        out.append(((bh >> 1) & 3, bh >> 3))
        pos += 3 + (1 if (bh >> 1) & 3 == 1 else bh >> 3)
        if bh & 1:
            return out


# ---- (a) frames libzstd writes

@pytest.mark.parametrize("content_size", [True, False])
@pytest.mark.parametrize("checksum", [True, False])
@pytest.mark.parametrize("level", [1, 3, 9, 19, 22])
def test_libzstd_levels_equal_input(level, checksum, content_size):
    d = _data(40000, level)
    frame = zstandard.ZstdCompressor(
        level=level, write_checksum=checksum,
        write_content_size=content_size).compress(d)
    assert zstd.frame_header(frame).checksum == checksum
    assert (zstd.frame_header(frame).content_size is not None) == (
        content_size)
    _both(frame, d)


@pytest.mark.parametrize("level", [1, 9, 19])
def test_inputs_over_128_kib_take_several_blocks(level):
    d = _data(300000, 10 + level)
    frame = zstandard.ZstdCompressor(level=level,
                                     write_checksum=True).compress(d)
    assert len(_blocks(frame)) >= 3
    _both(frame, d)


def test_a_match_from_more_than_a_block_back():
    """Noise, 140 KiB of one byte, the noise again: its second copy
    matches from past the previous block, in a window descriptor frame
    (no content size)."""
    noise = np.random.default_rng(3).integers(0, 256, 6000,
                                              np.uint8).tobytes()
    d = noise + b"\x07" * 140000 + noise
    frame = zstandard.ZstdCompressor(compression_params=(
        zstandard.ZstdCompressionParameters.from_level(
            19, window_log=18, write_content_size=False))).compress(d)
    assert len(frame) < 7000 and zstd.frame_header(frame).window == 1 << 18
    _both(frame, d)


def test_long_distance_matching():
    rng = np.random.default_rng(4)
    far = rng.integers(0, 256, 200000, np.uint8).tobytes()
    d = far + _data(30000, 4) + far
    frame = zstandard.ZstdCompressor(compression_params=(
        zstandard.ZstdCompressionParameters.from_level(
            3, window_log=20, enable_ldm=True,
            write_checksum=True))).compress(d)
    assert len(frame) < 300000
    _both(frame, d)


def test_skippable_and_concatenated_frames():
    a, b = _data(5000, 5), _data(7000, 6)
    skip = struct.pack("<II", 0x184D2A53, 5) + b"hello"
    frames = (skip + zstandard.ZstdCompressor(level=3).compress(a)
              + zstandard.ZstdCompressor(level=9, write_checksum=True)
              .compress(b) + struct.pack("<II", 0x184D2A5F, 0))
    assert _libzstd(frames) == a + b
    _both(frames, a + b)


@pytest.mark.parametrize("kind", ["rle", "raw", "empty"])
def test_rle_raw_and_empty_blocks(kind):
    d = {"rle": b"\x2a" * 200000, "empty": b"",
         "raw": np.random.default_rng(7).integers(
             0, 256, 150000, np.uint8).tobytes()}[kind]
    frame = zstandard.ZstdCompressor(level=3).compress(d)
    want = {"rle": 1, "raw": 0, "empty": 0}[kind]
    assert want in {t for t, _ in _blocks(frame)}
    _both(frame, d)


@pytest.mark.parametrize("cap", [0, 1, 70000, 131072, 131073, 199999])
def test_a_cap_stops_the_output_there(cap):
    """As libtiff stops when a chunk's buffer is full: the output cut at
    ``cap``, through ``zstd.decompress`` and the C++ chunk decoder."""
    d = _data(200000, 8)
    frame = zstandard.ZstdCompressor(level=3,
                                     write_checksum=True).compress(d)
    assert zstd.decompress(frame, cap) == d[:cap]
    out = np.zeros(cap, np.uint8)
    assert tiff.decode_chunks(tiff.ZSTD, [frame], [out]) == [cap]
    assert out.tobytes() == d[:cap]


def _manifest():
    with open(os.path.join(FIXTURES, "MANIFEST.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("entry", _manifest()["fixtures"],
                         ids=lambda e: e["name"])
def test_fixtures_decode_to_their_digests(entry):
    with open(os.path.join(FIXTURES, entry["file"]), "rb") as f:
        frame = f.read()
    assert len(frame) <= 8192
    for out in (zstd.decompress(frame), native.zstd_decode(frame)):
        assert len(out) == entry["size"]
        assert hashlib.sha256(out).hexdigest() == entry["sha256"]


# ---- (b) corrupt streams

def _frame(body: bytes, n: int, fhd: int = 0x20, last: bool = True,
           extra: bytes = b"") -> bytes:
    """A single-segment frame of one compressed block ``body`` that
    regenerates ``n`` (< 256) bytes."""
    return (struct.pack("<IB", zstd.MAGIC, fhd) + extra + bytes([n])
            + struct.pack("<I", int(last) | (2 << 1) | (len(body) << 3))[:3]
            + body)


def _raises(frame, error, match, native_match="corrupt"):
    """Both decoders raise ``error`` (the plain one's message matching
    ``match``, the C++ one's ``native_match``), and so does libzstd."""
    with pytest.raises(error, match=match):
        zstd.decompress(frame)
    with pytest.raises(error, match=native_match):
        native.zstd_decode(frame)
    with pytest.raises(zstandard.ZstdError):
        zstandard.ZstdDecompressor().decompress(frame,
                                                max_output_size=1 << 20)


def test_a_wrong_checksum_raises():
    frame = bytearray(zstandard.ZstdCompressor(
        write_checksum=True).compress(_data(3000, 9)))
    frame[-1] ^= 0x40
    _raises(bytes(frame), ValueError, "checksum|corrupt")


@pytest.mark.parametrize("cut", [1, 3, 100])
def test_a_truncated_block_raises(cut):
    frame = zstandard.ZstdCompressor(level=9).compress(_data(9000, 10))
    _raises(frame[:-cut], ValueError, "corrupt")


@pytest.mark.parametrize("mode,ncount", [
    (2 << 6, b"\x0f\xff\xff"),
    (2 << 4, zw.ncount([2] * 31 + [1, 1], 6))],
    ids=["log_over_9", "offset_codes_past_31"])
def test_a_bad_fse_table_raises(mode, ncount):
    """Ten raw literals and one sequence, one of its tables FSE-coded: a
    literal-length accuracy log of 20; an offset table of 33 codes."""
    body = bytes([10 << 3]) + b"abcdefghij" + b"\x01" + bytes(
        [mode]) + ncount + b"\x01"
    _raises(_frame(body, 200), ValueError, "FSE")


def test_a_dictionary_id_raises_naming_it():
    frame = struct.pack("<IBB", zstd.MAGIC, 0x21, 42) + bytes([3]) + (
        struct.pack("<I", 1 | (3 << 3))[:3] + b"abc")
    for fn in (zstd.decompress, native.zstd_decode):
        with pytest.raises(NotImplementedError, match="dictionary ID 42"):
            fn(frame)
    with pytest.raises(zstandard.ZstdError):
        _libzstd(frame)
    with pytest.raises(NotImplementedError, match="dictionary ID 42"):
        tiff.decode_chunks(tiff.ZSTD, [frame], [np.zeros(3, np.uint8)])


def test_a_window_over_2_27_raises_unless_the_content_size_fits():
    """A 2^28 window descriptor: refused in a frame without a content
    size (libzstd's streaming limit, which libtiff meets), read in one
    that declares a content size the output holds (libzstd's single
    pass)."""
    block = struct.pack("<I", 1 | (5 << 3))[:3] + b"hello"
    bare = struct.pack("<IBB", zstd.MAGIC, 0x00, 18 << 3) + block
    _raises(bare, ValueError, "window of 268435456 bytes",
            "window of 268435456 bytes")
    with pytest.raises(ValueError, match="window"):
        tiff.decode_chunks(tiff.ZSTD, [bare], [np.zeros(5, np.uint8)])
    sized = struct.pack("<IBBI", zstd.MAGIC, 0x80, 18 << 3, 5) + block
    assert zstandard.ZstdDecompressor().decompress(sized) == b"hello"
    _both(sized, b"hello")
    assert zstd.decompress(sized, 5) == b"hello"
    with pytest.raises(ValueError, match="window"):
        zstd.decompress(sized, 4)


@pytest.mark.parametrize("seed", range(16))
def test_random_damage_gives_both_decoders_one_outcome(seed):
    rng = np.random.default_rng(100 + seed)
    d = _data(20000, seed)
    frame = bytearray(zstandard.ZstdCompressor(
        level=[1, 9, 19][seed % 3], write_checksum=seed % 2 == 0).compress(d))
    for at in rng.integers(4, len(frame), 1 + seed % 3):
        frame[at] ^= 1 << int(rng.integers(0, 8))
    got = []
    for fn in (zstd.decompress, native.zstd_decode):
        try:
            got.append(fn(bytes(frame)))
        except (ValueError, NotImplementedError) as e:
            got.append(type(e))
    assert got[0] == got[1]


# ---- (c) tools/zstd_writer.py's frames

def _many_sequences(n: int, seed: int) -> bytes:
    """3-byte words of 64 and one byte of noise: a sequence every 4
    bytes, over 32511 in a block (the 3-byte sequence count)."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, 256, (64, 3), np.uint8)
    k = n // 4
    return np.concatenate([toks[rng.integers(0, 64, k)],
                           rng.integers(0, 256, (k, 1), np.uint8)],
                          1).tobytes()


def _one_literal(seed: int) -> bytes:
    """2 KiB of noise, then pieces of it each after one "Z": the second
    block's literals are all "Z"."""
    noise = np.random.default_rng(seed).integers(0, 256, 2048, np.uint8)
    return noise.tobytes() + b"".join(
        b"Z" + noise[k * 90:k * 90 + 80].tobytes() for k in range(22))


WRITER_CASES = {
    "mixed": (lambda: _data(60000, 20), {}),
    "mixed_checksum": (lambda: _data(60000, 21), dict(checksum=True)),
    "mixed_window": (lambda: _data(60000, 22),
                     dict(window_log=16, content_size=False)),
    "mixed_window_sized": (lambda: _data(60000, 23),
                           dict(window_log=17, checksum=True)),
    "small_blocks": (lambda: _data(60000, 24), dict(block=2048)),
    "min_match_4": (lambda: _data(60000, 25), dict(min_match=4)),
    "over_128_kib": (lambda: _data(300000, 26), dict(checksum=True)),
    "many_sequences": (lambda: _many_sequences(140000, 27),
                       dict(min_match=3)),
    "small_alphabet": (lambda: np.random.default_rng(28).integers(
        0, 12, 3000, np.uint8).tobytes(), {}),
    "tiny": (lambda: b"abracadabra, abracadabra!", {}),
    "runs": (lambda: b"\x00" * 70000 + b"\x01" * 70000, {}),
    "noise": (lambda: np.random.default_rng(29).integers(
        0, 256, 5000, np.uint8).tobytes(), dict(checksum=True)),
    "empty": (lambda: b"", {}),
    "rle_literals": (lambda: _one_literal(30), dict(block=2048)),
}


@pytest.mark.parametrize("case", list(WRITER_CASES))
def test_writer_frames_decode_to_the_input(case):
    make, kw = WRITER_CASES[case]
    d = make()
    stats = Counter()
    frame = zw.compress(d, stats=stats, **kw)
    assert _libzstd(frame) == d
    _both(frame, d)


def test_writer_takes_every_table_mode():
    """Over the cases above (run here again if they were not): every
    literal and sequence table mode, repeat offsets, and raw, RLE and
    compressed blocks."""
    stats = Counter()
    for make, kw in WRITER_CASES.values():
        zw.compress(make(), stats=stats, **kw)
    want = ["block_raw", "block_rle", "block_compressed", "literals_raw",
            "literals_rle", "literals_treeless", "huffman_1_streams",
            "huffman_4_streams", "huffman_fse_weights",
            "huffman_direct_weights", "repeat_offsets"] + [
        f"{k}_{m}" for k in ("ll", "of", "ml")
        for m in ("predefined", "rle", "fse", "repeat")]
    assert [w for w in want if not stats[w]] == []
