"""Writes the Zstandard fixtures of ``multimodalfusion_tpu_torch/testdata/
zstd/`` and their ``MANIFEST.json``: small frames libzstd writes (through
the ``zstandard`` module), one for each path of the port's decoders that
libzstd's frames take -- compressed blocks at levels 1, 3, 9, 19 and 22
(predefined, FSE-coded, RLE and repeated tables; treeless literals),
frames without a content size, checksums, a match from more than a
block back, long distance matching, skippable and concatenated frames,
RLE and raw blocks, Huffman weights sent directly, a single Huffman
stream, RLE literals, treeless literals and repeated tables in flushed
blocks, RLE tables, and the tile of an image after TIFF's horizontal
predictor.  Each is at most 8 KB.  The manifest records the ``zstandard``
and libzstd versions, what each frame covers and the SHA-256 and size of
what libzstd decodes from it.  ``chip_smoke.py`` (its ``[zstd]`` phase)
holds the port's C++ and plain decoders to those digests on a machine
without a zstd module; ``tests/test_torch_zstd.py`` does here.  Run it
again only with the libzstd it records, or the frames change.

    python tools/make_zstd_fixtures.py
"""
import hashlib
import io
import json
import os
import struct

import numpy as np
import zstandard

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "multimodalfusion_tpu_torch", "testdata", "zstd")


def _text(n, seed):
    rng = np.random.default_rng(seed)
    words = [rng.integers(97, 123, rng.integers(2, 9), np.uint8).tobytes()
             for _ in range(60)]
    return b" ".join(words[i] for i in rng.integers(0, 60, n // 5))[:n]


def _noise(n, seed):
    return np.random.default_rng(seed).integers(0, 256, n,
                                                np.uint8).tobytes()


def _tile(seed):
    """A 48 x 48 RGB tile of smooth colour and noise, differenced along
    its rows (TIFF Predictor 2)."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[:48, :48]
    img = np.stack([120 + x, 80 + y, 160 + (x + y) // 2], -1)
    img = (img + rng.integers(-4, 5, img.shape)).astype(np.uint8)
    d = img.astype(np.int16)
    d[:, 1:] -= img[:, :-1]
    return (d & 255).astype(np.uint8).tobytes()


def _params(level, **kw):
    return zstandard.ZstdCompressor(compression_params=(
        zstandard.ZstdCompressionParameters.from_level(level, **kw)))


def _blocks(parts, level=19):
    """One frame of ``parts``, a block (or more) each: the stream
    flushed after every part."""
    c = zstandard.ZstdCompressor(level=level).compressobj()
    out = b""
    for p in parts:
        out += c.compress(p) + c.flush(zstandard.COMPRESSOBJ_FLUSH_BLOCK)
    return out + c.flush()


def _specs():
    far = _noise(3000, 7)
    nz = _noise(4000, 3)
    rec = _noise(64, 15)
    return [
        ("level1_checksum", "level 1, checksum, content size",
         lambda: zstandard.ZstdCompressor(
             level=1, write_checksum=True).compress(_text(20000, 1))),
        ("level3_no_size", "level 3, window descriptor, no content size",
         lambda: zstandard.ZstdCompressor(
             level=3, write_content_size=False).compress(_text(20000, 2))),
        ("level9_multiblock", "level 9 (libtiff's), 3 blocks over 128 KiB",
         lambda: zstandard.ZstdCompressor(level=9, write_checksum=True)
         .compress(_text(1500, 3) * 200)),
        ("level19_tables", "level 19, FSE-coded tables",
         lambda: zstandard.ZstdCompressor(level=19).compress(
             _text(30000, 4))),
        ("level22_ultra", "level 22",
         lambda: zstandard.ZstdCompressor(level=22).compress(
             _text(30000, 5))),
        ("far_match", "a match from more than a block back, window 2^18",
         lambda: _params(19, window_log=18, write_content_size=False)
         .compress(far + b"\x05" * 140000 + far)),
        ("long_distance", "long distance matching, window 2^20",
         lambda: _params(3, window_log=20, enable_ldm=True,
                         write_checksum=True)
         .compress(far + _text(4000, 8) * 40 + far)),
        ("skippable_concat", "a skippable frame, then two frames",
         lambda: struct.pack("<II", 0x184D2A50, 4) + b"skip"
         + zstandard.ZstdCompressor(level=1).compress(_text(3000, 9))
         + zstandard.ZstdCompressor(level=9, write_checksum=True)
         .compress(_text(3000, 10))),
        ("rle_block", "RLE blocks",
         lambda: zstandard.ZstdCompressor(level=3).compress(
             b"\xab" * 300000)),
        ("raw_block", "a raw block",
         lambda: zstandard.ZstdCompressor(level=3).compress(
             _noise(4000, 11))),
        ("direct_weights", "Huffman weights sent directly (12 symbols)",
         lambda: zstandard.ZstdCompressor(level=3).compress(
             np.random.default_rng(12).integers(0, 12, 6000, np.uint8)
             .tobytes())),
        ("one_stream", "a single Huffman stream (under 256 literals)",
         lambda: zstandard.ZstdCompressor(level=19).compress(
             _text(200, 13))),
        ("rle_literals", "RLE literals: a block of pieces of the first, "
         "each after a Z",
         lambda: _blocks([nz, b"".join(b"Z" + nz[p:p + 200] for p in (
             np.random.default_rng(0).integers(0, 3800, 70)))
             + b"Z" * 16])),
        ("repeat_tables", "five flushed blocks: treeless literals, "
         "repeated tables",
         lambda: _blocks([_text(20000, 4)[i:i + 4000]
                          for i in range(0, 20000, 4000)])),
        ("rle_tables", "RLE sequence tables: 64-byte records that differ "
         "in their first byte",
         lambda: zstandard.ZstdCompressor(level=19).compress(b"".join(
             bytes([k]) + rec[1:] for k in range(100)))),
        ("tile_predictor2", "a 48 x 48 RGB tile after Predictor 2, level 9",
         lambda: zstandard.ZstdCompressor(level=9).compress(_tile(14))),
    ]


def main() -> int:
    os.makedirs(OUT, exist_ok=True)
    entries = []
    for name, covers, make in _specs():
        frame = make()
        if len(frame) > 8192:
            raise SystemExit(f"{name}: {len(frame)} bytes, over 8 KB")
        out = zstandard.ZstdDecompressor().stream_reader(
            io.BytesIO(frame), read_across_frames=True).read()
        with open(os.path.join(OUT, name + ".zst"), "wb") as f:
            f.write(frame)
        entries.append(dict(name=name, file=name + ".zst", covers=covers,
                            size=len(out),
                            sha256=hashlib.sha256(out).hexdigest()))
        print(f"{name}: {len(frame)} bytes -> {len(out)}")
    manifest = dict(zstandard=zstandard.__version__,
                    libzstd=".".join(map(str, zstandard.ZSTD_VERSION)),
                    fixtures=entries)
    with open(os.path.join(OUT, "MANIFEST.json"), "w") as f:
        json.dump(manifest, f, indent=1)
        f.write("\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
