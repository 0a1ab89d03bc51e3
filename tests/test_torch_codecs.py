"""The port's image decoders against PIL (libjpeg-turbo, libpng) and
against their own plain versions, bit for bit (tolerance 0):

- baseline JPEG (``utils/jpeg.py``, C++ in ``csrc/imgcodec.cpp``): PIL's
  files at 4:4:4, 4:2:2 and 4:2:0, gray, with restart markers, optimised
  Huffman tables and 16-bit quantisation tables, at odd and tiny sizes;
  files of this test's own encoder for what PIL does not write (4:4:0,
  4:1:1, chroma sampled above luma, one scan per component, an Adobe
  marker, 'R', 'G', 'B' component ids, streams without Huffman
  tables); the refusals (12-bit, arithmetic coding) and corrupt scans,
  baseline and progressive (progressive and four-component frames:
  tests/test_torch_jpeg_progressive.py);
- TIFF LZW and PackBits (``utils/tiff.py``): the C++ batch and the plain
  versions equal the source bytes, on libtiff's chunks and on this
  test's encoders' (clear codes, the KwKwK case, 12-bit codes, no-op
  PackBits headers);
- PNG (``utils/png.py``): every colour type and bit depth PIL reads,
  Adam7 and every row filter, as PIL holds the pixels and as its
  ``convert("RGB")`` gives them.
"""
import io
import struct
import zlib

import numpy as np
import pytest
from PIL import Image

from multimodalfusion_tpu_torch.utils import jpeg, png, tiff


def _image(h, w, c=3, seed=0):
    """A smooth gradient under noise: every AC band in use."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    base = np.stack([(x * 3 + y) % 256, (y * 2) % 256, (x + y * 5) % 256],
                    -1)[..., :c]
    px = np.clip(base + rng.integers(-20, 20, (h, w, c)), 0, 255)
    return px.astype(np.uint8)


def _pil(data: bytes) -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(data)))


def _both(data: bytes, want: np.ndarray, **kw) -> None:
    """The C++ route and the plain route each equal ``want``."""
    for plain in (False, True):
        got = jpeg.decode_jpeg(data, plain=plain, **kw)
        assert got.dtype == np.uint8 and got.shape == want.shape
        np.testing.assert_array_equal(got, want)


# ---- JPEG: PIL's files

PIL_CASES = [dict(quality=q, subsampling=s) for q in (50, 95)
             for s in (0, 1, 2)] + [
    dict(quality=90, optimize=True),
    dict(quality=90, restart_marker_blocks=3),
    dict(quality=90, restart_marker_rows=1, subsampling=2),
    dict(quality=100, subsampling=0),
    # 16-bit quantisation tables (values past 255)
    dict(qtables=[list(range(200, 264)), [300] * 64], subsampling=2)]


@pytest.mark.parametrize("size", [(37, 53), (17, 9), (3, 2), (64, 48)])
@pytest.mark.parametrize("kw", PIL_CASES,
                         ids=[str(i) for i in range(len(PIL_CASES))])
def test_jpeg_equals_pil(size, kw):
    for gray in (False, True):
        a = _image(*size, c=1)[..., 0] if gray else _image(*size)
        buf = io.BytesIO()
        Image.fromarray(a).save(buf, "JPEG", **kw)
        data = buf.getvalue()
        if "restart_marker_blocks" in kw and size[0] * size[1] > 1000:
            assert re_rst(data)
        if "qtables" in kw:
            assert b"\xff\xdb\x00\x83\x10" in data  # a 16-bit DQT
        _both(data, _pil(data))


def re_rst(data: bytes) -> bool:
    return any(bytes([0xFF, 0xD0 + k]) in data for k in range(8))


# ---- JPEG: this test's encoder, for what PIL does not write

def _encode(comps, sampling, quality=90, restart=0, interleave=True,
            ids=None, app=b"jfif", dht=True):
    """A baseline JPEG of the uint8 planes ``comps`` (full size, already
    in the stream's colour space), component c sampled at
    ``sampling[c]`` = (h, v) by box means, coded with the standard
    Huffman tables by ``utils/jpeg.py``'s own coder."""
    H, W = comps[0].shape
    n = len(comps)
    hm = max(h for h, _ in sampling)
    vm = max(v for _, v in sampling)
    mx, my = -(-W // (8 * hm)), -(-H // (8 * vm))
    qy, qc = jpeg.quant_tables(quality)
    blocks, dims = [], []
    for c, (p, (h, v)) in enumerate(zip(comps, sampling)):
        rh, rv = hm // h, vm // v
        full = np.pad(p, ((0, my * vm * 8 - H), (0, mx * hm * 8 - W)),
                      mode="edge").astype(np.float32)
        sub = full.reshape(full.shape[0] // rv, rv, full.shape[1] // rh,
                           rh).mean(axis=(1, 3))
        blocks.append(jpeg._quantised(sub, qy if c == 0 else qc))
        dims.append((-(-W * h // hm), -(-H * v // vm)))
    ids = ids or list(range(1, n + 1))
    scans = [list(range(n))] if interleave and n > 1 else [[c] for c in
                                                           range(n)]
    out = [b"\xff\xd8"]
    if app == b"jfif":
        out.append(jpeg._segment(0xE0, b"JFIF\0" + struct.pack(
            ">BBBHHBB", 1, 1, 0, 1, 1, 0, 0)))
    elif app is not None:  # Adobe APP14 with this transform byte
        out.append(jpeg._segment(0xEE, b"Adobe" + struct.pack(
            ">HHHB", 100, 0, 0, app)))
    for i, t in enumerate((qy, qc)):
        out.append(jpeg._segment(0xDB, bytes([i]) + bytes(
            t[jpeg.ZIGZAG].tolist())))
    sof = struct.pack(">BHHB", 8, H, W, n)
    for c in range(n):
        sof += bytes([ids[c], sampling[c][0] << 4 | sampling[c][1],
                      0 if c == 0 else 1])
    out.append(jpeg._segment(0xC0, sof))
    if dht:
        for tc, bits, vals in ((0x00, jpeg._DC_BITS[0], jpeg._DC_VALS),
                               (0x10, jpeg._AC_BITS[0], jpeg._AC_VALS[0]),
                               (0x01, jpeg._DC_BITS[1], jpeg._DC_VALS),
                               (0x11, jpeg._AC_BITS[1], jpeg._AC_VALS[1])):
            out.append(jpeg._segment(0xC4, bytes([tc]) + bytes(bits) + vals))
    if restart:
        out.append(jpeg._segment(0xDD, struct.pack(">H", restart)))
    for scan in scans:
        # the scan's units: MCUs, or one component's blocks in raster
        if len(scan) > 1:
            units = [[(c, my_ * sampling[c][1] + by, mx_ * sampling[c][0]
                       + bx) for c in scan for by in range(sampling[c][1])
                      for bx in range(sampling[c][0])]
                     for my_ in range(my) for mx_ in range(mx)]
        else:
            c = scan[0]
            dw, dh = dims[c]
            units = [[(c, y, x)] for y in range(-(-dh // 8))
                     for x in range(-(-dw // 8))]
        step = restart or len(units)
        pieces = []
        for a in range(0, len(units), step):
            seq = [b for u in units[a:a + step] for b in u]
            vals, lens, keys = [], [], []
            for c in scan:
                mine = [(i, y, x) for i, (cc, y, x) in enumerate(seq)
                        if cc == c]
                bl = np.stack([blocks[c][y, x] for _, y, x in mine])
                v, ln, blk = jpeg._scan_items(bl, 0 if c == 0 else 1, 0)
                vals.append(v)
                lens.append(ln)
                keys.append(np.array([mine[j][0] for j in blk]))
            order = np.argsort(np.concatenate(keys), kind="stable")
            pieces.append(jpeg._pack(np.concatenate(vals)[order],
                                     np.concatenate(lens)[order]))
        data = b"".join(p + (bytes([0xFF, 0xD0 + i % 8])
                             if i + 1 < len(pieces) else b"")
                        for i, p in enumerate(pieces))
        sos = bytes([len(scan)]) + b"".join(
            bytes([ids[c], 0x00 if c == 0 else 0x11]) for c in scan)
        out.append(jpeg._segment(0xDA, sos + bytes([0, 63, 0])) + data)
    out.append(b"\xff\xd9")
    return b"".join(out)


OWN_CASES = {
    "440": dict(sampling=[(1, 2), (1, 1), (1, 1)]),
    "411": dict(sampling=[(4, 1), (1, 1), (1, 1)]),
    "chroma_above_luma": dict(sampling=[(1, 1), (2, 2), (1, 2)]),
    "420_per_component_scans": dict(sampling=[(2, 2), (1, 1), (1, 1)],
                                    interleave=False),
    "422_restart_5": dict(sampling=[(2, 1), (1, 1), (1, 1)], restart=5),
    "adobe_rgb": dict(sampling=[(1, 1)] * 3, app=0),
    "adobe_ycc": dict(sampling=[(2, 2), (1, 1), (1, 1)], app=1),
    "ids_rgb": dict(sampling=[(1, 1)] * 3, app=None, ids=[82, 71, 66]),
    "ids_other": dict(sampling=[(1, 1)] * 3, app=None, ids=[7, 8, 9]),
    "no_dht": dict(sampling=[(2, 2), (1, 1), (1, 1)], dht=False),
    "gray_2x2": dict(sampling=[(2, 2)]),
}


@pytest.mark.parametrize("case", sorted(OWN_CASES))
def test_jpeg_of_other_layouts_equals_pil(case):
    kw = OWN_CASES[case]
    for h, w in ((37, 53), (24, 40), (5, 3)):
        img = _image(h, w, c=len(kw["sampling"]), seed=h)
        data = _encode([img[..., c] for c in range(img.shape[2])], **kw)
        want = _pil(data)
        _both(data, want)
        if case == "adobe_rgb":  # no transform: the planes come back
            assert np.abs(want.astype(int) - img).max() < 24


def test_jpeg_refusals():
    a = _image(24, 32)
    buf = io.BytesIO()
    Image.fromarray(a).save(buf, "JPEG")
    data = buf.getvalue()
    sof = data.index(b"\xff\xc0")
    twelve = data[:sof + 4] + b"\x0c" + data[sof + 5:]
    with pytest.raises(NotImplementedError, match="12-bit"):
        jpeg.decode_jpeg(twelve)
    # SOF11 (arithmetic lossless), SOF13 (arithmetic hierarchical): PIL
    # refuses them, and so does the port
    for marker in (b"\xcb", b"\xcd"):
        arith = data[:sof + 1] + marker + data[sof + 2:]
        with pytest.raises(OSError):
            _pil(arith)
        with pytest.raises(NotImplementedError, match="arithmetic"):
            jpeg.decode_jpeg(arith)
    # a corrupt scan, baseline and progressive: both routes raise
    buf = io.BytesIO()
    Image.fromarray(_image(48, 64)).save(buf, "JPEG", progressive=True)
    prog = buf.getvalue()
    for stream in (data, prog):
        # the first scan of the baseline stream, the last (luma AC
        # refinement) of the progressive one
        scan = (stream.index if stream is data else stream.rindex)(
            b"\xff\xda")
        bad = stream[:scan + 20] + b"\xff\xff\xff\xff" * 8 + stream[scan + 52:]
        for plain in (False, True):
            with pytest.raises(ValueError):
                jpeg.decode_jpeg(bad, plain=plain)


def test_jpeg_tables_from_elsewhere_and_frame_batch():
    """An abbreviated stream whose tables come from a table-spec stream
    (a TIFF's JPEGTables); frames decoded together into views of one
    page, cropped at its edge."""
    a = _image(40, 56)
    buf = io.BytesIO()
    Image.fromarray(a).save(buf, "JPEG", quality=80)
    data = buf.getvalue()
    tables, rest, pos = [b"\xff\xd8"], [b"\xff\xd8"], 2
    for marker, s, e in jpeg._segments(data, 2):
        seg = data[pos:e]
        pos = e
        if marker in (0xDB, 0xC4):
            tables.append(seg)
        elif marker != 0xDA:
            rest.append(seg)
        else:
            rest.append(data[s - 4:])
            break
    tables.append(b"\xff\xd9")
    abbrev = b"".join(rest)
    with pytest.raises(ValueError, match="quantisation table"):
        jpeg.decode_jpeg(abbrev)
    _both(abbrev, _pil(data), tables=b"".join(tables), transform=True)
    frames = [jpeg.parse_jpeg(data)] * 3
    page = np.zeros((40, 100, 3), np.uint8)
    views = [page[:, 0:40], page[:, 40:80], page[:30, 80:100]]
    for plain in (False, True):
        page[...] = 0
        jpeg.decode_frames(frames, views, plain=plain)
        for v in views:
            np.testing.assert_array_equal(v, _pil(data)[:v.shape[0],
                                                        :v.shape[1]])


# ---- TIFF LZW and PackBits

def _lzw_encode(data: bytes) -> bytes:
    """TIFF LZW as libtiff writes it: Clear first and when the table
    fills, the code width growing one code early, EOI last."""
    bits = []
    table = {bytes([i]): i for i in range(256)}
    nxt, width = 258, 9

    def put(code):
        bits.append((code, width))

    put(256)
    w = b""
    for byte in data:
        wc = w + bytes([byte])
        if wc in table:
            w = wc
            continue
        put(table[w])
        table[wc] = nxt
        nxt += 1
        if nxt == 4094:
            put(256)
            table = {bytes([i]): i for i in range(256)}
            nxt, width = 258, 9
        elif nxt > (1 << width) - 1:
            width += 1
        w = bytes([byte])
    if w:
        put(table[w])
        nxt += 1
        if nxt > (1 << width) - 1 and width < 12:
            width += 1
    put(257)
    text = "".join(format(code, f"0{n}b") for code, n in bits)
    text += "0" * (-len(text) % 8)
    return int(text, 2).to_bytes(len(text) // 8, "big")


def _packbits_encode(data: bytes) -> bytes:
    """PackBits with a no-op header (-128) before every run."""
    out, i = bytearray(), 0
    while i < len(data):
        j = i
        while j < len(data) and j - i < 128 and data[j] == data[i]:
            j += 1
        out.append(0x80)
        if j - i >= 2:
            out += bytes([(1 - (j - i)) & 0xFF, data[i]])
            i = j
        else:
            k = min(i + 1 + int(data[i] % 7), len(data))
            out += bytes([k - i - 1]) + data[i:k]
            i = k
    return bytes(out)


def _streams():
    rng = np.random.default_rng(11)
    yield b""
    yield b"a" * 1000  # the KwKwK case, over and over
    yield rng.integers(0, 256, 20000, dtype=np.uint8).tobytes()  # clears
    yield rng.integers(0, 4, 30000, dtype=np.uint8).tobytes()  # 12 bits
    yield bytes(_image(40, 50).tobytes())


@pytest.mark.parametrize("codec", [tiff.LZW, tiff.PACKBITS])
def test_tiff_chunk_decoders_equal_source_and_plain(codec, tmp_path):
    enc = _lzw_encode if codec == tiff.LZW else _packbits_encode
    plain = (tiff.lzw_decode_plain if codec == tiff.LZW
             else tiff.packbits_decode_plain)
    sources = list(_streams())
    chunks = [enc(s) for s in sources]
    # and libtiff's own chunks of an image, through PIL
    a = _image(70, 45)
    p = str(tmp_path / "c.tiff")
    Image.fromarray(a).save(p, compression="tiff_lzw" if codec == tiff.LZW
                            else "packbits")
    (page,) = tiff.read_pages(p)
    with open(p, "rb") as f:
        for off, n in page.chunks:
            f.seek(off)
            chunks.append(f.read(n))
    rps = page.rows_per_strip
    sources += [a[y:y + rps].tobytes() for y in range(0, 70, rps)]
    outs = [np.full(len(s), 7, np.uint8) for s in sources]
    done = tiff.decode_chunks(codec, chunks, outs)
    assert done == [len(s) for s in sources]
    for src, chunk, out in zip(sources, chunks, outs):
        assert out.tobytes() == src
        assert plain(chunk, len(src)) == src
        # a cap shorter than the data: both stop there
        cap = len(src) // 3
        short = np.zeros(cap, np.uint8)
        assert tiff.decode_chunks(codec, [chunk], [short]) == [cap]
        assert short.tobytes() == src[:cap] == plain(chunk, cap)


def test_tiff_chunk_decoders_refuse_corrupt_data():
    for codec, chunk in ((tiff.LZW, bytes([0x80, 0x7F, 0xFF, 0xF0])),
                         (tiff.PACKBITS, b"\x05ab")):
        out = np.zeros(16, np.uint8)
        with pytest.raises(ValueError, match="corrupt"):
            tiff.decode_chunks(codec, [chunk], [out])
        fn = (tiff.lzw_decode_plain if codec == tiff.LZW
              else tiff.packbits_decode_plain)
        with pytest.raises(ValueError, match="corrupt"):
            fn(chunk, 16)


# ---- PNG

ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
         (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))
CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data)))


def _pack_rows(v: np.ndarray, depth: int) -> np.ndarray:
    h = v.shape[0]
    if depth == 16:
        return v.astype(">u2").view(np.uint8).reshape(h, -1)
    if depth == 8:
        return v.astype(np.uint8)
    bits = ((v[..., None] >> np.arange(depth - 1, -1, -1)) & 1).reshape(
        h, -1).astype(np.uint8)
    return np.packbits(bits, axis=1)


def _filtered(rows: np.ndarray, bpp: int, kinds) -> np.ndarray:
    """Each row filtered by kinds[row % len(kinds)], as PNG defines it."""
    h, rb = rows.shape
    out, prior = [], np.zeros(rb, int)
    for y in range(h):
        x = rows[y].astype(int)
        f = kinds[y % len(kinds)]
        a = np.concatenate([np.zeros(bpp, int), x])[:rb]
        c = np.concatenate([np.zeros(bpp, int), prior])[:rb]
        if f == 0:
            r = x
        elif f == 1:
            r = x - a
        elif f == 2:
            r = x - prior
        elif f == 3:
            r = x - (a + prior) // 2
        else:
            p = a + prior - c
            pa, pb, pc = abs(p - a), abs(p - prior), abs(p - c)
            r = x - np.where((pa <= pb) & (pa <= pc), a,
                             np.where(pb <= pc, prior, c))
        out.append(np.concatenate([[f], r & 255]))
        prior = x
    return np.array(out, np.uint8)


def _png(vals, depth, ctype, interlace, kinds, plte=b""):
    h, w, ch = vals.shape
    bpp = max(1, depth * ch // 8)
    body = b""
    for x0, y0, dx, dy in (ADAM7 if interlace else ((0, 0, 1, 1),)):
        sub = vals[y0::dy, x0::dx]
        if sub.size:
            rows = _pack_rows(sub.reshape(sub.shape[0], -1), depth)
            body += _filtered(rows, bpp, kinds).tobytes()
    return (png.SIGNATURE + _chunk(b"IHDR", struct.pack(
        ">IIBBBBB", w, h, depth, ctype, 0, 0, interlace))
        + (_chunk(b"PLTE", plte) if plte else b"")
        + _chunk(b"IDAT", zlib.compress(body)) + _chunk(b"IEND", b""))


@pytest.mark.parametrize("depth,ctype", sorted(png.MODES))
@pytest.mark.parametrize("interlace", [0, 1])
def test_png_equals_pil(depth, ctype, interlace):
    rng = np.random.default_rng(depth * 10 + ctype)
    for h, w in ((13, 17), (1, 1), (9, 3)):
        if ctype == 3:
            vals = rng.integers(0, min(1 << depth, 200), (h, w, 1))
            plte = rng.integers(0, 256, 3 * min(1 << depth, 180),
                                dtype=np.uint8).tobytes()
        else:
            vals = rng.integers(0, 1 << depth, (h, w, CHANNELS[ctype]))
            plte = b""
        data = _png(vals, depth, ctype, interlace, [0, 1, 2, 3, 4, 4, 3, 1],
                    plte)
        im = Image.open(io.BytesIO(data))
        assert im.mode == png.mode(depth, ctype)
        want = np.asarray(im.convert("RGB") if im.mode == "P" else im)
        if im.mode == "1":
            want = want.astype(np.uint8) * 255
        for plain in (False, True):
            got = png.decode_png(data, plain=plain)
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)
            np.testing.assert_array_equal(
                png.decode_png(data, plain=plain, rgb=True),
                np.asarray(im.convert("RGB")))


def test_png_unfilter_routes_agree_on_pil_and_libpng_files(tmp_path):
    """PIL's and OpenCV's own files (their adaptive filters), and a
    palette index past the palette, which PIL reads as black."""
    import cv2
    a = _image(31, 45)
    for name, write in (("pil", lambda p: Image.fromarray(a).save(p)),
                        ("cv", lambda p: cv2.imwrite(p, a[..., ::-1]))):
        p = str(tmp_path / f"{name}.png")
        write(p)
        for plain in (False, True):
            np.testing.assert_array_equal(png.read_png(p, plain=plain), a)
    # indices 0..5 under a palette of 2 entries
    data = _png(np.arange(6).reshape(1, 6, 1), 8, 3, 0, [0],
                plte=bytes(range(6)))
    np.testing.assert_array_equal(png.decode_png(data),
                                  np.asarray(Image.open(io.BytesIO(data))
                                             .convert("RGB")))


@pytest.mark.parametrize("seed", [1, 2])
def test_corrupt_streams_decode_alike(seed):
    """Bytes overwritten in a JPEG scan with restart markers, and in LZW
    and PackBits chunks: the C++ and plain routes give the same pixels or
    both raise ``ValueError`` (the C++ never reads past its input)."""
    rng = np.random.default_rng(seed)
    buf = io.BytesIO()
    Image.fromarray(_image(40, 56)).save(buf, "JPEG", quality=80,
                                         restart_marker_blocks=2)
    base = buf.getvalue()
    sos = base.index(b"\xff\xda") + 14
    raised = 0
    for _ in range(150):
        data = bytearray(base)
        for _ in range(int(rng.integers(1, 6))):
            data[int(rng.integers(sos, len(data) - 2))] = int(
                rng.integers(0, 256))
        got = []
        for plain in (False, True):
            try:
                got.append(jpeg.decode_jpeg(bytes(data), plain=plain))
            except ValueError:
                got.append(None)
        raised += got[0] is None
        assert (got[0] is None) == (got[1] is None)
        if got[0] is not None:
            np.testing.assert_array_equal(got[0], got[1])
    assert 0 < raised < 150
    src = _image(30, 40).tobytes()
    for codec, enc, plain in (
            (tiff.LZW, _lzw_encode, tiff.lzw_decode_plain),
            (tiff.PACKBITS, _packbits_encode, tiff.packbits_decode_plain)):
        chunk = enc(src)
        for _ in range(100):
            data = bytearray(chunk)
            for _ in range(int(rng.integers(1, 4))):
                data[int(rng.integers(0, len(data)))] = int(
                    rng.integers(0, 256))
            out = np.zeros(len(src), np.uint8)
            try:
                (n,) = tiff.decode_chunks(codec, [bytes(data)], [out])
                native = out[:n].tobytes()
            except ValueError:
                native = None
            try:
                ref = plain(bytes(data), len(src))
            except ValueError:
                ref = None
            assert native == ref
