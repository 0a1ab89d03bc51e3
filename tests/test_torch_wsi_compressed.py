"""The compressed inputs the JAX package reads through PIL and h5py, read
by the port's own decoders and held to the JAX package on the same
files:

- slides: the port's ``PILSlide(path).levels`` equal JAX
  ``PILSlide(path).levels`` bit for bit (tolerance 0, JPEG included) on
  two-page pyramids written here -- stripped and tiled pages with edge
  tiles; uncompressed, LZW and Deflate (predictors 1 and 2), PackBits;
  8-bit RGB and gray, 16-bit gray, a big-endian file; JPEG tiles in
  YCbCr (4:4:4, 4:2:0, with and without JPEGTables and restart
  markers), in RGB (photometric 2) and in gray, libtiff's own JPEG
  strips; arithmetic-coded tiles (SOF9 and SOF10, with and without
  restart markers, one larger than PIL's 64 KiB read block, which
  libtiff hands libjpeg whole) and lossless (SOF3) tiles, coded by
  ``tools/jpeg_arith.py``; PNG slides of each colour type, depth and interlace; .jpg
  slides; JPEG 2000 slides (.jp2, .j2k, .jpc and .j2c) written by PIL:
  RGB lossless and lossy, tiled, grey and I;16.  PIL ignores tile tags
  when it saves, so the IFDs are written
  here around chunks that PIL (libtiff), ``zlib`` or this file's
  encoders compressed.  Every compressed page also decodes equal
  through the plain versions (``read_page(..., plain=True)``);
- stage 0: ``cli.create_patches --device cpu`` writes the JAX CLI's
  coordinates on a JPEG-tiled and an LZW-tiled slide, and on a .jp2
  slide;
- DICOM: a Baseline JPEG (…1.2.4.50) frame built by PIL reads equal to
  JAX's ``read_file``; a colour frame and a frame whose shape is not
  Rows x Columns raise alike;
- h5: gzip, shuffle and fletcher32 chunked datasets (h5py) read equal
  through JAX's ``load_features_h5`` and the port's; a corrupted
  fletcher32 checksum raises ``OSError`` in both.
"""
import importlib.util
import io
import os
import struct
import zlib

import h5py
import numpy as np
import pytest
from PIL import Image

from test_torch_codecs import _image, _lzw_encode, _png
from test_torch_dicom import _same_outcome, _volume, _with_syntax, _write

from multimodalfusion_tpu.cli.create_patches import main as jax_cp
from multimodalfusion_tpu.data import dicom as jd
from multimodalfusion_tpu.data import io as jio
from multimodalfusion_tpu.data import wsi as jw
from multimodalfusion_tpu_torch.cli import create_patches as tcp
from multimodalfusion_tpu_torch.data import io as tio
from multimodalfusion_tpu_torch.data import wsi as tw
from multimodalfusion_tpu_torch.utils import j2k, tiff

LZW, DEFLATE, ADOBE, PACKBITS, JPEG = 5, 8, 32946, 32773, 7
_spec = importlib.util.spec_from_file_location(
    "jpeg_arith", os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "tools", "jpeg_arith.py"))
arith = importlib.util.module_from_spec(_spec)  # the test-stream coder
_spec.loader.exec_module(arith)


# ---- writing the files

def _pieces(img, tile, rps):
    """(pixels of each tile, edge tiles padded by repeating the edge) or
    (each strip, the last one short)."""
    h, w = img.shape[:2]
    if tile:
        tw_, th = tile
        pad = [(0, -h % th), (0, -w % tw_)] + [(0, 0)] * (img.ndim - 2)
        full = np.pad(img, pad, mode="edge")
        return [full[y:y + th, x:x + tw_] for y in range(0, h, th)
                for x in range(0, w, tw_)]
    return [img[y:y + rps] for y in range(0, h, rps)]


def _pil_chunk(px, compression):
    """The one strip PIL (libtiff) writes for ``px``."""
    buf = io.BytesIO()
    Image.fromarray(px).save(buf, "TIFF", compression=compression)
    path = buf.getvalue()
    order = "<" if path[:2] == b"II" else ">"
    (ifd,) = struct.unpack_from(order + "I", path, 4)
    (n,) = struct.unpack_from(order + "H", path, ifd)
    tags = {}
    for i in range(n):
        tag, typ, cnt, val = struct.unpack_from(order + "HHII", path,
                                                ifd + 2 + 12 * i)
        if typ == 3 and cnt == 1:
            val = struct.unpack_from(order + "H", path, ifd + 10 + 12 * i)[0]
        tags[tag] = (cnt, val)
    assert tags[273][0] == 1, "one strip expected"
    return path[tags[273][1]:tags[273][1] + tags[279][1]]


def _differenced(px):
    """TIFF Predictor 2: each sample minus its left neighbour, modulo the
    sample's range."""
    d = px.astype(np.int64)
    d[:, 1:] -= px[:, :-1].astype(np.int64)
    return (d % (1 << (8 * px.dtype.itemsize))).astype(px.dtype)


def _split_tables(stream):
    """(JPEGTables: SOI, DQT, DHT, EOI; the abbreviated stream)."""
    tables, rest, pos = [b"\xff\xd8"], [b"\xff\xd8"], 2
    while True:
        marker = stream[pos + 1]
        (n,) = struct.unpack_from(">H", stream, pos + 2)
        seg = stream[pos:pos + 2 + n]
        if marker == 0xDA:
            rest.append(stream[pos:])
            break
        (tables if marker in (0xDB, 0xC4) else rest).append(seg)
        pos += 2 + n
    return b"".join(tables) + b"\xff\xd9", b"".join(rest)


def _encode_page(img, compression, tile=None, rps=None, predictor=1,
                 jpeg_kw=None, tables_apart=False, order="<"):
    """A page dict for ``_write_tiff``: its chunks and tags."""
    gray16 = img.dtype == np.uint16
    spp = 1 if img.ndim == 2 else 3
    page = dict(w=img.shape[1], h=img.shape[0], spp=spp,
                bits=16 if gray16 else 8, compression=compression,
                tile=tile, rps=rps, predictor=predictor, tables=None,
                photometric=1 if spp == 1 else 2, sub=None)
    chunks = []
    for px in _pieces(img, tile, rps):
        if predictor == 2:
            px = _differenced(px)
        if order == ">" and gray16:
            raw = px.astype(">u2").tobytes()
        else:
            raw = np.ascontiguousarray(px).tobytes()
        if compression == 1:
            chunks.append(raw)
        elif compression in (DEFLATE, ADOBE):
            chunks.append(zlib.compress(raw))
        elif compression == LZW:
            chunks.append(_lzw_encode(raw) if order == ">" else
                          _pil_chunk(px, "tiff_lzw"))
        elif compression == PACKBITS:
            chunks.append(_pil_chunk(px, "packbits"))
        else:
            kw = dict(jpeg_kw)
            photometric = kw.pop("photometric", 6 if spp == 3 else 1)
            page["photometric"] = photometric
            buf = io.BytesIO()
            Image.fromarray(px).save(buf, "JPEG", keep_rgb=photometric == 2,
                                     **kw)
            stream = buf.getvalue()
            if tables_apart:
                page["tables"], stream = _split_tables(stream)
            chunks.append(stream)
    page["chunks"] = chunks
    return page


def _write_tiff(path, pages, order="<"):
    """A TIFF of ``pages`` (``_encode_page``), the IFDs written here."""
    out = bytearray((b"II*\0" if order == "<" else b"MM\0*") + b"\0" * 4)
    link = 4
    for p in pages:
        offsets = []
        for c in p["chunks"]:
            offsets.append(len(out))
            out += c + b"\0" * (len(c) % 2)
        counts = [len(c) for c in p["chunks"]]
        tile = p["tile"]
        entries = [(256, 4, [p["w"]]), (257, 4, [p["h"]]),
                   (258, 3, [p["bits"]] * p["spp"]),
                   (259, 3, [p["compression"]]), (262, 3, [p["photometric"]]),
                   (277, 3, [p["spp"]]), (284, 3, [1])]
        if tile:
            entries += [(322, 4, [tile[0]]), (323, 4, [tile[1]]),
                        (324, 4, offsets), (325, 4, counts)]
        else:
            entries += [(273, 4, offsets), (278, 4, [p["rps"]]),
                        (279, 4, counts)]
        if p["predictor"] != 1:
            entries.append((317, 3, [p["predictor"]]))
        if p["tables"]:
            entries.append((347, 7, list(p["tables"])))
        if p["sub"]:
            entries.append((530, 3, list(p["sub"])))
        entries.sort()
        ifd = len(out)
        struct.pack_into(order + "I", out, link, ifd)
        extra = ifd + 2 + 12 * len(entries) + 4
        body, blobs = struct.pack(order + "H", len(entries)), b""
        for tag, typ, vals in entries:
            code = {3: "H", 4: "I", 7: "B"}[typ]
            raw = struct.pack(f"{order}{len(vals)}{code}", *vals)
            if len(raw) <= 4:
                field = raw + b"\0" * (4 - len(raw))
            else:
                field = struct.pack(order + "I", extra + len(blobs))
                blobs += raw + b"\0" * (len(raw) % 2)
            body += struct.pack(order + "HHI", tag, typ, len(vals)) + field
        link = ifd + 2 + 12 * len(entries)
        out += body + b"\0\0\0\0" + blobs
    with open(path, "wb") as f:
        f.write(bytes(out))
    return path


def _pyramid(img):
    return [img, np.ascontiguousarray(img[::2, ::2])]


def _check_slide(path, plain_too=True):
    """The port's levels equal JAX's; each page equal through the plain
    decoders too."""
    got, want = tw.PILSlide(path).levels, jw.PILSlide(path).levels
    assert [g.shape for g in got] == [w.shape for w in want]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    if plain_too and path.endswith(".tiff"):
        for page, g in zip(tiff.read_pages(path), got):
            np.testing.assert_array_equal(
                tiff.read_page(path, page, plain=True), g)


# ---- slides

LOSSLESS = [(c, pred) for c in (1, LZW, DEFLATE, ADOBE, PACKBITS)
            for pred in ((1, 2) if c in (LZW, DEFLATE, ADOBE) else (1,))]


@pytest.mark.parametrize("compression,predictor", LOSSLESS)
@pytest.mark.parametrize("layout", ["strips", "tiles"])
def test_lossless_tiff_equals_jax(tmp_path, compression, predictor, layout):
    kw = dict(tile=(32, 16)) if layout == "tiles" else dict(rps=7)
    kinds = {"rgb": _image(45, 70), "gray": _image(45, 70, c=1)[..., 0]}
    if compression in (1, LZW, DEFLATE):
        g = _image(45, 70, c=1, seed=5)[..., 0].astype(np.uint16)
        kinds["gray16"] = g * 251 + 3  # values past 255 (saturated)
    for name, img in kinds.items():
        path = str(tmp_path / f"{name}.tiff")
        pages = [_encode_page(lvl, compression, predictor=predictor, **kw)
                 for lvl in _pyramid(img)]
        _check_slide(_write_tiff(path, pages))


def test_big_endian_lzw_predictor_2(tmp_path):
    img = (_image(33, 50, c=1, seed=2)[..., 0].astype(np.uint16) * 257)
    pages = [_encode_page(lvl, LZW, tile=(16, 16), predictor=2, order=">")
             for lvl in _pyramid(img)]
    _check_slide(_write_tiff(str(tmp_path / "be.tiff"), pages, order=">"))


JPEG_CASES = {
    "ycc420": dict(quality=90, subsampling=2),
    "ycc444": dict(quality=90, subsampling=0),
    "ycc420_restart": dict(quality=85, subsampling=2,
                           restart_marker_blocks=2),
    "rgb": dict(quality=90, subsampling=0, photometric=2),
}


@pytest.mark.parametrize("case", sorted(JPEG_CASES))
@pytest.mark.parametrize("tables_apart", [False, True])
def test_jpeg_tiles_equal_jax(tmp_path, case, tables_apart):
    img = _image(72, 100, seed=3)
    pages = [_encode_page(lvl, JPEG, tile=(32, 32), jpeg_kw=JPEG_CASES[case],
                          tables_apart=tables_apart)
             for lvl in _pyramid(img)]
    if case == "ycc420" and tables_apart:
        for p in pages:
            p["sub"] = (2, 2)  # YCbCrSubsampling as the stream has it
    _check_slide(_write_tiff(str(tmp_path / "j.tiff"), pages))


@pytest.mark.parametrize("case", ["ycc420", "rgb"])
@pytest.mark.parametrize("progressive", [False, True], ids=["sof9",
                                                            "sof10"])
@pytest.mark.parametrize("restart", [0, 2])
def test_arithmetic_jpeg_tiles_equal_jax(tmp_path, case, progressive,
                                         restart):
    """JPEG tiles coded again in arithmetic coding (libtiff hands them to
    PIL's libjpeg-turbo): the same pixels through the port's C++ and plain
    routes."""
    img = _image(72, 100, seed=3)
    pages = [_encode_page(lvl, JPEG, tile=(32, 32), jpeg_kw=JPEG_CASES[case])
             for lvl in _pyramid(img)]
    for p in pages:
        p["chunks"] = [arith.transcode(c, progressive=progressive, app=None,
                                       restart=restart) for c in p["chunks"]]
    _check_slide(_write_tiff(str(tmp_path / "a.tiff"), pages))


def test_large_arithmetic_and_lossless_tiles_equal_jax(tmp_path):
    """A 512 x 512 arithmetic tile past PIL's 64 KiB read block (libtiff
    reads it whole), and lossless tiles in gray and RGB."""
    img = (np.random.default_rng(4).integers(0, 256, (512, 512, 3))
           .astype(np.uint8))
    page = _encode_page(img, JPEG, tile=(512, 512),
                        jpeg_kw=dict(quality=95, subsampling=2))
    page["chunks"] = [arith.transcode(c, progressive=False, app=None)
                      for c in page["chunks"]]
    assert len(page["chunks"][0]) > 1 << 16
    _check_slide(_write_tiff(str(tmp_path / "big.tiff"), [page]),
                 plain_too=False)
    img = _image(72, 100, seed=5)
    for name, im, kw in (("gray", img[..., 0], dict(quality=90)),
                         ("rgb", img, dict(quality=90, subsampling=0,
                                           photometric=2))):
        pages = [_encode_page(lvl, JPEG, tile=(32, 32), jpeg_kw=kw)
                 for lvl in _pyramid(im)]
        for p, lvl in zip(pages, _pyramid(im)):
            p["chunks"] = [arith.encode_lossless(
                [t] if t.ndim == 2 else [t[..., c] for c in range(3)],
                psv=4, pt=1) for t in _pieces(lvl, (32, 32), None)]
        _check_slide(_write_tiff(str(tmp_path / f"ll_{name}.tiff"), pages))


def test_gray_jpeg_tiles_and_libtiff_strips_equal_jax(tmp_path):
    g = _image(40, 56, c=1)[..., 0]
    pages = [_encode_page(lvl, JPEG, tile=(16, 16), jpeg_kw=dict(quality=80))
             for lvl in _pyramid(g)]
    _check_slide(_write_tiff(str(tmp_path / "g.tiff"), pages))
    # libtiff's own JPEG TIFF: photometric RGB strips, JPEGTables
    for name, img in (("rgb", _image(50, 61)), ("gray", g)):
        path = str(tmp_path / f"lib_{name}.tiff")
        imgs = [Image.fromarray(lvl) for lvl in _pyramid(img)]
        imgs[0].save(path, compression="jpeg", quality=80, save_all=True,
                     append_images=imgs[1:])
        assert tiff.read_pages(path)[0].jpeg_tables
        _check_slide(path)


def test_jpeg_tile_sampling_libtiff_refuses(tmp_path):
    """A 4:2:0 stream under photometric RGB, or under a YCbCrSubsampling
    of 1 x 1: libtiff (so PIL) refuses, and so does the port."""
    img = _image(32, 32)
    for photometric, sub in ((2, None), (6, (1, 1))):
        page = _encode_page(img, JPEG, tile=(32, 32),
                            jpeg_kw=dict(quality=90, subsampling=2))
        page["photometric"], page["sub"] = photometric, sub
        path = _write_tiff(str(tmp_path / f"bad{photometric}.tiff"), [page])
        with pytest.raises(OSError):
            jw.PILSlide(path)
        with pytest.raises(OSError, match="sampling"):
            tw.PILSlide(path)


def test_png_and_jpeg_slides_equal_jax(tmp_path):
    rng = np.random.default_rng(9)
    cases = [(8, 2, 0), (16, 2, 1), (8, 6, 0), (8, 4, 1), (16, 0, 0),
             (4, 0, 1), (1, 0, 0), (2, 3, 1), (8, 3, 0), (16, 6, 1)]
    for depth, ctype, interlace in cases:
        ch = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[ctype]
        vals = rng.integers(0, 1 << depth, (37, 29, ch))
        plte = rng.integers(0, 256, 3 * (1 << min(depth, 8)),
                            dtype=np.uint8).tobytes() if ctype == 3 else b""
        path = str(tmp_path / f"s{depth}_{ctype}_{interlace}.png")
        with open(path, "wb") as f:
            f.write(_png(vals, depth, ctype, interlace, [0, 1, 2, 3, 4],
                         plte))
        _check_slide(path)
    for ext, img, kw in ((".jpg", _image(61, 83), dict(quality=90)),
                         (".jpeg", _image(50, 40, c=1)[..., 0], {}),
                         (".jpg", _image(48, 64), dict(subsampling=1))):
        path = str(tmp_path / f"slide{ext}")
        Image.fromarray(img).save(path, "JPEG", **kw)
        _check_slide(path)


J2K_SLIDES = {
    "rgb_lossless.jp2": (lambda: _image(61, 83), dict(irreversible=False)),
    "rgb_lossy.j2k": (lambda: _image(70, 57), dict(
        irreversible=True, quality_mode="rates", quality_layers=[20, 5])),
    "rgb_tiled.jpc": (lambda: _image(90, 76), dict(
        irreversible=False, tile_size=(32, 48), progression="RPCL",
        precinct_size=(32, 32))),
    "gray.j2c": (lambda: _image(44, 39, c=1)[..., 0], dict(
        irreversible=True, no_jp2=True)),
    "gray16.jp2": (lambda: (_image(44, 39, c=1)[..., 0].astype(np.uint16)
                            * 37 + 100), dict(irreversible=False)),
}


@pytest.mark.parametrize("name", sorted(J2K_SLIDES))
def test_j2k_slides_equal_jax(tmp_path, name):
    """PIL's JPEG 2000 slides: the port's RGB level equals JAX's
    (``convert("RGB")`` of PIL's mode: RGB, L repeated, I;16 clipped), and
    the port reads the size and mode from the headers as PIL does."""
    make, kw = J2K_SLIDES[name]
    path = str(tmp_path / name)
    Image.fromarray(make()).save(path, "JPEG2000", **kw)
    _check_slide(path)
    np.testing.assert_array_equal(j2k.read_j2k(path, plain=True, rgb=True),
                                  tw.PILSlide(path).levels[0])
    with Image.open(path) as im:
        assert tw._j2k_header(path) == (im.size, im.mode)


def test_budget_counts_the_modes_this_reads(tmp_path):
    """The decode budget from the headers of a palette PNG (1 B/px native)
    and a .jpg (4 B/px), at the JAX table's bytes."""
    path = str(tmp_path / "p.png")
    with open(path, "wb") as f:
        f.write(_png(np.zeros((20, 30, 1), int), 8, 3, 0, [0], b"\0" * 3))
    need = 3 * 20 * 30 + 1 * 20 * 30
    for cls in (tw.PILSlide, jw.PILSlide):
        cls(path, max_decode_bytes=need)
        with pytest.raises(ValueError, match="budget"):
            cls(path, max_decode_bytes=need - 1)
    jpg = str(tmp_path / "s.jpg")
    Image.fromarray(_image(20, 30)).save(jpg)
    need = 3 * 20 * 30 + 4 * 20 * 30
    for cls in (tw.PILSlide, jw.PILSlide):
        cls(jpg, max_decode_bytes=need)
        with pytest.raises(ValueError, match="budget"):
            cls(jpg, max_decode_bytes=need - 1)


# ---- stage 0 on compressed slides

def test_create_patches_on_jpeg_and_lzw_tiles_equals_jax(tmp_path):
    slide = jw.synthetic_slide(2048, 1536, n_blobs=3, seed=1, n_levels=3)
    src = tmp_path / "slides"
    os.makedirs(src)
    _write_tiff(str(src / "JPG.tiff"), [
        _encode_page(lvl, JPEG, tile=(128, 128), tables_apart=True,
                     jpeg_kw=dict(quality=90, subsampling=2))
        for lvl in slide.levels])
    _write_tiff(str(src / "LZW.tiff"), [
        _encode_page(lvl, LZW, tile=(128, 128), predictor=2)
        for lvl in slide.levels])
    Image.fromarray(slide.levels[0]).save(str(src / "J2K.jp2"), "JPEG2000",
                                          irreversible=False)
    out = {}
    for who, fn, extra in (("jax", jax_cp, []),
                           ("port", tcp.main, ["--device", "cpu"])):
        out[who] = tmp_path / who
        assert fn(["--source", str(src), "--save_dir", str(out[who]),
                   "--patch_size", "128", "--step_size", "128", "--a_t",
                   "0.5", "--a_h", "0.05"] + extra) == 0
    for stem in ("JPG", "LZW", "J2K"):
        with h5py.File(out["jax"] / "patches" / f"{stem}_patches.h5") as j, \
                h5py.File(out["port"] / "patches" / f"{stem}_patches.h5") \
                as t:
            assert len(j["coords"]) > 5
            np.testing.assert_array_equal(t["coords"][()], j["coords"][()])


# ---- DICOM Baseline JPEG

def _baseline_dicom(tmp_path, name, frame_img, rows_cols_px):
    """A DICOM file of ``rows_cols_px``'s header whose one fragment is
    PIL's JPEG of ``frame_img``, syntax 1.2.840.10008.1.2.4.50."""
    rle = open(_write(jd, tmp_path / f"{name}_rle.dcm", rows_cols_px,
                      "rle", False, 1), "rb").read()
    bio = io.BytesIO()
    Image.fromarray(frame_img).save(bio, format="JPEG", quality=90)
    blob = bio.getvalue() + b"\x00" * (len(bio.getvalue()) % 2)
    frame = jd._rle_encode_frame(rows_cols_px)
    old = struct.pack("<HHI", 0xFFFE, 0xE000, len(frame)) + frame
    new = struct.pack("<HHI", 0xFFFE, 0xE000, len(blob)) + blob
    path = tmp_path / f"{name}.dcm"
    path.write_bytes(_with_syntax(rle.replace(old, new), jd.JPEG_BASELINE))
    return path


def test_dicom_baseline_jpeg_reads_as_jax(tmp_path):
    px = _volume(n=1)[0]
    gray = (px % 256).astype(np.uint8)
    ok = _same_outcome(_baseline_dicom(tmp_path, "gray", gray, px))
    assert ok[0] == "ok" and ok[2].shape == px.shape
    color = _same_outcome(_baseline_dicom(
        tmp_path, "color", np.stack([gray] * 3, -1), px))
    assert color[:3] == ("raise", "pixels", "NotImplementedError")
    shape = _same_outcome(_baseline_dicom(tmp_path, "shape", gray[:, :-8],
                                          px))
    assert shape[:3] == ("raise", "pixels", "ValueError")


# ---- h5 filters

@pytest.mark.parametrize("kw", [
    dict(compression="gzip"), dict(compression="gzip", shuffle=True),
    dict(shuffle=True), dict(fletcher32=True),
    dict(compression="gzip", compression_opts=9, shuffle=True,
         fletcher32=True)], ids=["gzip", "gzip_shuffle", "shuffle",
                                 "fletcher32", "all"])
def test_filtered_h5_reads_as_jax(tmp_path, kw):
    rng = np.random.default_rng(1)
    feats = rng.standard_normal((37, 96)).astype(np.float32)
    index = np.arange(37, dtype=np.int64) * 3
    path = str(tmp_path / "f.h5")
    with h5py.File(path, "w") as f:
        f.create_dataset("features", data=feats, chunks=(5, 96), **kw)
        f.create_dataset("slice_index", data=index, chunks=(8,), **kw)
    got, want = tio.load_features_h5(path), jio.load_features_h5(path)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def test_corrupted_fletcher32_raises_oserror_in_both(tmp_path):
    path = str(tmp_path / "c.h5")
    with h5py.File(path, "w") as f:
        f.create_dataset("features", data=np.ones((8, 64), np.float32),
                         chunks=(8, 64), fletcher32=True)
        off = f["features"].id.get_chunk_info(0).byte_offset
    raw = bytearray(open(path, "rb").read())
    raw[off + 10] ^= 0xFF
    open(path, "wb").write(bytes(raw))
    for load in (jio.load_features_h5, tio.load_features_h5):
        with pytest.raises(OSError):
            load(path)
