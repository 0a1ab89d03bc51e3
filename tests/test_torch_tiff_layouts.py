"""The TIFF page layouts PIL reads beyond 8-bit RGB and gray, read by the
port's ``utils/tiff.py`` and held to the JAX package's ``PILSlide`` (PIL,
libtiff) on the same files: the port's ``PILSlide(path).levels`` equal
JAX ``PILSlide(path).levels`` bit for bit (tolerance 0), and every page
equal through the plain decoders too (``read_page(..., plain=True)``):

- written by PIL, two pages each, under none, LZW, Deflate, PackBits and
  LZMA (34925): RGBA (unassociated alpha), LA, palette, CMYK, bilevel
  and 8-bit gray;
- written here around chunks this file codes (PIL cannot write them):
  PlanarConfiguration 2 of RGB and RGBA under none, LZW (predictor 1
  and 2), Deflate, PackBits, LZMA and JPEG, stripped and tiled;
  associated alpha; bilevel and 8-bit min-is-white; 16-bit RGB, little-
  and big-endian, with predictor 2; a 4-bit palette; RGB with an
  unspecified extra sample;
- the decode budget of each new mode at the JAX table's bytes a pixel;
- layouts PIL refuses or the port still refuses (FillOrder 2, 5-sample
  RGB, CCITT Group 4) raise ``NotImplementedError`` naming the tag.
"""
import io
import lzma
import struct
import zlib

import numpy as np
import pytest
from PIL import Image

from test_torch_codecs import _image, _lzw_encode

from multimodalfusion_tpu.data import wsi as jw
from multimodalfusion_tpu_torch.data import wsi as tw
from multimodalfusion_tpu_torch.utils import tiff

NONE, LZW, JPEG, DEFLATE, PACKBITS, LZMA = 1, 5, 7, 8, 32773, 34925


def _check(path, n_pages=None):
    got, want = tw.PILSlide(path).levels, jw.PILSlide(path).levels
    assert [g.shape for g in got] == [w.shape for w in want]
    if n_pages:
        assert len(got) == n_pages
    for g, w in zip(got, want):
        assert g.dtype == np.uint8
        np.testing.assert_array_equal(g, w)
    for page, g in zip(tiff.read_pages(path), got):
        np.testing.assert_array_equal(tiff.read_page(path, page, plain=True),
                                      g)


def _image4(h, w, seed):
    """Four seeded samples a pixel: ``_image``'s three and a fourth."""
    return np.concatenate([_image(h, w, seed=seed),
                           _image(h, w, c=1, seed=seed + 100)], -1)


def _pil_page(mode, h, w, seed):
    img = Image.fromarray(_image4(h, w, seed), "RGBA")
    if mode == "LA":
        return Image.merge("LA", (img.getchannel(0), img.getchannel(3)))
    if mode == "CMYK":
        return Image.fromarray(_image4(h, w, seed), "CMYK")
    return img if mode == "RGBA" else img.convert("RGB").convert(mode)


# ---- written by PIL

@pytest.mark.parametrize("mode", ["RGBA", "LA", "P", "CMYK", "1", "L"])
@pytest.mark.parametrize("compression", ["raw", "tiff_lzw",
                                         "tiff_adobe_deflate", "packbits",
                                         "lzma"])
def test_pil_written_layouts_equal_jax(tmp_path, mode, compression):
    path = str(tmp_path / f"{mode}.tiff")
    pages = [_pil_page(mode, 37, 53, 1), _pil_page(mode, 18, 26, 2)]
    pages[0].save(path, compression=compression, save_all=True,
                  append_images=pages[1:])
    heads = tiff.read_pages(path)
    with Image.open(path) as im:
        assert heads[0].mode == im.mode
    _check(path, 2)


# ---- written here

def _packbits(raw: bytes) -> bytes:
    """PackBits of ``raw``: runs of 3 or more equal bytes repeated,
    literals of at most 128 bytes."""
    out, i, n = bytearray(), 0, len(raw)
    lit = bytearray()

    def flush():
        for k in range(0, len(lit), 128):
            part = lit[k:k + 128]
            out.append(len(part) - 1)
            out.extend(part)
        lit.clear()
    while i < n:
        j = i
        while j < n and j - i < 128 and raw[j] == raw[i]:
            j += 1
        if j - i >= 3:
            flush()
            out.append(257 - (j - i))
            out.append(raw[i])
            i = j
        else:
            lit.append(raw[i])
            i += 1
    flush()
    return bytes(out)


def _differenced(px):
    d = px.astype(np.int64)
    d[:, 1:] -= px[:, :-1].astype(np.int64)
    return (d % (1 << (8 * px.dtype.itemsize))).astype(px.dtype)


def _pieces(img, tile, rps):
    h, w = img.shape[:2]
    if tile:
        tw_, th = tile
        full = np.pad(img, [(0, -h % th), (0, -w % tw_)]
                      + [(0, 0)] * (img.ndim - 2), mode="edge")
        return [full[y:y + th, x:x + tw_] for y in range(0, h, th)
                for x in range(0, w, tw_)]
    return [img[y:y + rps] for y in range(0, h, rps)]


def _encode(px, compression, predictor, order, bits):
    """One chunk's bytes: samples [rows, cols, s] packed (``bits`` < 8:
    MSB first, rows padded to bytes), differenced, compressed."""
    if bits < 8:
        rows = px[..., 0]
        raw = b"".join(np.packbits(np.unpackbits(
            r[:, None], axis=1)[:, 8 - bits:].ravel()).tobytes()
                       for r in rows)
    else:
        if predictor == 2:
            px = _differenced(px)
        raw = px.astype(px.dtype.newbyteorder(order)).tobytes()
    if compression == NONE:
        return raw
    if compression == LZW:
        return _lzw_encode(raw)
    if compression == DEFLATE:
        return zlib.compress(raw)
    if compression == PACKBITS:
        return _packbits(raw)
    if compression == LZMA:
        return lzma.compress(raw)
    buf = io.BytesIO()  # JPEG: one gray plane
    Image.fromarray(np.ascontiguousarray(px[..., 0])).save(buf, "JPEG",
                                                           quality=90)
    return buf.getvalue()


def _page(img, photometric, compression=NONE, planar=1, tile=None,
          rps=None, predictor=1, bits=8, extra=(), colormap=None,
          order="<"):
    """A page dict for ``_write``: samples [H, W, S] (uint8 or uint16),
    their chunks (one list a plane when ``planar`` is 2) and tags."""
    h, w, spp = img.shape
    rps = rps or h
    planes = [img[..., s:s + 1] for s in range(spp)] if planar == 2 else [
        img]
    chunks = [_encode(p, compression, predictor, order, bits)
              for plane in planes for p in _pieces(plane, tile, rps)]
    tags = {256: (4, [w]), 257: (4, [h]), 258: (3, [bits] * spp),
            259: (3, [compression]), 262: (3, [photometric]),
            277: (3, [spp]), 284: (3, [planar])}
    if tile:
        tags.update({322: (4, [tile[0]]), 323: (4, [tile[1]])})
    else:
        tags[278] = (4, [rps])
    if predictor != 1:
        tags[317] = (3, [predictor])
    if extra:
        tags[338] = (3, list(extra))
    if colormap is not None:
        tags[320] = (3, list(colormap))
    return dict(chunks=chunks, tags=tags, tiled=bool(tile))


def _write(path, pages, order="<"):
    """A TIFF of ``pages`` (``_page``), its IFDs written here."""
    out = bytearray((b"II*\0" if order == "<" else b"MM\0*") + b"\0" * 4)
    link = 4
    for p in pages:
        offsets = []
        for c in p["chunks"]:
            offsets.append(len(out))
            out += c + b"\0" * (len(c) % 2)
        tags = dict(p["tags"])
        off_tag, count_tag = (324, 325) if p["tiled"] else (273, 279)
        tags[off_tag] = (4, offsets)
        tags[count_tag] = (4, [len(c) for c in p["chunks"]])
        entries = sorted(tags.items())
        ifd = len(out)
        struct.pack_into(order + "I", out, link, ifd)
        extra = ifd + 2 + 12 * len(entries) + 4
        body, blobs = struct.pack(order + "H", len(entries)), b""
        for tag, (typ, vals) in entries:
            raw = struct.pack(f"{order}{len(vals)}{'H' if typ == 3 else 'I'}",
                              *vals)
            if len(raw) <= 4:
                field = raw + b"\0" * (4 - len(raw))
            else:
                field = struct.pack(order + "I", extra + len(blobs))
                blobs += raw
            body += struct.pack(order + "HHI", tag, typ, len(vals)) + field
        link = ifd + 2 + 12 * len(entries)
        out += body + b"\0\0\0\0" + blobs
    with open(path, "wb") as f:
        f.write(bytes(out))
    return path


def _pyramid(img):
    return [img, np.ascontiguousarray(img[::2, ::2])]


# (compression, predictor, alpha): libtiff's JPEG codec takes no alpha
PLANAR = [(c, pred, alpha) for c in (NONE, LZW, DEFLATE, PACKBITS, LZMA, JPEG)
          for pred in ((1, 2) if c == LZW else (1,))
          for alpha in ((False,) if c == JPEG else (False, True))]


@pytest.mark.parametrize("compression,predictor,alpha", PLANAR)
@pytest.mark.parametrize("layout", ["strips", "tiles"])
def test_planar_pages_equal_jax(tmp_path, compression, predictor, layout,
                                alpha):
    """PlanarConfiguration 2 (Bio-Formats' bfconvert writes RGB planes
    apart): one chunk list a sample, under every compression the port
    reads; JPEG planes are gray streams."""
    kw = dict(tile=(32, 16)) if layout == "tiles" else dict(rps=7)
    img = _image4(45, 70, 3) if alpha else _image(45, 70, seed=3)
    pages = [_page(lvl, 2, compression, planar=2, predictor=predictor,
                   extra=(2,) if alpha else (), **kw)
             for lvl in _pyramid(img)]
    _check(_write(str(tmp_path / "planar.tiff"), pages), 2)


@pytest.mark.parametrize("extra", [(1,), (2,), (0,), ()],
                         ids=["associated", "unassociated", "unspecified",
                              "none"])
@pytest.mark.parametrize("planar", [1, 2])
@pytest.mark.parametrize("compression", [NONE, LZW])
def test_rgb_with_a_fourth_sample_equals_jax(tmp_path, extra, planar,
                                             compression):
    """ExtraSamples 1 (associated alpha: PIL divides it out), 2 and none
    (RGBA: alpha dropped), 0 (RGBX: the sample ignored); alpha 0 and 255
    included.  A compressed planar page without ExtraSamples goes through
    libtiff's RGBA reader in PIL, which counts its alpha associated; an
    uncompressed planar page of an associated or unspecified fourth
    sample PIL's raw reader refuses, and so does the port.  Uncompressed
    pages in strips, compressed ones in tiles."""
    img = _image4(33, 47, 4)
    img[0, :5, 3] = 0
    img[1, :5, 3] = 255
    if extra == (1,):  # premultiplied samples never exceed alpha
        img[..., :3] = np.minimum(img[..., :3], img[..., 3:])
    kw = dict(tile=(16, 16)) if compression != NONE else dict(rps=6)
    pages = [_page(lvl, 2, compression, planar=planar, extra=extra, **kw)
             for lvl in _pyramid(img)]
    path = _write(str(tmp_path / "rgba.tiff"), pages)
    if (planar, compression) == (2, NONE) and extra in ((0,), (1,)):
        with pytest.raises(ValueError):
            jw.PILSlide(path)
        with pytest.raises(NotImplementedError, match="tag 338"):
            tw.PILSlide(path)
        return
    _check(path, 2)


@pytest.mark.parametrize("photometric", [0, 1], ids=["min_is_white",
                                                      "min_is_black"])
@pytest.mark.parametrize("bits", [1, 8])
@pytest.mark.parametrize("compression", [NONE, LZW, PACKBITS])
def test_bilevel_and_min_is_white_equal_jax(tmp_path, photometric, bits,
                                            compression):
    g = _image(29, 43, c=1, seed=5)
    if bits == 1:
        g = (g > 128).astype(np.uint8)
    pages = [_page(lvl, photometric, compression, bits=bits, rps=5)
             for lvl in _pyramid(g)]
    _check(_write(str(tmp_path / "bw.tiff"), pages), 2)


@pytest.mark.parametrize("order", ["<", ">"])
@pytest.mark.parametrize("compression,predictor", [(NONE, 1), (LZW, 2),
                                                   (DEFLATE, 1)])
def test_16_bit_rgb_equals_jax(tmp_path, order, compression, predictor):
    """16-bit RGB as PIL's "RGB;16L" / "RGB;16B" unpackers take it: the
    high byte of each sample."""
    img = (_image(31, 45, seed=6).astype(np.uint16) * 257
           + np.arange(45, dtype=np.uint16)[None, :, None])
    pages = [_page(lvl, 2, compression, predictor=predictor, bits=16,
                   order=order, tile=(16, 16))
             for lvl in _pyramid(img)]
    _check(_write(str(tmp_path / "rgb16.tiff"), pages, order), 2)


@pytest.mark.parametrize("bits", [4, 8])
def test_palette_pages_equal_jax(tmp_path, bits):
    """Photometric 3: the ColorMap's 16-bit entries // 256, as PIL's
    palette holds them; 4-bit indices packed two a byte."""
    n = 1 << bits
    rng = np.random.default_rng(bits)
    cmap = rng.integers(0, 65536, 3 * n)
    idx = (_image(27, 39, c=1, seed=7).astype(np.int64) % n).astype(np.uint8)
    pages = [_page(lvl, 3, LZW, bits=bits, colormap=cmap, rps=4)
             for lvl in _pyramid(idx)]
    _check(_write(str(tmp_path / "pal.tiff"), pages), 2)


def test_budget_counts_the_new_modes(tmp_path):
    """The decode budget from the headers: the largest page in its native
    mode (RGBA, LA and CMYK 4 B/px, palette and bilevel 1) beside 3 B/px
    RGB, at the JAX table's bytes."""
    for mode, bpp in (("RGBA", 4), ("LA", 4), ("CMYK", 4), ("P", 1),
                      ("1", 1)):
        path = str(tmp_path / f"{mode}.tiff")
        _pil_page(mode, 20, 30, 9).save(path, compression="tiff_lzw")
        assert tiff.read_pages(path)[0].mode == mode
        need = 3 * 20 * 30 + bpp * 20 * 30
        for cls in (tw.PILSlide, jw.PILSlide):
            cls(path, max_decode_bytes=need)
            with pytest.raises(ValueError, match="budget"):
                cls(path, max_decode_bytes=need - 1)


def test_layouts_still_refused_name_the_tag(tmp_path):
    """FillOrder 2 and five-sample RGB: the port raises naming the tag;
    CCITT Group 4 (Compression 4) names the compression."""
    img = _image(16, 16, c=1, seed=8)
    page = _page(img, 1, NONE)
    page["tags"][266] = (3, [2])
    with pytest.raises(NotImplementedError, match="tag 266"):
        tw.PILSlide(_write(str(tmp_path / "fill.tiff"), [page]))
    page = _page(_image4(16, 16, 8)[..., [0, 1, 2, 3, 3]], 2, NONE,
                 extra=(2, 0))
    page["tags"][258] = (3, [8] * 5)
    with pytest.raises(NotImplementedError, match="tag 338"):
        tw.PILSlide(_write(str(tmp_path / "five.tiff"), [page]))
    page = _page(_image(16, 16, seed=8), 2, NONE)
    page["tags"][259] = (3, [4])
    with pytest.raises(NotImplementedError, match="tag 259"):
        tw.PILSlide(_write(str(tmp_path / "g4.tiff"), [page]))
