"""ZSTD-compressed TIFF pages (Compression 50000) read by the port's
``utils/tiff.py`` -- its C++ decoder and, page by page, its plain one
(``read_page(..., plain=True)``) -- held to the JAX package's
``PILSlide`` (PIL, libtiff, libzstd) on the same files: the port's
``PILSlide(path).levels`` equal JAX ``PILSlide(path).levels`` bit for bit
(tolerance 0):

- written by PIL (``compression="zstd"``), two pages each, with
  predictor 1 and (8-bit samples) 2: L, RGB, RGBA, LA, P, CMYK and 1;
- written here around chunks ``zstandard`` codes: strips and tiles,
  chunky and planar, predictor 1 and 2, RGB and RGBA; LA, 4-bit palette,
  CMYK, bilevel min-is-white and 16-bit RGB of either byte order; chunks
  with checksums; chunks of more frames than one (libtiff reads the
  first);
- written by ``tools/zstd_writer.py`` as ``chip_smoke.py`` writes its
  slide's crop (tiles with predictor 2, strips with checksums in small
  blocks, planar RGBA), at a small size;
- a corrupt chunk, a chunk of a dictionary and a short chunk raise.
"""
import numpy as np
import pytest
import zstandard
from PIL import Image

from test_torch_codecs import _image
from test_torch_tiff_layouts import (_check, _image4, _page, _pil_page,
                                     _pyramid, _write)
from test_torch_zstd import zw

from multimodalfusion_tpu.data import wsi as jw
from multimodalfusion_tpu_torch.data import wsi as tw
from multimodalfusion_tpu_torch.utils import tiff

NONE, ZSTD = 1, 50000


def _zpage(img, photometric, level=9, frames=1, checksum=False, **kw):
    """``_page`` with its chunks coded by libzstd (``frames`` frames a
    chunk)."""
    page = _page(img, photometric, NONE, **kw)
    c = zstandard.ZstdCompressor(level=level, write_checksum=checksum)
    chunks = []
    for raw in page["chunks"]:
        cut = len(raw) // frames
        chunks.append(b"".join(c.compress(raw[i * cut:(i + 1) * cut if
                                              i + 1 < frames else None])
                               for i in range(frames)))
    page["chunks"] = chunks
    page["tags"][259] = (3, [ZSTD])
    return page


# ---- written by PIL

# libtiff's predictor takes 8-bit samples only: not the bilevel and
# palette pages
PIL_CASES = [(m, p) for m in ("L", "RGB", "RGBA", "LA", "P", "CMYK", "1")
             for p in ((1,) if m in ("1", "P") else (1, 2))]


@pytest.mark.parametrize("mode,predictor", PIL_CASES)
def test_pil_written_zstd_equals_jax(tmp_path, mode, predictor):
    path = str(tmp_path / f"{mode}.tiff")
    pages = [_pil_page(mode, 37, 53, 1), _pil_page(mode, 18, 26, 2)]
    info = {317: predictor} if predictor == 2 else {}
    pages[0].save(path, compression="zstd", save_all=True,
                  append_images=pages[1:], tiffinfo=info)
    heads = tiff.read_pages(path)
    assert [h.compression for h in heads] == [ZSTD, ZSTD]
    assert heads[0].predictor == predictor
    with Image.open(path) as im:
        assert heads[0].mode == im.mode
    _check(path, 2)


# ---- written here

@pytest.mark.parametrize("alpha", [False, True], ids=["rgb", "rgba"])
@pytest.mark.parametrize("predictor", [1, 2])
@pytest.mark.parametrize("planar", [1, 2])
@pytest.mark.parametrize("layout", ["strips", "tiles"])
def test_rgb_pages_equal_jax(tmp_path, layout, planar, predictor, alpha):
    kw = dict(tile=(32, 16)) if layout == "tiles" else dict(rps=7)
    img = _image4(45, 70, 3) if alpha else _image(45, 70, seed=3)
    pages = [_zpage(lvl, 2, planar=planar, predictor=predictor,
                    extra=(2,) if alpha else (), **kw)
             for lvl in _pyramid(img)]
    _check(_write(str(tmp_path / "rgb.tiff"), pages), 2)


def _layout_case(name):
    if name == "LA":
        img = _image4(33, 47, 4)[..., [0, 3]]
        return img, dict(photometric=1, extra=(2,), predictor=2)
    if name == "P4":
        cmap = np.random.default_rng(4).integers(0, 65536, 48)
        idx = (_image(27, 39, c=1, seed=7) % 16).astype(np.uint8)
        return idx, dict(photometric=3, bits=4, colormap=cmap)
    if name == "CMYK":
        return _image4(33, 47, 5), dict(photometric=5, predictor=2)
    if name == "1_min_is_white":
        return (_image(29, 43, c=1, seed=5) > 128).astype(np.uint8), dict(
            photometric=0, bits=1)
    img = (_image(31, 45, seed=6).astype(np.uint16) * 257
           + np.arange(45, dtype=np.uint16)[None, :, None])
    return img, dict(photometric=2, bits=16, predictor=2)


@pytest.mark.parametrize("name", ["LA", "P4", "CMYK", "1_min_is_white",
                                  "RGB16_LE", "RGB16_BE"])
def test_other_layouts_equal_jax(tmp_path, name):
    img, kw = _layout_case(name)
    order = ">" if name == "RGB16_BE" else "<"
    kw["order"] = order
    photometric = kw.pop("photometric")
    pages = [_zpage(lvl, photometric, tile=(16, 16), **kw)
             for lvl in _pyramid(img)]
    _check(_write(str(tmp_path / f"{name}.tiff"), pages, order), 2)


@pytest.mark.parametrize("frames,checksum,level", [(2, False, 1),
                                                   (3, True, 19),
                                                   (1, True, 22)])
def test_a_chunk_is_its_first_frame(tmp_path, frames, checksum, level):
    """As libtiff reads a chunk (ZSTDDecode stops when libzstd says a
    frame is done): one whole frame, checksummed or not, then frames of
    noise that are not read; or the chunk cut over ``frames`` frames,
    which both packages refuse as short."""
    img = _image(40, 64, seed=9)
    pages = [_zpage(lvl, 2, level=level, checksum=checksum, rps=9,
                    predictor=2) for lvl in _pyramid(img)]
    noise = zstandard.ZstdCompressor().compress(bytes(range(200)))
    for p in pages:
        p["chunks"] = [c + noise * (frames - 1) for c in p["chunks"]]
    _check(_write(str(tmp_path / "first.tiff"), pages), 2)
    if frames == 1:
        return
    cut = [_zpage(lvl, 2, level=level, frames=frames, checksum=checksum,
                  rps=9, predictor=2) for lvl in _pyramid(img)]
    path = _write(str(tmp_path / "cut.tiff"), cut)
    with pytest.raises(OSError):
        jw.PILSlide(path).levels
    for plain in (False, True):
        with pytest.raises(OSError, match="decodes to"):
            tiff.read_page(path, tiff.read_pages(path)[0], plain=plain)


@pytest.mark.parametrize("layout", ["tiled_predictor2", "strips_checksum",
                                    "planar_rgba"])
def test_zstd_writer_pages_equal_jax(tmp_path, layout):
    """The port's own test-stream writer, as ``chip_smoke.py`` writes its
    slide's crop, at a small size."""
    img = _image(70, 90, seed=11)
    kw = {"tiled_predictor2": dict(tile=32, predictor=2),
          "strips_checksum": dict(rows=16, checksum=True, block=1024),
          "planar_rgba": dict(tile=32, planar=True, extra=(2,))}[layout]
    if layout == "planar_rgba":
        img = _image4(70, 90, 11)
    path = str(tmp_path / f"{layout}.tiff")
    zw.write_tiff(path, img, **kw)
    _check(path, 1)
    np.testing.assert_array_equal(tw.PILSlide(path).levels[0],
                                  img[..., :3])


def _one_page(tmp_path, chunk_fn):
    page = _zpage(_image(16, 24, seed=12), 2, rps=16)
    page["chunks"] = [chunk_fn(page["chunks"][0])]
    return _write(str(tmp_path / "bad.tiff"), [page])


def test_a_corrupt_chunk_raises_in_both_decoders(tmp_path):
    def damage(c):
        c = bytearray(c)
        c[len(c) // 2] ^= 0xFF
        c[-3] ^= 0x0F
        return bytes(c)
    path = _one_page(tmp_path, damage)
    page = tiff.read_pages(path)[0]
    for plain in (False, True):
        with pytest.raises((ValueError, OSError)):
            tiff.read_page(path, page, plain=plain)


def test_a_dictionary_chunk_names_its_id(tmp_path):
    path = _one_page(tmp_path, lambda c: c[:4] + bytes([c[4] | 1, 7])
                     + c[5:])
    page = tiff.read_pages(path)[0]
    for plain in (False, True):
        with pytest.raises(NotImplementedError, match="dictionary ID 7"):
            tiff.read_page(path, page, plain=plain)


def test_a_short_chunk_raises(tmp_path):
    path = _one_page(tmp_path, lambda c: zstandard.ZstdCompressor()
                     .compress(b"\0" * 100))
    page = tiff.read_pages(path)[0]
    for plain in (False, True):
        with pytest.raises(OSError, match="decodes to 100 of"):
            tiff.read_page(path, page, plain=plain)
