"""Aperio ``.svs`` slides in the port (``utils/aperio.py``,
``tiff.read_tiles``, ``data/wsi.OpenSlideBackend``) against PIL and the
JAX package's openslide route, on the CPU.

The slides are written here by ``tools/svs_writer.py`` with PIL's JPEG
encoder: a level 0 of 1920 x 1440 (8 x 6 tiles of 240) with levels at
downsample 4 and 16, a stripped JPEG thumbnail, an LZW label and a JPEG
macro; the same with sides that do not divide by 16 (so the downsamples
are openslide's mean of two ratios and the edge tiles are cropped); with
a missing tile (byte count 0); and with photometric 2 over YCbCr-coded
streams.

- Held to PIL: each level read whole through ``read_region`` equals
  JAX's ``PILSlide`` page of a ``.tif`` copy bit for bit (tolerance 0);
  the missing tile, which PIL cannot decode, reads (0, 0, 0) over the
  pixels of the same file with the tile present; the plain decoders
  equal the C++ route; the associated images equal PIL's pages.
- Held to JAX's ``OpenSlideBackend``: an ``openslide`` module written
  here on PIL from openslide's Aperio rules (the levels are the tiled
  pages; page 1 is the thumbnail, another stripped page is named by its
  description's second line; downsample ``(w0 / w + h0 / h) / 2``; the
  ``aperio.*`` properties, ``openslide.mpp-x`` and ``-y`` as glib writes
  a double, ``openslide.objective-power``, ``openslide.vendor``; a
  transparent result outside the level and on a missing tile) is put in
  ``sys.modules``, so JAX's ``open_slide`` builds its own
  ``OpenSlideBackend``.  Its levels, downsamples, properties,
  ``thumbnail()``, ``fetch_mag_patching_params`` and whole-number regions
  (across the right and bottom edges and the missing tile) equal the
  port's.  JAX's ``create_patches`` and ``extract_features_fp`` (default
  ``--slide_ext .svs``, ``--dtype float32``, one seeded ``--weights``)
  against the port's: equal coordinates and attributes, features at the
  ResNet tolerance.
- The tile route reads a slide whose decode ``PILSlide``'s budget
  refuses, decodes only the tiles a region touches and keeps its cache
  within its bound.
- Refusals: bytes of no format (``OSError``), a TIFF without an Aperio
  description (``NotImplementedError``), Aperio's JPEG 2000 (33003,
  ``NotImplementedError`` naming it), a tiled page that is not
  reduced-resolution, and ``.ndpi`` by its extension.
"""
import importlib.util
import io
import os
import shutil
import struct
import sys
import types

import cv2
import h5py
import numpy as np
import pytest
import torch
from PIL import Image

from test_torch_codecs import _image
from test_torch_resnet import ATOL, RTOL, seeded_state_dict
from test_torch_tiff_layouts import _page, _write as _write_layout
from test_torch_wsi_compressed import _pil_chunk

from multimodalfusion_tpu.cli.create_patches import main as jax_cp
from multimodalfusion_tpu.cli.extract_features_fp import main as jax_fx
from multimodalfusion_tpu.data import wsi as jw
from multimodalfusion_tpu_torch.cli import create_patches as tcp
from multimodalfusion_tpu_torch.cli import extract_features_fp as tfx
from multimodalfusion_tpu_torch.data import wsi as tw
from multimodalfusion_tpu_torch.data.io import load_pt
from multimodalfusion_tpu_torch.utils import aperio, tiff

_spec = importlib.util.spec_from_file_location(
    "svs_writer", os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "tools", "svs_writer.py"))
svs_writer = importlib.util.module_from_spec(_spec)  # the test coder
_spec.loader.exec_module(svs_writer)
_spec = importlib.util.spec_from_file_location(
    "bigtiff", os.path.join(os.path.dirname(svs_writer.__file__),
                            "bigtiff.py"))
bigtiff = importlib.util.module_from_spec(_spec)  # the BigTIFF re-packer
_spec.loader.exec_module(bigtiff)

T = svs_writer.TILE
# name: (level-0 width, height, photometric, missing (level, tile) pairs)
SLIDES = {"base": (1920, 1440, 6, ()), "odd": (1900, 1430, 6, ()),
          "missing": (1920, 1440, 6, ((0, 9),)),
          "rgb": (1920, 1440, 2, ())}
PATCH = ["--patch_size", "128", "--step_size", "128", "--a_t", "0.5",
         "--a_h", "0.05"]
# the file PIL decodes for a slide with missing tiles: the same tiles, all
# present (PIL cannot decode a page with a missing tile)
_COMPLETE = {}


def _pil_jpeg(subsampling):
    def encode(rgb):
        buf = io.BytesIO()
        Image.fromarray(rgb).save(buf, "JPEG", quality=90,
                                  subsampling=subsampling)
        return buf.getvalue()
    return encode


def _write(folder, name, w, h, photometric, missing, **kw):
    img = jw.synthetic_slide(w, h, n_blobs=3, seed=len(name),
                             n_levels=1).levels[0]
    levels = [img] + [cv2.resize(img, (w // d, h // d),
                                 interpolation=cv2.INTER_AREA)
                      for d in (4, 16)]
    encode = _pil_jpeg(2 if photometric == 6 else 0)
    coded = svs_writer.encode_levels(levels, encode)
    extra = dict(thumbnail=np.ascontiguousarray(levels[2][::2, ::2]),
                 label=np.ascontiguousarray(img[:40, :56]),
                 lzw=lambda rgb: _pil_chunk(rgb, "tiff_lzw"),
                 macro=np.ascontiguousarray(levels[2][:50, :90]))
    extra.update(kw)
    path = os.path.join(folder, f"{name}.svs")
    svs_writer.write_svs(path, coded, encode, photometric=photometric,
                         missing=missing, **extra)
    if missing:
        _COMPLETE[path] = svs_writer.write_svs(
            f"{folder}_complete.tif", coded, encode, photometric=photometric,
            **extra)
    return path


@pytest.fixture(scope="module")
def slides(tmp_path_factory):
    root = tmp_path_factory.mktemp("svs")
    out = {}
    for name, (w, h, photometric, missing) in SLIDES.items():
        folder = root / name
        os.makedirs(folder)
        out[name] = _write(str(folder), name, w, h, photometric, missing)
    return out


# ---- openslide's Aperio rules on PIL, for JAX's OpenSlideBackend

def _standin_properties(desc):
    """openslide's properties of an Aperio slide (add_properties and the
    duplicated standard ones, with glib's number parsing and printing)."""
    props = {"openslide.vendor": "aperio"}
    for item in desc.split("|")[1:]:
        if "=" in item:
            key, value = item.split("=", 1)
            props["aperio." + key.strip(" \t\n\v\f\r")] = value.strip(
                " \t\n\v\f\r")
    try:  # _openslide_parse_double: a comma read as the decimal point
        mpp = float(props.get("aperio.MPP", "x").replace(",", "."))
    except ValueError:
        mpp = None
    if mpp is not None and np.isfinite(mpp):
        props["openslide.mpp-x"] = props["openslide.mpp-y"] = "%.17g" % mpp
    mag = props.get("aperio.AppMag", "")
    if mag.lstrip("+-").isdigit():
        props["openslide.objective-power"] = str(int(mag))
    return props


class _OpenSlide:
    """``openslide.OpenSlide`` of an Aperio slide, its pixels PIL's."""

    def __init__(self, path):
        im = Image.open(path)
        tags = []
        for i in range(im.n_frames):
            im.seek(i)
            tags.append(dict(im.tag_v2))
        if 322 not in tags[0] or not str(tags[0].get(270, "")).startswith(
                "Aperio"):
            raise NotImplementedError("the stand-in reads Aperio only")
        self._path, self._tags = path, tags
        self._pages = [i for i, t in enumerate(tags) if 322 in t]
        self.level_dimensions = tuple((tags[i][256], tags[i][257])
                                      for i in self._pages)
        self.level_count = len(self._pages)
        w0, h0 = self.level_dimensions[0]
        self.level_downsamples = tuple((w0 / w + h0 / h) / 2
                                       for w, h in self.level_dimensions)
        self.properties = _standin_properties(tags[0][270])
        self.associated_images = {}
        for i, t in enumerate(tags):
            if 322 in t:
                continue
            lines = str(t.get(270, "")).replace("\r", "\n").split("\n")
            name = "thumbnail" if i == 1 else (
                lines[1].split(" ")[0] if len(lines) > 1 and lines[1]
                else None)
            if name is not None:
                self.associated_images[name] = i
        self._rgba = {}

    def _level(self, level):
        if level not in self._rgba:
            page = self._pages[level]
            im = Image.open(_COMPLETE.get(self._path, self._path))
            im.seek(page)
            rgba = im.convert("RGBA")
            t = self._tags[page]
            across = -(-t[256] // t[322])
            for k, count in enumerate(t[325]):
                if count == 0:  # a missing tile is transparent
                    rgba.paste(Image.new("RGBA", (t[322], t[323])),
                               (k % across * t[322], k // across * t[323]))
            self._rgba[level] = rgba
        return self._rgba[level]

    def read_region(self, location, level, size):
        ds = self.level_downsamples[level]
        x, y = location[0] / ds, location[1] / ds
        assert x == int(x) and y == int(y), "a whole-number position"
        x, y = int(x), int(y)
        # PIL's crop is transparent outside the image, as openslide's read
        return self._level(level).crop((x, y, x + size[0], y + size[1]))


@pytest.fixture
def openslide(monkeypatch):
    mod = types.ModuleType("openslide")
    mod.OpenSlide = _OpenSlide
    mod.open_slide = _OpenSlide
    monkeypatch.setitem(sys.modules, "openslide", mod)
    return mod


# ---- held to PIL

def _complete_levels(path):
    """JAX's PILSlide pages of ``path``'s tiled pages (a .tif copy), the
    missing tiles (0, 0, 0)."""
    pages = tiff.read_pages(path)
    src = _COMPLETE.get(path, path)
    tif = os.path.dirname(path) + "_pil.tif"  # beside the slide's folder
    if not os.path.exists(tif):
        shutil.copy(src, tif)
    by_shape = {lv.shape: lv for lv in jw.PILSlide(tif).levels}
    assert len(by_shape) == len(pages)  # every page its own shape
    out = []
    for page in (p for p in pages if p.tile):
        lv = by_shape[(page.height, page.width, 3)].copy()
        across = tiff.tile_grid(page)[0]
        for k, (_, count) in enumerate(page.chunks):
            if count == 0:
                y, x = k // across * T, k % across * T
                lv[y:y + T, x:x + T] = 0
        out.append(lv)
    return out


@pytest.mark.parametrize("name", sorted(SLIDES))
def test_levels_equal_pil(slides, name):
    path = slides[name]
    slide = tw.open_slide(path)
    assert isinstance(slide, tw.OpenSlideBackend) and slide.name == name
    want = _complete_levels(path)
    assert slide.level_count == len(want) == 3
    pages = tiff.read_pages(path)
    for lvl, ref in enumerate(want):
        dims = slide.level_dimensions[lvl]
        got = slide.read_region((0, 0), lvl, dims)
        np.testing.assert_array_equal(got, ref)
        # the plain decoders, tile by tile
        page = pages[slide.wsi.levels[lvl]]
        across, down = tiff.tile_grid(page)
        for t in range(across * down):
            y, x = t // across * T, t % across * T
            out = np.empty_like(ref[y:y + T, x:x + T])
            tiff.read_tiles(path, page, [t], [out], plain=True)
            np.testing.assert_array_equal(out, got[y:y + T, x:x + T])
    np.testing.assert_array_equal(slide.thumbnail(), want[-1])
    # the associated pages, as openslide names them, read as PIL reads them
    assert slide.wsi.associated == {"thumbnail": 1, "label": 4, "macro": 5}
    for index in slide.wsi.associated.values():
        im = Image.open(path)
        im.seek(index)
        np.testing.assert_array_equal(tiff.read_page(path, pages[index]),
                                      np.asarray(im.convert("RGB")))


def test_odd_sides_downsamples_and_edge_tiles(slides):
    slide = tw.open_slide(slides["odd"])
    assert slide.level_dimensions == [(1900, 1430), (475, 357), (118, 89)]
    for (d, e), (w, h) in zip(slide.level_downsamples[1:],
                              slide.level_dimensions[1:]):
        assert d == e == (1900 / w + 1430 / h) / 2 and d != 1900 / w
    page = tiff.read_pages(slides["odd"])[0]
    assert tiff.tile_grid(page) == (8, 6)
    edge = np.empty((1430 - 5 * T, 1900 - 7 * T, 3), np.uint8)
    tiff.read_tiles(slides["odd"], page, [47], [edge])
    np.testing.assert_array_equal(edge, slide.read_region(
        (7 * T, 5 * T), 0, (edge.shape[1], edge.shape[0])))


def test_bigtiff_svs_reads_as_classic(slides, tmp_path):
    """An Aperio slide in BigTIFF (as scanners write slides past 4 GB),
    every tile's bytes kept: the classic file's levels and properties."""
    big = bigtiff.repack(slides["base"], str(tmp_path / "big.svs"))
    t, c = tw.open_slide(big), tw.open_slide(slides["base"])
    assert open(big, "rb").read(4) == b"II+\0"
    assert (t.level_dimensions, t.wsi.properties, t.wsi.associated) == (
        c.level_dimensions, c.wsi.properties, c.wsi.associated)
    for lvl, dims in enumerate(t.level_dimensions):
        np.testing.assert_array_equal(t.read_region((0, 0), lvl, dims),
                                      c.read_region((0, 0), lvl, dims))


# ---- held to JAX's OpenSlideBackend

def _regions(slide, rng, n=12):
    """(location, level, size) at whole-number level positions, some
    across the level's right and bottom edges."""
    out = []
    for level, (w, h) in enumerate(slide.level_dimensions):
        ds = slide.level_downsamples[level][0]
        step = int(ds) if ds == int(ds) else None
        for _ in range(n if step else 1):
            size = (int(rng.integers(1, 300)), int(rng.integers(1, 300)))
            if step is None:  # only (0, 0) is a whole number there
                out.append(((0, 0), level, size))
                continue
            x, y = int(rng.integers(0, w)), int(rng.integers(0, h))
            out.append(((x * step, y * step), level, size))
        out.append((((w - 50) * int(ds), (h - 40) * int(ds)), level,
                    (120, 100)) if step else ((0, 0), level, (w + 7, h + 9)))
    return out


@pytest.mark.parametrize("name", sorted(SLIDES))
def test_backend_equals_jax_openslide_backend(slides, name, openslide):
    path = slides[name]
    j, t = jw.open_slide(path), tw.open_slide(path)
    assert isinstance(j, jw.OpenSlideBackend)
    assert (t.name, t.level_count, t.level_dimensions) == (
        j.name, j.level_count, j.level_dimensions)
    assert t.level_downsamples == j.level_downsamples
    assert t.wsi.properties == j.wsi.properties
    assert t.wsi.associated == j.wsi.associated_images
    assert t.wsi.properties["openslide.mpp-x"] == "%.17g" % 0.499
    for mag in (20, 5):
        assert tw.fetch_mag_patching_params(t, mag_level=mag) == \
            jw.fetch_mag_patching_params(j, mag_level=mag)
    np.testing.assert_array_equal(t.thumbnail(), j.thumbnail())
    regions = _regions(t, np.random.default_rng(len(name)))
    if name == "missing":  # the missing tile (row 1, column 1) and around
        regions += [((T + 10, T + 20), 0, (300, 260)), ((T, T), 0, (T, T))]
    for loc, level, size in regions:
        np.testing.assert_array_equal(t.read_region(loc, level, size),
                                      j.read_region(loc, level, size))
    coords = np.array([loc for loc, level, _ in regions if level == 0])
    np.testing.assert_array_equal(tw.read_patches(t, coords, 0, 200),
                                  jw.read_patches(j, coords, 0, 200))
    assert tw.fetch_mag_patching_params(t, mag_level=5)[1] == 1


def test_properties_follow_openslide():
    desc = ("Aperio Image Library v11.2.1 \r\n46000x32914 [0,100 46000x32914]"
            " (256x256) JPEG/RGB Q=30| AppMag = 40 |MPP = 0,2520|Filename ="
            " a=b|no value|  Left  =  25.69\r\n")
    got = aperio.properties(desc)
    assert got == _standin_properties(desc)
    assert got["aperio.AppMag"] == "40" and got["aperio.Filename"] == "a=b"
    assert got["openslide.mpp-x"] == "%.17g" % 0.252 == "0.252"
    assert got["openslide.objective-power"] == "40"
    assert got["aperio.Left"] == "25.69" and "aperio.no value" not in got
    odd = aperio.properties("Aperio X|AppMag = 40.0|MPP = n/a")
    assert odd == _standin_properties("Aperio X|AppMag = 40.0|MPP = n/a")
    assert "openslide.objective-power" not in odd
    assert "openslide.mpp-x" not in odd


def test_create_patches_equals_jax(slides, openslide, tmp_path):
    src = os.path.dirname(slides["base"])
    out = {}
    for who, fn, extra in (("jax", jax_cp, []),
                           ("port", tcp.main, ["--device", "cpu"])):
        out[who] = tmp_path / who
        assert fn(["--source", src, "--save_dir", str(out[who])] + PATCH
                  + extra) == 0
    with h5py.File(out["jax"] / "patches" / "base_patches.h5", "r") as j, \
            h5py.File(out["port"] / "patches" / "base_patches.h5",
                      "r") as t:
        assert len(t["coords"]) > 20
        np.testing.assert_array_equal(t["coords"][()], j["coords"][()])
        ja, ta = dict(j["coords"].attrs), dict(t["coords"].attrs)
        assert sorted(ta) == sorted(ja)
        for k in ja:
            assert type(ta[k]) is type(ja[k]), k
            np.testing.assert_array_equal(ta[k], ja[k])


def test_extract_features_equals_jax(slides, openslide, tmp_path):
    src = os.path.dirname(slides["base"])
    assert tcp.main(["--source", src, "--save_dir", str(tmp_path / "p"),
                     "--device", "cpu"] + PATCH) == 0
    weights = str(tmp_path / "resnet50.pt")
    torch.save(seeded_state_dict(3), weights)
    common = ["--data_h5_dir", str(tmp_path / "p"), "--data_slide_dir", src,
              "--batch_size", "16", "--target_patch_size", "64",
              "--dtype", "float32", "--weights", weights]
    assert jax_fx(common + ["--feat_dir", str(tmp_path / "fj")]) == 0
    assert tfx.main(common + ["--feat_dir", str(tmp_path / "ft"),
                              "--device", "cpu"]) == 0
    want = load_pt(str(tmp_path / "fj" / "path_pt_files" / "base.pt"))
    got = load_pt(str(tmp_path / "ft" / "path_pt_files" / "base.pt"))
    assert got.shape == want.shape and 20 < len(got) < 100
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


# (samples, compression, planar, predictor, bits) of the pages whose
# tiles read_tiles decodes as read_page decodes the page
TILE_LAYOUTS = {"none": (3, 1, 1, 1, 8), "lzw_predictor2": (3, 5, 1, 2, 8),
                "deflate": (3, 8, 1, 1, 8), "packbits": (3, 32773, 1, 1, 8),
                "lzma": (3, 34925, 1, 1, 8), "planar_lzw": (3, 5, 2, 1, 8),
                "planar_jpeg": (3, 7, 2, 1, 8), "gray_jpeg": (1, 7, 1, 1, 8),
                "gray16_deflate": (1, 8, 1, 2, 16)}


@pytest.mark.parametrize("name", sorted(TILE_LAYOUTS))
def test_read_tiles_equals_read_page(tmp_path, name):
    """Any tiled page the reader takes: each tile, edge tiles cropped,
    through the C++ and the plain decoders, equals read_page's pixels
    there; a tile of byte count 0 reads 0."""
    spp, compression, planar, predictor, bits = TILE_LAYOUTS[name]
    img = _image(70, 100, c=spp, seed=5)
    if bits == 16:
        img = img.astype(np.uint16) * 257 + 3
    path = _write_layout(str(tmp_path / f"{name}.tif"), [_page(
        img, 2 if spp == 3 else 1, compression, planar=planar,
        tile=(32, 16), predictor=predictor, bits=bits)])
    page = tiff.read_pages(path)[0]
    whole = tiff.read_page(path, page)
    across, down = tiff.tile_grid(page)
    assert (across, down) == (4, 5)
    tiles = list(range(across * down))[::-1]
    for plain in (False, True):
        outs = [np.empty_like(whole[t // across * 16:t // across * 16 + 16,
                                    t % across * 32:t % across * 32 + 32])
                for t in tiles]
        tiff.read_tiles(path, page, tiles, outs, plain=plain)
        for t, o in zip(tiles, outs):
            y, x = t // across * 16, t % across * 32
            np.testing.assert_array_equal(o, whole[y:y + 16, x:x + 32])
    chunks = list(page.chunks)
    chunks[6] = (chunks[6][0], 0)
    out = np.full((16, 32, 3), 7, np.uint8)
    tiff.read_tiles(path, page._replace(chunks=chunks), [6], [out])
    assert not out.any()


# ---- the tile route

def test_tile_route_reads_what_pilslide_refuses(slides, tmp_path,
                                                 monkeypatch):
    path = slides["base"]
    tif = str(shutil.copy(path, tmp_path / "base.tif"))
    with pytest.raises(ValueError, match="budget"):
        tw.PILSlide(tif, max_decode_bytes=1 << 20)
    nbytes = T * T * 3
    monkeypatch.setattr(tw.OpenSlideBackend, "CACHE_BYTES", 4 * nbytes)
    slide = tw.OpenSlideBackend(path)
    # a region on four tiles decodes those four, then none again
    region = slide.read_region((T - 5, T - 5), 0, (10, 10))
    assert (slide.tiles_decoded, slide.tiles_touched) == (4, 4)
    np.testing.assert_array_equal(slide.read_region((T - 5, T - 5), 0,
                                                    (10, 10)), region)
    assert (slide.tiles_decoded, slide.tiles_touched) == (4, 8)
    # a batch of patches decodes each tile it touches once
    rng = np.random.default_rng(0)
    coords = rng.integers(0, 1800, (40, 2))
    before = slide.tiles_decoded, slide.tiles_touched
    batch = tw.read_patches(slide, coords, 0, 128)
    touched = {ty * 8 + tx for x, y in coords if x < 1920 and y < 1440
               for ty in range(y // T, (min(y + 128, 1440) - 1) // T + 1)
               for tx in range(x // T, (min(x + 128, 1920) - 1) // T + 1)}
    assert slide.tiles_touched - before[1] == len(touched)
    assert slide.tiles_decoded - before[0] <= len(touched)
    for (x, y), patch in zip(coords, batch):
        np.testing.assert_array_equal(patch, slide.read_region((x, y), 0,
                                                               (128, 128)))
    assert slide.cache.peak_bytes == 4 * nbytes


# ---- refusals

def _set_tag(path, tag, value, pages=None):
    """Write ``value`` into the short or long ``tag`` of the IFDs
    ``pages`` (all when None) of a little-endian classic TIFF."""
    with open(path, "r+b") as f:
        data = bytearray(f.read())
        (at,) = struct.unpack_from("<I", data, 4)
        k = 0
        while at:
            (n,) = struct.unpack_from("<H", data, at)
            for i in range(n):
                e = at + 2 + 12 * i
                t, typ = struct.unpack_from("<HH", data, e)
                if t == tag and (pages is None or k in pages):
                    struct.pack_into("<H" if typ == 3 else "<I", data,
                                     e + 8, value)
            (at,) = struct.unpack_from("<I", data, at + 2 + 12 * n)
            k += 1
        f.seek(0)
        f.write(data)
    return path


def test_refusals(slides, tmp_path):
    junk = tmp_path / "junk.svs"
    junk.write_bytes(b"\0" * 64)
    with pytest.raises(OSError, match="junk.svs.*cannot identify"):
        tw.open_slide(str(junk))
    plain = str(tmp_path / "plain.svs")
    svs_writer.write_twin(plain, svs_writer.encode_levels(
        [np.zeros((300, 500, 3), np.uint8)], _pil_jpeg(2)))
    with pytest.raises(NotImplementedError, match="plain.svs.*generic TIFF"):
        tw.open_slide(plain)
    j2k = _set_tag(shutil.copy(slides["base"], tmp_path / "j2k.svs"), 259,
                   33003, pages=(0,))
    with pytest.raises(NotImplementedError, match="j2k.svs.*33003"):
        tw.open_slide(str(j2k))
    flat = _set_tag(shutil.copy(slides["base"], tmp_path / "flat.svs"), 254,
                    0, pages=(2,))
    with pytest.raises(ValueError, match="page 2.*reduced-resolution"):
        tw.open_slide(str(flat))
    ndpi = shutil.copy(slides["base"], tmp_path / "s.ndpi")
    with pytest.raises(NotImplementedError, match="s.ndpi.*not supported"):
        tw.open_slide(str(ndpi))
