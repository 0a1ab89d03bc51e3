"""Slides routed by their first bytes, as PIL's ``Image.open`` routes them:
the port's ``PILSlide`` picks its reader from the file's content
(``data/wsi.slide_format``), whatever its name, and is held to JAX's
``PILSlide`` on the same files (levels bit for bit, the name the file
name's stem):

- a two-page TIFF named ``.btf``, ``.tf8``, ``.jfif``, ``.png`` and with
  no extension; a BigTIFF named ``.tif``; a PNG named ``.tif``; a JPEG
  named ``.jpe`` and ``.jp2``; a JP2 file named ``.tiff``;
- GIF, BMP, WebP and PPM files, which JAX reads through PIL, refused
  with ``NotImplementedError`` naming the format, under their own
  extension and named ``.tiff``;
- bytes of no image format raise ``OSError`` in both packages;
- a TIFF named ``.svs`` without an Aperio description is still refused
  by ``open_slide`` (JAX sends a ``.svs`` to openslide, whose generic TIFF
  route the port does not port).
"""
import importlib.util
import os

import numpy as np
import pytest
from PIL import Image

from test_torch_codecs import _image

from multimodalfusion_tpu.data import wsi as jw
from multimodalfusion_tpu_torch.data import wsi as tw

_spec = importlib.util.spec_from_file_location(
    "bigtiff", os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "tools", "bigtiff.py"))
bigtiff = importlib.util.module_from_spec(_spec)  # the test coder
_spec.loader.exec_module(bigtiff)


def _pages():
    img = Image.fromarray(_image(120, 160, seed=11))
    return [img, img.resize((80, 60))]


def _save(kind, path):
    """``path`` written as ``kind`` by PIL, whatever its extension."""
    pages = _pages()
    if kind in ("TIFF", "BigTIFF"):
        target = path + ".classic" if kind == "BigTIFF" else path
        pages[0].save(target, "TIFF", compression="tiff_lzw", save_all=True,
                      append_images=pages[1:])
        if kind == "BigTIFF":
            bigtiff.repack(target, path)
    elif kind == "JPEG2000":
        pages[0].save(path, "JPEG2000", irreversible=False, no_jp2=False)
    elif kind == "PPM":
        pages[0].save(path, "PPM")
    else:
        pages[0].save(path, kind)
    return path


def _same_as_jax(path):
    got, want = tw.PILSlide(path), jw.PILSlide(path)
    assert got.name == want.name == "slide"
    assert [g.shape for g in got.levels] == [w.shape for w in want.levels]
    for g, w in zip(got.levels, want.levels):
        np.testing.assert_array_equal(g, w)
    return got


@pytest.mark.parametrize("kind,ext", [
    ("TIFF", ".btf"), ("TIFF", ".tf8"), ("TIFF", ".jfif"), ("TIFF", ""),
    ("TIFF", ".png"), ("BigTIFF", ".tif"), ("PNG", ".tif"), ("JPEG", ".jpe"),
    ("JPEG", ".jp2"), ("JPEG2000", ".tiff")])
def test_slides_read_by_content_equal_jax(tmp_path, kind, ext):
    path = _save(kind, str(tmp_path / f"slide{ext}"))
    slide = _same_as_jax(path)
    assert slide.level_count == (2 if "TIFF" in kind else 1)
    assert tw.slide_format(path) == ("TIFF" if "TIFF" in kind else kind)
    for g, w in zip(tw.open_slide(path).levels, slide.levels):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("fmt,name", [("GIF", "GIF"), ("BMP", "BMP"),
                                      ("WEBP", "WebP"),
                                      ("PPM", "PBM/PGM/PPM")])
@pytest.mark.parametrize("named", ["own", "tiff"])
def test_formats_pil_reads_are_refused_by_name(tmp_path, fmt, name, named):
    """JAX reads these through PIL; the port refuses them, naming the
    format it found in the first bytes (ROADMAP.md, "Kept on purpose")."""
    ext = {"own": "." + fmt.lower(), "tiff": ".tiff"}[named]
    path = _save(fmt, str(tmp_path / f"slide{ext}"))
    assert jw.PILSlide(path).levels[0].shape == (120, 160, 3)
    with pytest.raises(NotImplementedError,
                       match=f"slide\\{ext}: a {name} slide"):
        tw.PILSlide(path)
    with pytest.raises(NotImplementedError, match=name):
        tw.open_slide(path)


@pytest.mark.parametrize("data", [b"", b"not a slide at all\n" * 8,
                                  b"II*"], ids=["empty", "text", "short"])
@pytest.mark.parametrize("ext", [".tif", ".png"])
def test_unidentified_bytes_raise_oserror(tmp_path, data, ext):
    path = str(tmp_path / f"slide{ext}")
    with open(path, "wb") as f:
        f.write(data)
    with pytest.raises(OSError):
        jw.PILSlide(path)
    with pytest.raises(OSError, match="cannot identify"):
        tw.PILSlide(path)


def test_openslide_extensions_still_refused(tmp_path):
    """JAX sends ``.svs`` to openslide by its extension; so does the
    port's ``open_slide``, which refuses a TIFF without an Aperio
    description; ``PILSlide`` itself reads the TIFF inside."""
    path = _save("TIFF", str(tmp_path / "slide.svs"))
    with pytest.raises(NotImplementedError, match="slide.svs.*not supported"):
        tw.open_slide(path)
    _same_as_jax(path)
