"""BigTIFF slides read by the port's ``utils/tiff.py`` and held to the JAX
package's ``PILSlide`` (PIL 12.1.0, libtiff) on the same files: the
port's ``PILSlide(path).levels`` equal JAX ``PILSlide(path).levels`` bit
for bit (tolerance 0), each compressed page equal through the plain
decoders too (``read_page(..., plain=True)``), or both packages refuse:

- classic two-page pyramids (at most 400 x 300) re-packed as BigTIFF by
  ``tools/bigtiff.py``, keeping every chunk's bytes: none, LZW with
  predictor 2, Deflate, PackBits, LZMA, ZSTD and JPEG with JPEGTables,
  in strips and in tiles; a multi-page file PIL writes with
  ``big_tiff=True``;
- where values sit: a one-tile and a two-tile page with their offsets
  as SHORT, LONG and LONG8 (inline up to 8 bytes, else behind an
  offset), 3 x SHORT BitsPerSample;
- a page whose tiles sit past 4 GiB in a sparse file, its IFDs before
  the hole or after it (PIL hands libtiff the IFD's offset in 32 bits,
  so past 4 GiB it decodes a compressed page to zeros: the port reads
  it);
- SubIFDs, which neither package follows;
- the headers PIL reads as classic TIFF (``II\\0*``, ``MM*\\0``) and a
  BigTIFF of offset size 4: uncompressed pages read, compressed ones
  raise in both, since libtiff refuses those headers;
- ``MM\\0+`` (PIL 12.1.0 parses it as classic TIFF and fails): the
  port's ``BigEndianBigTIFFError``; an IFD loop; a 100000 x 80000 level
  refused by both for the decode budget before any decode;
- ``cli.create_patches --device cpu`` on a JPEG-tiled ``.btf`` slide
  writes JAX's coordinates.
"""
import importlib.util
import os
import struct

import h5py
import numpy as np
import pytest
from PIL import Image

from test_torch_codecs import _image
from test_torch_tiff_layouts import _check, _page, _pyramid, _write
from test_torch_tiff_zstd import _zpage
from test_torch_wsi_compressed import _encode_page, _write_tiff

from multimodalfusion_tpu.cli.create_patches import main as jax_cp
from multimodalfusion_tpu.data import wsi as jw
from multimodalfusion_tpu_torch.cli import create_patches as tcp
from multimodalfusion_tpu_torch.data import wsi as tw
from multimodalfusion_tpu_torch.utils import tiff

NONE, LZW, JPEG, DEFLATE, PACKBITS, LZMA, ZSTD = (1, 5, 7, 8, 32773, 34925,
                                                 50000)
_spec = importlib.util.spec_from_file_location(
    "bigtiff", os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "tools", "bigtiff.py"))
bigtiff = importlib.util.module_from_spec(_spec)  # the test coder
_spec.loader.exec_module(bigtiff)


def _classic(path, compression, layout, img=None, order="<"):
    """A two-page classic TIFF of ``img`` (default 300 x 400 RGB) under
    ``compression``, in strips of 37 rows or 64 x 48 tiles."""
    img = _image(300, 400, seed=7) if img is None else img
    kw = dict(tile=(64, 48)) if layout == "tiles" else dict(rps=37)
    if compression == JPEG:  # YCbCr 4:2:0, the tables in JPEGTables
        return _write_tiff(path, [
            _encode_page(lvl, JPEG, tables_apart=True,
                         jpeg_kw=dict(quality=90, subsampling=2), **kw)
            for lvl in _pyramid(img)], order=order)
    if compression == ZSTD:
        pages = [_zpage(lvl, 2, **kw) for lvl in _pyramid(img)]
    else:
        pages = [_page(lvl, 2, compression, order=order,
                       predictor=2 if compression == LZW else 1, **kw)
                 for lvl in _pyramid(img)]
    return _write(path, pages, order=order)


def _same_levels(a, b):
    assert [x.shape for x in a] == [y.shape for y in b]
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


def _entry(path, ifd, tag):
    """(field type, count, the 8 value bytes) of ``tag`` in the
    little-endian BigTIFF IFD at ``ifd``."""
    with open(path, "rb") as f:
        f.seek(ifd)
        (n,) = struct.unpack("<Q", f.read(8))
        block = f.read(20 * n)
    for i in range(n):
        t, typ, count = struct.unpack_from("<HHQ", block, 20 * i)
        if t == tag:
            return typ, count, block[20 * i + 12:20 * i + 20]
    raise KeyError(tag)


def _ifds(path):
    """The offsets of the main chain's IFDs of a little-endian BigTIFF."""
    out = []
    with open(path, "rb") as f:
        f.seek(8)
        (at,) = struct.unpack("<Q", f.read(8))
        while at:
            out.append(at)
            f.seek(at)
            (n,) = struct.unpack("<Q", f.read(8))
            f.seek(at + 8 + 20 * n)
            (at,) = struct.unpack("<Q", f.read(8))
    return out


def _sparse_files(folder) -> bool:
    """Whether the filesystem under ``folder`` leaves a hole unallocated
    (a 64 MiB hole probed)."""
    probe = os.path.join(folder, "probe")
    with open(probe, "wb") as f:
        f.seek(64 << 20)
        f.write(b"\0")
    sparse = os.stat(probe).st_blocks * 512 < (1 << 20)
    os.remove(probe)
    return sparse


# ---- the compressions, re-packed

@pytest.mark.parametrize("compression", [NONE, LZW, DEFLATE, PACKBITS, LZMA,
                                         ZSTD, JPEG],
                         ids=["none", "lzw_pred2", "deflate", "packbits",
                              "lzma", "zstd", "jpeg_tables"])
@pytest.mark.parametrize("layout", ["strips", "tiles"])
def test_bigtiff_equals_jax(tmp_path, compression, layout):
    src = _classic(str(tmp_path / "classic.tiff"), compression, layout)
    path = bigtiff.repack(src, str(tmp_path / "slide.btf"))
    with open(path, "rb") as f:
        assert f.read(8) == b"II+\0\x08\0\0\0"
    pages = tiff.read_pages(path)
    assert [p.compression for p in pages] == [compression] * 2
    assert [p.chunks for p in pages] != [p.chunks for p in tiff.read_pages(
        src)]  # the chunks moved; their bytes did not
    _check(path, 2)
    _same_levels(tw.PILSlide(path).levels, tw.PILSlide(src).levels)


@pytest.mark.parametrize("mode", ["RGB", "L", "RGBA"])
def test_pil_written_bigtiff_equals_jax(tmp_path, mode):
    """PIL writes BigTIFF uncompressed only (its libtiff route ignores
    ``big_tiff=True``)."""
    img = Image.fromarray(np.concatenate([_image(300, 400, seed=1),
                                          _image(300, 400, 1, seed=2)], -1),
                          "RGBA")
    pages = [img.convert(mode), img.resize((200, 150)).convert(mode)]
    path = str(tmp_path / "pil.tif")
    pages[0].save(path, big_tiff=True, save_all=True,
                  append_images=pages[1:])
    with open(path, "rb") as f:
        assert f.read(4) == b"II+\0"
    _check(path, 2)


@pytest.mark.parametrize("offset_type", [3, 4, 16],
                         ids=["short", "long", "long8"])
def test_inline_and_offset_values_equal_jax(tmp_path, offset_type):
    """A two-tile level and a one-tile level: each offsets array sits in
    its entry when it fits in 8 bytes (two SHORTs or LONGs, one LONG8),
    else behind an offset (two LONG8s); BitsPerSample's 3 SHORTs inline."""
    img = _image(32, 64, seed=3)
    pages = [_page(lvl, 2, LZW, tile=(32, 32)) for lvl in _pyramid(img)]
    src = _write(str(tmp_path / "classic.tiff"), pages)
    path = bigtiff.repack(src, str(tmp_path / "tiles.btf"),
                          offset_type=offset_type)
    size = {3: 2, 4: 4, 16: 8}[offset_type]
    for ifd, page in zip(_ifds(path), tiff.read_pages(path)):
        offsets = [o for o, _ in page.chunks]
        typ, count, field = _entry(path, ifd, 324)
        assert (typ, count) == (offset_type, len(offsets))
        inline = struct.unpack_from(f"<{len(offsets)}{'HIQ'[size // 4]}",
                                    field) if size * count <= 8 else None
        assert inline is None or list(inline) == offsets
        assert (inline is None) == (offset_type == 16 and count == 2)
        assert _entry(path, ifd, 258)[:2] == (3, 3)
        assert _entry(path, ifd, 258)[2] == struct.pack("<3H2x", 8, 8, 8)
    _check(path, 2)


@pytest.mark.parametrize("compression", [NONE, LZW])
@pytest.mark.parametrize("ifds_past_gap", [False, True],
                         ids=["ifds_before", "ifds_past_4gib"])
def test_chunks_past_4_gib(tmp_path, compression, ifds_past_gap):
    """Level 0's chunks past 4 GiB behind a hole.  Both packages read it
    when the IFDs sit before the hole; past it, PIL 12.1.0 hands libtiff
    the IFD's offset cut to 32 bits and decodes a compressed page to
    zeros without an error, where the port reads the page."""
    if not _sparse_files(str(tmp_path)):
        pytest.skip("the filesystem allocates holes: a 4 GiB file")
    src = _classic(str(tmp_path / "classic.tiff"), compression, "tiles")
    path = bigtiff.repack(src, str(tmp_path / "gap.btf"), gap=0,
                          ifds_past_gap=ifds_past_gap)
    assert os.path.getsize(path) > 1 << 32
    pages = tiff.read_pages(path)
    assert min(o for o, _ in pages[0].chunks) > 1 << 32
    assert (min(_ifds(path)) > 1 << 32) == ifds_past_gap
    got, classic = tw.PILSlide(path).levels, tw.PILSlide(src).levels
    _same_levels(got, classic)
    want = jw.PILSlide(path).levels
    if ifds_past_gap and compression != NONE:
        assert all(not w.any() for w in want)
    else:
        _same_levels(got, want)


@pytest.mark.parametrize("subifd_type", [16, 18], ids=["long8", "ifd8"])
def test_subifds_are_not_followed(tmp_path, subifd_type):
    """bfconvert's layout: the reduced levels as SubIFDs of level 0."""
    img = _image(300, 400, seed=4)
    pages = [_page(lvl, 2, DEFLATE, tile=(64, 64))
             for lvl in (img, img[::2, ::2], img[::4, ::4])]
    src = _write(str(tmp_path / "classic.tiff"), pages)
    path = bigtiff.repack(src, str(tmp_path / "sub.btf"),
                          subifds={0: [1, 2]}, subifd_type=subifd_type)
    typ, count, _ = _entry(path, _ifds(path)[0], 330)
    assert (typ, count) == (subifd_type, 2)
    assert len(jw.PILSlide(path).levels) == 1
    _check(path, 1)


# ---- headers

def _with_header(src, path, head):
    with open(src, "rb") as f:
        data = f.read()
    with open(path, "wb") as f:
        f.write(head + data[len(head):])
    return path


@pytest.mark.parametrize("compression", [NONE, LZW])
@pytest.mark.parametrize("header", ["II\\0*", "MM*\\0", "bigtiff_size_4"])
def test_headers_pil_reads_as_classic(tmp_path, header, compression):
    """PIL opens ``II\\0*`` and ``MM*\\0`` as classic TIFF and a BigTIFF
    whatever bytes 4-8 hold, and reads their uncompressed pages itself;
    their compressed pages go to libtiff, which refuses such a header,
    and raise.  The port does the same."""
    order = ">" if header.startswith("MM") else "<"
    src = _classic(str(tmp_path / "classic.tiff"), compression, "strips",
                   order=order)
    if header == "bigtiff_size_4":
        src = bigtiff.repack(src, str(tmp_path / "big.btf"))
        head = b"II+\0\x04\0\0\0"
    else:
        head = {"II\\0*": b"II\0*", "MM*\\0": b"MM*\0"}[header]
    path = _with_header(src, str(tmp_path / "odd.tif"), head)
    if compression == NONE:
        _check(path, 2)
        return
    with pytest.raises(OSError):
        jw.PILSlide(path)
    with pytest.raises(OSError, match="header libtiff refuses"):
        tw.PILSlide(path)


@pytest.mark.parametrize("compression", [NONE, DEFLATE])
def test_big_endian_bigtiff_is_refused(tmp_path, compression):
    src = _classic(str(tmp_path / "classic.tiff"), compression, "tiles")
    path = bigtiff.repack(src, str(tmp_path / "be.btf"), order=">")
    with open(path, "rb") as f:
        assert f.read(4) == b"MM\0+"
    with pytest.raises(OSError):
        jw.PILSlide(path)
    with pytest.raises(tiff.BigEndianBigTIFFError,
                       match="be.btf: a big-endian BigTIFF"):
        tw.PILSlide(path)
    assert issubclass(tiff.BigEndianBigTIFFError, OSError)


def test_ifd_loop_raises(tmp_path):
    """The second IFD links back to the first: the port refuses the file
    (PIL stops the chain at the repeat)."""
    src = _classic(str(tmp_path / "classic.tiff"), LZW, "tiles")
    path = bigtiff.repack(src, str(tmp_path / "loop.btf"))
    first, second = _ifds(path)
    with open(path, "r+b") as f:
        f.seek(second)
        (n,) = struct.unpack("<Q", f.read(8))
        f.seek(second + 8 + 20 * n)
        f.write(struct.pack("<Q", first))
    with pytest.raises(OSError, match="a loop in the IFD chain"):
        tw.PILSlide(path)


def test_decode_budget_from_headers(tmp_path):
    """A level whose headers declare 100000 x 80000 (its one strip holds a
    few rows): both packages refuse it for the budget, naming the same
    page sizes, before any decode."""
    img = _image(300, 400, seed=5)
    pages = [_page(lvl, 2, NONE, rps=300) for lvl in _pyramid(img)]
    pages[1]["tags"].update({256: (4, [100000]), 257: (4, [80000]),
                             278: (4, [80000])})
    src = _write(str(tmp_path / "classic.tiff"), pages)
    path = bigtiff.repack(src, str(tmp_path / "huge.btf"))
    sizes = "[(400, 300), (100000, 80000)]"
    with pytest.raises(ValueError) as jax_err:
        jw.PILSlide(path)
    with pytest.raises(ValueError) as port_err:
        tw.PILSlide(path)
    assert sizes in str(jax_err.value) and sizes in str(port_err.value)
    assert str(port_err.value).split("needs")[1].split("(")[0] == str(
        jax_err.value).split("needs")[1].split("(")[0]


def test_create_patches_on_a_bigtiff_slide_equals_jax(tmp_path):
    slide = jw.synthetic_slide(1024, 768, n_blobs=3, seed=2, n_levels=2)
    src = tmp_path / "slides"
    os.makedirs(src)
    classic = _write_tiff(str(tmp_path / "classic.tiff"), [
        _encode_page(lvl, JPEG, tile=(128, 128), tables_apart=True,
                     jpeg_kw=dict(quality=90, subsampling=2))
        for lvl in slide.levels])
    bigtiff.repack(classic, str(src / "BIG.btf"))
    out = {}
    for who, fn, extra in (("jax", jax_cp, []),
                           ("port", tcp.main, ["--device", "cpu"])):
        out[who] = tmp_path / who
        assert fn(["--source", str(src), "--save_dir", str(out[who]),
                   "--patch_size", "128", "--step_size", "128", "--a_t",
                   "0.5", "--a_h", "0.05"] + extra) == 0
    with h5py.File(out["jax"] / "patches" / "BIG_patches.h5") as j, \
            h5py.File(out["port"] / "patches" / "BIG_patches.h5") as t:
        assert len(j["coords"]) > 5
        np.testing.assert_array_equal(t["coords"][()], j["coords"][()])
