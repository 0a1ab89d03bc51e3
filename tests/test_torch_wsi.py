"""The port's data/wsi.py against the JAX package's on the same pixels:
JAX's synthetic_slide levels fed to both packages' ArraySlide (one slide
as drawn, one with holes carved into its tissue and a blob on the image's
edge).  Tissue and hole contours equal element for element, in order;
process_contours' coordinates equal for every contour_fn; the checkers,
fetch_mag_patching_params, the patch filters and the stitch canvas
equal; the port's synthetic_slide draws JAX's pixels.  Then the TIFF
reader and writer (multimodalfusion_tpu_torch/utils/tiff.py) against PIL,
the decode budget of PILSlide (tests/test_wsi.py:114-141, its 16-bit
page included) and the formats it refuses."""
import os
import struct

import cv2
import numpy as np
import pytest
from PIL import Image

from multimodalfusion_tpu.data import wsi as jw
from multimodalfusion_tpu_torch.data import wsi as tw
from multimodalfusion_tpu_torch.utils import png, tiff

SEG = dict(a_t=0.5, a_h=0.05)
MODES = ("basic", "center", "four_pt", "four_pt_hard")


def _holed_levels(seed):
    """JAX's synthetic slide with white discs carved into its blobs and a
    blob over the top edge, drawn on level 0 and downsampled as the JAX
    slide does."""
    base = jw.synthetic_slide(2048, 1536, n_blobs=3, seed=seed)
    img = base.levels[0].copy()
    rng = np.random.default_rng(seed)
    ys, xs = np.nonzero((img[::32, ::32].astype(int).sum(-1) < 600))
    for i in rng.choice(len(ys), size=min(6, len(ys)), replace=False):
        cv2.circle(img, (int(xs[i]) * 32, int(ys[i]) * 32),
                   int(rng.integers(40, 90)), (245, 245, 245), -1)
    cv2.ellipse(img, (1000, 10), (300, 120), 0.0, 0, 360, (180, 90, 160), -1)
    levels = [img]
    for _ in range(2):
        prev = levels[-1]
        levels.append(cv2.resize(prev, (prev.shape[1] // 2,
                                        prev.shape[0] // 2)))
    return levels


@pytest.fixture(scope="module", params=["plain", "holed"])
def slides(request):
    if request.param == "plain":
        levels = jw.synthetic_slide(2048, 1536, n_blobs=3, seed=1).levels
    else:
        levels = _holed_levels(4)
    return (jw.ArraySlide(levels, "s"), tw.ArraySlide(levels, "s"),
            request.param)


def test_segment_tissue_equals_jax(slides):
    js, ts, kind = slides
    for kw in (SEG, dict(SEG, use_otsu=True, close=0),
               dict(a_t=0.5, a_h=0.0, mthresh=5, close=3, sthresh=12)):
        jt, jh = jw.segment_tissue(js, seg_level=2, **kw)
        tt, th = tw.segment_tissue(ts, seg_level=2, device="cpu", **kw)
        assert len(tt) == len(jt) and len(tt) >= 1
        for a, b in zip(tt, jt):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
        assert [len(h) for h in th] == [len(h) for h in jh]
        for ha, hb in zip(th, jh):
            for a, b in zip(ha, hb):
                np.testing.assert_array_equal(a, b)
    if kind == "holed":
        assert sum(len(h) for h in th) >= 1


def test_process_contours_equal_jax(slides, tmp_path):
    js, ts, _ = slides
    jt, jh = jw.segment_tissue(js, seg_level=2, **SEG)
    tt, th = tw.segment_tissue(ts, seg_level=2, device="cpu", **SEG)
    for mode in MODES:
        for ps in (128, 256):
            want, _ = jw.process_contours(js, jt, jh, patch_size=ps,
                                          step_size=ps, contour_fn=mode)
            got, _ = tw.process_contours(ts, tt, th, patch_size=ps,
                                         step_size=ps, contour_fn=mode)
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want, err_msg=mode)
    got, path = tw.process_contours(ts, tt, th, save_path=str(tmp_path),
                                    patch_level=1, patch_size=128,
                                    use_padding=False)
    assert os.path.basename(path) == "s_patches.h5" and len(got) > 3


def test_checkers_and_hole_test_equal_jax(slides):
    js, ts, _ = slides
    jt, jh = jw.segment_tissue(js, seg_level=2, **SEG)
    rng = np.random.default_rng(0)
    pts = rng.integers(-100, 2100, (200, 2))
    holes = [h for hs in jh for h in hs]
    for cont in jt:
        for mode in MODES:
            jc = jw.make_contour_checker(cont, 128, mode)
            tc = tw.make_contour_checker(cont, 128, mode)
            assert [tc(p) for p in pts] == [jc(p) for p in pts]
    assert [tw._in_holes(holes, p, 128) for p in pts] == \
        [jw._in_holes(holes, p, 128) for p in pts]


def test_filters_stitch_and_mag_params_equal_jax(slides):
    js, ts, _ = slides
    jt, jh = jw.segment_tissue(js, seg_level=2, **SEG)
    coords, _ = jw.process_contours(js, jt, jh, patch_size=128,
                                    step_size=128)
    for level in (0, 1):
        np.testing.assert_array_equal(
            tw.read_patches(ts, coords[:7], level, 96),
            jw.read_patches(js, coords[:7], level, 96))
    patches = jw.read_patches(js, coords[::3], 0, 64)
    rng = np.random.default_rng(1)
    extra = [np.full((64, 64, 3), v, np.uint8) for v in (0, 30, 250, 255)]
    extra += [rng.integers(0, 256, (33, 17, 3), dtype=np.uint8)]
    for p in list(patches) + extra:
        for t in (5, 15):
            assert tw.is_white_patch(p, t) == jw.is_white_patch(p, t)
        for t in (40, 200):
            assert tw.is_black_patch(p, t) == jw.is_black_patch(p, t)
    for level, ps, ds in ((0, 256, 16), (1, 128, 8), (0, 200, 16)):
        np.testing.assert_array_equal(
            tw.stitch_coords(ts, coords, level, ps, downscale=ds),
            jw.stitch_coords(js, coords, level, ps, downscale=ds))
    np.testing.assert_array_equal(
        tw.stitch_coords(ts, coords, draw_grid=False),
        jw.stitch_coords(js, coords, draw_grid=False))
    for kw in ({"mag_level": 20, "mpp": 0.25}, {"mag_level": 5, "mpp": 0.25},
               {"mag_level": 20, "mpp": 0.5}, {"mag_level": 20},
               {"mag_level": 40, "mpp": 0.5}, {"mag_level": 10, "mpp": 0.7,
                                               "dec_prec": -1}):
        assert tw.fetch_mag_patching_params(ts, **kw) == \
            jw.fetch_mag_patching_params(js, **kw)


@pytest.mark.parametrize("seed,w,h,blobs,levels",
                         [(1, 2048, 1536, 3, 3), (9, 1001, 767, 5, 3),
                          (0, 512, 512, 0, 1)])
def test_synthetic_slide_draws_jax_pixels(seed, w, h, blobs, levels):
    a = jw.synthetic_slide(w, h, blobs, seed=seed, n_levels=levels)
    b = tw.synthetic_slide(w, h, blobs, seed=seed, n_levels=levels, rows=97)
    assert b.name == a.name and b.level_count == levels
    for x, y in zip(a.levels, b.levels):
        np.testing.assert_array_equal(y, x)


# ---------------------------------------------------------------------------
# the slide readers
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def small_slide():
    return jw.synthetic_slide(1024, 768, n_blobs=3, seed=2)


def _pil_pages(path):
    im = Image.open(path)
    out = []
    try:
        while True:
            out.append(np.asarray(im.convert("RGB")))
            im.seek(im.tell() + 1)
    except EOFError:
        return out


def test_tiff_writer_read_by_pil_and_reader_reads_pil(tmp_path, small_slide):
    levels = small_slide.levels
    ours = str(tmp_path / "port.tiff")
    tiff.write_tiff(ours, levels)
    for got, want in zip(_pil_pages(ours), levels):
        np.testing.assert_array_equal(got, want)
    theirs = str(tmp_path / "pil.tiff")
    imgs = [Image.fromarray(l) for l in levels]
    imgs[0].save(theirs, save_all=True, append_images=imgs[1:])
    for path in (ours, theirs):
        pages = tiff.read_pages(path)
        assert [(p.width, p.height, p.mode) for p in pages] == \
            [(l.shape[1], l.shape[0], "RGB") for l in levels]
        for p, want in zip(pages, levels):
            np.testing.assert_array_equal(tiff.read_page(path, p), want)
    s = tw.PILSlide(theirs)
    assert s.name == "pil" and s.level_dimensions == \
        small_slide.level_dimensions
    np.testing.assert_array_equal(s.read_region((100, 200), 0, (32, 32)),
                                  small_slide.read_region((100, 200), 0,
                                                          (32, 32)))


def _big_endian_tiff(path, pages):
    """A big-endian baseline TIFF of gray (uint8 / uint16) or RGB pages,
    two strips a page, written by hand."""
    out = bytearray(b"MM\0*" + b"\0\0\0\0")
    prev_link = 4
    for a in pages:
        h, w = a.shape[:2]
        raw = a.astype(a.dtype.newbyteorder(">")).tobytes()
        half = -(-h // 2) * (len(raw) // h)
        offs = [len(out), len(out) + half]
        out += raw
        rgb = a.ndim == 3
        bits_at = len(out)
        out += struct.pack(">HHH", 8, 8, 8)
        ifd_at = len(out)
        struct.pack_into(">I", out, prev_link, ifd_at)
        entries = [(256, 3, 1, w), (257, 3, 1, h),
                   (258, 3, 3, bits_at) if rgb else
                   (258, 3, 1, 8 * a.dtype.itemsize),
                   (259, 3, 1, 1), (262, 3, 1, 2 if rgb else 1),
                   (273, 4, 2, None), (277, 3, 1, 3 if rgb else 1),
                   (278, 3, 1, -(-h // 2)), (279, 4, 2, None)]
        arrays_at = ifd_at + 2 + 12 * len(entries) + 4
        body = struct.pack(">H", len(entries))
        for tag, typ, count, value in entries:
            if count == 2:
                value = arrays_at + (0 if tag == 273 else 8)
                body += struct.pack(">HHII", tag, typ, count, value)
            elif typ == 3 and count == 1:
                body += struct.pack(">HHIHH", tag, typ, count, value, 0)
            else:
                body += struct.pack(">HHII", tag, typ, count, value)
        body += struct.pack(">I", 0)
        prev_link = ifd_at + 2 + 12 * len(entries)
        out += body + struct.pack(">II", *offs) + struct.pack(
            ">II", half, len(raw) - half)
    with open(path, "wb") as f:
        f.write(bytes(out))
    return path


def test_tiff_reader_big_endian_gray_and_16_bit(tmp_path):
    rng = np.random.default_rng(3)
    rgb = rng.integers(0, 256, (21, 17, 3), dtype=np.uint8)
    g8 = rng.integers(0, 256, (9, 13), dtype=np.uint8)
    g16 = rng.integers(0, 65536, (12, 7), dtype=np.uint16)
    g16[0, :3] = (0, 255, 256)
    p = _big_endian_tiff(str(tmp_path / "be.tiff"), [rgb, g8, g16])
    want = _pil_pages(p)
    pages = tiff.read_pages(p)
    assert [pg.mode for pg in pages] == ["RGB", "L", "I;16"]
    for pg, w in zip(pages, want):
        np.testing.assert_array_equal(tiff.read_page(p, pg), w)
    np.testing.assert_array_equal(want[2][..., 0], np.minimum(g16, 255))
    # PIL's own little-endian 16-bit and 8-bit grayscale files
    for a in (g16, g8):
        q = str(tmp_path / f"le{a.dtype.itemsize}.tiff")
        Image.fromarray(a).save(q)
        (pg,) = tiff.read_pages(q)
        np.testing.assert_array_equal(tiff.read_page(q, pg),
                                      _pil_pages(q)[0])


def test_pil_slide_size_gate(tmp_path, small_slide, monkeypatch):
    """The budget is checked from the headers before any decode, counts
    the native-mode page (a 16-bit page costs 2 B/px more), and reads the
    env var (tests/test_wsi.py:114-141)."""
    p = str(tmp_path / "slide.tiff")
    tiff.write_tiff(p, small_slide.levels)
    with pytest.raises(ValueError, match="MMF_TPU_WSI_MAX_BYTES"):
        tw.PILSlide(p, max_decode_bytes=1024)
    monkeypatch.setenv("MMF_TPU_WSI_MAX_BYTES", "1024")
    with pytest.raises(ValueError, match="budget"):
        tw.PILSlide(p)
    monkeypatch.setenv("MMF_TPU_WSI_MAX_BYTES", str(1 << 30))
    assert tw.PILSlide(p).level_count == 3
    p16 = str(tmp_path / "slide16.tiff")
    h, w = small_slide.levels[0].shape[:2]
    Image.fromarray(
        (small_slide.levels[0][..., 0].astype(np.uint16) << 8)).save(p16)
    for budget in (int(3.5 * w * h), 6 * w * h):
        ok = [True, True]
        for i, cls in enumerate((jw.PILSlide, tw.PILSlide)):
            try:
                cls(p16, max_decode_bytes=budget)
            except ValueError:
                ok[i] = False
        assert ok[0] == ok[1] == (budget == 6 * w * h)
    s = tw.PILSlide(p16, max_decode_bytes=6 * w * h)
    np.testing.assert_array_equal(s.levels[0],
                                  jw.PILSlide(p16).levels[0])


def test_readers_refuse_what_they_cannot_read(tmp_path, small_slide):
    """What the port does not read raises, naming the file; what it now
    reads (a baseline or progressive JPEG slide, LZW) reads as PIL reads
    it."""
    lvl = small_slide.levels[2]
    jpg = str(tmp_path / "s.jpg")
    Image.fromarray(lvl).save(jpg)
    np.testing.assert_array_equal(tw.open_slide(jpg).levels[0],
                                  jw.PILSlide(jpg).levels[0])
    prog = str(tmp_path / "p.jpg")
    Image.fromarray(lvl).save(prog, progressive=True)
    np.testing.assert_array_equal(tw.open_slide(prog).levels[0],
                                  jw.PILSlide(prog).levels[0])
    # its SOF2 marker made SOF11 (arithmetic lossless), which PIL and the
    # port refuse; made SOF10 (arithmetic progressive), its Huffman data
    # is corrupt arithmetic-coded data, which the port refuses (PIL
    # decodes noise, with libjpeg's warnings)
    with open(prog, "rb") as f:
        data = f.read()
    with open(prog, "wb") as f:
        f.write(data.replace(b"\xff\xc2", b"\xff\xcb", 1))
    with pytest.raises(OSError):
        jw.PILSlide(prog)
    with pytest.raises(NotImplementedError, match="p.jpg.*arithmetic"):
        tw.open_slide(prog)
    with open(prog, "wb") as f:
        f.write(data.replace(b"\xff\xc2", b"\xff\xca", 1))
    with pytest.raises(ValueError, match="corrupt"):
        tw.open_slide(prog)
    gif = str(tmp_path / "s.gif")
    Image.fromarray(lvl).save(gif)
    with pytest.raises(NotImplementedError, match="s.gif"):
        tw.open_slide(gif)
    for ext in (".svs", ".ndpi", ".mrxs"):
        path = str(tmp_path / f"slide{ext}")
        with open(path, "wb") as f:
            f.write(b"\0" * 16)
        # a .svs is read by its bytes, as openslide reads it: none here
        err, what = ((OSError, "cannot identify") if ext == ".svs" else
                     (NotImplementedError, "not supported"))
        with pytest.raises(err, match=f"slide\\{ext}.*{what}"):
            tw.open_slide(path)
    lzw = str(tmp_path / "lzw.tiff")
    Image.fromarray(lvl).save(lzw, compression="tiff_lzw")
    np.testing.assert_array_equal(tw.open_slide(lzw).levels[0],
                                  jw.PILSlide(lzw).levels[0])
    # the writer's file with its last tag (PlanarConfiguration) renamed
    # TileWidth (a tiled page without TileLength), then
    # PlanarConfiguration 3 (neither chunky nor planar), then its
    # Compression (the fourth tag) set to CCITT Group 4 (4)
    for tag, value, match, at in ((322, 64, "tiled.*tag 323", 9),
                                  (284, 3, "tag 284", 9),
                                  (259, 4, "tiled.*tag 259", 3)):
        path = str(tmp_path / "tiled.tiff")
        tiff.write_tiff(path, [lvl])
        with open(path, "r+b") as f:
            f.seek(4)
            (ifd,) = struct.unpack("<I", f.read(4))
            f.seek(ifd + 2 + 12 * at)
            f.write(struct.pack("<HHIHH", tag, 3, 1, value, 0))
        with pytest.raises(NotImplementedError, match=match):
            tw.open_slide(path)
    # a PNG slide: the port's own files, and PIL's when filter 0
    pth = str(tmp_path / "s.png")
    png.write_png(pth, lvl)
    s = tw.open_slide(pth)
    assert s.level_count == 1
    np.testing.assert_array_equal(s.levels[0], lvl)
    gray = str(tmp_path / "g.png")
    png.write_png(gray, lvl[..., 1].copy())
    np.testing.assert_array_equal(tw.open_slide(gray).levels[0][..., 2],
                                  lvl[..., 1])
