"""Progressive and four-component JPEG in the port's decoder
(``utils/jpeg.py``, C++ in ``csrc/imgcodec.cpp``) against PIL's
libjpeg-turbo, which the JAX package reads JPEG through, bit for bit
(tolerance 0), through the C++ route and through the plain route:

- PIL's progressive files at several sizes, subsamplings and qualities,
  gray too, with restart markers;
- scripts of the test-stream writer (``tools/jpeg_writer.py``): spectral
  selection only, successive approximation from Al = 3, EOB runs across
  blocks (the writer's flush at 937 correction bits and at 0x7FFF
  blocks), restart intervals in every scan type, the AC of Cr before Y,
  the Huffman tables redefined between scans;
- scripts that leave coefficients unrefined, which libjpeg-turbo smooths
  (jdcoefct.c's decompress_smooth_data): a DC scan alone, the default
  script stopped early, AC never refined, one component without AC;
- CMYK (with and without an Adobe marker) and YCCK, baseline and
  progressive; PIL refuses two components, and so does the port;
- the writer's fully refined scripts decode to their baseline source's
  pixels (the oracle ``chip_smoke.py`` uses on the card);
- the committed fixtures of ``testdata/jpeg`` (tools/make_jpeg_fixtures
  .py) are made again from their recorded parameters, byte for byte, and
  PIL's, the C++ and the plain pixels of them have the manifest's digest;
- the port's ``PILSlide`` equals the JAX package's on progressive, CMYK
  and YCCK ``.jpg`` slides and on a TIFF of progressive JPEG tiles, and a
  progressive DICOM …1.2.4.50 frame reads as the JAX package reads it;
- scan scripts libjpeg refuses or warns about raise ``ValueError``;
  corrupt progressive data gives the same outcome from both routes.
The plain route runs a Python loop a coefficient, so its images stay at
96 x 96 or less.
"""
import hashlib
import importlib.util
import io
import json
import os
import struct

import numpy as np
import pytest
from PIL import Image

from test_torch_codecs import _image
from test_torch_dicom import _same_outcome, _volume, _with_syntax, _write
from test_torch_wsi_compressed import JPEG, _encode_page, _pyramid, \
    _write_tiff

from multimodalfusion_tpu.data import dicom as jd
from multimodalfusion_tpu.data import wsi as jw
from multimodalfusion_tpu_torch.data import wsi as tw
from multimodalfusion_tpu_torch.utils import jpeg, tiff

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(ROOT, "multimodalfusion_tpu_torch", "testdata",
                        "jpeg")
_spec = importlib.util.spec_from_file_location(
    "make_jpeg_fixtures", os.path.join(ROOT, "tools", "make_jpeg_fixtures.py"))
fixtures = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(fixtures)
writer = fixtures.writer
with open(os.path.join(FIXTURES, "MANIFEST.json")) as _f:
    MANIFEST = json.load(_f)


def _pil(data: bytes) -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(data)))


def _pil_jpeg(img: np.ndarray, **kw) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(img, "CMYK" if img.ndim == 3 and img.shape[2] == 4
                    else None).save(buf, "JPEG", **kw)
    return buf.getvalue()


def _both(data: bytes, want: np.ndarray = None) -> np.ndarray:
    """The C++ and the plain decode each equal PIL's pixels (or
    ``want``)."""
    want = _pil(data) if want is None else want
    for plain in (False, True):
        got = jpeg.decode_jpeg(data, plain=plain)
        assert got.dtype == np.uint8 and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
    return want


# ---- PIL's progressive files

@pytest.mark.parametrize("size", [(1, 1), (17, 9), (33, 65), (96, 80)])
@pytest.mark.parametrize("kw", [
    dict(quality=90, subsampling=0), dict(quality=50, subsampling=1),
    dict(quality=75, subsampling=2), dict(quality=95, optimize=True),
    dict(quality=80, subsampling=2, restart_marker_blocks=3)],
    ids=["444", "422", "420", "optimize", "restart"])
def test_pil_progressive_equals_pil(size, kw):
    for gray in (False, True):
        img = _image(*size, c=1)[..., 0] if gray else _image(*size)
        data = _pil_jpeg(img, progressive=True, **kw)
        assert jpeg.parse_jpeg(data).progressive
        _both(data)


# ---- the writer's scripts

def _source(h=40, w=56, gray=False, seed=0, **kw):
    img = _image(h, w, c=1, seed=seed)[..., 0] if gray else _image(
        h, w, seed=seed)
    return _pil_jpeg(img, **dict(dict(quality=85, subsampling=2), **kw))


def _al3(n):
    dc = tuple(range(n))
    return ([(dc, 0, 0, 0, 3), (dc, 0, 0, 3, 2), (dc, 0, 0, 2, 1),
             (dc, 0, 0, 1, 0)]
            + [((c,), 1, 63, ah, ah - 1) if ah else ((c,), 1, 63, 0, 3)
               for c in range(n) for ah in (0, 3, 2, 1)])


SCRIPTS = {
    "spectral_only": [((0, 1, 2), 0, 0, 0, 0)] + [
        ((c,), ss, se, 0, 0) for c in (0, 1, 2)
        for ss, se in ((1, 2), (3, 9), (10, 63))],
    "al3": _al3(3),
    "dc_per_component": [((c,), 0, 0, 0, 1) for c in (2, 0, 1)]
    + [((c,), 1, 63, 0, 0) for c in (0, 1, 2)]
    + [((c,), 0, 0, 1, 0) for c in (1, 2, 0)],
    "cr_before_y": [((0, 1, 2), 0, 0, 0, 0), ((2,), 1, 63, 0, 1),
                    ((2,), 1, 63, 1, 0), ((1,), 1, 63, 0, 0),
                    ((0,), 1, 63, 0, 2), ((0,), 1, 63, 2, 1),
                    ((0,), 1, 63, 1, 0)],
    "default": None,
}


@pytest.mark.parametrize("restart", [0, 1, 4])
@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_writer_scripts_equal_pil_and_their_source(name, restart):
    """Each fully refined script (restart intervals in every scan type
    when ``restart``; each scan's own optimal Huffman tables, defined
    just before it) decodes to PIL's pixels, which are the baseline
    source's."""
    for size, sub in (((40, 56), 2), ((33, 17), 1), ((24, 64), 0)):
        base = _source(*size, subsampling=sub)
        data = writer.transcode(base, SCRIPTS[name], restart=restart)
        f = jpeg.parse_jpeg(data)
        assert f.progressive and {s.restart for s in f.scans} == {restart}
        assert data.count(b"\xff\xc4") == len(f.scans) - sum(
            s.ss == 0 and s.ah > 0 for s in f.scans)
        _both(data, _pil(base))
        np.testing.assert_array_equal(_pil(data), _pil(base))


def test_writer_gray_and_sequential_round_trips():
    base = _source(37, 45, gray=True, seed=3)
    for script in (None, _al3(1), [((0,), 0, 0, 0, 0), ((0,), 1, 63, 0, 0)]):
        _both(writer.transcode(base, script, restart=2), _pil(base))
    rgb = _source(40, 56, seed=4)
    for restart in (0, 5):
        data = writer.transcode(rgb, progressive=False, restart=restart)
        assert not jpeg.parse_jpeg(data).progressive
        _both(data, _pil(rgb))


def test_eob_runs_across_blocks():
    """Long EOB runs: an AC first scan over a flat field (runs of many
    blocks, and one past 0x7FFF blocks, which the writer splits), and an
    AC refinement that makes no coefficient newly nonzero, so that its
    correction bits ride on EOB runs, flushed when they pass 937."""
    flat = np.full((64, 80), 120, np.uint8)
    flat[20:40, 30:50] = 140
    base = _pil_jpeg(flat, quality=90)
    script = [((0,), 0, 0, 0, 0), ((0,), 1, 63, 0, 1), ((0,), 1, 63, 1, 0)]
    _both(writer.transcode(base, script), _pil(base))
    co = writer.read_coefficients(_source(64, 96, gray=True, seed=5))
    even = co._replace(blocks=tuple(b * 2 for b in co.blocks))
    assert np.count_nonzero(even.blocks[0][..., 1:]) > 2 * 937
    _both(writer.encode(even, script))
    # 182 x 182 blocks of a flat gray field: one AC run of 33,124 blocks
    big = writer.read_coefficients(_pil_jpeg(np.full((1456, 1456), 99,
                                                     np.uint8)))
    assert not np.any(big.blocks[0][..., 1:])
    data = writer.encode(big, [((0,), 0, 0, 0, 0), ((0,), 1, 63, 0, 0)])
    np.testing.assert_array_equal(jpeg.decode_jpeg(data), _pil(data))


def test_huffman_tables_latched_per_scan():
    """A table slot redefined after a scan that used it: each scan
    decodes with the tables as they stood at its SOS."""
    base = _source(40, 56, seed=6)
    data = writer.transcode(base)
    f = jpeg.parse_jpeg(data)
    acs = [s.ac[0] for s in f.scans if s.ss > 0]
    assert len(set(acs)) > 1  # slot 0 holds another table in each AC scan
    _both(data, _pil(base))


# ---- smoothing: scripts that leave coefficients unrefined

SMOOTH = {
    "dc_only": lambda n: [(tuple(range(n)), 0, 0, 0, 0)],
    "dc_al1_only": lambda n: [(tuple(range(n)), 0, 0, 0, 1)],
    "dc_non_interleaved": lambda n: [((c,), 0, 0, 0, 1) for c in range(n)],
    "first_band": lambda n: [(tuple(range(n)), 0, 0, 0, 0),
                             ((0,), 1, 5, 0, 0)],
    "ac_al2": lambda n: [(tuple(range(n)), 0, 0, 0, 0)]
    + [((c,), 1, 63, 0, 2) for c in range(n)],
    "ac_half_refined": lambda n: [(tuple(range(n)), 0, 0, 0, 0)]
    + [((c,), 1, 63, 0, 2) for c in range(n)] + [((0,), 1, 63, 2, 1)],
    "luma_only": lambda n: [(tuple(range(n)), 0, 0, 0, 0),
                            ((0,), 1, 63, 0, 0)],
}


@pytest.mark.parametrize("name", sorted(SMOOTH) + [
    f"default_{i}" for i in range(1, 10)])
def test_unrefined_scripts_smooth_as_pil(name):
    """Sizes whose rows are 1, 2, 3 and more blocks wide and whose last
    iMCU row is partial, at every subsampling: the 5 x 5 DC window at the
    edges, the DC estimates when no AC was sent, the Al clamp."""
    for size, sub, gray in (((17, 9), 0, True), ((40, 16), 2, True),
                            ((9, 17), 2, False), ((24, 24), 1, False),
                            ((72, 24), 2, False), ((33, 65), 0, False),
                            ((1, 1), 2, False)):
        base = _source(*size, gray=gray, subsampling=sub, seed=size[0],
                       quality=75)
        n = 1 if gray else 3
        script = (writer.simple_progression(n)[:int(name[8:])]
                  if name.startswith("default") else SMOOTH[name](n))
        data = writer.transcode(base, script)
        f = jpeg.parse_jpeg(data)
        bits = [[-1] * 64 for _ in f.h]
        for s in f.scans:
            for c in s.comps:
                bits[c][s.ss:s.se + 1] = [s.al] * (s.se + 1 - s.ss)
        # every colour script leaves a coefficient of zigzag 1..9 unrefined
        assert gray or jpeg._smoothing_on(f, bits)
        _both(data)


def test_fully_refined_and_zero_quantiser_streams_are_not_smoothed():
    """libjpeg smooths nothing when a quantiser of zigzag 0..9 is 0 (it
    would divide by it) or when every coefficient of 1..9 is refined."""
    base = _source(40, 56, seed=8)
    f = jpeg.parse_jpeg(writer.transcode(base))
    bits = [[0] * 64 for _ in f.h]
    assert not jpeg._smoothing_on(f, bits)
    co = writer.read_coefficients(base)
    qt = tuple(np.where(np.arange(64) == 8, 0, q).astype(np.uint16)
               for q in co.qt)
    data = writer.encode(co._replace(qt=qt), [((0, 1, 2), 0, 0, 0, 0)])
    _both(data)


# ---- four components

@pytest.mark.parametrize("progressive", [False, True])
@pytest.mark.parametrize("kind", ["pil_cmyk", "cmyk_adobe", "cmyk_no_marker",
                                  "ycck", "ycck_subsampled", "adobe_1"])
def test_cmyk_and_ycck_equal_pil(kind, progressive):
    for h, w in ((40, 56), (17, 9), (1, 1)):
        img = np.concatenate([_image(h, w, seed=h),
                              _image(h, w, c=1, seed=w)], -1)
        if kind == "pil_cmyk":
            data = _pil_jpeg(img, quality=90, progressive=progressive)
        else:
            samp = ([(2, 2), (1, 1), (1, 1), (2, 2)]
                    if kind == "ycck_subsampled" else [(1, 1)] * 4)
            app, t = {"cmyk_adobe": ("adobe", 0), "cmyk_no_marker": (None, 0),
                      "ycck": ("adobe", 2), "ycck_subsampled": ("adobe", 2),
                      "adobe_1": ("adobe", 1)}[kind]
            co = writer.from_planes([img[..., c] for c in range(4)], samp, 85)
            data = writer.encode(co, progressive=progressive, app=app,
                                 adobe_transform=t, restart=2)
        want = _both(data)
        assert want.shape == (h, w, 4)
        if progressive:  # and stopped early: smoothed
            _both(writer.transcode(data, writer.simple_progression(4)[:5]))


def test_pil_reads_four_components_inverted_with_or_without_adobe():
    """PIL holds every four-component JPEG as "CMYK;I" (255 - x), whether
    or not an Adobe marker is present; so does the port."""
    img = np.concatenate([_image(16, 24), _image(16, 24, c=1)], -1)
    co = writer.from_planes([img[..., c] for c in range(4)], [(1, 1)] * 4,
                            95)
    with_marker = writer.encode(co, progressive=False, app="adobe")
    without = writer.encode(co, progressive=False, app=None)
    np.testing.assert_array_equal(_both(with_marker), _both(without))
    assert np.abs(_pil(without).astype(int) - (255 - img)).max() < 24


def test_two_components_refused_as_pil_refuses():
    img = _image(16, 24)
    co = writer.from_planes([img[..., 0], img[..., 1]], [(1, 1)] * 2)
    data = writer.encode(co, progressive=False, app=None)
    with pytest.raises(Exception):
        Image.open(io.BytesIO(data)).load()
    for plain in (False, True):
        with pytest.raises(NotImplementedError, match="2 components"):
            jpeg.decode_jpeg(data, plain=plain)


# ---- the committed fixtures

@pytest.mark.parametrize("entry", MANIFEST["files"],
                         ids=[e["name"] for e in MANIFEST["files"]])
def test_fixture_matches_manifest(entry):
    with open(os.path.join(FIXTURES, entry["name"]), "rb") as f:
        data = f.read()
    assert fixtures.write(entry) == data
    for px in (_pil(data), jpeg.decode_jpeg(data),
               jpeg.decode_jpeg(data, plain=True)):
        assert list(px.shape) == entry["shape"]
        assert hashlib.sha256(px.tobytes()).hexdigest() == entry["sha256"]


# ---- the callers: slides, TIFF tiles, DICOM

def _check_slide(path):
    got, want = tw.PILSlide(path).levels, jw.PILSlide(path).levels
    assert [g.shape for g in got] == [w.shape for w in want]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_progressive_and_cmyk_slides_equal_jax(tmp_path):
    img = _image(61, 83)
    k = _image(61, 83, c=1, seed=7)
    cases = {
        "prog.jpg": _pil_jpeg(img, progressive=True, quality=90,
                              subsampling=2),
        "prog_gray.jpeg": _pil_jpeg(img[..., 0], progressive=True),
        "smoothed.jpg": writer.transcode(_pil_jpeg(img),
                                         writer.simple_progression(3)[:3]),
        "cmyk.jpg": _pil_jpeg(np.concatenate([img, k], -1),
                              progressive=True),
        "ycck.jpg": writer.encode(writer.from_planes(
            [img[..., 0], img[..., 1], img[..., 2], k[..., 0]],
            [(2, 2), (1, 1), (1, 1), (2, 2)]), app="adobe",
            adobe_transform=2),
    }
    for name, data in cases.items():
        path = str(tmp_path / name)
        with open(path, "wb") as f:
            f.write(data)
        _check_slide(path)
        with Image.open(path) as im:
            assert tw._jpeg_header(path) == (im.size, im.mode)
    np.testing.assert_array_equal(
        tw._cmyk_to_rgb(np.array([[[100, 50, 25, 200]]], np.uint8)),
        [[[33, 44, 50]]])


def test_cmyk_slide_budget_counts_four_bytes(tmp_path):
    """The decode budget of a CMYK .jpg at the JAX table's 4 B/px."""
    path = str(tmp_path / "c.jpg")
    with open(path, "wb") as f:
        f.write(_pil_jpeg(np.concatenate([_image(20, 30), _image(
            20, 30, c=1)], -1)))
    need = 3 * 20 * 30 + 4 * 20 * 30
    for cls in (tw.PILSlide, jw.PILSlide):
        cls(path, max_decode_bytes=need)
        with pytest.raises(ValueError, match="budget"):
            cls(path, max_decode_bytes=need - 1)


@pytest.mark.parametrize("kw", [dict(quality=90),
                                dict(quality=90, subsampling=2),
                                dict(quality=90, photometric=2)],
                         ids=["444", "420", "rgb"])
def test_progressive_jpeg_tiles_equal_jax(tmp_path, kw):
    """PIL (libtiff) decodes progressive JPEG tiles; the port too, through
    both routes."""
    path = str(tmp_path / "p.tiff")
    _write_tiff(path, [_encode_page(lvl, JPEG, tile=(32, 32),
                                    jpeg_kw=dict(kw, progressive=True))
                       for lvl in _pyramid(_image(45, 70))])
    _check_slide(path)
    for page, lvl in zip(tiff.read_pages(path), tw.PILSlide(path).levels):
        np.testing.assert_array_equal(tiff.read_page(path, page, plain=True),
                                      lvl)


def test_dicom_progressive_frame_reads_as_jax(tmp_path):
    """A DICOM Baseline JPEG (…1.2.4.50) file whose frame PIL wrote
    progressive: PIL decodes it for the JAX package, the port's decoder
    for the port; the same pixels."""
    px = _volume(n=1)[0]
    rle = open(_write(jd, tmp_path / "rle.dcm", px, "rle", False, 1),
               "rb").read()
    for name, kw in (("prog", dict(progressive=True, quality=90)),
                     ("smooth", None)):
        gray = (px % 256).astype(np.uint8)
        blob = (_pil_jpeg(gray, **kw) if kw else writer.transcode(
            _pil_jpeg(gray), [((0,), 0, 0, 0, 1), ((0,), 1, 5, 0, 1)]))
        blob += b"\x00" * (len(blob) % 2)
        frame = jd._rle_encode_frame(px)
        old = struct.pack("<HHI", 0xFFFE, 0xE000, len(frame)) + frame
        new = struct.pack("<HHI", 0xFFFE, 0xE000, len(blob)) + blob
        path = tmp_path / f"{name}.dcm"
        path.write_bytes(_with_syntax(rle.replace(old, new),
                                      jd.JPEG_BASELINE))
        ok = _same_outcome(path)
        assert ok[0] == "ok" and ok[2].shape == px.shape


# ---- refusals and corrupt data

def _with_sos(data: bytes, i: int, params: bytes) -> bytes:
    """``data`` with the last three bytes of its i-th SOS (Ss, Se, Ah|Al)
    replaced."""
    pos = -1
    for _ in range(i + 1):
        pos = data.index(b"\xff\xda", pos + 1)
    (n,) = struct.unpack_from(">H", data, pos + 2)
    end = pos + 2 + n
    return data[:end - 3] + params + data[end:]


@pytest.mark.parametrize("scan,params,what", [
    (0, bytes([0, 5, 0x01]), "bad parameters"),       # DC with Se > 0
    (0, bytes([0, 0, 0x0E]), "bad parameters"),       # Al 14
    (1, bytes([1, 5, 0x20]), "bad parameters"),       # Ah 2, Al 0 != Ah-1
    (5, bytes([1, 63, 0x10]), "does not follow"),     # refines Al 2 by Ah 1
    (1, bytes([1, 5, 0x10]), "does not follow"),      # refines unsent bits
    (6, bytes([0, 0, 0x21]), "does not follow"),      # DC: Ah 2 after Al 1
], ids=["dc_se", "al14", "ah_al", "ah_mismatch", "refine_unsent",
        "dc_ah_mismatch"])
def test_bad_scripts_raise(scan, params, what):
    data = _with_sos(writer.transcode(_source(24, 32)), scan, params)
    for plain in (False, True):
        with pytest.raises(ValueError, match=what):
            jpeg.decode_jpeg(data, plain=plain)


def test_ac_scan_of_two_components_and_ac_before_dc_raise():
    co = writer.read_coefficients(_source(24, 32))
    dc = ((0, 1, 2), 0, 0, 0, 0)
    for script, what in (
            ([dc, ((0, 1), 1, 63, 0, 0), ((2,), 1, 63, 0, 0)],
             "bad parameters"),
            ([((0,), 1, 63, 0, 0), dc, ((1,), 1, 63, 0, 0),
              ((2,), 1, 63, 0, 0)], "before its DC scan")):
        data = writer.encode(co, script)
        for plain in (False, True):
            with pytest.raises(ValueError, match=what):
                jpeg.decode_jpeg(data, plain=plain)


@pytest.mark.parametrize("seed", [1, 2])
def test_corrupt_progressive_data_decodes_alike(seed):
    """Bytes overwritten in the scans of a progressive stream with and
    without restart markers: the C++ and plain routes give the same
    pixels or both raise the same exception."""
    rng = np.random.default_rng(seed)
    base = writer.transcode(_source(40, 56, seed=seed),
                            restart=2 if seed == 2 else 0)
    sos = base.index(b"\xff\xda") + 14
    raised = 0
    for _ in range(120):
        data = bytearray(base)
        for _ in range(int(rng.integers(1, 6))):
            data[int(rng.integers(sos, len(data) - 2))] = int(
                rng.integers(0, 256))
        got = []
        for plain in (False, True):
            try:
                got.append(jpeg.decode_jpeg(bytes(data), plain=plain))
            except (ValueError, NotImplementedError) as e:
                got.append(type(e))
        if isinstance(got[0], type) or isinstance(got[1], type):
            assert got[0] is got[1]
            raised += 1
        else:
            np.testing.assert_array_equal(got[0], got[1])
    assert 0 < raised < 120
