"""Arithmetic-coded (SOF9, SOF10) and lossless (SOF3) JPEG in the port's
decoder (``utils/jpeg.py``, C++ in ``csrc/imgcodec.cpp``) against PIL's
libjpeg-turbo, which the JAX package reads JPEG through, bit for bit
(tolerance 0), through the C++ route and through the plain route:

- arithmetic streams of ``tools/jpeg_arith.py`` (the coefficients of
  PIL's files coded again, as ``jpegtran -arithmetic`` does): gray,
  4:2:0, 4:2:2, 4:4:4, CMYK and YCCK; SOF9 and SOF10 in libjpeg's
  default script; restart intervals; non-default DAC conditioning; EOB
  runs and successive approximation from Al = 3; scripts that stop early,
  whose unrefined coefficients libjpeg-turbo smooths; each decodes to the
  pixels of the Huffman stream of the same coefficients too (the oracle
  ``chip_smoke.py`` uses on the card);
- lossless streams at 8 bits: predictors 1..7, point transforms, 1, 3
  and 4 components, interleaved or one scan a component, restart
  intervals, subsampled components (replicated, as libjpeg-turbo does);
- the callers: the port's ``PILSlide`` equals the JAX package's on .jpg
  slides of each coding, and a DICOM …1.2.4.50 frame of each decodes
  as JAX ``dicom._decode_encapsulated`` decodes it through PIL;
- refusals, where PIL refuses: 12-bit frames, SOF11, lossless at other
  than 8 bits, colour conversion in lossless mode, a lossless restart
  interval that is not whole MCU rows, bad lossless scan parameters, a
  bad DAC segment, a truncated arithmetic or lossless stream;
- corrupt arithmetic data: both routes give the same pixels or raise the
  same exception;
- an arithmetic stream larger than PIL's 64 KiB read block: PIL refuses
  it (libjpeg's arithmetic decoder cannot wait for more input), PIL with
  ``ImageFile.MAXBLOCK`` raised past the file decodes it, and the port
  decodes it to those pixels (a deliberate difference: libtiff decodes
  such a frame as a TIFF tile, see ``test_torch_wsi_compressed.py``).
"""
import importlib.util
import io
import os

import numpy as np
import pytest
from PIL import Image, ImageFile

from test_torch_codecs import _image

from multimodalfusion_tpu.data import dicom as jd
from multimodalfusion_tpu.data import wsi as jw
from multimodalfusion_tpu_torch.data import dicom as td
from multimodalfusion_tpu_torch.data import wsi as tw
from multimodalfusion_tpu_torch.utils import jpeg

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_spec = importlib.util.spec_from_file_location(
    "jpeg_arith", os.path.join(ROOT, "tools", "jpeg_arith.py"))
arith = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(arith)
writer = arith.writer


def _pil(data: bytes) -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(data)))


def _both(data: bytes, want: np.ndarray = None) -> np.ndarray:
    """The C++ and the plain decode each equal PIL's pixels (or
    ``want``)."""
    want = _pil(data) if want is None else want
    for plain in (False, True):
        got = jpeg.decode_jpeg(data, plain=plain)
        assert got.dtype == np.uint8 and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
    return want


def _pil_jpeg(img: np.ndarray, **kw) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(img, "CMYK" if img.ndim == 3 and img.shape[2] == 4
                    else None).save(buf, "JPEG", **kw)
    return buf.getvalue()


def _four(h, w, seed=0):
    return np.concatenate([_image(h, w, seed=seed),
                           _image(h, w, c=1, seed=seed + 1)], -1)


SOURCES = {
    "gray": lambda: _pil_jpeg(_image(33, 41, c=1)[..., 0], quality=90),
    "420": lambda: _pil_jpeg(_image(40, 56, seed=1), quality=90,
                             subsampling=2),
    "422": lambda: _pil_jpeg(_image(29, 50, seed=2), quality=75,
                             subsampling=1),
    "444": lambda: _pil_jpeg(_image(24, 32, seed=3), quality=95,
                             subsampling=0),
    "cmyk": lambda: _pil_jpeg(_four(24, 40, 4), quality=90),
}


def _arith(name, **kw):
    """(arithmetic stream, its source's Huffman stream)."""
    src = SOURCES[name]()
    app = "adobe" if name == "cmyk" else "jfif"
    return arith.transcode(src, app=app, **kw), src


# ---- arithmetic coding

@pytest.mark.parametrize("name", sorted(SOURCES))
@pytest.mark.parametrize("progressive", [False, True], ids=["sof9",
                                                            "sof10"])
@pytest.mark.parametrize("restart", [0, 2])
def test_arithmetic_equals_pil_and_its_source(name, progressive, restart):
    data, src = _arith(name, progressive=progressive, restart=restart)
    f = jpeg.parse_jpeg(data)
    assert f.coding == jpeg.ARITHMETIC and f.progressive == progressive
    want = _both(data)
    np.testing.assert_array_equal(want, _pil(src))


def test_ycck_equals_pil():
    img = _four(48, 64, 5)
    co = writer.from_planes([img[..., c] for c in range(4)],
                            [(2, 2), (1, 1), (1, 1), (2, 2)], 85)
    for progressive in (False, True):
        data = arith.encode(co, progressive=progressive, app="adobe",
                            adobe_transform=2)
        assert jpeg.parse_jpeg(data).transform
        _both(data, _pil(writer.encode(co, progressive=progressive,
                                       app="adobe", adobe_transform=2)))
        _both(data)


@pytest.mark.parametrize("dac", [
    {("dc", 0): (1, 3), ("dc", 1): (0, 0), ("ac", 0): 1, ("ac", 1): 63},
    {("dc", 0): (5, 10), ("dc", 1): (2, 2), ("ac", 0): 20, ("ac", 1): 0},
], ids=["narrow", "wide"])
def test_non_default_conditioning(dac):
    """DAC segments of other L, U and Kx change the contexts and bins;
    the stream still decodes to its source."""
    for progressive in (False, True):
        data, src = _arith("420", progressive=progressive, dac=dac)
        scan = jpeg.parse_jpeg(data).scans[0]
        assert scan.cond[0][:2] == dac[("dc", 0)]
        np.testing.assert_array_equal(_both(data), _pil(src))


def test_conditioning_of_a_tables_stream_is_reset():
    """A DAC in a TIFF's JPEGTables counts for nothing: the stream's SOI
    resets it (jdmarker.c's get_soi)."""
    data, _ = _arith("gray", progressive=False)
    tables = b"\xff\xd8" + jpeg._segment(0xCC, bytes([0, 0x54, 16, 9])) + \
        b"\xff\xd9"
    assert jpeg.parse_jpeg(data, tables).scans[0].cond == ((0, 1, 5),)


def _source(h=64, w=80, seed=6, **kw):
    return _pil_jpeg(_image(h, w, seed=seed), quality=90, subsampling=2,
                     **kw)


def _al3(n):
    dc = tuple(range(n))
    return ([(dc, 0, 0, 0, 3), (dc, 0, 0, 3, 2), (dc, 0, 0, 2, 1),
             (dc, 0, 0, 1, 0)]
            + [((c,), 1, 63, ah, ah - 1) if ah else ((c,), 1, 63, 0, 3)
               for c in range(n) for ah in (0, 3, 2, 1)])


@pytest.mark.parametrize("script,restart", [
    ("al3", 0), ("al3", 3), ("bands", 0), ("cr_first", 2)])
def test_progressive_scripts_equal_pil_and_their_source(script, restart):
    """Successive approximation from Al = 3 (DC and AC refinement),
    spectral selection in narrow bands, the AC of Cr before Y."""
    scripts = {
        "al3": _al3(3),
        "bands": [((0, 1, 2), 0, 0, 0, 0)] + [
            ((c,), lo, hi, 0, 0) for c in range(3)
            for lo, hi in ((1, 2), (3, 9), (10, 35), (36, 63))],
        "cr_first": [((0, 1, 2), 0, 0, 0, 1), ((2,), 1, 63, 0, 0),
                     ((1,), 1, 63, 0, 0), ((0,), 1, 63, 0, 1),
                     ((0, 1, 2), 0, 0, 1, 0), ((0,), 1, 63, 1, 0)]}
    src = _source()
    data = arith.transcode(src, scripts[script], restart=restart)
    np.testing.assert_array_equal(_both(data), _pil(src))


def test_eob_runs_on_a_flat_field():
    """Most blocks without AC coefficients: the EOB decision of their
    first position, block after block, across restart intervals."""
    img = np.full((64, 96, 3), 120, np.uint8)
    img[20:40, 30:60] = (200, 80, 150)
    src = _pil_jpeg(img, quality=70)
    for restart in (0, 1, 5):
        for progressive in (False, True):
            data = arith.transcode(src, progressive=progressive,
                                   restart=restart)
            np.testing.assert_array_equal(_both(data), _pil(src))


@pytest.mark.parametrize("stop", [1, 4, 6], ids=["dc_only", "first4",
                                                  "first6"])
def test_unrefined_scripts_smooth_as_pil(stop):
    """libjpeg's default script stopped early: libjpeg-turbo smooths the
    unrefined coefficients, an arithmetic frame as a Huffman one."""
    src = _source(72, 64, seed=7)
    data = arith.transcode(src, writer.simple_progression(3)[:stop])
    _both(data, _pil(writer.transcode(src, writer.simple_progression(3)[
        :stop])))
    _both(data)


# ---- lossless

def _planes(h, w, c, seed=0):
    img = _image(h, w, c=min(c, 3), seed=seed)
    planes = [img[..., k] for k in range(img.shape[2])]
    if c == 4:
        planes.append(_image(h, w, c=1, seed=seed + 1)[..., 0])
    return planes


@pytest.mark.parametrize("psv", range(1, 8))
@pytest.mark.parametrize("pt", [0, 3])
@pytest.mark.parametrize("c", [1, 3])
def test_lossless_equals_pil(psv, pt, c):
    planes = _planes(23, 31, c, seed=psv)
    data = arith.encode_lossless(planes, psv=psv, pt=pt)
    f = jpeg.parse_jpeg(data)
    assert f.coding == jpeg.LOSSLESS and not f.transform
    want = np.stack([(p >> pt) << pt for p in planes], -1)
    _both(data, want[..., 0] if c == 1 else want)
    _both(data)


@pytest.mark.parametrize("kw", [
    dict(interleave=False), dict(restart_rows=2),
    dict(interleave=False, restart_rows=3), dict(c=4),
    dict(sampling=[(2, 2), (1, 1), (1, 1)], restart_rows=1),
    dict(sampling=[(2, 1), (1, 1), (1, 1)], psv=5),
    dict(sampling=[(1, 2), (1, 1), (1, 1)], interleave=False, psv=3),
    dict(ids=[82, 71, 66], app="adobe", adobe_transform=0),
], ids=["scans_apart", "restart", "scans_apart_restart", "cmyk", "420",
        "422", "440_apart", "rgb_ids"])
def test_lossless_layouts_equal_pil(kw):
    kw = dict(kw)
    c = kw.pop("c", 3)
    sampling = kw.get("sampling")
    planes = _planes(21, 27, c, seed=9)
    if sampling:
        hm = max(h for h, _ in sampling)
        vm = max(v for _, v in sampling)
        planes = [p[::vm // v, ::hm // h] for p, (h, v) in zip(planes,
                                                             sampling)]
        kw["size"] = (27, 21)
    _both(arith.encode_lossless(planes, **kw))


# ---- the callers: .jpg slides and DICOM frames

def _streams():
    gray = _image(37, 45, c=1, seed=11)[..., 0]
    return {
        "sof9": arith.transcode(_pil_jpeg(_image(37, 45, seed=10),
                                          quality=90), progressive=False,
                                restart=4),
        "sof10": arith.transcode(_pil_jpeg(_image(37, 45, seed=10),
                                           quality=90)),
        "sof10_smoothed": arith.transcode(_pil_jpeg(gray, quality=90), [
            ((0,), 0, 0, 0, 1), ((0,), 1, 5, 0, 2)]),
        "sof9_cmyk": arith.transcode(_pil_jpeg(_four(30, 44, 12)),
                                     app="adobe", progressive=False),
        "sof3_gray": arith.encode_lossless([gray], psv=6, pt=1),
        "sof3_rgb": arith.encode_lossless(_planes(37, 45, 3, 13), psv=7),
    }


@pytest.mark.parametrize("name", sorted(_streams()))
def test_jpg_slides_equal_jax(tmp_path, name):
    path = str(tmp_path / f"{name}.jpg")
    with open(path, "wb") as f:
        f.write(_streams()[name])
    got, want = tw.PILSlide(path).levels, jw.PILSlide(path).levels
    assert len(got) == len(want) == 1
    np.testing.assert_array_equal(got[0], want[0])
    with Image.open(path) as im:
        assert tw._jpeg_header(path) == (im.size, im.mode)


@pytest.mark.parametrize("name", ["sof9", "sof10", "sof10_smoothed",
                                  "sof3_gray"])
def test_dicom_baseline_frames_read_as_jax(name):
    """A …1.2.4.50 frame carrying SOF9, SOF10 or SOF3: the JAX package
    decodes it through PIL, the port through its own decoder."""
    blob = _streams()[name]
    if name in ("sof9", "sof10"):  # DICOM frames of CT slices are gray
        blob = arith.transcode(_pil_jpeg(_image(37, 45, c=1, seed=14)[
            ..., 0], quality=90), progressive=name == "sof10")
    rows, cols = jpeg.parse_jpeg(blob).height, jpeg.parse_jpeg(blob).width
    args = ([blob], jd.JPEG_BASELINE, rows, cols, 8, False)
    want = jd._decode_encapsulated(*args)
    got = td._decode_encapsulated(*args)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    # a colour frame raises alike
    args = ([_streams()["sof3_rgb"]], jd.JPEG_BASELINE, 37, 45, 8, False)
    for mod in (jd, td):
        with pytest.raises(NotImplementedError, match="monochrome"):
            mod._decode_encapsulated(*args)


# ---- refusals

def _refused(data, what, port_exc=NotImplementedError):
    with pytest.raises(OSError):
        _pil(data)
    for plain in (False, True):
        with pytest.raises(port_exc, match=what):
            jpeg.decode_jpeg(data, plain=plain)


def test_refused_frames_raise_as_pil():
    data, _ = _arith("420", progressive=False)
    sof = data.index(b"\xff\xc9")
    _refused(data[:sof + 4] + b"\x0c" + data[sof + 5:], "12-bit")
    _refused(data[:sof + 1] + b"\xcb" + data[sof + 2:], "SOF11")
    planes = _planes(16, 16, 1)
    for precision in (7, 12):
        _refused(arith.encode_lossless([p >> (8 - min(precision, 8))
                                        for p in planes],
                                       precision=precision),
                 f"{precision}-bit")
    # colour conversion in lossless mode: JFIF, Adobe transform 1
    for kw in (dict(app="jfif"), dict(app="adobe", adobe_transform=1)):
        _refused(arith.encode_lossless(_planes(16, 16, 3), **kw),
                 "lossless")


def test_bad_lossless_scans_raise_as_pil():
    base = arith.encode_lossless(_planes(16, 24, 3), restart_rows=1)
    # DRI of 5 MCUs where a row holds 24
    dri = base.index(b"\xff\xdd")
    _refused(base[:dri + 4] + b"\x00\x05" + base[dri + 6:], "restart",
             ValueError)
    sos = base.index(b"\xff\xda")
    n = base[sos + 4]
    at = sos + 5 + 2 * n  # Ss (the predictor), Se, Ah | Al
    for params in (b"\x00\x00\x00", b"\x08\x00\x00", b"\x01\x05\x00",
                   b"\x01\x00\x10", b"\x01\x00\x08"):
        _refused(base[:at] + params + base[at + 3:], "bad parameters",
                 ValueError)


def test_bad_dac_segments_raise_as_pil():
    data, _ = _arith("gray", progressive=False)
    dac = data.index(b"\xff\xcc")
    for body in (bytes([0, 0x12]),   # L 2 > U 1
                 bytes([40, 5])):     # table index 40
        _refused(data[:dac + 4] + body + data[dac + 6:], "DAC", ValueError)


@pytest.mark.parametrize("kind", ["sof9", "sof10", "sof3"])
def test_truncated_streams_raise_as_pil(kind):
    streams = _streams()
    data = streams[{"sof9": "sof9", "sof10": "sof10",
                    "sof3": "sof3_rgb"}[kind]]
    for cut in (2, 30, len(data) // 2):
        _refused(data[:-cut], "truncated", ValueError)


@pytest.mark.parametrize("seed", [1, 2])
def test_corrupt_arithmetic_data_decodes_alike(seed):
    """Bytes overwritten in the scans of an arithmetic stream with and
    without restart markers: the C++ and plain routes give the same
    pixels or both raise the same exception."""
    rng = np.random.default_rng(seed)
    base = arith.transcode(_source(40, 56, seed=seed), progressive=seed == 1,
                           restart=2 if seed == 2 else 0)
    sos = base.index(b"\xff\xda") + 14
    outcomes = set()
    for _ in range(60):
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
            outcomes.add("raised")
        else:
            np.testing.assert_array_equal(got[0], got[1])
            outcomes.add("decoded")
    assert "decoded" in outcomes


def test_streams_past_pils_read_block(monkeypatch):
    """An arithmetic stream larger than PIL's 64 KiB read block: PIL
    refuses it (libjpeg's arithmetic decoder cannot wait for input PIL
    has not read yet); given the whole file it decodes it, and the port
    decodes it to those pixels."""
    img = np.random.default_rng(15).integers(0, 256, (160, 256, 3),
                                             np.uint8)
    src = _pil_jpeg(img, quality=95, subsampling=0)
    data = arith.transcode(src, progressive=False)
    assert len(data) > ImageFile.MAXBLOCK
    with pytest.raises(OSError):
        _pil(data)
    monkeypatch.setattr(ImageFile, "MAXBLOCK", 4 * len(data))
    np.testing.assert_array_equal(_both(data), _pil(src))
