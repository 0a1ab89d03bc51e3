"""The port's JPEG 2000 codec (multimodalfusion_tpu_torch/utils/j2k.py and
its C++ hot loops in csrc/j2k.cpp) against PIL's openjpeg, which the JAX
package reads and writes JPEG 2000 through, on seeded numpy images:

- streams PIL writes (JP2 and bare codestreams; the five progression
  orders with precincts; 1-8 layers; code-blocks 4-64; tiles with image
  and tile offsets; 5/3 and 9/7; L, LA, RGB, RGBA and I;16, signed too;
  the RCT and ICT) decode to PIL's pixels bit for bit, through the plain
  version and through C++ (tolerance 0, 9/7 included);
- streams the port's encoder and its test-stream writer
  (tools/j2k_writer.py: every code-block style bit, POC, SOP/EPH, PPM,
  PPT, tile-parts, an ROI shift, 1-4 components, 1- to 16-bit samples,
  signed and unsigned) write decode in PIL to the source's
  pixels as PIL maps them (its shift of a precision below 8 or 16 bits
  and its offset of a signed component, pinned here), and in the port to
  PIL's pixels; the C++ encoder writes the plain encoder's bytes, and
  the writer with its defaults writes ``j2k.encode``'s;
- what PIL writes for write_ct_slice (openjpeg's default COD, unsigned
  16 bits) and the port's encoder write the same COD;
- truncated and corrupted streams give the same outcome from C++ and
  plain: the same exception or the same pixels;
- each committed fixture of testdata/j2k (tools/make_j2k_fixtures.py) is
  made again from its recorded parameters, and PIL's pixels of it, and
  the port's C++ and plain decodes of the committed file, have the
  manifest's digest;
- Part-15 code-blocks, CAP, palettes and subsampled components are
  refused, naming the marker or box.
The plain tier 1 runs a Python loop per sample, so images stay small.
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

from multimodalfusion_tpu_torch import native
from multimodalfusion_tpu_torch.utils import j2k

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(ROOT, "multimodalfusion_tpu_torch", "testdata", "j2k")
_spec = importlib.util.spec_from_file_location(
    "make_j2k_fixtures", os.path.join(ROOT, "tools", "make_j2k_fixtures.py"))
fixtures = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(fixtures)
encode_stream = fixtures.writer.encode_stream
with open(os.path.join(FIXTURES, "MANIFEST.json")) as _f:
    MANIFEST = json.load(_f)


def _image(seed, h, w, c=1, bits=8, signed=False):
    return fixtures.fixture_image(dict(seed=seed, h=h, w=w, c=c, bits=bits,
                                       signed=signed))


def _pil_write(img, **kw):
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="JPEG2000", **kw)
    return buf.getvalue()


def _pil_read(data):
    return np.asarray(Image.open(io.BytesIO(data)))


def _digest(px):
    return hashlib.sha256(np.ascontiguousarray(px).tobytes()).hexdigest()


def _both(data):
    """The plain and the C++ decode, which must agree."""
    plain = j2k.decode(data, plain=True)
    fast = j2k.decode(data, n_threads=3)
    np.testing.assert_array_equal(fast, plain)
    assert fast.dtype == plain.dtype
    return plain


# ---- streams PIL writes

PIL_CASES = {
    "jp2_53": (dict(seed=1, h=33, w=47), dict(irreversible=False)),
    "j2k_53": (dict(seed=1, h=33, w=47), dict(irreversible=False,
                                              no_jp2=True)),
    "jp2_97": (dict(seed=2, h=29, w=38), dict(irreversible=True)),
    "layers_1": (dict(seed=3, h=32, w=32), dict(
        irreversible=False, quality_mode="rates", quality_layers=[4])),
    "layers_2_97": (dict(seed=3, h=32, w=32), dict(
        irreversible=True, quality_mode="rates", quality_layers=[30, 6])),
    "layers_4": (dict(seed=4, h=30, w=34, c=3), dict(
        irreversible=False, quality_mode="rates",
        quality_layers=[40, 20, 8, 2])),
    "layers_8_db": (dict(seed=4, h=30, w=34), dict(
        irreversible=True, quality_mode="dB",
        quality_layers=[20, 24, 28, 32, 36, 40, 44, 48])),
    "cblk_4x4": (dict(seed=5, h=21, w=19), dict(
        irreversible=False, codeblock_size=(4, 4), num_resolutions=2)),
    "cblk_8x64": (dict(seed=5, h=40, w=40), dict(
        irreversible=True, codeblock_size=(8, 64))),
    "cblk_64x8": (dict(seed=5, h=40, w=40), dict(
        irreversible=False, codeblock_size=(64, 8))),
    "cblk_16x32": (dict(seed=6, h=37, w=41, c=3), dict(
        irreversible=False, codeblock_size=(16, 32), mct=1)),
    "tiles": (dict(seed=7, h=40, w=44), dict(
        irreversible=False, tile_size=(16, 24), num_resolutions=3)),
    "tiles_offsets": (dict(seed=7, h=39, w=45), dict(
        irreversible=True, tile_size=(20, 17), offset=(7, 5),
        tile_offset=(3, 2), num_resolutions=3)),
    "image_offset": (dict(seed=8, h=25, w=31, c=3), dict(
        irreversible=False, offset=(3, 9), tile_size=(40, 40))),
    "levels_0": (dict(seed=9, h=20, w=24), dict(
        irreversible=False, num_resolutions=1)),
    "levels_6": (dict(seed=9, h=64, w=64), dict(
        irreversible=True, num_resolutions=7)),
    "la": (dict(seed=10, h=23, w=27, c=2), dict(irreversible=False)),
    "rgba_97": (dict(seed=11, h=23, w=27, c=4), dict(irreversible=True)),
    "rgb_rct": (dict(seed=12, h=35, w=29, c=3), dict(
        irreversible=False, mct=1)),
    "rgb_ict": (dict(seed=12, h=35, w=29, c=3), dict(
        irreversible=True, mct=1)),
    "i16_53": (dict(seed=13, h=31, w=26, bits=16), dict(
        irreversible=False)),
    "i16_97": (dict(seed=13, h=31, w=26, bits=16), dict(
        irreversible=True, quality_mode="rates", quality_layers=[10, 3])),
    "i16_signed": (dict(seed=14, h=24, w=24, bits=16), dict(
        irreversible=False, signed=True)),
}
for _prog in j2k.PROGRESSIONS:
    PIL_CASES[f"prog_{_prog}"] = (dict(seed=15, h=36, w=40, c=3), dict(
        irreversible=False, progression=_prog, precinct_size=(16, 16),
        num_resolutions=3, codeblock_size=(8, 8), quality_mode="rates",
        quality_layers=[20, 5]))


@pytest.mark.parametrize("case", sorted(PIL_CASES))
def test_pil_streams_decode_to_pils_pixels(case):
    spec, kw = PIL_CASES[case]
    img = _image(**spec)
    data = _pil_write(img, **kw)
    want = _pil_read(data)
    got = _both(data)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    assert j2k.header(data) == (Image.open(io.BytesIO(data)).size,
                                Image.open(io.BytesIO(data)).mode)


# ---- streams the port writes

def _pil_pixels(img, prec, signed, mode):
    """The source as PIL should map it (the rule pinned below)."""
    img = img if img.ndim == 3 else img[..., None]
    siz = j2k.Siz(img.shape[1], img.shape[0], 0, 0, 1, 1, 0, 0,
                  [prec] * img.shape[2], [signed] * img.shape[2])
    return j2k.pil_pixels([img[..., c].astype(np.int64)
                           for c in range(img.shape[2])], siz, mode)


PORT_CASES = {
    **{f"style_{b}": (dict(seed=20 + b, h=26, w=23), dict(style=b,
                                                          layers=2))
       for b in (1, 2, 4, 8, 16, 32)},
    "style_all": (dict(seed=27, h=26, w=29), dict(style=63, layers=3)),
    "style_bypass_termall": (dict(seed=28, h=24, w=24, bits=16),
                             dict(style=5)),
    "poc": (dict(seed=29, h=27, w=25, c=3), dict(
        layers=3, precincts=[(8, 8)], levels=2,
        pocs=[(0, 0, 1, 2, 3, "RPCL"), (1, 0, 3, 3, 2, "CPRL"),
              (0, 0, 3, 3, 3, "LRCP")])),
    "sop_eph": (dict(seed=30, h=22, w=30), dict(sop=True, eph=True,
                                                layers=2)),
    "ppm_tileparts": (dict(seed=31, h=30, w=26), dict(
        ppm=True, tile_size=(16, 16), tile_parts=2, layers=2)),
    "ppt_tileparts": (dict(seed=32, h=30, w=26, c=3), dict(
        ppt=True, tile_size=(13, 17), tile_offset=(0, 0), tile_parts=3,
        sop=True)),
    "roi": (dict(seed=33, h=28, w=28), dict(roi={0: True}, levels=3)),
    "prec12": (dict(seed=34, h=23, w=21, bits=12), dict(prec=12)),
    "prec12_signed": (dict(seed=35, h=23, w=21, bits=12, signed=True),
                      dict(prec=12, signed=True, jp2=False)),
    "prec16_signed": (dict(seed=36, h=20, w=20, bits=16, signed=True),
                      dict(signed=True)),
    "prec4": (dict(seed=37, h=17, w=19, bits=4), dict(prec=4)),
    "prec9_jp2": (dict(seed=38, h=17, w=19, bits=9), dict(prec=9)),
    "prec9_j2k": (dict(seed=38, h=17, w=19, bits=9), dict(prec=9,
                                                          jp2=False)),
    "prec1": (dict(seed=39, h=17, w=19, bits=1), dict(prec=1, levels=2)),
    "two_comps": (dict(seed=40, h=19, w=22, c=2), dict()),
    "four_comps_rct": (dict(seed=41, h=19, w=22, c=4), dict(mct=True)),
    "rgb_no_mct": (dict(seed=42, h=19, w=22, c=3), dict(mct=False)),
    "rpcl_precincts_offsets": (dict(seed=43, h=33, w=29, c=3), dict(
        progression="RPCL", precincts=[(16, 8), (8, 8)], offset=(5, 3),
        tile_size=(20, 18), tile_offset=(1, 2), cblk=(8, 4), layers=4)),
    "layers_8": (dict(seed=44, h=24, w=24), dict(layers=8, cblk=(16, 16))),
}


@pytest.mark.parametrize("case", sorted(PORT_CASES))
def test_port_streams_decode_in_pil_and_the_port(case):
    spec, kw = PORT_CASES[case]
    img = _image(**spec)
    bits = spec.get("bits", 8)
    prec = kw.get("prec", 8 if img.dtype == np.uint8 else 16)
    if spec.get("signed"):
        img = img.astype(np.int64)
    data = encode_stream(img, plain=True, **kw)
    assert encode_stream(img, n_threads=3, **kw) == data
    want = _pil_read(data)
    mode = Image.open(io.BytesIO(data)).mode
    np.testing.assert_array_equal(
        want, _pil_pixels(img, prec, kw.get("signed", False), mode))
    np.testing.assert_array_equal(_both(data), want)
    assert bits == prec


def test_pil_shifts_12_bits_and_offsets_signed_samples():
    """PIL's I;16 shifts a 12-bit sample up by 4 and offsets a signed one
    by 2**(prec - 1); the JAX package's DICOM reader keeps both."""
    img = np.array([[0, 1, 4095, 2048]], np.uint16)
    data = j2k.encode(img, prec=12, plain=True)
    np.testing.assert_array_equal(_pil_read(data), [[0, 16, 65520, 32768]])
    signed = np.array([[-7, 0, -32768, 32767]])
    data = j2k.encode(signed, prec=16, signed=True, plain=True)
    assert data[:12] == j2k.JP2_SIGNATURE
    np.testing.assert_array_equal(_pil_read(data),
                                  [[32761, 32768, 0, 65535]])
    np.testing.assert_array_equal(_both(data), _pil_read(data))


def test_write_ct_slice_settings_are_openjpegs_defaults():
    """What PIL writes for the JAX write_ct_slice: a JP2 file whose
    codestream starts at byte 85, COD = LRCP, one layer, no MCT, 5
    levels, 64 x 64 code-blocks, style 0, 5/3; SIZ unsigned 16-bit.  The
    port's encoder writes the same COD, QCD and Ssiz."""
    px = _image(50, 40, 36, bits=16)
    pil = _pil_write(px, irreversible=False)
    assert pil[:12] == j2k.JP2_SIGNATURE
    assert pil.index(b"\xff\x4f\xff\x51") == 85
    cod = bytes.fromhex("ff52000c000000010005040400" "01")
    port = j2k.encode(px)
    for data in (pil, port):
        cs = j2k.parse_container(data).codestream
        assert cod in cs
        assert cs[4 + 2 + 36] == 0x0F      # Ssiz of the one component
        qcd = cs[cs.index(b"\xff\x5c"):]
        assert qcd[:5] == b"\xff\x5c\x00\x13\x40"
    np.testing.assert_array_equal(_pil_read(port), px)
    np.testing.assert_array_equal(_both(pil), px)


@pytest.mark.parametrize("spec", [
    dict(seed=51, h=37, w=45), dict(seed=52, h=30, w=26, c=3),
    dict(seed=53, h=24, w=20, bits=12),
    dict(seed=54, h=21, w=23, bits=16, signed=True)],
    ids=["grey8", "rgb8", "grey12", "signed16"])
def test_encode_is_the_writers_default_stream(spec):
    """``j2k.encode`` (grey or RGB, what write_ct_slice and a slide
    need) writes the test-stream writer's bytes at its defaults, plain
    and in C++, and refuses another component count."""
    img = _image(**spec)
    prec = spec.get("bits", 8) if spec.get("bits", 8) != 8 else None
    signed = spec.get("signed", False)
    data = j2k.encode(img, prec=prec, signed=signed, plain=True)
    assert j2k.encode(img, prec=prec, signed=signed, n_threads=2) == data
    assert encode_stream(img, prec=prec, signed=signed, plain=True) == data
    with pytest.raises(ValueError, match="H, W, 3"):
        j2k.encode(np.stack([img] * 2, axis=-1) if img.ndim == 2
                   else img[..., :2], prec=prec, signed=signed)


# ---- corrupt streams: C++ and plain alike

def _outcome(data, plain):
    try:
        return ("ok", _digest(j2k.decode(data, plain=plain, n_threads=2)))
    except Exception as e:  # noqa: BLE001 -- the outcome is what is compared
        return ("raise", type(e).__name__, str(e))


@pytest.mark.parametrize("stream", ["mq_53", "bypass_termall", "pil_97"])
def test_corrupt_streams_give_the_same_outcome(stream):
    img = _image(60, 24, 22)
    if stream == "pil_97":
        data = _pil_write(img, irreversible=True, no_jp2=True)
    else:
        data = encode_stream(img, plain=True, jp2=False, layers=2,
                             style=0 if stream == "mq_53" else 5)
    rng = np.random.default_rng(61)
    body = data.index(b"\xff\x93") + 2
    raised = 0
    for k in range(24):
        buf = bytearray(data)
        if k % 3 == 0:
            buf = buf[:int(rng.integers(body, len(buf)))]
        else:
            for _ in range(int(rng.integers(1, 4))):
                buf[int(rng.integers(body, len(buf) - 2))] = int(
                    rng.integers(0, 256))
        a, b = _outcome(bytes(buf), True), _outcome(bytes(buf), False)
        assert a == b
        raised += a[0] == "raise"
    assert raised < 24


def test_counters_count_calls():
    img = _image(62, 20, 20, c=3)
    data = j2k.encode(img)
    d0, i0 = native.j2k_decode_blocks.calls, native.j2k_idwt.calls
    e0 = native.j2k_encode_blocks.calls
    j2k.decode(data)
    j2k.encode(img)
    assert native.j2k_decode_blocks.calls == d0 + 1
    assert native.j2k_idwt.calls == i0 + 3
    assert native.j2k_encode_blocks.calls == e0 + 1
    j2k.decode(data, plain=True)
    assert native.j2k_decode_blocks.calls == d0 + 1


# ---- the committed fixtures

@pytest.mark.parametrize("entry", MANIFEST["files"],
                         ids=[e["name"] for e in MANIFEST["files"]])
def test_fixture_regenerates_to_its_manifest_digest(entry):
    data = fixtures.write(entry)
    px = _pil_read(data)
    assert list(px.shape) == entry["shape"] and str(px.dtype) == \
        entry["dtype"]
    assert _digest(px) == entry["sha256"]
    with open(os.path.join(FIXTURES, entry["name"]), "rb") as f:
        committed = f.read()
    if entry["writer"] == "port":
        assert data == committed
    assert j2k.read_header(os.path.join(FIXTURES, entry["name"])) == \
        j2k.header(committed) == (tuple(entry["shape"][1::-1]),
                                  Image.open(io.BytesIO(committed)).mode)
    assert _digest(_both(committed)) == entry["sha256"]


def test_fixtures_are_small_and_cover_the_listed_features():
    sizes = [os.path.getsize(os.path.join(FIXTURES, e["name"]))
             for e in MANIFEST["files"]]
    assert sum(sizes) < 256 * 1024
    params = [e["params"] for e in MANIFEST["files"]]
    assert any(p.get("irreversible") and len(p.get("quality_layers", [])) >= 2
               for p in params)
    assert any(p.get("progression") == "RPCL" and p.get("precinct_size")
               for p in params)
    assert any(p.get("tile_size") and p.get("offset") for p in params)
    assert any(p.get("irreversible") and p.get("mct") for p in params)
    assert any(p.get("prec") == 12 and p.get("signed") for p in params)
    assert any(p.get("style", 0) & (j2k.LAZY | j2k.TERMALL)
               == j2k.LAZY | j2k.TERMALL for p in params)


@pytest.mark.parametrize("layout", ["jp2_extra_box", "jp2_xl_box", "j2k",
                                    "jp2h_truncated"])
def test_read_header_reads_only_the_headers(tmp_path, layout):
    """``read_header`` gives ``header``'s answer while the code-blocks
    after SIZ are garbage, and the same error for a cut jp2h box."""
    img = _image(80, 20, 24, c=3)
    jp2 = j2k.encode(img)
    at = jp2.index(b"jp2c") - 4
    cs = j2k.parse_container(jp2).codestream
    siz_end = 4 + struct.unpack(">H", cs[4:6])[0]
    cs = cs[:siz_end] + bytes(len(cs) - siz_end)
    if layout == "jp2_extra_box":
        data = (jp2[:at] + j2k._box(b"uuid", bytes(5000))
                + j2k._box(b"jp2c", cs))
    elif layout == "jp2_xl_box":
        data = jp2[:at] + struct.pack(">I4sQ", 1, b"jp2c", 16 + len(cs)) + cs
    elif layout == "j2k":
        data = cs
    else:
        data = jp2[:jp2.index(b"jp2h") + 20]
    path = tmp_path / "x.jp2"
    path.write_bytes(data)
    if layout == "jp2h_truncated":
        with pytest.raises(ValueError, match="runs past the file"):
            j2k.header(data)
        with pytest.raises(ValueError, match="runs past the file"):
            j2k.read_header(str(path))
    else:
        assert j2k.read_header(str(path)) == j2k.header(jp2) == \
            ((24, 20), "RGB")


# ---- refusals

def _patched(data, old, new):
    assert old in data
    return data.replace(old, new, 1)


def test_refusals_name_the_marker_or_box():
    img = _image(70, 16, 16)
    cs = encode_stream(img, jp2=False)
    cod = cs[cs.index(b"\xff\x52"):cs.index(b"\xff\x52") + 14]
    ht = cod[:12] + bytes([cod[12] | 0x40]) + cod[13:]
    with pytest.raises(NotImplementedError, match="HTJ2K"):
        j2k.decode(_patched(cs, cod, ht))
    siz_end = 4 + struct.unpack(">H", cs[4:6])[0]
    cap = cs[:siz_end] + b"\xff\x50\x00\x08\x00\x02\x00\x00" + cs[siz_end:]
    with pytest.raises(NotImplementedError, match="CAP"):
        j2k.decode(cap)
    sub = cs[:siz_end - 2] + b"\x02\x01" + cs[siz_end:]
    with pytest.raises(NotImplementedError, match="subsamples"):
        j2k.decode(sub)
    jp2 = j2k.encode(img)
    pclr = _patched(jp2, b"colr", b"pclr")
    with pytest.raises(NotImplementedError, match="pclr"):
        j2k.decode(pclr)
    with pytest.raises(ValueError, match="not a JPEG 2000"):
        j2k.decode(b"\x89PNG\r\n\x1a\n" + jp2)
