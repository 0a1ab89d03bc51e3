"""The port's DICOM reader and writer (multimodalfusion_tpu_torch.data.
dicom, with the C++ lossless-JPEG decoder of its csrc/imgcodec.cpp) against
the JAX package's, and its lung bounding boxes against OpenCV: every
syntax the JAX writer writes without PIL is read by both readers to equal
pixel arrays and attributes, and written byte for byte alike; the C++
decoder equals the Python one; malformed, corrupted and mislabelled files
fail alike; the syntaxes JAX decodes through PIL decode to JAX's pixels
(Baseline JPEG gray frames, JPEG 2000 lossless and lossy frames, 12-bit
and signed ones as PIL maps them, in one or several fragments), and the
port's JPEG 2000 writer writes what the JAX reader reads back."""
import importlib.util
import io
import os
import struct

import cv2
import numpy as np
import pytest
from PIL import Image

from multimodalfusion_tpu.data import ct_preprocess as jct
from multimodalfusion_tpu.data import dicom as jd
from multimodalfusion_tpu_torch import native
from multimodalfusion_tpu_torch.data import ct_preprocess as tct
from multimodalfusion_tpu_torch.data import dicom as td
from multimodalfusion_tpu_torch.utils import j2k as tj2k

ATTRS = ("Modality", "SliceThickness", "ImagePositionPatient",
         "ImageOrientationPatient", "Rows", "Columns", "PixelSpacing",
         "BitsAllocated", "PixelRepresentation", "RescaleIntercept",
         "RescaleSlope", "TransferSyntaxUID")
# (compression, implicit, jpeg_psv) of every syntax JAX writes without PIL
WRITTEN = ([(None, False, 1), (None, True, 1), ("rle", False, 1),
            ("deflated", False, 1)]
           + [("jpeg_lossless", False, psv) for psv in range(1, 8)])


def _volume(n=3, hw=24, seed=0):
    rng = np.random.default_rng(seed)
    vol = rng.integers(900, 1200, size=(n, hw, hw)).astype(np.int16)
    vol[0, 0, 0], vol[0, 0, 1] = -7, 32767   # signed and extreme values
    return vol


def _write(mod, path, pixels, comp, implicit, psv, z=0.0):
    return mod.write_ct_slice(str(path), pixels, z=z, spacing=(0.7, 0.8),
                              thickness=2.5, intercept=-1024.0, slope=1.0,
                              implicit=implicit, compression=comp,
                              jpeg_psv=psv)


def _outcome(mod, path):
    """('ok', attributes, pixels) or ('raise', stage, class, message)."""
    try:
        s = mod.read_file(str(path))
    except Exception as e:
        return ("raise", "read", type(e).__name__, str(e))
    attrs = {k: getattr(s, k, None) for k in ATTRS}
    try:
        return ("ok", attrs, s.pixel_array)
    except Exception as e:
        return ("raise", "pixels", type(e).__name__, str(e))


def _same_outcome(path):
    want, got = _outcome(jd, path), _outcome(td, path)
    assert got[0] == want[0], (got, want)
    if want[0] == "ok":
        assert got[1] == want[1]
        np.testing.assert_array_equal(got[2], want[2])
        assert got[2].dtype == want[2].dtype
    else:
        assert got[1:3] == want[1:3], (got, want)
        if want[2] != "NotImplementedError":
            assert got[3] == want[3]
    return want


@pytest.mark.parametrize("comp,implicit,psv", WRITTEN)
def test_every_written_syntax_reads_alike_and_writes_alike(tmp_path, comp,
                                                           implicit, psv):
    vol = _volume()
    for i in range(vol.shape[0]):
        jp = _write(jd, tmp_path / f"j{i}.dcm", vol[i], comp, implicit, psv,
                    z=2.5 * i)
        tp = _write(td, tmp_path / f"t{i}.dcm", vol[i], comp, implicit, psv,
                    z=2.5 * i)
        assert open(tp, "rb").read() == open(jp, "rb").read()
        want = _same_outcome(jp)
        np.testing.assert_array_equal(want[2], vol[i])


def _meta_end(raw):
    pos = 132
    while struct.unpack("<H", raw[pos:pos + 2])[0] == 0x0002:
        vr = raw[pos + 4:pos + 6]
        if vr in jd._LONG_VRS:
            pos += 12 + struct.unpack("<I", raw[pos + 8:pos + 12])[0]
        else:
            pos += 8 + struct.unpack("<H", raw[pos + 6:pos + 8])[0]
    return pos


def _with_syntax(raw, ts):
    meta = jd._enc_element(0x0002, 0x0010, "UI", ts.encode())
    return raw[:132] + meta + raw[_meta_end(raw):]


def _handmade(tmp_path):
    """Files the JAX writer does not write: big endian, sequences,
    offset tables, split fragments, multi-frame, mislabelled syntaxes."""
    vol = _volume(n=1)
    px = np.ascontiguousarray(vol[0])
    base = {c: open(_write(jd, tmp_path / f"base_{c}.dcm", px, c, False, 1),
                    "rb").read()
            for c in (None, "rle", "jpeg_lossless")}
    raw, rle, jll = base[None], base["rle"], base["jpeg_lossless"]
    head, body = raw[:_meta_end(raw)], raw[_meta_end(raw):]

    def enc_be(group, elem, vr, value):
        if len(value) % 2:
            value += b" " if vr in ("DS", "IS", "CS") else b"\x00"
        h = struct.pack(">HH", group, elem) + vr.encode()
        if vr.encode() in jd._LONG_VRS:
            return h + b"\x00\x00" + struct.pack(">I", len(value)) + value
        return h + struct.pack(">H", len(value)) + value

    be = (enc_be(0x0020, 0x0032, "DS", b"0\\0\\2.5")
          + enc_be(0x0028, 0x0010, "US", struct.pack(">H", px.shape[0]))
          + enc_be(0x0028, 0x0011, "US", struct.pack(">H", px.shape[1]))
          + enc_be(0x0028, 0x0100, "US", struct.pack(">H", 16))
          + enc_be(0x0028, 0x0103, "US", struct.pack(">H", 1))
          + enc_be(0x7FE0, 0x0010, "OW", px.astype(">i2").tobytes()))
    sq = (struct.pack("<HH", 0x0008, 0x1140) + b"SQ\x00\x00"
          + struct.pack("<I", 0xFFFFFFFF)
          + struct.pack("<HHI", 0xFFFE, 0xE000, 0xFFFFFFFF)
          + struct.pack("<HH", 0x0008, 0x1150) + b"UI"
          + struct.pack("<H", 4) + b"1.2\x00"
          + struct.pack("<HH", 0x0008, 0x9215) + b"SQ\x00\x00"
          + struct.pack("<I", 0xFFFFFFFF)
          + struct.pack("<HHI", 0xFFFE, 0xE000, 6) + b"zzzzzz"
          + struct.pack("<HHI", 0xFFFE, 0xE0DD, 0)
          + struct.pack("<HHI", 0xFFFE, 0xE00D, 0)
          + struct.pack("<HHI", 0xFFFE, 0xE0DD, 0))
    unknown = (struct.pack("<HH", 0x0009, 0x0010) + b"LO"
               + struct.pack("<H", 4) + b"ACME")
    empty_bot = struct.pack("<HHI", 0xFFFE, 0xE000, 0)
    full_bot = struct.pack("<HHI", 0xFFFE, 0xE000, 4) + b"\x00" * 4
    frame = jd._encode_jpeg_lossless_sv1(px.view(np.uint16))
    frame += b"\x00" * (len(frame) % 2)
    item = struct.pack("<HHI", 0xFFFE, 0xE000, len(frame)) + frame
    cut = (len(frame) // 2) & ~1
    split = (struct.pack("<HHI", 0xFFFE, 0xE000, cut) + frame[:cut]
             + struct.pack("<HHI", 0xFFFE, 0xE000, len(frame) - cut)
             + frame[cut:])
    rle_frame = jd._rle_encode_frame(px)
    rle_item = struct.pack("<HHI", 0xFFFE, 0xE000,
                           len(rle_frame)) + rle_frame
    rows_elem = jd._enc_element(0x0028, 0x0010, "US",
                                struct.pack("<H", px.shape[0]))
    nframes = jd._enc_element(0x0028, 0x0008, "IS", b"3 ")
    files = {
        "big_endian": (raw[:132] + jd._enc_element(
            0x0002, 0x0010, "UI", jd.EXPLICIT_VR_BE.encode()) + be),
        "sequences": head + sq + unknown + body,
        "no_offset_table": rle.replace(empty_bot, b""),
        "full_offset_table": rle.replace(empty_bot, full_bot),
        "jpeg_split_fragments": jll.replace(item, split),
        "multi_frame_declared": raw.replace(rows_elem, nframes + rows_elem),
        "multi_frame_rle": rle.replace(rle_item, rle_item + rle_item),
        "jpeg_extended": _with_syntax(rle, jd.JPEG_EXTENDED),
        "rle_labelled_jpeg_lossless": _with_syntax(rle,
                                                   jd.JPEG_LOSSLESS_SV1),
        "jpeg_labelled_p14": _with_syntax(jll, jd.JPEG_LOSSLESS_P14),
        "jpeg_ls_unknown": _with_syntax(raw, "1.2.840.10008.1.2.4.80"),
        "bare_dataset": body,
    }
    for name, data in files.items():
        (tmp_path / f"{name}.dcm").write_bytes(data)
    return files


def test_handmade_files_read_alike(tmp_path):
    files = _handmade(tmp_path)
    kinds = {name: _same_outcome(tmp_path / f"{name}.dcm")[0]
             for name in files}
    assert kinds["big_endian"] == kinds["sequences"] == "ok"
    assert kinds["multi_frame_declared"] == "raise"
    assert kinds["jpeg_labelled_p14"] == "ok"


def test_corrupted_files_fail_alike(tmp_path):
    """Truncations, byte flips, zeroed windows and splices of a valid
    file of each syntax: the same pixels or the same error in both
    readers (the message too, but where JAX names PIL)."""
    vol = _volume(n=1, hw=16)
    rng = np.random.default_rng(2026)
    target = tmp_path / "fuzz.dcm"
    n_raised = n = 0
    for comp in (None, "rle", "jpeg_lossless", "deflated"):
        raw = open(_write(jd, tmp_path / "src.dcm", vol[0], comp, False, 1),
                   "rb").read()
        for _ in range(20):
            buf = bytearray(raw)
            kind = int(rng.integers(0, 4))
            i = int(rng.integers(0, len(buf)))
            if kind == 0:
                buf = buf[:i]
            elif kind == 1:
                for _ in range(int(rng.integers(1, 9))):
                    buf[int(rng.integers(0, len(buf)))] ^= int(
                        rng.integers(1, 256))
            elif kind == 2:
                j = min(len(buf), i + int(rng.integers(1, 64)))
                buf[i:j] = b"\x00" * (j - i)
            else:
                buf[i:i] = rng.integers(0, 256, int(rng.integers(1, 32)),
                                        dtype=np.uint8).tobytes()
            target.write_bytes(bytes(buf))
            n += 1
            n_raised += _same_outcome(target)[0] == "raise"
    assert n == 80 and n_raised >= n // 2


@pytest.mark.parametrize("case", ["baseline_color", "baseline_gray",
                                  "jpeg2000"])
def test_pil_syntaxes_raise_naming_the_syntax(tmp_path, case):
    """Baseline JPEG and JPEG 2000 decode through PIL in JAX, and through
    the port's own decoders here: a gray baseline frame reads equal to
    JAX's, a colour frame raises NotImplementedError in both.  A JAX-written
    JPEG 2000 file reads equal to JAX's read and to its source, and so does
    the port-written one, in both readers."""
    px = _volume(n=1)[0]
    if case == "jpeg2000":
        p = _write(jd, tmp_path / "j2k.dcm", px, "jpeg2000", False, 1)
        want = _same_outcome(p)
        np.testing.assert_array_equal(want[2], px)
        tp = _write(td, tmp_path / "t.dcm", px, "jpeg2000", False, 1)
        got = _same_outcome(tp)
        np.testing.assert_array_equal(got[2], px)
        assert got[1]["TransferSyntaxUID"] == jd.JPEG2000_LOSSLESS
        return
    else:
        rle = open(_write(jd, tmp_path / "rle.dcm", px, "rle", False, 1),
                   "rb").read()
        bio = io.BytesIO()
        img = (np.stack([px % 256] * 3, -1) if case == "baseline_color"
               else px % 256).astype(np.uint8)
        Image.fromarray(img).save(bio, format="JPEG")
        blob = bio.getvalue() + b"\x00" * (len(bio.getvalue()) % 2)
        frame = jd._rle_encode_frame(px)
        old = struct.pack("<HHI", 0xFFFE, 0xE000, len(frame)) + frame
        new = struct.pack("<HHI", 0xFFFE, 0xE000, len(blob)) + blob
        ts = jd.JPEG_BASELINE
        p = tmp_path / "baseline.dcm"
        p.write_bytes(_with_syntax(rle.replace(old, new), ts))
    want = _same_outcome(p)
    assert want[0] == ("ok" if case == "baseline_gray" else "raise")


def _j2k_dicom(tmp_path, name, frame, ts=jd.JPEG2000_LOSSLESS, parts=1,
               hw=24):
    """A JAX-written one-frame RLE file whose PixelData is replaced by the
    JPEG 2000 ``frame`` in ``parts`` fragments, under syntax ``ts``."""
    px = _volume(n=1, hw=hw)[0]
    rle = open(_write(jd, tmp_path / f"{name}_rle.dcm", px, "rle", False,
                      1), "rb").read()
    old = jd._rle_encode_frame(px)
    old = struct.pack("<HHI", 0xFFFE, 0xE000, len(old)) + old
    cuts = [2 * (len(frame) * k // (2 * parts)) for k in range(parts)]
    cuts.append(len(frame))   # even cuts: only the last piece is padded
    new = b""
    for a, b in zip(cuts[:-1], cuts[1:]):
        piece = frame[a:b] + b"\x00" * ((b - a) % 2)
        new += struct.pack("<HHI", 0xFFFE, 0xE000, len(piece)) + piece
    p = tmp_path / f"{name}.dcm"
    p.write_bytes(_with_syntax(rle.replace(old, new), ts))
    return p


J2K_FRAMES = {
    # PIL's lossy 9/7 of a CT slice, as a …1.2.4.91 frame
    "lossy_97": lambda px: _pil_j2k(px, irreversible=True,
                                    quality_mode="rates",
                                    quality_layers=[12, 4]),
    "lossless_3_fragments": lambda px: _pil_j2k(px, irreversible=False),
    "port_12bit": lambda px: tj2k.encode(
        (px.astype(np.int64) - 900) % 4096, prec=12, plain=True),
    "port_signed": lambda px: tj2k.encode(px.astype(np.int64) - 1100,
                                          prec=16, signed=True),
    "port_signed_12bit_j2k": lambda px: _j2k_writer().encode_stream(
        (px.astype(np.int64) - 900) % 4096 - 2048, prec=12, signed=True,
        jp2=False),
}


def _j2k_writer():
    """tools/j2k_writer.py, the test-stream writer (bare codestreams)."""
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "tools", "j2k_writer.py")
    spec = importlib.util.spec_from_file_location("j2k_writer", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _pil_j2k(px, **kw):
    bio = io.BytesIO()
    Image.fromarray(px.view(np.uint16)).save(bio, format="JPEG2000", **kw)
    return bio.getvalue()


@pytest.mark.parametrize("case", sorted(J2K_FRAMES))
def test_j2k_frames_read_as_jax(tmp_path, case):
    """JPEG 2000 frames JAX hands to PIL: lossy …1.2.4.91, fragmented,
    12-bit (PIL shifts it up by 4) and signed (PIL offsets it by
    2**(prec - 1)) read to JAX's int16 pixels."""
    px = _volume(n=1, hw=24)[0]
    frame = J2K_FRAMES[case](px)
    ts = jd.JPEG2000 if case == "lossy_97" else jd.JPEG2000_LOSSLESS
    p = _j2k_dicom(tmp_path, case, frame, ts,
                   parts=3 if "fragments" in case else 1)
    want = _same_outcome(p)
    assert want[0] == "ok"
    if case == "lossless_3_fragments":
        np.testing.assert_array_equal(want[2], px)


def test_j2k_frame_shape_and_colour_fail_as_jax(tmp_path):
    """A colour JPEG 2000 frame raises NotImplementedError and a frame of
    the wrong size ValueError, in both readers."""
    rgb = np.stack([_volume(n=1)[0].astype(np.uint8)] * 3, -1)
    bio = io.BytesIO()
    Image.fromarray(rgb).save(bio, format="JPEG2000", irreversible=False)
    want = _same_outcome(_j2k_dicom(tmp_path, "rgb", bio.getvalue()))
    assert want[:3] == ("raise", "pixels", "NotImplementedError")
    small = _pil_j2k(_volume(n=1, hw=16)[0], irreversible=False)
    want = _same_outcome(_j2k_dicom(tmp_path, "small", small))
    assert want[:3] == ("raise", "pixels", "ValueError")


def test_j2k_series_written_by_either_package_loads_as_jax(tmp_path):
    """load_scan and get_pixels_hu on a JPEG 2000 series the port wrote
    and on one the JAX package wrote: the port equals JAX, and both equal
    the source volume."""
    vol = _volume(n=4, hw=20, seed=3)
    for who, mod in (("port", td), ("jax", jd)):
        d = tmp_path / who
        d.mkdir()
        for i in range(vol.shape[0]):
            mod.write_ct_slice(str(d / f"s{i}.dcm"), vol[i], z=1.5 * i,
                               compression="jpeg2000")
        got, want = tct.load_scan(str(d)), jct.load_scan(str(d))
        assert [s.path for s in got] == [s.path for s in want]
        hu = tct.get_pixels_hu(got)
        np.testing.assert_array_equal(hu, jct.get_pixels_hu(want))
        np.testing.assert_array_equal(
            np.stack([s.pixel_array for s in want]), vol)


@pytest.mark.parametrize("psv", range(1, 8))
def test_native_decoder_equals_python_decoder(psv):
    rng = np.random.default_rng(psv)
    img = rng.integers(0, 65536, (37, 23), np.uint16)
    img[0, :4] = [0, 65535, 32768, 32767]
    blob = td._encode_jpeg_lossless(img, psv)
    assert blob == jd._encode_jpeg_lossless(img, psv)
    calls = native.jpeg_lossless_decode.calls
    got = td._decode_jpeg_lossless(blob, 37, 23)
    assert native.jpeg_lossless_decode.calls == calls + 1
    sos = blob.index(b"\xff\xda")
    entropy = blob[sos + 10:-2].replace(b"\xff\x00", b"\xff")
    dht = blob[blob.index(b"\xff\xc4") + 5:]
    counts = dht[:16]
    py = td._decode_jpeg_lossless_python(entropy, counts,
                                         dht[16:16 + sum(counts)], 37, 23,
                                         psv, 1 << 15)
    np.testing.assert_array_equal(got, py)
    np.testing.assert_array_equal(got, img)


@pytest.mark.parametrize("name,dht,entropy,error", [
    ("non_canonical", bytes([0x00, 3] + [0] * 15 + [0, 1, 2]), b"\x00\x00",
     "non-canonical"),
    ("truncated_dht", bytes([0x00, 0, 4] + [0] * 14 + [0, 1]), b"\x00\x00",
     "truncated DHT"),
    ("ssss_past_16", bytes([0x00, 2] + [0] * 15 + [0, 40]), b"\xaa\xaa",
     "invalid SSSS|invalid Huffman"),
    ("truncated_scan", bytes([0x00, 0, 4] + [0] * 14 + [0, 1, 2, 3]),
     b"\xff\x00", "index out of range|invalid"),
])
def test_malformed_streams_raise_the_jax_error(name, dht, entropy, error):
    sof = struct.pack(">BHHB", 16, 2, 3, 1) + bytes([1, 0x11, 0])
    sos = bytes([1, 1, 0x00, 1, 0, 0x00])
    blob = (b"\xff\xd8" + b"\xff\xc4" + struct.pack(">H", len(dht) + 2)
            + dht + b"\xff\xc3" + struct.pack(">H", len(sof) + 2) + sof
            + b"\xff\xda" + struct.pack(">H", len(sos) + 2) + sos
            + entropy + b"\xff\xd9")
    errors = []
    for mod in (jd, td):
        with pytest.raises((ValueError, IndexError), match=error) as e:
            mod._decode_jpeg_lossless(blob, 2, 3)
        errors.append((type(e.value), str(e.value)))
    assert errors[0] == errors[1]


def test_series_load_scan_and_hu_equal_jax(tmp_path):
    """read_series, load_scan (z-sorted from shuffled files, thickness
    from the positions) and get_pixels_hu, with a slope != 1 and an
    oblique orientation through apply_orientation_fixes."""
    vol = _volume(n=5)
    for file_i, z_i in enumerate([3, 0, 4, 1, 2]):
        td.write_ct_slice(str(tmp_path / f"f{file_i}.dcm"), vol[z_i],
                          z=2.0 * z_i, slope=1.0 if z_i else 2.0,
                          orientation=(0, 1, 0, -1, 0, 0),
                          compression="jpeg_lossless" if z_i % 2 else None)
    got, want = tct.load_scan(str(tmp_path)), jct.load_scan(str(tmp_path))
    assert [s.path for s in got] == [s.path for s in want]
    assert [s.SliceThickness for s in got] == [s.SliceThickness
                                               for s in want]
    hu = tct.get_pixels_hu(got)
    np.testing.assert_array_equal(hu, jct.get_pixels_hu(want))
    ori = [s.ImageOrientationPatient for s in got]
    np.testing.assert_array_equal(tct.apply_orientation_fixes(hu, ori),
                                  jct.apply_orientation_fixes(hu, ori))
    empty = tmp_path / "empty"
    empty.mkdir()
    assert tct.load_scan(str(empty)) is None


def _masks():
    rng = np.random.default_rng(7)
    ring = np.zeros((20, 24), np.uint8)
    ring[3:15, 4:20] = 1
    ring[6:12, 8:16] = 0                          # a hole
    several = np.zeros((20, 24), np.uint8)
    several[2:5, 3:6] = several[12:18, 15:22] = several[9, 1] = 1
    border = np.zeros((20, 24), np.uint8)
    border[0, 5:9] = border[7:19, 23] = border[19, 0] = 1
    full = np.ones((20, 24), np.uint8)
    labels = np.zeros((20, 24), np.uint8)
    labels[4:9, 4:9], labels[11:16, 12:20] = 1, 2  # lungmask's labels
    return {"hole": ring, "several": several, "border": border,
            "full": full, "labels": labels,
            "empty": np.zeros((20, 24), np.uint8),
            "random": (rng.uniform(size=(20, 24)) < 0.05).astype(np.uint8),
            "bool": rng.uniform(size=(20, 24)) < 0.02}


@pytest.mark.parametrize("name", sorted(_masks()))
def test_lung_box_equals_the_cv2_contours_box(name):
    """The bounding box of the mask's nonzero pixels against the union of
    the bounding rectangles of cv2.findContours (JAX ct_preprocess.py:
    195-218), coordinates and the widened mask and HU crop."""
    seg = _masks()[name]
    u8 = np.ascontiguousarray(seg.astype(np.uint8))
    boxes = [cv2.boundingRect(c) for c in cv2.findContours(
        u8, cv2.RETR_LIST, cv2.CHAIN_APPROX_SIMPLE)[-2]]
    want = ((min(b[1] for b in boxes), max(b[1] + b[3] for b in boxes),
             min(b[0] for b in boxes), max(b[0] + b[2] for b in boxes))
            if boxes else (None, None, None, None))
    hu = np.random.default_rng(1).integers(-1000, 400, seg.shape).astype(
        np.int16)
    assert tct.lung_box(hu, seg, return_coord=True) == want
    assert jct.lung_box(hu, seg, return_coord=True) == want
    for got, exp in zip(tct.lung_box(hu, seg), jct.lung_box(hu, seg)):
        np.testing.assert_array_equal(got, exp)
