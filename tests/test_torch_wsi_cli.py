"""WSI stages 0 and 1 of the port (cli.create_patches, cli.extract_
features_fp) against the JAX package's CLIs on the CPU, on one small
multi-page TIFF slide written by PIL: the same coordinates and
attributes (read with h5py), the same process_list_autogen.csv (read
with pandas, and as text), the --preset / --process_list precedence of
tests/test_wsi.py:212-242, mask and stitch JPEGs that PIL decodes to
within 1 dB of the PSNR of cv2's file of the same image, and the
features of extract_features_fp --dtype float32 --device cpu at the
ResNet tolerance of tests/test_torch_resnet.py with one seeded --weights
file, in files of JAX's keys and shapes.  openslide formats are refused,
naming the file.  Then the JPEG encoder's header tables against cv2's
file, its PSNR on a clean image (at least 40 dB) and its scan coded in
chunks; extract_features_fp --data_parallel on two gloo ranks."""
import io
import json
import os

import cv2
import h5py
import numpy as np
import pandas as pd
import pytest
import torch
from PIL import Image

from test_torch_resnet import ATOL, RTOL, seeded_state_dict
from torch_dist_ranks import spawn

from multimodalfusion_tpu.cli.create_patches import main as jax_cp
from multimodalfusion_tpu.cli.extract_features_fp import main as jax_fx
from multimodalfusion_tpu.data import wsi as jw
from multimodalfusion_tpu_torch.cli import create_patches as tcp
from multimodalfusion_tpu_torch.cli import extract_features_fp as tfx
from multimodalfusion_tpu_torch.data import wsi as tw
from multimodalfusion_tpu_torch.data.io import load_pt
from multimodalfusion_tpu_torch.utils import jpeg

PATCH = ["--patch_size", "128", "--step_size", "128", "--stitch",
         "--a_t", "0.5", "--a_h", "0.05"]


def _psnr(a, b) -> float:
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return float("inf") if mse == 0 else 10 * np.log10(255.0 ** 2 / mse)


def _pil(path_or_bytes):
    src = (io.BytesIO(path_or_bytes) if isinstance(path_or_bytes, bytes)
           else path_or_bytes)
    return np.asarray(Image.open(src).convert("RGB"))


def _cv2_psnr(img) -> float:
    ok, enc = cv2.imencode(".jpg", cv2.cvtColor(img, cv2.COLOR_RGB2BGR))
    assert ok
    return _psnr(_pil(enc.tobytes()), img)


@pytest.fixture(scope="module")
def patched(tmp_path_factory):
    """One slide (2048 x 1536, 3 levels) with three blobs, a carved hole, and
    an .svs stand-in beside it, patched by both CLIs."""
    root = tmp_path_factory.mktemp("wsi")
    slide = jw.synthetic_slide(2048, 1536, n_blobs=3, seed=1)
    img = slide.levels[0].copy()
    ys, xs = np.nonzero(img[::16, ::16].astype(int).sum(-1) < 600)
    cv2.circle(img, (int(xs[len(xs) // 2]) * 16, int(ys[len(ys) // 2]) * 16),
               100, (245, 245, 245), -1)
    levels = [img]
    for _ in range(2):
        levels.append(cv2.resize(levels[-1], (levels[-1].shape[1] // 2,
                                              levels[-1].shape[0] // 2)))
    slides = root / "slides"
    os.makedirs(slides)
    imgs = [Image.fromarray(l) for l in levels]
    imgs[0].save(str(slides / "CASE1.tiff"), save_all=True,
                 append_images=imgs[1:])
    with open(slides / "BAD.svs", "wb") as f:
        f.write(b"\0" * 64)
    out = {}
    for who, fn, extra in (("jax", jax_cp, []),
                           ("port", tcp.main, ["--device", "cpu"])):
        out[who] = root / who
        assert fn(["--source", str(slides), "--save_dir", str(out[who])]
                  + PATCH + extra) == 0
    return root, slides, levels, out


def test_coords_and_attributes_equal_jax(patched):
    _, _, _, out = patched
    with h5py.File(out["jax"] / "patches" / "CASE1_patches.h5", "r") as j, \
            h5py.File(out["port"] / "patches" / "CASE1_patches.h5",
                      "r") as t:
        assert list(t.keys()) == list(j.keys()) == ["coords"]
        np.testing.assert_array_equal(t["coords"][()], j["coords"][()])
        assert len(t["coords"]) > 5
        ja, ta = dict(j["coords"].attrs), dict(t["coords"].attrs)
        assert sorted(ta) == sorted(ja)
        for k in ja:
            assert type(ta[k]) is type(ja[k]), k
            np.testing.assert_array_equal(ta[k], ja[k])
        assert isinstance(ta["name"], str) and ta["name"] == "CASE1"


def test_autogen_csv_equals_jax(patched):
    _, _, _, out = patched
    j = pd.read_csv(out["jax"] / "process_list_autogen.csv")
    t = pd.read_csv(out["port"] / "process_list_autogen.csv")
    assert list(t.columns) == list(j.columns)
    assert t["slide_id"].tolist() == ["BAD.svs", "CASE1.tiff"]
    assert t["status"][1] == "processed" and t["n_patches"][1] > 5
    assert t["status"][0].startswith("failed: ") and "BAD.svs" in \
        t["status"][0] and "cannot identify" in t["status"][0]
    pd.testing.assert_frame_equal(t.drop(columns="status"),
                                  j.drop(columns="status"))
    # the text of the processed row too
    jl = open(out["jax"] / "process_list_autogen.csv").read().splitlines()
    tl = open(out["port"] / "process_list_autogen.csv").read().splitlines()
    assert tl[0] == jl[0] and tl[2] == jl[2]


def test_masks_and_stitches_decode_near_cv2(patched):
    _, slides, levels, out = patched
    slide = tw.PILSlide(str(slides / "CASE1.tiff"))
    tissue, holes = tw.segment_tissue(slide, seg_level=2, device="cpu",
                                      sthresh=8, a_t=0.5, a_h=0.05)
    assert sum(len(h) for h in holes) >= 1
    mask = tcp.draw_mask(slide, tissue, holes, 2)
    coords = tw.process_contours(slide, tissue, holes, patch_size=128,
                                 step_size=128)[0]
    stitch = tw.stitch_coords(slide, coords, 0, 128)
    for kind, name, src in (("masks", "CASE1_mask.jpg", mask),
                            ("stitches", "CASE1_stitch.jpg", stitch)):
        port = _pil(str(out["port"] / kind / name))
        jx = _pil(str(out["jax"] / kind / name))
        assert port.shape == jx.shape == src.shape
        # the JAX CLI's file holds cv2's encoding of the same image
        ref = _cv2_psnr(src)
        assert abs(_psnr(jx, src) - ref) < 1e-9
        got = _psnr(port, src)
        assert got >= ref - 1.0, (kind, got, ref)


def test_preset_and_process_list_precedence(tmp_path):
    """The cases of tests/test_wsi.py:212-242 through both CLIs."""
    slides = tmp_path / "slides"
    os.makedirs(slides)
    slide = jw.synthetic_slide(2048, 1536, n_blobs=3, seed=9)
    imgs = [Image.fromarray(l) for l in slide.levels]
    imgs[0].save(str(slides / "P1.tiff"), save_all=True,
                 append_images=imgs[1:])
    strict = tmp_path / "strict.csv"
    strict.write_text("seg_level,sthresh,a_t,a_h\n-1,8,100,50\n")
    plist = tmp_path / "plist.csv"
    plist.write_text("slide_id,a_t,a_h,use_otsu,contour_fn\n"
                     "P1.tiff,0.5,0.05,False,center\n")
    plist2 = tmp_path / "plist2.csv"
    plist2.write_text("slide_id,a_t,a_h,mthresh\nP1.tiff,,0.05,5\n")
    for case, args in (("strict", ["--preset", str(strict)]),
                       ("override", ["--preset", str(strict),
                                     "--process_list", str(plist)]),
                       ("nan", ["--preset", str(strict), "--process_list",
                                str(plist2), "--patch_size", "64"])):
        frames = []
        for who, fn, extra in (("jax", jax_cp, []),
                               ("port", tcp.main, ["--device", "cpu"])):
            save = tmp_path / f"{case}_{who}"
            assert fn(["--source", str(slides), "--save_dir", str(save)]
                      + args + extra) == 0
            frames.append(pd.read_csv(save / "process_list_autogen.csv"))
            with h5py.File(save / "patches" / "P1_patches.h5", "r") as f:
                frames[-1].attrs["coords"] = f["coords"][()].tolist()
        j, t = frames
        pd.testing.assert_frame_equal(t, j)
        assert t.attrs["coords"] == j.attrs["coords"]
        if case == "override":
            assert t["a_t"][0] == 0.5 and t["n_patches"][0] > 0
        else:
            # an empty a_t cell overrides the preset with NaN, which then
            # falls back to the CLI's --a_t (100), as in the JAX CLI
            assert t["a_t"][0] == 100 and t["n_patches"][0] == 0


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    p = tmp_path_factory.mktemp("weights") / "resnet50.pt"
    torch.save(seeded_state_dict(3), p)
    return str(p)


def test_feature_extraction_matches_jax(patched, weights):
    root, slides, _, out = patched
    common = ["--data_h5_dir", str(out["jax"]), "--data_slide_dir",
              str(slides), "--batch_size", "8", "--slide_ext", ".tiff",
              "--target_patch_size", "64", "--dtype", "float32",
              "--weights", weights]
    assert jax_fx(common + ["--feat_dir", str(root / "fj")]) == 0
    assert tfx.main(common + ["--feat_dir", str(root / "ft"),
                              "--device", "cpu"]) == 0
    want = load_pt(str(root / "fj" / "path_pt_files" / "CASE1.pt"))
    got = load_pt(str(root / "ft" / "path_pt_files" / "CASE1.pt"))
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    with h5py.File(root / "fj" / "h5_files" / "CASE1.h5", "r") as j, \
            h5py.File(root / "ft" / "h5_files" / "CASE1.h5", "r") as t:
        assert sorted(t.keys()) == sorted(j.keys()) == ["coords", "features"]
        for k in ("coords", "features"):
            assert t[k].shape == j[k].shape and t[k].dtype == j[k].dtype
        np.testing.assert_array_equal(t["coords"][()], j["coords"][()])
        np.testing.assert_array_equal(t["features"][()], got)
    # a rerun skips the slide; a .svs of no format raises, naming it
    assert tfx.main(common + ["--feat_dir", str(root / "ft"),
                              "--device", "cpu"]) == 0
    bad = root / "bad_h5"
    os.makedirs(bad / "patches")
    os.link(out["port"] / "patches" / "CASE1_patches.h5",
            bad / "patches" / "BAD_patches.h5")
    with pytest.raises(OSError, match="BAD.svs.*cannot identify"):
        tfx.main(["--data_h5_dir", str(bad), "--data_slide_dir",
                  str(slides), "--feat_dir", str(root / "fb"),
                  "--weights", weights, "--device", "cpu"])


def test_two_ranks_write_the_one_process_files(tmp_path, weights):
    """--data_parallel under a torchrun environment: rank r of 2 extracts
    every other slide; the files equal one process's byte for byte (one
    thread each, so the CPU convolutions sum in one order)."""
    slides = tmp_path / "slides"
    os.makedirs(slides)
    for i, seed in enumerate((1, 9, 5)):
        levels = jw.synthetic_slide(1536, 1152, n_blobs=3, seed=seed).levels
        imgs = [Image.fromarray(l) for l in levels]
        imgs[0].save(str(slides / f"S{i}.tiff"), save_all=True,
                     append_images=imgs[1:])
    assert tcp.main(["--source", str(slides), "--save_dir",
                     str(tmp_path / "patched"), "--a_t", "0.2", "--a_h",
                     "0.05", "--device", "cpu"]) == 0

    def argv(out):
        return ["--data_h5_dir", str(tmp_path / "patched"),
                "--data_slide_dir", str(slides), "--feat_dir", str(out),
                "--slide_ext", ".tiff", "--batch_size", "8",
                "--target_patch_size", "64", "--dtype", "float32",
                "--weights", weights, "--data_parallel", "--device", "cpu"]
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        assert tfx.main(argv(tmp_path / "one")) == 0
    finally:
        torch.set_num_threads(threads)
    work = tmp_path / "ranks"
    work.mkdir()
    (work / "cli_runs.json").write_text(json.dumps(
        [["extract_features_fp", argv(tmp_path / "two")]]))
    spawn("cli_runs", 2, str(work), torchrun_env=True)
    one, two = tmp_path / "one", tmp_path / "two"
    files = sorted(os.path.relpath(os.path.join(d, f), one)
                   for d, _, fs in os.walk(one) for f in fs)
    assert len(files) == 6 and files == sorted(
        os.path.relpath(os.path.join(d, f), two)
        for d, _, fs in os.walk(two) for f in fs)
    for rel in files:
        assert (one / rel).read_bytes() == (two / rel).read_bytes(), rel


def test_jpeg_headers_and_clean_image_psnr():
    """The quantisation and Huffman tables, sampling factors and JFIF
    header equal those of cv2's file; a clean image (blobs without noise)
    decodes at 40 dB or more, within 1 dB of cv2's file."""
    img = np.full((300, 401, 3), 245, np.uint8)
    for c, ax, col in (((120, 100), (90, 60), (200, 90, 170)),
                       ((280, 200), (100, 70), (160, 60, 150))):
        cv2.ellipse(img, c, ax, 30.0, 0, 360, col, -1)
    ours = jpeg.encode_jpeg(img)
    ok, theirs = cv2.imencode(".jpg", cv2.cvtColor(img, cv2.COLOR_RGB2BGR))
    theirs = theirs.tobytes()

    def segments(data):
        out, pos = {}, 2
        while data[pos + 1] != 0xDA:
            n = int.from_bytes(data[pos + 2:pos + 4], "big")
            out.setdefault(data[pos + 1], []).append(data[pos + 4:pos + 2 + n])
            pos += 2 + n
        return out
    a, b = segments(ours), segments(theirs)
    for marker in (0xE0, 0xDB, 0xC0, 0xC4):
        assert sorted(a[marker]) == sorted(b[marker]), hex(marker)
    got, ref = _psnr(_pil(ours), img), _cv2_psnr(img)
    assert got >= 40 and got >= ref - 1.0, (got, ref)
    # coding the scan one MCU row at a time changes no byte
    assert jpeg.encode_jpeg(img, chunk_rows=1) == ours
    with pytest.raises(ValueError, match="uint8"):
        jpeg.encode_jpeg(img.astype(np.float32))
