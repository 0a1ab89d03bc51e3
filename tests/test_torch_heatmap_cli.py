"""The path branch of the port's create_heatmaps against the JAX CLI's on
the CPU (the cases of tests/test_interpret_clis.py:170-288), on one
synthetic three-level TIFF slide with a carved hole, the feature h5 that
the JAX stage-1 CLI extracted from it with one seeded ResNet50, and a
PathAMIL that the JAX CLI trained: the blockmap's coords equal and its
scores at rel 1e-5; with ``save_ext: png`` the heatmap and orig pixels,
read back with cv2, equal JAX's, and so do the sampled patch PNGs (names
and pixels) and mosaics, over the shorthand and list sampling forms, the
ROI, ``use_ref_scores``, ``blur`` with ``custom_downsample``,
``binarize`` and ``blank_canvas``; with ``jpg`` each file within 1 dB of
the PSNR of cv2's file of the same image; the fine pass's heatmap equal
to JAX's but for at most 2% of its pixels; the extraction on a miss
(coords equal, features at the ResNet tolerance), on that slide and on
its levels written as an Aperio .svs; the phase gating and the
overrides.  Both embedders run in float32 here (the CLIs' default is
bfloat16), so that the fine pass can be held at the ResNet tolerance."""
import os
import sys

import cv2
import h5py
import numpy as np
import pandas as pd
import pytest
import torch
import yaml
from PIL import Image

import jax.numpy as jnp

from fixtures import make_cohort_csv, make_feature_store, make_splits
from test_torch_resnet import ATOL, RTOL, seeded_state_dict

from multimodalfusion_tpu.cli import create_heatmaps as jax_ch
from multimodalfusion_tpu.cli.create_patches import main as jax_cp
from multimodalfusion_tpu.cli.extract_features_fp import main as jax_fx
from multimodalfusion_tpu.cli.main import main as jax_stage2
from multimodalfusion_tpu.data import wsi as jw
from multimodalfusion_tpu.extract.features import Embedder as JaxEmbedder
from multimodalfusion_tpu_torch.cli import create_heatmaps as port_ch
from multimodalfusion_tpu_torch.extract.features import Embedder

PATCHING = {"patch_size": 256, "a_t": 0.5, "a_h": 0.05, "batch_size": 16,
            "target_patch_size": 64}
# the share of the fine heatmap's pixels allowed to differ: near-tied fine
# scores (features at the ResNet tolerance) may swap percentile ranks
FINE_SHARE = 0.02


def _psnr(a, b) -> float:
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return float("inf") if mse == 0 else 10 * np.log10(255.0 ** 2 / mse)


def _rgb(path):
    return cv2.cvtColor(cv2.imread(str(path)), cv2.COLOR_BGR2RGB)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The slide, its JAX-extracted features, a JAX-trained PathAMIL and a
    seeded weights file."""
    root = tmp_path_factory.mktemp("heatmap_cli")
    csv_path, df, latent = make_cohort_csv(
        str(root / "dataset_csv" / "brain"), n=16, seed=5)
    make_feature_store(str(root / "features" / "brain"), df, latent, seed=5,
                       bag_range=(4, 9))
    make_splits(str(root / "splits" / "brain" / "2foldcv"), df, k=2, seed=5)
    assert jax_stage2([
        "--cancer_type", "brain", "--which_splits", "2foldcv", "--k", "1",
        "--data_root_dir", str(root / "features"),
        "--dataset_root", str(root / "dataset_csv"),
        "--splits_root", str(root / "splits"), "--overwrite",
        "--results_dir", str(root / "s2p"),
        "--model_type", "path_attention_mil", "--mode", "path",
        "--gate_path", "--bag_loss", "nll_surv", "--batch_size", "4",
        "--max_epochs", "1", "--lr", "1e-3"]) == 0
    exp = next((root / "s2p" / "brain" / "2foldcv").iterdir())

    slide = jw.synthetic_slide(2048, 1536, n_blobs=3, seed=9)
    img = slide.levels[0].copy()
    ys, xs = np.nonzero(img[::16, ::16].astype(int).sum(-1) < 600)
    cv2.circle(img, (int(xs[len(xs) // 3]) * 16, int(ys[len(ys) // 3]) * 16),
               120, (245, 245, 245), -1)
    levels = [img]
    for _ in range(2):
        levels.append(cv2.resize(levels[-1], (levels[-1].shape[1] // 2,
                                              levels[-1].shape[0] // 2)))
    slides = root / "slides"
    os.makedirs(slides)
    imgs = [Image.fromarray(l) for l in levels]
    imgs[0].save(str(slides / "HEAT1.tiff"), save_all=True,
                 append_images=imgs[1:])
    weights = root / "resnet50.pt"
    torch.save(seeded_state_dict(3), weights)
    assert jax_cp(["--source", str(slides), "--save_dir",
                   str(root / "patched"), "--a_t", "0.5",
                   "--a_h", "0.05"]) == 0
    assert jax_fx(["--data_h5_dir", str(root / "patched"),
                   "--data_slide_dir", str(slides),
                   "--feat_dir", str(root / "wsifeat"), "--slide_ext",
                   ".tiff", "--batch_size", "16", "--target_patch_size",
                   "64", "--dtype", "float32", "--weights",
                   str(weights)]) == 0
    plist = root / "slides.csv"
    pd.DataFrame({"slide_id": ["HEAT1.tiff"]}).to_csv(plist, index=False)
    return {"root": root, "exp": str(exp), "slides": str(slides),
            "feat": str(root / "wsifeat"), "plist": str(plist),
            "weights": str(weights)}


@pytest.fixture
def f32_embedders(monkeypatch):
    """Both CLIs' embedders in float32, the same weights file."""
    def jax_embedder(m, p):
        return JaxEmbedder(weights_path=m.resnet_weights,
                           batch_size=int(p.batch_size),
                           image_size=int(p.target_patch_size),
                           dtype=jnp.float32)

    def port_embedder(m, p, device):
        return Embedder(weights_path=m.resnet_weights,
                        batch_size=int(p.batch_size),
                        image_size=int(p.target_patch_size),
                        dtype="float32", device=device)
    monkeypatch.setattr(jax_ch, "_embedder_from_config", jax_embedder)
    monkeypatch.setattr(port_ch, "_embedder_from_config", port_embedder)


def _run_both(world, tmp_path, heatmap, sample, data=None, argv=(),
              plist=None):
    """Run the JAX CLI and the port's (--device cpu) on one config each;
    returns the two save dirs."""
    os.makedirs(tmp_path, exist_ok=True)
    out = {}
    for who, fn, extra in (("jax", jax_ch.main, []),
                           ("port", port_ch.main, ["--device", "cpu"])):
        out[who] = tmp_path / who
        cfg = {
            "exp_arguments": {"branch": "path", "save_dir": str(out[who]),
                              "raw_save_dir": str(tmp_path / f"raw_{who}")},
            "data_arguments": {"process_list": plist or world["plist"],
                               "data_dir": world["slides"],
                               "feat_dir": world["feat"], **(data or {})},
            "patching_arguments": PATCHING,
            "model_arguments": {"ckpt_path": world["exp"], "which_k": 0,
                                "resnet_weights": world["weights"]},
            "heatmap_arguments": heatmap,
            "sample_arguments": sample,
        }
        if data and "feat_dir" in data:
            cfg["data_arguments"]["feat_dir"] = str(tmp_path / f"feat_{who}")
        path = tmp_path / f"{who}.yaml"
        path.write_text(yaml.safe_dump(cfg))
        assert fn(["--config", str(path)] + list(argv) + extra) == 0
    return out["jax"], out["port"]


def _same_blockmap(jax_dir, port_dir, stem="HEAT1"):
    with h5py.File(jax_dir / f"{stem}_blockmap.h5", "r") as j, \
            h5py.File(port_dir / f"{stem}_blockmap.h5", "r") as t:
        assert sorted(t.keys()) == sorted(j.keys()) == [
            "attention_scores", "coords"]
        for k in ("attention_scores", "coords"):
            assert t[k].dtype == j[k].dtype and t[k].shape == j[k].shape
        np.testing.assert_array_equal(t["coords"][()], j["coords"][()])
        want = j["attention_scores"][()]
        np.testing.assert_allclose(t["attention_scores"][()], want,
                                   rtol=0, atol=1e-5 * np.abs(want).max())
        return want


def _same_files(jax_dir, port_dir, pattern):
    """Every file of ``pattern`` under both dirs: the same names and, read
    by cv2, the same pixels."""
    want = sorted(p.relative_to(jax_dir) for p in jax_dir.glob(pattern))
    got = sorted(p.relative_to(port_dir) for p in port_dir.glob(pattern))
    assert got == want and want, (pattern, got, want)
    for rel in want:
        np.testing.assert_array_equal(_rgb(port_dir / rel),
                                      _rgb(jax_dir / rel), err_msg=str(rel))
    return want


HEATMAP_CASES = {
    # the example config's options, as cli.summarize emits them
    "template": ({"alpha": 0.4, "cmap": "coolwarm", "vis_level": -1,
                  "segment": True, "use_holes": True, "save_orig": True,
                  "save_ext": "png"},
                 {"floor": 4, "save_n": 3}),
    # RdYlBu_r by default; blur, custom_downsample, use_ref_scores, the
    # list form with a range_sample spec and a skipped spec
    "blur_ref_scores": ({"blur": True, "custom_downsample": 2,
                         "use_ref_scores": True, "save_ext": "png",
                         "use_holes": False},
                        {"samples": [
                            {"name": "topk_high", "sample": True, "k": 3,
                             "mode": "topk"},
                            {"name": "mid_band", "sample": True, "seed": 1,
                             "k": 2, "mode": "range_sample",
                             "score_start": 0.2, "score_end": 0.8},
                            {"name": "skipped", "sample": False, "k": 5,
                             "mode": "topk"}]}),
    # vis_level 1, binarize with the dynamic threshold, a blank canvas, no
    # segmentation, no blending
    "binarize_blank": ({"vis_level": 1, "binarize": True,
                        "binary_thresh": -1, "blank_canvas": True,
                        "segment": False, "alpha": 1.0, "cmap": "jet",
                        "save_ext": "png"},
                       {"samples": [{"name": "low", "k": 2,
                                     "mode": "reverse_topk"}]}),
}


@pytest.mark.parametrize("case", sorted(HEATMAP_CASES))
def test_coarse_heatmap_and_samples_equal_jax(world, tmp_path, case):
    heatmap, sample = HEATMAP_CASES[case]
    jax_dir, port_dir = _run_both(world, tmp_path, heatmap, sample)
    _same_blockmap(jax_dir, port_dir)
    names = _same_files(jax_dir, port_dir, "*.png")
    assert "HEAT1_heatmap.png" in {str(n) for n in names}
    _same_files(jax_dir, port_dir, "HEAT1_*/*.png")
    assert not (port_dir / "HEAT1_skipped").exists()
    if heatmap.get("custom_downsample") == 2:
        assert _rgb(port_dir / "HEAT1_heatmap.png").shape[:2] == (192, 256)


def test_roi_columns(world, tmp_path):
    """use_roi with the x1/x2/y1/y2 columns; an empty cell is no ROI."""
    plist = tmp_path / "roi.csv"
    plist.write_text("slide_id,x1,x2,y1,y2\nHEAT1.tiff,256,1536,256,1280\n")
    jax_dir, port_dir = _run_both(
        world, tmp_path / "roi", {"use_roi": True, "save_ext": "png",
                                  "vis_level": 1},
        {"floor": 2, "save_n": 1}, plist=str(plist))
    _same_files(jax_dir, port_dir, "*.png")
    assert _rgb(port_dir / "HEAT1_heatmap.png").shape[:2] == (512, 640)
    plist.write_text("slide_id,x1,x2,y1,y2\nHEAT1.tiff,,1536,256,1280\n")
    jax_dir, port_dir = _run_both(
        world, tmp_path / "empty", {"use_roi": True, "save_ext": "png",
                                    "vis_level": 1},
        {"floor": 2, "save_n": 1}, plist=str(plist))
    _same_files(jax_dir, port_dir, "*.png")
    assert _rgb(port_dir / "HEAT1_heatmap.png").shape[:2] == (768, 1024)


def test_jpg_within_a_decibel_and_fine_pass(world, tmp_path, monkeypatch,
                                            f32_embedders):
    """save_ext jpg and overlap 0.5: every JPEG within 1 dB of the PSNR of
    cv2's file (JAX's) of the same image; the images themselves, captured
    before encoding, equal JAX's (the fine one but for FINE_SHARE of its
    pixels)."""
    drawn = {"jax": {}, "port": {}}
    imwrite = cv2.imwrite

    def jax_write(path, bgr, *a):
        if path.endswith(".jpg"):
            drawn["jax"][os.path.basename(path)] = cv2.cvtColor(
                bgr, cv2.COLOR_BGR2RGB)
        return imwrite(path, bgr, *a)
    write_image = port_ch._write_image

    def port_write(path, rgb):
        drawn["port"][os.path.basename(path)] = np.asarray(rgb).copy()
        return write_image(path, rgb)
    monkeypatch.setattr(cv2, "imwrite", jax_write)
    monkeypatch.setattr(port_ch, "_write_image", port_write)
    jax_dir, port_dir = _run_both(
        world, tmp_path, {"alpha": 0.4, "cmap": "coolwarm", "overlap": 0.5,
                          "save_orig": True},
        {"floor": 2, "save_n": 1})
    names = ["HEAT1_heatmap.jpg", "HEAT1_orig.jpg", "HEAT1_fine_heatmap.jpg"]
    assert sorted(drawn["port"]) == sorted(drawn["jax"]) == sorted(names)
    for name in names:
        img = drawn["jax"][name]
        diff = np.any(drawn["port"][name] != img, axis=-1).mean()
        assert diff <= (FINE_SHARE if "fine" in name else 0.0), (name, diff)
        ref = _psnr(np.asarray(Image.open(jax_dir / name).convert("RGB")),
                    img)
        got = _psnr(np.asarray(Image.open(port_dir / name).convert("RGB")),
                    img)
        assert got >= ref - 1.0, (name, got, ref)


def test_extraction_on_a_miss(world, tmp_path, f32_embedders):
    """An empty feat_dir: both CLIs segment, patch and embed the slide,
    and write its h5 before drawing."""
    jax_dir, port_dir = _run_both(
        world, tmp_path, {"save_ext": "png", "save_orig": True},
        {"samples": [{"name": "top", "k": 2, "mode": "topk"}]},
        data={"feat_dir": "per run"})
    with h5py.File(tmp_path / "feat_jax" / "h5_files" / "HEAT1.h5") as j, \
            h5py.File(tmp_path / "feat_port" / "h5_files" / "HEAT1.h5") as t:
        assert sorted(t.keys()) == sorted(j.keys()) == ["coords",
                                                        "features"]
        assert t["features"].dtype == j["features"].dtype == np.float32
        assert t["coords"].dtype == j["coords"].dtype == np.int64
        np.testing.assert_array_equal(t["coords"][()], j["coords"][()])
        np.testing.assert_allclose(t["features"][()], j["features"][()],
                                   rtol=RTOL, atol=ATOL)
        assert len(t["coords"]) > 3
    _same_blockmap(jax_dir, port_dir)
    assert (port_dir / "HEAT1_orig.png").exists()
    assert len(list((port_dir / "HEAT1_top").glob("*.png"))) == 2


def test_phase_gating_and_overrides(world, tmp_path):
    """--config_file, --save_exp_code (under raw_save_dir), --overlap and
    --sampling: exactly the sampling phase runs."""
    jax_dir, port_dir = _run_both(
        world, tmp_path, {"overlap": 0.5, "save_ext": "png"},
        {"floor": 4, "save_n": 2},
        argv=["--save_exp_code", "EXP_OVERRIDE", "--overlap", "0.0",
              "--sampling"])
    for who in ("jax", "port"):
        out = tmp_path / f"raw_{who}" / "EXP_OVERRIDE"
        assert len(list((out / "HEAT1_topk").glob("*.png"))) == 2
        assert not (out / "HEAT1_heatmap.png").exists()
        assert not (out / "HEAT1_fine_heatmap.jpg").exists()
        assert not (tmp_path / who).exists()
    _same_files(tmp_path / "raw_jax" / "EXP_OVERRIDE",
                tmp_path / "raw_port" / "EXP_OVERRIDE", "HEAT1_*/*.png")
    _same_blockmap(tmp_path / "raw_jax" / "EXP_OVERRIDE",
                   tmp_path / "raw_port" / "EXP_OVERRIDE")
    # --heatmap alone: no sampled patches
    jax_dir, port_dir = _run_both(world, tmp_path / "h", {"save_ext": "png"},
                                  {"floor": 4, "save_n": 2},
                                  argv=["--heatmap"])
    _same_files(jax_dir, port_dir, "*.png")
    assert not list(port_dir.glob("HEAT1_*/*.png"))


@pytest.mark.parametrize("bad, match", [
    ({"cmap": "viridis"}, "colormap 'viridis' is not supported"),
    ({"save_ext": "tif"}, "save_ext 'tif'"),
])
def test_unsupported_options_raise_before_any_work(world, tmp_path, bad,
                                                   match):
    cfg = tmp_path / "bad.yaml"
    cfg.write_text(yaml.safe_dump({
        "exp_arguments": {"branch": "path", "save_dir": str(tmp_path / "o")},
        "data_arguments": {"process_list": world["plist"],
                           "data_dir": world["slides"],
                           "feat_dir": world["feat"]},
        "model_arguments": {"ckpt_path": world["exp"]},
        "heatmap_arguments": bad}))
    with pytest.raises(ValueError, match=match):
        port_ch.main(["--config", str(cfg), "--device", "cpu"])
    assert not (tmp_path / "o").exists()


def test_openslide_slide_is_refused(world, tmp_path):
    plist = tmp_path / "svs.csv"
    plist.write_text("slide_id\nBAD.svs\n")
    cfg = tmp_path / "svs.yaml"
    cfg.write_text(yaml.safe_dump({
        "exp_arguments": {"branch": "path", "save_dir": str(tmp_path / "o")},
        "data_arguments": {"process_list": str(plist),
                           "data_dir": world["slides"],
                           "feat_dir": world["feat"]},
        "model_arguments": {"ckpt_path": world["exp"]}}))
    with pytest.raises(OSError, match="BAD.svs"):
        port_ch.main(["--config", str(cfg), "--device", "cpu"])


def test_svs_slide_equals_jax(world, tmp_path, monkeypatch, f32_embedders):
    """The slide's levels as an Aperio .svs (tools/svs_writer.py, PIL's
    JPEG tiles): the port reads it through its OpenSlideBackend, JAX
    through its own with tests/test_torch_svs.py's stand-in openslide;
    both extract on a miss and draw the same blockmap and PNGs."""
    from test_torch_svs import _OpenSlide, _pil_jpeg, svs_writer
    mod = type(sys)("openslide")
    mod.open_slide = _OpenSlide
    monkeypatch.setitem(sys.modules, "openslide", mod)
    levels = jw.PILSlide(os.path.join(world["slides"], "HEAT1.tiff")).levels
    svs_dir = tmp_path / "svs"
    os.makedirs(svs_dir)
    encode = _pil_jpeg(2)
    svs_writer.write_svs(str(svs_dir / "HEATSVS.svs"),
                         svs_writer.encode_levels(levels, encode), encode)
    plist = tmp_path / "svs.csv"
    plist.write_text("slide_id\nHEATSVS.svs\n")
    jax_dir, port_dir = _run_both(
        world, tmp_path, {"save_ext": "png", "save_orig": True},
        {"samples": [{"name": "top", "k": 2, "mode": "topk"}]},
        data={"data_dir": str(svs_dir), "feat_dir": "per run"},
        plist=str(plist))
    _same_blockmap(jax_dir, port_dir, stem="HEATSVS")
    _same_files(jax_dir, port_dir, "*.png")
    assert len(list((port_dir / "HEATSVS_top").glob("*.png"))) == 2
