"""The port's radiology images (multimodalfusion_tpu_torch.cli.gradcam and
the scan_list branch of cli.create_heatmaps) against the JAX package's
CLIs on the CPU, on one radio AMIL that the JAX CLI trained (2 sequences,
concat, gated; tests/test_gradcam_cli.py trains its own the same way) and
one seeded --weights file:
- gradcam single scan (glioma and lung, aug-smooth on) and cohort (top
  slices with scores.csv, --all_slices): the same files; every NIfTI and
  heatmap.pkl array at atol 1e-4; each CAM PNG with at most 0.5% of its
  pixels different, each by at most 4 levels (the blurred CAM on a jet
  bin edge); the rc 2 refusals alike;
- create_heatmaps radio with scan_list, a string and a list
  display_modality (and a lung display): the same PNG names and pixels.
Numeric subject ids render in the port alone: JAX compares its text ids
with pandas' integer columns and skips them (ROADMAP.md, queue 3)."""
import csv
import os
import pickle

import cv2
import numpy as np
import pytest
import torch
import yaml

from fixtures import make_cohort_csv, make_feature_store, make_splits
from test_torch_resnet import seeded_state_dict

from multimodalfusion_tpu.cli.create_heatmaps import main as jax_heatmaps
from multimodalfusion_tpu.cli.gradcam import main as jax_gradcam
from multimodalfusion_tpu.cli.main import main as jax_stage2
from multimodalfusion_tpu.data.io import save_hdf5
from multimodalfusion_tpu_torch.cli.create_heatmaps import \
    main as port_heatmaps
from multimodalfusion_tpu_torch.cli.gradcam import main as port_gradcam
from multimodalfusion_tpu_torch.data.nifti import read_nifti, write_nifti
from multimodalfusion_tpu_torch.data.radiology import preprocess_lung_scan
from multimodalfusion_tpu_torch.utils.png import read_png

SEQS = ["T1", "T2"]


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """(base dir, the JAX-trained experiment, the weights file, the cohort
    frame)."""
    b = tmp_path_factory.mktemp("torch_gradcam")
    _, df, latent = make_cohort_csv(str(b / "dataset_csv" / "brain"), n=20,
                                    seed=4, modalities=SEQS)
    make_feature_store(str(b / "features" / "brain"), df, latent, seed=4,
                       modalities=SEQS, bag_range=(5, 12))
    make_splits(str(b / "splits" / "brain" / "1fold"), df, k=1)
    assert jax_stage2([
        "--cancer_type", "brain", "--which_splits", "1fold", "--k", "1",
        "--max_epochs", "1", "--model_type", "radio_attention_mil",
        "--mode", "radio", "--modality", ",".join(SEQS),
        "--radio_fusion", "concat", "--gate_radio", "--bag_loss",
        "nll_surv", "--batch_size", "4",
        "--data_root_dir", str(b / "features"),
        "--dataset_root", str(b / "dataset_csv"),
        "--splits_root", str(b / "splits"),
        "--results_dir", str(b / "res"), "--overwrite"]) == 0
    exp = next((b / "res" / "brain" / "1fold").iterdir())
    weights = str(b / "resnet50_seeded.pt")
    torch.save(seeded_state_dict(0), weights)
    return b, str(exp), weights, df


def glioma_volume(rng, n=8, size=96):
    vol = np.zeros((n, size, size), np.float32)
    inner = size * 2 // 3
    lo = (size - inner) // 2
    vol[1:n - 1, lo:lo + inner, lo:lo + inner] = rng.uniform(
        5, 90, size=(n - 2, inner, inner))
    return vol


def lung_volume():
    """tests/test_gradcam_cli.py's CT phantom: air border, two low-HU
    lung fields in soft tissue."""
    lung = np.full((10, 72, 72), 40, np.int16)
    lung[:, :4, :] = lung[:, -4:, :] = -1000
    lung[:, :, :4] = lung[:, :, -4:] = -1000
    lung[2:9, 20:52, 12:32] = -850
    lung[2:9, 20:52, 40:60] = -850
    return lung.astype(np.float32)


def files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def jax_png(path):
    """A PNG that the JAX package wrote with cv2.imwrite of its BGR
    conversion, back as RGB (or grayscale)."""
    img = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    return cv2.cvtColor(img, cv2.COLOR_BGR2RGB) if img.ndim == 3 else img


def same_outputs(port_dir, jax_dir, png_share=5e-3, png_levels=4):
    """The same files; NIfTIs and heatmap.pkl at atol 1e-4; PNGs with at
    most ``png_share`` of their pixels off by at most ``png_levels``."""
    names = files(jax_dir)
    assert files(port_dir) == names and names
    for name in names:
        got, want = os.path.join(port_dir, name), os.path.join(jax_dir, name)
        if name.endswith(".png"):
            g, w = read_png(got), jax_png(want)
            assert g.shape == w.shape, name
            diff = np.abs(g.astype(int) - w.astype(int))
            assert (diff > 0).mean() <= png_share, name
            assert diff.max() <= png_levels, name
        elif name.endswith(".nii.gz"):
            g, w = read_nifti(got).data, read_nifti(want).data
            assert g.shape == w.shape and g.dtype == w.dtype, name
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-4, err_msg=name)
        elif name.endswith(".pkl"):
            with open(got, "rb") as f:
                g = pickle.load(f)
            with open(want, "rb") as f:
                w = pickle.load(f)
            assert list(g) == list(w), name
            for k in w:
                assert isinstance(g[k], np.ndarray)
                np.testing.assert_allclose(g[k], w[k], rtol=0, atol=1e-4)
    return names


def both(tmp_path, argv):
    """Run both CLIs with ``argv`` into tmp_path/{jax,port}."""
    assert jax_gradcam(argv + ["--save_dir", str(tmp_path / "jax")]) == 0
    assert port_gradcam(argv + ["--save_dir", str(tmp_path / "port"),
                                "--device", "cpu"]) == 0
    return same_outputs(str(tmp_path / "port"), str(tmp_path / "jax"))


def test_single_scan_glioma_matches_jax(setup, tmp_path):
    _, exp, weights, _ = setup
    scan = write_nifti(str(tmp_path / "scan.nii.gz"),
                       glioma_volume(np.random.default_rng(0)),
                       origin_lps=(0.0, -239.0, 0.0))
    names = both(tmp_path, ["--scan", scan, "--ckpt_path", exp,
                            "--modality", "T2", "--image_size", "96",
                            "--top_frac", "0.4", "--weights", weights])
    assert "cam_volume.nii.gz" in names
    assert len([n for n in names if n.startswith("slice")]) == 3
    cam = read_nifti(str(tmp_path / "port" / "cam_volume.nii.gz")).data
    assert cam.shape == (6, 64, 64) and np.isfinite(cam).all()


def test_single_scan_lung_matches_jax(setup, tmp_path):
    """CAMs zeroed outside the lung mask and blurred: inside the lungs the
    mean CAM is more than twice the mean outside
    (tests/test_gradcam_cli.py:76-78)."""
    _, exp, weights, _ = setup
    scan = write_nifti(str(tmp_path / "lung.nii.gz"), lung_volume(),
                       pixdim=(1.0, 1.0, 1.5))
    both(tmp_path, ["--scan", scan, "--ckpt_path", exp, "--cancer_type",
                    "lung", "--image_size", "96", "--top_frac", "0.5",
                    "--weights", weights])
    cam = read_nifti(str(tmp_path / "port" / "cam_volume.nii.gz")).data
    _, _, mask = preprocess_lung_scan(scan, return_mask=True)
    assert cam.shape == mask.shape and np.isfinite(cam).all()
    assert cam[mask].mean() > 2 * max(cam[~mask].mean(), 1e-9)


def write_cohort(base, subjects, seed=1):
    """Two glioma sequences a subject (slice ids 1..6 after the black
    slices go), the scan list and a scores.csv in the heatmap radio
    branch's layout."""
    rng = np.random.default_rng(seed)
    scans = base / "scans"
    os.makedirs(scans, exist_ok=True)
    rows = []
    for s in subjects:
        row = {"subject_id": s}
        for m in SEQS:
            row[m] = f"{s}_{m}.nii.gz"
            write_nifti(str(scans / row[m]), glioma_volume(rng),
                        origin_lps=(0.0, -239.0, 0.0))
        rows.append(row)
    scan_list = str(base / "scan_list.csv")
    with open(scan_list, "w", newline="") as f:
        w = csv.DictWriter(f, ["subject_id"] + SEQS, lineterminator="\n")
        w.writeheader()
        w.writerows(rows)
    scores = str(base / "scores.csv")
    with open(scores, "w") as f:
        f.write("subject_id,slice_index,attention,group\n")
        for s in subjects:
            for sid in range(1, 7):
                f.write(f"{s},{sid},{10 - sid + 1.5 * (sid % 2)},"
                        f"{'top' if sid <= 3 else 'low'}\n")
    return str(scans), scan_list, scores


def cohort_args(exp, weights, scans, scan_list, scores):
    return ["--ckpt_path", exp, "--csv_path", scan_list, "--radio_dir",
            scans, "--scores_csv", scores, "--image_size", "96",
            "--weights", weights, "--no_aug_smooth"]


def test_cohort_top_slices_match_jax(setup, tmp_path):
    _, exp, weights, _ = setup
    args = cohort_args(exp, weights, *write_cohort(tmp_path,
                                                   ["SUBJ000", "SUBJ001"]))
    names = both(tmp_path, args + ["--top", "3"])
    assert [n for n in names if n.startswith("SUBJ000")] == [
        os.path.join("SUBJ000", "ig_heatmap", f"{m}_{k}_{sid}.png")
        for m, k, sid in (("T1", 0, 1), ("T1", 1, 3), ("T1", 2, 2),
                          ("T2", 0, 1), ("T2", 1, 3), ("T2", 2, 2))]


def test_cohort_all_slices_match_jax(setup, tmp_path):
    _, exp, weights, _ = setup
    args = cohort_args(exp, weights, *write_cohort(tmp_path,
                                                   ["SUBJ000", "SUBJ001"]))
    names = both(tmp_path, args + ["--all_slices", "--subject", "SUBJ001"])
    assert os.path.join("SUBJ001", "heatmap.pkl") in names
    assert not any(n.startswith("SUBJ000") for n in names)
    attr = [read_nifti(str(tmp_path / "port" / "SUBJ001" /
                           f"SUBJ001_{m}_attr.nii.gz")).data for m in SEQS]
    assert all(a.shape == (6, 64, 64) and a.min() >= 0 for a in attr)
    assert max(a.max() for a in attr) == pytest.approx(1.0, abs=1e-5)


def test_refusals_match_jax(setup, tmp_path):
    """rc 2 without --weights, for a missing --weights file (before any
    subject is preprocessed), and for --scan with --csv_path; both CLIs
    alike."""
    b, exp, weights, _ = setup
    scans, scan_list, scores = write_cohort(tmp_path, ["SUBJ000"])
    scan = os.path.join(scans, "SUBJ000_T1.nii.gz")
    cohort = cohort_args(exp, weights, scans, scan_list, scores)
    cases = {
        "no_weights": ["--scan", scan, "--ckpt_path", exp,
                       "--image_size", "96"],
        "missing_weights": [a if a != weights else str(b / "missing.pt")
                            for a in cohort],
        "scan_and_csv": ["--scan", scan] + cohort,
        "neither": ["--ckpt_path", exp, "--weights", weights],
    }
    for name, argv in cases.items():
        for side, main, extra in (("jax", jax_gradcam, []),
                                  ("port", port_gradcam,
                                   ["--device", "cpu"])):
            out = tmp_path / name / side
            assert main(argv + ["--save_dir", str(out)] + extra) == 2, \
                (name, side)
            assert not os.path.exists(out) or not os.listdir(out)


def test_numeric_subject_ids_render(setup, tmp_path):
    """Ids that read as numbers (7, 007) stay text, match scores.csv and
    render, top slices and volumes alike (the JAX CLI skips them)."""
    _, exp, weights, _ = setup
    args = cohort_args(exp, weights, *write_cohort(tmp_path, ["7", "007"]))
    assert port_gradcam(args + ["--top", "2", "--save_dir",
                                str(tmp_path / "top"), "--device",
                                "cpu"]) == 0
    for s in ("7", "007"):
        assert sorted(os.listdir(tmp_path / "top" / s / "ig_heatmap")) == [
            "T1_0_1.png", "T1_1_3.png", "T2_0_1.png", "T2_1_3.png"]
    assert port_gradcam(args + ["--all_slices", "--subject", "007",
                                "--save_dir", str(tmp_path / "all"),
                                "--device", "cpu"]) == 0
    assert os.listdir(tmp_path / "all") == ["007"]
    assert (tmp_path / "all" / "007" / "007_T2_attr.nii.gz").is_file()


def test_gradcam_needs_cuda_unless_cpu_is_asked(setup, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    _, exp, weights, _ = setup
    with pytest.raises(RuntimeError, match="--device cpu"):
        port_gradcam(["--scan", "x.nii.gz", "--ckpt_path", exp,
                      "--weights", weights, "--save_dir", str(tmp_path)])
    assert not os.listdir(tmp_path)


# ---------------------------------------------------------------------------
# create_heatmaps: the scan_list slice images
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("layout", ["one_sequence", "sequence_list",
                                    "lung"])
def test_heatmap_scan_list_matches_jax(setup, tmp_path, layout):
    """Three subjects' top and low slices: a string display_modality writes
    subject/{top,low}, a list subject/{sequence}/{top,low}; in the list,
    FLAIR's feature h5 of the first subject holds none of the selected
    slices, so both CLIs skip its preprocessing (and its files)."""
    b, exp, _, df = setup
    subjects = list(df["subject_id"].iloc[:3])
    plist = tmp_path / "subjects.csv"
    plist.write_text("subject_id\n" + "".join(f"{s}\n" for s in subjects))
    scans = tmp_path / "scans"
    os.makedirs(scans)
    rng = np.random.default_rng(3)
    display = {"one_sequence": "T1", "sequence_list": ["T1", "FLAIR"],
               "lung": "CT"}[layout]
    cols = [display] if isinstance(display, str) else display
    rows = []
    for s in subjects:
        row = {"subject_id": s}
        for m in cols:
            row[m] = f"{s}_{m}.nii.gz"
            if m == "CT":
                write_nifti(str(scans / row[m]), lung_volume(),
                            pixdim=(1.0, 1.0, 1.5))
            else:
                write_nifti(str(scans / row[m]), rng.uniform(
                    1, 90, size=(25, 24, 24)).astype(np.float32),
                    origin_lps=(0.0, -239.0, 0.0))
        rows.append(row)
    with open(tmp_path / "scan_list.csv", "w", newline="") as f:
        w = csv.DictWriter(f, ["subject_id"] + cols, lineterminator="\n")
        w.writeheader()
        w.writerows(rows)
    feat_dir = b / "features" / "brain"
    if layout == "sequence_list":
        os.makedirs(feat_dir / "radio_h5_files" / "FLAIR", exist_ok=True)
        save_hdf5(str(feat_dir / "radio_h5_files" / "FLAIR" /
                      f"{subjects[0]}.h5"),
                  {"features": np.zeros((3, 1024), np.float32),
                   "slice_index": np.arange(500, 503)}, mode="w")
    for side, main, extra in (("jax", jax_heatmaps, []),
                              ("port", port_heatmaps, ["--device", "cpu"])):
        cfg = tmp_path / f"{side}.yaml"
        cfg.write_text(yaml.safe_dump({
            "exp_arguments": {"branch": "radio",
                              "save_dir": str(tmp_path / side)},
            "data_arguments": {
                "process_list": str(plist), "feat_dir": str(feat_dir),
                "modalities": SEQS, "scan_list": str(tmp_path /
                                                     "scan_list.csv"),
                "scan_dir": str(scans), "display_modality": display,
                **({"cancer_type": "lung"} if layout == "lung" else {})},
            "model_arguments": {"ckpt_path": exp, "which_k": 0}}))
        assert main(["--config", str(cfg)] + extra) == 0
    names = same_outputs(str(tmp_path / "port"), str(tmp_path / "jax"),
                         png_share=0, png_levels=0)
    pngs = [n for n in names if n.endswith(".png")]
    first = {"one_sequence": [subjects[0], "top"],
             "sequence_list": [subjects[1], "T1", "low"],
             "lung": [subjects[0], "low"]}[layout]
    assert any(n.startswith(os.path.join(*first)) for n in pngs)
    if layout == "sequence_list":
        assert not os.path.exists(tmp_path / "port" / subjects[0] / "FLAIR")
        assert any(os.path.join(subjects[1], "FLAIR", "top") in n
                   for n in pngs)
