"""Radiology stage 1 of the port (multimodalfusion_tpu_torch.data.{nifti,
ct_preprocess,radiology} and cli.feature_extraction) against the JAX
package's on the CPU: NIfTI round trips both ways; glioma and lung
preprocessing (slices, slice ids and lung masks) equal to JAX's exactly;
the extraction CLI of both packages, with --dtype float32 and one seeded
--weights file, writes the same h5 and .pt files (names and slice_index
exact, features at the ResNet tolerance) and the same not_processed.pkl
labels; the CSV reader drops what pandas' dropna drops; the refusals."""
import os
import pickle
import warnings

import numpy as np
import pandas as pd
import pytest
import torch

from test_torch_resnet import ATOL, RTOL, seeded_state_dict

from multimodalfusion_tpu.cli.feature_extraction import main as jax_fx
from multimodalfusion_tpu.data import ct_preprocess as jct
from multimodalfusion_tpu.data import nifti as jnii
from multimodalfusion_tpu.data import radiology as jrad
from multimodalfusion_tpu.data.io import load_features_h5 as jax_load_h5
from multimodalfusion_tpu_torch.cli import feature_extraction as tfx
from multimodalfusion_tpu_torch.data import ct_preprocess as tct
from multimodalfusion_tpu_torch.data import dicom as tdicom
from multimodalfusion_tpu_torch.data import nifti as tnii
from multimodalfusion_tpu_torch.data import radiology as trad
from multimodalfusion_tpu_torch.data.io import load_features_h5, load_pt

MODS = ("FLAIR", "T1", "T1Gd", "T2")


@pytest.mark.parametrize("dtype", ["int16", "float32", "uint8", "float64"])
@pytest.mark.parametrize("suffix", [".nii", ".nii.gz"])
def test_nifti_round_trips_both_ways(tmp_path, dtype, suffix):
    vol = (np.random.default_rng(0).normal(size=(5, 12, 9)) * 50).astype(
        dtype)
    kw = dict(pixdim=(0.9, 1.1, 2.5), origin_lps=(3.0, -239.0, 7.5))
    tp = tnii.write_nifti(str(tmp_path / f"t{suffix}"), vol, **kw)
    jp = jnii.write_nifti(str(tmp_path / f"j{suffix}"), vol, **kw)
    if suffix == ".nii":
        assert open(tp, "rb").read() == open(jp, "rb").read()
    for reader in (tnii.read_nifti, jnii.read_nifti):
        for p in (tp, jp):
            img = reader(p)
            np.testing.assert_array_equal(img.data, vol)
            assert img.data.dtype == vol.dtype
            assert img.pixdim == jnii.read_nifti(p).pixdim
            assert img.origin_lps == jnii.read_nifti(p).origin_lps
            np.testing.assert_array_equal(img.affine,
                                          jnii.read_nifti(p).affine)


def test_corrupted_nifti_fail_alike(tmp_path):
    vol = np.random.default_rng(1).normal(size=(4, 6, 5)).astype(np.float32)
    rng = np.random.default_rng(11)
    for name in ("f.nii", "f.nii.gz"):
        raw = open(jnii.write_nifti(str(tmp_path / name), vol), "rb").read()
        target = tmp_path / ("fuzz_" + name)
        for _ in range(30):
            buf = bytearray(raw)
            if rng.integers(0, 2):
                buf = buf[:int(rng.integers(0, len(buf)))]
            else:
                hi = min(len(buf), 348)
                for _ in range(int(rng.integers(1, 9))):
                    buf[int(rng.integers(0, hi))] ^= int(rng.integers(1, 256))
            target.write_bytes(bytes(buf))
            out = []
            for reader in (jnii.read_nifti, tnii.read_nifti):
                try:
                    img = reader(str(target))
                    out.append(("ok", img.data.tobytes(), img.data.shape))
                except Exception as e:
                    out.append(("raise", type(e), str(e)))
            assert out[0] == out[1]


def _glioma_volume(seed, shape=(8, 32, 30)):
    rng = np.random.default_rng(seed)
    vol = np.zeros(shape, np.int16)
    vol[2:7, 5:27, 4:20] = rng.integers(1, 900, (5, 22, 16))
    return vol


@pytest.mark.parametrize("origin", [(0.0, -239.0, 0.0), (10.0, -239.0, 0.0),
                                    (0.0, 5.0, 0.0), (1.0, 2.0, 3.0)])
@pytest.mark.parametrize("kind", ["int16", "float32", "black"])
def test_glioma_preprocess_equals_jax(tmp_path, origin, kind):
    """Flips of every origin axis that differs from (0, -239, 0), black
    slices dropped, min-max over the kept stack, the nonzero crop."""
    vol = _glioma_volume(3)
    vol = (np.zeros_like(vol) if kind == "black" else
           vol.astype(np.float32) * 0.37 if kind == "float32" else vol)
    p = jnii.write_nifti(str(tmp_path / "s.nii.gz"), vol, origin_lps=origin)
    (ws, wi), (gs, gi) = jrad.preprocess_glioma_scan(p), \
        trad.preprocess_glioma_scan(p)
    assert gs.dtype == ws.dtype == np.float32 and gi.dtype == wi.dtype
    np.testing.assert_array_equal(gi, wi)
    np.testing.assert_array_equal(gs, ws)


def _lung_hu(z=10, h=56, w=60, seed=0):
    """HU volume: outside air, a tissue body, two air lungs, an airway
    joining them, noise."""
    rng = np.random.default_rng(seed)
    vol = np.full((z, h, w), -1000, np.int16)
    vol[:, 6:50, 5:55] = 40
    vol[1:9, 14:40, 10:26] = -850
    vol[1:9, 14:40, 32:50] = -850
    vol[4:6, 26:28, 26:32] = -900
    return vol + rng.integers(-8, 8, vol.shape).astype(np.int16)


@pytest.mark.parametrize("spacing", [(2.0, 1.0, 1.0), (2.5, 0.7, 0.7),
                                     (1.0, 1.5, 1.5)])
@pytest.mark.parametrize("mode", ["box", "mask", "each_slice"])
def test_lung_volume_preprocess_equals_jax(spacing, mode):
    """Resample, classical segmentation, the bounding boxes (cv2 in JAX,
    numpy in the port), crop, window; and the aligned mask."""
    vol = _lung_hu(seed=int(spacing[1] * 10))
    kw = {"box": {}, "mask": {"return_mask": True},
          "each_slice": {"segment_each_slice": True}}[mode]
    want = jrad.preprocess_lung_volume(vol, spacing, **kw)
    got = trad.preprocess_lung_volume(vol, spacing, **kw)
    assert len(got) == len(want) == (3 if mode == "mask" else 2)
    assert got[0].shape[0] > 0
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def test_ct_building_blocks_equal_jax():
    vol = _lung_hu(seed=5).astype(np.float32)
    for new in ((1.0, 1.5, 1.5), (0.5, 2.0, 0.7)):
        for g, w in zip(tct.resample(vol, (2.0, 1.0, 1.0), new),
                        jct.resample(vol, (2.0, 1.0, 1.0), new)):
            np.testing.assert_array_equal(g, w)
    for fill in (False, True):
        np.testing.assert_array_equal(tct.segment_lung_mask(vol, fill),
                                      jct.segment_lung_mask(vol, fill))
    seg = jct.segment_lung_mask(vol)
    for g, w in zip(tct.largest_lung_box(vol, seg, return_box=True),
                    jct.largest_lung_box(vol, seg, return_box=True)):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(tct.normalize(vol, -1000, 400),
                                  jct.normalize(vol, -1000, 400))
    for g, w in zip(tct.crop_image(vol + 1000, 30, return_index=True),
                    jct.crop_image(vol + 1000, 30, return_index=True)):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("spacing, new", [
    ((2.0, 1.0, 1.0), (1.0, 1.5, 1.5)),      # up in z, down in y and x
    ((0.5, 3.1, 2.2), (1.0, 1.5, 1.5)),      # down in z, up in y and x
    ((1.0, 0.7, 4.0), (1.0, 1.5, 1.5)),      # z kept: not contracted
])
def test_resample_xla_equals_jax(spacing, new):
    """The device resample against jax.image.resize's trilinear (which
    antialiases when it downsamples): the same shape and real spacing,
    the values at rel 1e-5 of the largest."""
    vol = np.random.default_rng(7).normal(size=(9, 31, 17)).astype(
        np.float32)
    want, want_sp = jct.resample_xla(vol, spacing, new)
    got, got_sp = tct.resample_xla(vol, spacing, new, device="cpu")
    want = np.asarray(want)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got_sp, want_sp)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())
    # F.interpolate(trilinear) does not antialias: it is not this function
    plain = torch.nn.functional.interpolate(
        torch.from_numpy(vol)[None, None], size=want.shape,
        mode="trilinear", align_corners=False)[0, 0].numpy()
    assert np.abs(plain - want).max() > 1e-3 * np.abs(want).max()


def _write_series(d, vol_hu, spacing=(2.0, 1.5, 1.5), jpeg_every=0):
    os.makedirs(d)
    for i in range(vol_hu.shape[0]):
        tdicom.write_ct_slice(
            os.path.join(d, f"s{i:02d}.dcm"), vol_hu[i] + 1024,
            z=spacing[0] * i, spacing=spacing[1:], thickness=spacing[0],
            intercept=-1024.0,
            compression=("jpeg_lossless" if jpeg_every and i % jpeg_every
                         == 0 else None))


@pytest.mark.parametrize("fmt", ["dicom", "dicom_jpeg", "nifti", "empty"])
def test_lung_scan_equals_jax(tmp_path, fmt):
    vol = _lung_hu(seed=9)
    if fmt == "nifti":
        path = jnii.write_nifti(str(tmp_path / "ct.nii.gz"),
                                vol.astype(np.float32),
                                pixdim=(1.5, 1.5, 2.0))
    else:
        path = str(tmp_path / "ct")
        if fmt == "empty":
            os.makedirs(path)
        else:
            _write_series(path, vol, jpeg_every=2 if fmt == "dicom_jpeg"
                          else 0)
    for return_mask in (False, True):
        want = jrad.preprocess_lung_scan(path, return_mask=return_mask)
        got = trad.preprocess_lung_scan(path, return_mask=return_mask)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    p = tmp_path_factory.mktemp("weights") / "resnet50.pt"
    torch.save(seeded_state_dict(2), p)
    return str(p)


def _glioma_cohort(root):
    """The tests/test_extraction.py:180-222 cohort (S1, S2: four 6 x 40 x
    40 sequences each), plus S3 whose T2 file is truncated and S4 whose
    FLAIR cell is empty (dropped from all four sequences)."""
    rng = np.random.default_rng(2)
    radio_dir = os.path.join(root, "scans")
    os.makedirs(radio_dir)
    rows = []
    for s in ("S1", "S2", "S3", "S4"):
        row = {"subject_id": s}
        for m in MODS:
            vol = np.zeros((6, 40, 40), np.float32)
            vol[1:5, 5:35, 5:35] = rng.uniform(1, 80, size=(4, 30, 30))
            fname = f"{s}_{m}.nii" + ("" if s == "S3" else ".gz")
            p = jnii.write_nifti(os.path.join(radio_dir, fname), vol,
                                 origin_lps=(0.0, -239.0, 0.0))
            if s == "S3" and m == "T2":
                with open(p, "r+b") as f:
                    f.truncate(352 + 3000)
            row[m] = None if (s == "S4" and m == "FLAIR") else fname
        rows.append(row)
    csv_path = os.path.join(root, "scans.csv")
    pd.DataFrame(rows).to_csv(csv_path, index=False)
    return radio_dir, csv_path


def _lung_cohort(root):
    """L1 (DICOM, every other slice JPEG Lossless), L2 (NIfTI), L3 (a
    directory without .dcm: an empty scan), L4 (a corrupt .dcm)."""
    radio_dir = os.path.join(root, "scans")
    _write_series(os.path.join(radio_dir, "L1", "ct"), _lung_hu(seed=1),
                  jpeg_every=2)
    os.makedirs(os.path.join(radio_dir, "L2"))
    jnii.write_nifti(os.path.join(radio_dir, "L2", "ct.nii.gz"),
                     _lung_hu(seed=2).astype(np.float32),
                     pixdim=(1.5, 1.5, 2.0))
    os.makedirs(os.path.join(radio_dir, "L3", "ct"))
    os.makedirs(os.path.join(radio_dir, "L4", "ct"))
    with open(os.path.join(radio_dir, "L4", "ct", "x.dcm"), "wb") as f:
        f.write(b"\x00" * 128 + b"DICM" + b"\x02\x00")
    csv_path = os.path.join(root, "scans.csv")
    pd.DataFrame({"subject_id": ["L1", "L2", "L3", "L4"],
                  "CT": ["ct", "ct.nii.gz", "ct", "ct"]}).to_csv(
                      csv_path, index=False)
    return radio_dir, csv_path


@pytest.mark.parametrize("cancer", ["glioma", "lung"])
def test_feature_extraction_cli_matches_jax(tmp_path, weights, cancer):
    radio_dir, csv_path = (_glioma_cohort if cancer == "glioma"
                           else _lung_cohort)(str(tmp_path))
    common = ["--radio_dir", radio_dir, "--csv_path", csv_path,
              "--cancer_type", cancer, "--batch_size", "8", "--dtype",
              "float32", "--weights", weights]
    assert jax_fx(common + ["--output_dir", str(tmp_path / "jax")]) == 0
    assert tfx.main(common + ["--output_dir", str(tmp_path / "port"),
                              "--device", "cpu"]) == 0
    jroot, troot = (str(tmp_path / who / cancer) for who in ("jax", "port"))
    files = sorted(os.path.relpath(os.path.join(d, f), jroot)
                   for d, _, fs in os.walk(jroot) for f in fs)
    assert files == sorted(os.path.relpath(os.path.join(d, f), troot)
                           for d, _, fs in os.walk(troot) for f in fs)
    n_h5 = 0
    for rel in files:
        if rel.endswith(".h5"):
            want_f, want_i = jax_load_h5(os.path.join(jroot, rel))
            got_f, got_i = load_features_h5(os.path.join(troot, rel))
            assert got_i.dtype == np.int64 and got_f.dtype == np.float32
            np.testing.assert_array_equal(got_i, want_i)
            assert got_f.shape == want_f.shape
            np.testing.assert_allclose(got_f, want_f, rtol=RTOL, atol=ATOL)
            pt = os.path.join(troot, rel.replace("h5", "pt"))
            np.testing.assert_array_equal(load_pt(pt), got_f)
            n_h5 += 1
    with open(os.path.join(jroot, "not_processed.pkl"), "rb") as f:
        want = pickle.load(f)
    with open(os.path.join(troot, "not_processed.pkl"), "rb") as f:
        got = pickle.load(f)
    assert [r[:-1] for r in got] == [r[:-1] for r in want]
    assert all(isinstance(r[-1], str) and r[-1] for r in got)
    if cancer == "glioma":
        assert n_h5 == 11 and [r[:-1] for r in got] == [("S3", "T2")]
        assert not any("S4" in f for f in files)
    else:
        assert n_h5 == 3 and [r[:-1] for r in got] == [("L4",)]
        assert load_features_h5(os.path.join(
            troot, "radio_h5_files", "CT", "L3.h5"))[0].shape == (0, 1024)


def test_cli_keeps_text_ids_skips_existing_and_ignores_no_s2d_stem(
        tmp_path, weights, capsys):
    """Ids stay text (007.h5, where JAX writes 7.h5); a rerun skips
    every existing h5; --no_s2d_stem changes nothing; the CSV reader
    drops the rows pandas' dropna drops (pandas' NA strings)."""
    radio_dir = tmp_path / "scans"
    radio_dir.mkdir()
    vol = _glioma_volume(4)
    cells = {"007": ["a.nii"] * 4, "12": ["a.nii", "NA", "a.nii", "a.nii"],
             "x1": ["a.nii", "a.nii", "nan", "a.nii"],
             "": ["a.nii"] * 4, "NULL": ["a.nii"] * 4}
    jnii.write_nifti(str(radio_dir / "a.nii"), vol,
                     origin_lps=(0.0, -239.0, 0.0))
    csv_path = tmp_path / "scans.csv"
    with open(csv_path, "w") as f:
        f.write("subject_id,FLAIR,T1,T1Gd,T2,age\n")
        f.writelines(f"{s},{','.join(c)},50\n" for s, c in cells.items())
    cols = ["subject_id"] + list(MODS)
    want = pd.read_csv(csv_path, dtype=str)[cols].dropna().values.tolist()
    assert tfx.read_scans_csv(str(csv_path), cols) == want == [
        ["007"] + ["a.nii"] * 4]
    outs = []
    for flags in ([], ["--no_s2d_stem"]):
        out = tmp_path / f"out{len(flags)}"
        argv = ["--radio_dir", str(radio_dir), "--csv_path", str(csv_path),
                "--output_dir", str(out), "--dtype", "float32",
                "--weights", weights, "--device", "cpu"] + flags
        assert tfx.main(argv) == 0
        h5 = out / "glioma" / "radio_h5_files" / "T1" / "007.h5"
        mtime = os.stat(h5).st_mtime_ns
        capsys.readouterr()
        assert tfx.main(argv) == 0
        assert os.stat(h5).st_mtime_ns == mtime
        assert "0 scans, 0 slices" in capsys.readouterr().out
        outs.append(load_features_h5(str(h5))[0])
    np.testing.assert_array_equal(outs[0], outs[1])


@pytest.mark.parametrize("case", ["data_parallel", "no_weights",
                                  "missing_weights_file", "cuda_without_gpu"])
def test_cli_refusals(tmp_path, weights, case, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    csv_path = tmp_path / "scans.csv"
    csv_path.write_text("subject_id,FLAIR,T1,T1Gd,T2\n")
    argv = ["--radio_dir", str(tmp_path), "--csv_path", str(csv_path),
            "--output_dir", str(tmp_path / "out")]
    if case == "data_parallel":
        # two visible GPUs and no torchrun environment: one process would
        # leave a GPU idle, so it raises and says how to launch
        monkeypatch.delenv("WORLD_SIZE", raising=False)
        monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    extra, error, match = {
        "data_parallel": (["--data_parallel", "--weights", weights],
                          RuntimeError, "torchrun --nproc_per_node=2"),
        "no_weights": (["--device", "cpu"], ValueError, "ResNet50 weights"),
        "missing_weights_file": (["--weights", str(tmp_path / "none.pt"),
                                  "--device", "cpu"], FileNotFoundError, ""),
        "cuda_without_gpu": (["--weights", weights], RuntimeError, "CUDA"),
    }[case]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        with pytest.raises(error, match=match or None):
            tfx.main(argv + extra)
    assert not (tmp_path / "out").exists()
