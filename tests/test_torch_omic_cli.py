"""The port's genomic data layer and its omic / path+omic CLIs
(multimodalfusion_tpu_torch.data, cli.main, cli.infer) against the JAX
package's on the CPU: the z-scored genomic features at 1e-12 (NaN and
constant columns included), the batches for the same seed bit for bit,
two epochs of each CLI writing the JAX CLI's files, and ``--eval_only``
and ``cli.infer`` on JAX-trained experiments at rel 1e-4."""
import csv
import json
import math
import os
import pickle
import shutil

import numpy as np
import pandas as pd
import pytest
import torch

from fixtures import make_cohort_csv, make_feature_store, make_splits

from multimodalfusion_tpu.cli.infer import main as jax_infer
from multimodalfusion_tpu.cli.main import main as jax_main
from multimodalfusion_tpu.data import loaders as jloaders
from multimodalfusion_tpu.data.survival_dataset import \
    SurvivalDataset as JaxDataset
from multimodalfusion_tpu_torch.cli.infer import main as port_infer
from multimodalfusion_tpu_torch.cli.main import main as port_main
from multimodalfusion_tpu_torch.data import loaders as tloaders
from multimodalfusion_tpu_torch.data.survival_dataset import (
    Scaler, SurvivalDataset as PortDataset)

MODELS = {
    "path_omic": ["--model_type", "mm_attention_mil", "--mode", "path_omic",
                  "--fusion", "tensor", "--gate_path", "--drop_out",
                  "--bag_loss", "nll_surv"],
    "max_net": ["--model_type", "max_net", "--mode", "omic",
                "--bag_loss", "cox_surv", "--reg_type", "omic_mm"],
}


@pytest.fixture(scope="module")
def cohort(tmp_path_factory):
    """tests/fixtures.py's synthetic cohort (16 subjects, 12 genomic
    columns, bags of 6-40 instances, two folds of 8 + 8 subjects) with a
    missing genomic cell: one subject is omic-absent."""
    base = tmp_path_factory.mktemp("torch_omic")
    root = str(base / "dataset_csv" / "brain")
    csv_path, df, latent = make_cohort_csv(root, n=16, seed=7)
    df.loc[3, "G0_cnv"] = np.nan
    df.to_csv(csv_path, index=False)
    make_feature_store(str(base / "features" / "brain"), df, latent, seed=7,
                       modalities=["T1"], bag_range=(6, 40))
    make_splits(str(base / "splits" / "brain" / "2foldcv"), df, k=2,
                val_frac=0.5, seed=7)
    return base


def cli_args(base, results_dir, model, *extra):
    return ["--cancer_type", "brain", "--which_splits", "2foldcv",
            "--k", "2", "--k_end", "1", "--max_epochs", "2",
            "--batch_size", "4", "--lr", "1e-3", *MODELS[model],
            "--data_root_dir", str(base / "features"),
            "--dataset_root", str(base / "dataset_csv"),
            "--splits_root", str(base / "splits"),
            "--results_dir", str(results_dir), *extra]


def split_csv(base, k=0):
    return str(base / "splits" / "brain" / "2foldcv" / f"splits_{k}.csv")


def write_variant(base, name, edit):
    """A copy of the cohort CSV edited by ``edit(df)``."""
    df = pd.read_csv(base / "dataset_csv" / "brain" / "survival.csv")
    edit(df)
    path = str(base / f"{name}.csv")
    df.to_csv(path, index=False)
    return path


def nan_and_constant(df):
    df.loc[[0, 5, 9], "G1_mut"] = np.nan
    df.loc[2, "G4_cnv"] = np.nan
    df["CONST_cnv"] = 2.5                           # zero variance
    df["BIG_cnv"] = np.linspace(-1e3, 3e3, len(df))


@pytest.mark.parametrize("variant", ["cohort", "nan_and_constant"])
@pytest.mark.parametrize("mode", ["omic", "path_omic"])
def test_genomic_features_match_jax(cohort, variant, mode):
    """Columns, omic presence, usable subjects and the train-fold
    z-scored features of both splits: JAX's load_splits at 1e-12."""
    path = (str(cohort / "dataset_csv" / "brain" / "survival.csv")
            if variant == "cohort"
            else write_variant(cohort, variant, nan_and_constant))
    data = str(cohort / "features" / "brain")
    jsplits = JaxDataset(path, mode=mode, data_dir=data,
                         n_bins=4).load_splits(split_csv(cohort))
    tsplits = PortDataset(path, mode=mode, data_dir=data,
                          n_bins=4).load_splits(split_csv(cohort))
    usable = 0
    for j, t in zip(jsplits, tsplits):
        usable += len(tloaders.usable_indices(t))
        assert t.genomic_cols == list(j.genomic_cols)
        np.testing.assert_allclose(t.genomic_features, j.genomic_features,
                                   rtol=1e-12, atol=1e-12)
        assert np.array_equal(np.isnan(t.genomic_features),
                              np.isnan(j.genomic_features))
        assert jloaders.usable_indices(j) == tloaders.usable_indices(t)
        assert [j.probe_present(i) for i in range(len(j))] == [
            t.probe_present(i) for i in range(len(t))]
    assert usable < sum(len(t) for t in tsplits)  # omic-absent subjects


def test_scaler_is_standard_scaler():
    """Scaler against sklearn's StandardScaler: NaN ignored in the fit and
    kept in the transform, constant, near-constant (under sklearn's
    bound) and all-NaN columns, at 1e-12.  (The near-constant column is
    tested here and not through a CSV: pandas' float parser and Python's
    may read a 17-digit cell one unit in the last place apart, and a
    near-constant column keeps that difference after centring.)"""
    from sklearn.preprocessing import StandardScaler
    rng = np.random.default_rng(0)
    X = rng.normal(size=(9, 7)) * [1, 10, 1e-3, 1, 1, 1, 1] + [
        0, 5, 1e6, 0, 0, 0, 0]
    X[[1, 4], 0] = np.nan
    X[:, 3] = 7.0
    X[:, 4] = np.nan
    X[2, 5] = np.nan
    X[:, 6] = 1e6 + np.arange(9) * 2 ** -33    # a few ulps of 1e6 apart
    want_fit = StandardScaler().fit(X)
    got_fit = Scaler.fit(X)
    np.testing.assert_allclose(got_fit.mean, want_fit.mean_, rtol=1e-12,
                               equal_nan=True)
    np.testing.assert_allclose(got_fit.scale, want_fit.scale_, rtol=1e-12,
                               equal_nan=True)
    np.testing.assert_allclose(got_fit.transform(X), want_fit.transform(X),
                               rtol=1e-12, atol=1e-12, equal_nan=True)


def test_all_nan_column_warns_and_empties_the_fold(cohort, capsys):
    """A column that is NaN for every subject is reported as JAX reports
    it, and every subject is omic-absent."""
    path = write_variant(cohort, "all_nan",
                         lambda df: df.__setitem__("SCAN_path", np.nan))
    data = str(cohort / "features" / "brain")
    jtr, _ = JaxDataset(path, mode="omic", data_dir=data,
                        n_bins=4).load_splits(split_csv(cohort))
    jout = capsys.readouterr().out
    ttr, _ = PortDataset(path, mode="omic", data_dir=data,
                         n_bins=4).load_splits(split_csv(cohort))
    tout = capsys.readouterr().out
    assert ttr.all_nan_genomic_cols == jtr.all_nan_genomic_cols == [
        "SCAN_path"]
    assert tout == jout and "entirely NaN" in tout
    assert tloaders.usable_indices(ttr) == jloaders.usable_indices(jtr) == []


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("mode", ["omic", "path_omic"])
def test_batch_order_matches_jax(cohort, mode, weighted):
    """For the same seed, the batches hold the same subjects in the same
    order, with the same labels, genomic rows and bags, bit for bit."""
    path = str(cohort / "dataset_csv" / "brain" / "survival.csv")
    data = str(cohort / "features" / "brain")
    jtr, _ = JaxDataset(path, mode=mode, data_dir=data,
                        n_bins=4).load_splits(split_csv(cohort))
    ttr, _ = PortDataset(path, mode=mode, data_dir=data,
                         n_bins=4).load_splits(split_csv(cohort))
    jb = list(jloaders.iter_batches(jtr, batch_size=4, shuffle=True,
                                    weighted=weighted, seed=11,
                                    reuse_collation_buffers=False))
    tb = list(tloaders.prefetch(tloaders.iter_batches(
        ttr, batch_size=4, shuffle=True, weighted=weighted, seed=11)))
    assert len(jb) == len(tb) > 1
    for j, t in zip(jb, tb):
        assert sorted(j) == sorted(t)
        assert list(j["subject_ids"]) == list(t["subject_ids"])
        for k in j:
            if k != "subject_ids":
                assert j[k].dtype == t[k].dtype, k
                assert j[k].tobytes() == t[k].tobytes(), k


@pytest.fixture(scope="module")
def jax_runs(cohort):
    """One fold, two epochs of JAX training per model; msgpack
    checkpoints and their .pt exports."""
    for model in MODELS:
        assert jax_main(cli_args(cohort, cohort / "jax" / model,
                                 model)) == 0
    return {m: cohort / "jax" / m for m in MODELS}


def exp_dir(results_dir):
    return next((results_dir / "brain" / "2foldcv").iterdir())


@pytest.mark.parametrize("model", list(MODELS))
def test_cli_writes_the_jax_file_set(cohort, jax_runs, tmp_path, model):
    """Two epochs of the port's CLI on the CPU: the JAX CLI's files (.pt
    checkpoints only, the resume bundle as the port's .pt), metrics keys,
    result keys and shapes; each
    checkpoint has the JAX export's keys (placeholders included), and
    cli.infer serves it."""
    assert port_main(cli_args(cohort, tmp_path / "port", model,
                              "--device", "cpu")) == 0
    jexp, texp = exp_dir(jax_runs[model]), exp_dir(tmp_path / "port")
    assert jexp.name == texp.name
    jfiles = {p.relative_to(jexp).as_posix().replace(
        "_resume.msgpack", "_resume.pt") for p in jexp.rglob("*")
        if p.is_file() and (not p.name.endswith(".msgpack")
                            or p.name.endswith("_resume.msgpack"))
        and not p.name.startswith("risks")}
    tfiles = {p.relative_to(texp).as_posix() for p in texp.rglob("*")
              if p.is_file()}
    assert tfiles == jfiles
    jrecs = [json.loads(x) for x in open(jexp / "0" / "metrics.jsonl")]
    trecs = [json.loads(x) for x in open(texp / "0" / "metrics.jsonl")]
    assert [list(r) for r in trecs] == [list(r) for r in jrecs]
    assert len(trecs) == 2
    assert all(math.isfinite(r["train_loss"]) for r in trecs)
    with open(jexp / "split_train_val_0_results.pkl", "rb") as f:
        jres = pickle.load(f)
    with open(texp / "split_train_val_0_results.pkl", "rb") as f:
        tres = pickle.load(f)
    assert list(tres) == list(jres)
    for k in jres:
        assert tres[k].shape == jres[k].shape, k
    np.testing.assert_array_equal(tres["subject_id"], jres["subject_id"])
    for name in ("s_0_checkpoint.pt", "s_0_minloss_checkpoint.pt"):
        jsd = torch.load(jexp / name, weights_only=True)
        tsd = torch.load(texp / name, weights_only=True)
        assert list(tsd) == list(jsd), name
        assert all(tsd[k].shape == jsd[k].shape for k in jsd)
    out = tmp_path / "risks.csv"
    assert port_infer(["--model_path", str(texp), "--which_k", "0",
                       "--out", str(out), "--device", "cpu"]) == 0
    with open(out) as f:
        rows = list(csv.DictReader(f))
    assert rows and all(math.isfinite(float(r["risk"])) for r in rows)


@pytest.mark.parametrize("model", list(MODELS))
def test_eval_only_matches_jax(cohort, jax_runs, tmp_path, model):
    """--eval_only of the port on a JAX-trained experiment (its .pt
    export, placeholders dropped) gives JAX's validation c-index and
    per-subject risks at rel 1e-4."""
    runs = {}
    for name, main, extra in (("jax", jax_main, ()),
                              ("port", port_main, ("--device", "cpu"))):
        root = tmp_path / name
        shutil.copytree(jax_runs[model], root)
        assert main(cli_args(cohort, root, model, "--eval_only",
                             *extra)) == 0
        exp = exp_dir(root)
        with open(exp / "split_train_val_0_results.pkl", "rb") as f:
            res = pickle.load(f)
        with open(exp / "eval_summary_partial_0_1.csv") as f:
            rows = list(csv.reader(f))
        runs[name] = (res, rows)
    (jres, jrows), (tres, trows) = runs["jax"], runs["port"]
    assert trows[0] == jrows[0]
    assert float(trows[1][2]) == pytest.approx(float(jrows[1][2]),
                                               rel=1e-4)
    assert list(tres) == list(jres)
    np.testing.assert_array_equal(tres["subject_id"], jres["subject_id"])
    np.testing.assert_allclose(tres["risk"], jres["risk"], rtol=1e-4)
    if "prob" in jres:
        np.testing.assert_allclose(tres["prob"], jres["prob"], rtol=1e-4,
                                   atol=1e-6)


def read_rows(path):
    with open(path, newline="") as f:
        return {r["subject_id"]: r for r in csv.DictReader(f)}


@pytest.mark.parametrize("cohort_csv", ["own", "reordered_label_free"])
@pytest.mark.parametrize("model", list(MODELS))
def test_infer_matches_jax(cohort, jax_runs, tmp_path, model, cohort_csv):
    """cli.infer of the port and of JAX on a JAX-trained experiment: the
    same rows and columns at rel 1e-4.  The label-free cohort lists the
    genomic columns in reverse: both refit the training fold's scaler and
    reorder the columns to the training order."""
    exp = exp_dir(jax_runs[model])
    common = ["--model_path", str(exp), "--which_k", "0",
              "--batch_size", "4"]
    if cohort_csv != "own":
        path = write_variant(cohort, f"infer_{model}", lambda df: None)
        src = pd.read_csv(path)
        genes = [c for c in src.columns if c[-4:] in ("_cnv", "_mut")]
        src[["subject_id", "slide_id"] + genes[::-1]].to_csv(path,
                                                             index=False)
        common += ["--csv", path]
    jax_csv, port_csv = tmp_path / "jax.csv", tmp_path / "port.csv"
    assert jax_infer(common + ["--out", str(jax_csv)]) == 0
    assert port_infer(common + ["--out", str(port_csv),
                                "--device", "cpu"]) == 0
    want, got = read_rows(jax_csv), read_rows(port_csv)
    assert list(got) == list(want) and len(got) == 15  # one omic-absent
    assert list(next(iter(got.values()))) == list(next(iter(want.values())))
    for sid, row in want.items():
        for col, v in row.items():
            if col != "subject_id":
                assert float(got[sid][col]) == pytest.approx(
                    float(v), rel=1e-4), (sid, col)


def test_infer_refuses_other_genomic_columns(cohort, jax_runs, tmp_path):
    path = write_variant(cohort, "renamed",
                         lambda df: df.rename(columns={"G0_cnv": "X_cnv"},
                                              inplace=True))
    with pytest.raises(ValueError, match="genomic columns differ"):
        port_infer(["--model_path", str(exp_dir(jax_runs["max_net"])),
                    "--csv", path, "--out", str(tmp_path / "r.csv"),
                    "--device", "cpu"])
    assert not os.path.exists(tmp_path / "r.csv")
