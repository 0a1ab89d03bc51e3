"""The port's --split on the CPU: its stratified splitters
(data/stratified.py) against scikit-learn's over a hypothesis grid, and
SurvivalDataset.do_split against the JAX package's (byte for byte with
text ids, as the same ids in the same order with numeric ones)."""
import csv
import os
import warnings

import numpy as np
import pandas as pd
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st
from sklearn.model_selection import StratifiedKFold, StratifiedShuffleSplit

from fixtures import make_cohort_csv, make_feature_store

from multimodalfusion_tpu.cli.main import main as jax_main
from multimodalfusion_tpu.data.survival_dataset import \
    SurvivalDataset as JaxDataset
from multimodalfusion_tpu_torch.cli.main import main as port_main
from multimodalfusion_tpu_torch.data import stratified
from multimodalfusion_tpu_torch.data.survival_dataset import \
    SurvivalDataset as PortDataset


def _both(want_fn, got_fn):
    """Both splitters' folds, or both their ValueErrors."""
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)
            want = [tuple(f) for f in want_fn()]
    except ValueError:
        with pytest.raises(ValueError):
            list(got_fn())
        return None
    got = [tuple(f) for f in got_fn()]
    assert len(got) == len(want)
    for (a, b), (c, d) in zip(got, want):
        np.testing.assert_array_equal(a, c)
        np.testing.assert_array_equal(b, d)
    return got


labels = st.lists(st.integers(0, 7), min_size=2, max_size=80)


@settings(max_examples=150, deadline=None)
@given(y=labels, k=st.integers(2, 6), seed=st.integers(0, 2 ** 31 - 1))
def test_stratified_kfold_matches_sklearn(y, k, seed):
    y = np.asarray(y)
    _both(lambda: StratifiedKFold(k, shuffle=True, random_state=seed).split(
        np.zeros(len(y)), y), lambda: stratified.stratified_kfold(y, k, seed))


@settings(max_examples=150, deadline=None)
@given(y=labels, k=st.integers(1, 6), seed=st.integers(0, 2 ** 31 - 1),
       test_size=st.sampled_from([0.1, 0.2, 0.25, 1 / 3, 0.5]))
def test_stratified_shuffle_split_matches_sklearn(y, k, seed, test_size):
    y = np.asarray(y)
    _both(lambda: StratifiedShuffleSplit(
        k, test_size=test_size, random_state=seed).split(np.zeros(len(y)), y),
        lambda: stratified.stratified_shuffle_split(y, k, test_size, seed))


def write_cohort(root, n, seed, numeric_ids=False):
    """A cohort CSV of ``n`` subjects: the last sixth held out (train 0),
    and about a third of the rest missing a modality, a genomic cell or
    the slide, so that threemod and each pre_trained mode see different
    subjects."""
    path, df, _ = make_cohort_csv(str(root), n=n, seed=seed)
    rng = np.random.default_rng(seed + 1)
    df = pd.read_csv(path)
    if numeric_ids:
        df["subject_id"] = [str(i) for i in rng.permutation(n) + 1]
    df.loc[df.index[-(n // 6):], "train"] = 0
    for i in rng.choice(n, size=n // 3, replace=False):
        col = rng.choice(["T1", "FLAIR", "G1_mut", "G2_cnv", "slide_id"])
        df.loc[i, col] = np.nan
    df.to_csv(path, index=False)
    return path


CASES = [("threemod", "path", 3, 48), ("threemod", "omic", 5, 160),
         ("pre_trained", "path", 2, 160), ("pre_trained", "omic", 3, 160),
         ("pre_trained", "radio", 2, 160)]


@pytest.mark.parametrize("split,mode,k,n", CASES,
                         ids=[f"{s}-{m}-k{k}-n{n}" for s, m, k, n in CASES])
def test_do_split_writes_jax_csvs(tmp_path, split, mode, k, n):
    """Byte for byte, for the same seed (threemod with k-fold from 120
    subjects, shuffle splits below, and a held-out test column)."""
    path = write_cohort(tmp_path / "cohort", n, seed=n)
    JaxDataset(path, mode=mode, n_bins=2, seed=11).do_split(
        split, str(tmp_path / "jax"), k=k)
    PortDataset(path, mode=mode, n_bins=2).do_split(
        split, str(tmp_path / "port"), k=k, seed=11)
    assert sorted(os.listdir(tmp_path / "port")) == \
        sorted(os.listdir(tmp_path / "jax")) == \
        [f"splits_{i}.csv" for i in range(k)]
    for i in range(k):
        name = f"splits_{i}.csv"
        assert (tmp_path / "port" / name).read_text() == \
            (tmp_path / "jax" / name).read_text(), name


def _columns(path):
    with open(path, newline="") as f:
        rows = list(csv.DictReader(f))
    return {c: [int(float(r[c])) for r in rows if r[c]] for c in rows[0]}


@pytest.mark.parametrize("split", ["threemod", "pre_trained"])
def test_do_split_numeric_ids(tmp_path, split):
    """Numeric ids, which pandas reads as integers: the same ids in the
    same order in every column (JAX writes its test column as floats; the
    held-out ids sort as numbers in both)."""
    path = write_cohort(tmp_path / "cohort", 160, seed=3, numeric_ids=True)
    JaxDataset(path, mode="path", n_bins=2, seed=5).do_split(
        split, str(tmp_path / "jax"), k=2)
    PortDataset(path, mode="path", n_bins=2).do_split(
        split, str(tmp_path / "port"), k=2, seed=5)
    for i in range(2):
        got = _columns(tmp_path / "port" / f"splits_{i}.csv")
        want = _columns(tmp_path / "jax" / f"splits_{i}.csv")
        assert got == want
        if "test" in got:
            assert got["test"] == sorted(got["test"])


def test_do_split_refuses_a_missing_column(tmp_path):
    """A cohort without a modality column raises KeyError in both, as
    pandas' dropna does."""
    path = write_cohort(tmp_path / "cohort", 40, seed=2)
    df = pd.read_csv(path).drop(columns=["T2"])
    df.to_csv(path, index=False)
    for ds, kw in ((JaxDataset(path, mode="path", n_bins=2), {}),
                   (PortDataset(path, mode="path", n_bins=2), {"seed": 7})):
        with pytest.raises(KeyError):
            ds.do_split("threemod", str(tmp_path / "sp"), k=2, **kw)


def test_cli_split_writes_jax_files_and_trains(tmp_path):
    """--split threemod through both CLIs (seed 3): the same splits_{k}.csv
    bytes, and the port trains on them."""
    root = tmp_path / "cohort"
    path = write_cohort(root / "dataset_csv" / "brain", 48, seed=4)
    df = pd.read_csv(path)
    make_feature_store(str(root / "features" / "brain"), df,
                       np.zeros(len(df)), seed=4, modalities=[],
                       bag_range=(4, 12), d=1024)

    def argv(name, *extra):
        return ["--cancer_type", "brain", "--which_splits", name,
                "--split", "threemod", "--k", "2", "--k_end", "1",
                "--seed", "3", "--n_classes", "2", "--max_epochs", "1",
                "--model_type", "max_net", "--mode", "omic", "--bag_loss",
                "cox_surv", "--batch_size", "8", "--data_root_dir",
                str(root / "features"), "--dataset_root",
                str(root / "dataset_csv"), "--splits_root",
                str(root / "splits"), "--results_dir",
                str(tmp_path / "results" / name), *extra]
    assert jax_main(argv("jax")) == 0
    assert port_main(argv("port", "--device", "cpu")) == 0
    for i in range(2):
        name = f"splits_{i}.csv"
        assert (root / "splits" / "brain" / "port" / name).read_text() == \
            (root / "splits" / "brain" / "jax" / name).read_text()
    assert list((tmp_path / "results" / "port").rglob("s_0_checkpoint.pt"))
