"""The port's reporting analyses (multimodalfusion_tpu_torch.analysis)
against the JAX package's (multimodalfusion_tpu.analysis) on the same
seeded numpy inputs, a DataFrame of JAX's being a dict of numpy columns in
the port: values at rtol 1e-12 unless stated, bootstrap CIs and hazard
histograms equal.  Pooling is held with numeric and text ids and with
subjects validated in two folds.  Then both reporting CLIs on synthetic
results trees that reach the CLI's corners: eleven folds (fold 10 pooled
before fold 2), pkls that lack a column or hold no subject, an experiment
of fewer than 4 subjects, a cohort CSV in another time unit
(survival_auc skipped), all-NaN and inf metric columns, experiments with
other columns, and the top-k order with a NaN c-index."""
import os
import pickle

import matplotlib
import numpy as np
import pandas as pd
import pytest

from test_torch_summarize_cli import read_rows, same_cells

from multimodalfusion_tpu import analysis as ja
from multimodalfusion_tpu.cli.summarize import main as jax_summarize
from multimodalfusion_tpu_torch import analysis as ta
from multimodalfusion_tpu_torch.cli.summarize import main as port_summarize

matplotlib.use("Agg")
RTOL = 1e-12


def survival(seed, n=40, censor=0.3):
    rng = np.random.default_rng(seed)
    time = rng.uniform(1, 120, n).round(1)
    event = rng.uniform(size=n) >= censor
    risk = rng.normal(size=n) - 0.01 * time
    return event, time, risk


@pytest.mark.parametrize("seed", range(3))
def test_km_curve_and_logrank(seed):
    e, t, r = survival(seed)
    for got, want in zip(ta.km_curve(e, t), ja.km_curve(e, t)):
        np.testing.assert_allclose(got, want, rtol=RTOL)
    hi = r > np.median(r)
    got = ta.logrank_test(e[hi], t[hi], e[~hi], t[~hi])
    want = ja.logrank_test(e[hi], t[hi], e[~hi], t[~hi])
    np.testing.assert_allclose(got, want, rtol=RTOL)
    # no event anywhere: V = 0 gives (0, 1)
    z = np.zeros(5, bool)
    assert ta.logrank_test(z, t[:5], z, t[5:10]) == \
        ja.logrank_test(z, t[:5], z, t[5:10]) == (0.0, 1.0)


@pytest.mark.parametrize("percentiles", [(50,), (25, 50, 75), (10, 90)])
def test_risk_groups_and_strata(percentiles):
    _, _, r = survival(4)
    np.testing.assert_array_equal(ta.risk_groups(r), ja.risk_groups(r))
    np.testing.assert_array_equal(ta.risk_groups(r, 0.1),
                                  ja.risk_groups(r, 0.1))
    cuts = np.percentile(r, list(percentiles))
    np.testing.assert_array_equal(ta.hazard2grade(r, cuts),
                                  ja.hazard2grade(r, cuts))
    np.testing.assert_array_equal(ta.stratify_risk(r, percentiles),
                                  ja.stratify_risk(r, percentiles))


@pytest.mark.parametrize("seed,n_boot", [(0, 200), (1, 500), (2, 50)])
def test_bootstrap_cindex_ci_is_the_same_draw(seed, n_boot):
    e, t, r = survival(seed, n=25, censor=0.6)
    assert ta.bootstrap_cindex_ci(e, t, r, n_boot=n_boot, seed=seed) == \
        ja.bootstrap_cindex_ci(e, t, r, n_boot=n_boot, seed=seed)


def test_bootstrap_without_a_valid_resample():
    """One event among 5: most resamples have no event (skipped); with
    n_boot=1 none may be left, giving NaN bounds on both sides."""
    e = np.array([1, 0, 0, 0, 0], bool)
    t = np.array([1.0, 2, 3, 4, 5])
    r = np.array([0.5, 0.1, 0.2, 0.3, 0.4])
    for n_boot, seed in ((1, 3), (40, 0)):
        got = ta.bootstrap_cindex_ci(e, t, r, n_boot=n_boot, seed=seed)
        want = ja.bootstrap_cindex_ci(e, t, r, n_boot=n_boot, seed=seed)
        np.testing.assert_array_equal(got, want)


def fold_result(seed, ids, numeric=False, dtype=np.float32):
    """A fold's results dict as both training CLIs write it."""
    rng = np.random.default_rng(seed)
    n = len(ids)
    return {"subject_id": (np.array([int(s) for s in ids]) if numeric
                           else np.array(ids, object)),
            "risk": rng.normal(size=n).astype(dtype),
            "disc_label": rng.integers(0, 4, n).astype(np.int32),
            "survival": rng.uniform(1, 100, n).round(1).astype(np.float32),
            "censorship": (rng.uniform(size=n) < 0.3).astype(np.float32)}


def test_load_risk_df():
    res = fold_result(0, [f"S{i}" for i in range(12)])
    got, want = ta.load_risk_df(res), ja.load_risk_df(res)
    assert list(got) == list(want.columns)
    for k in got:
        np.testing.assert_array_equal(got[k], want[k].to_numpy())


IDS_TEXT = ["b", "a10", "a9", "c", "a1", "b2"]
IDS_NUMERIC = ["10", "9", "007", "100", "5", "18"]


@pytest.mark.parametrize("how", ["mean", "median", "max"])
@pytest.mark.parametrize("ids,numeric", [(IDS_TEXT, False),
                                         (IDS_NUMERIC, False),
                                         (IDS_NUMERIC, True)])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_pool_folds_by_subject(how, ids, numeric, dtype):
    """Three folds over six subjects, four of them validated in two or
    three folds: the subjects in groupby's order (numbers as numbers,
    text ids that all read as ints in numeric order, other text as
    text), the risk aggregated in its dtype, survival and censorship from
    the first frame that holds the subject."""
    folds = [ids[:4], ids[2:], ids[1:3] + ids[4:5]]
    dfs = [fold_result(i, f, numeric, dtype) for i, f in enumerate(folds)]
    got = ta.pool_folds_by_subject(dfs, how)
    want = ja.pool_folds_by_subject(
        [pd.DataFrame({k: d[k] for k in ("subject_id", "risk", "survival",
                                         "censorship")}) for d in dfs], how)
    assert list(got) == ["subject_id", "risk", "censorship", "survival"]
    assert list(got) == list(want.columns)
    if numeric or not all(s.isdigit() for s in ids):
        assert [str(s) for s in got["subject_id"]] == \
            [str(s) for s in want["subject_id"]]
    else:  # text ids that read as ints: JAX holds these as numbers
        assert [int(s) for s in got["subject_id"]] == \
            sorted(int(s) for s in ids)
        return
    assert got["risk"].dtype == want["risk"].dtype == dtype
    np.testing.assert_allclose(got["risk"], want["risk"].to_numpy(),
                               rtol=1e-6 if dtype == np.float32 else RTOL)
    if how == "max":
        np.testing.assert_array_equal(got["risk"], want["risk"].to_numpy())
    for k in ("censorship", "survival"):
        np.testing.assert_array_equal(got[k], want[k].to_numpy())


def test_pooled_mean_is_pandas_bit_for_bit():
    """pandas' compensated group mean, reproduced: 64 folds of one subject
    whose risks span 8 orders of magnitude."""
    rng = np.random.default_rng(3)
    for dtype in (np.float32, np.float64):
        dfs = [{"subject_id": np.array(["a", "b"], object),
                "risk": (rng.normal(size=2) * 10.0 ** rng.integers(
                    -4, 4, 2)).astype(dtype),
                "survival": np.ones(2), "censorship": np.zeros(2)}
               for _ in range(64)]
        got = ta.pool_folds_by_subject(dfs)
        want = ja.pool_folds_by_subject([pd.DataFrame(d) for d in dfs])
        np.testing.assert_array_equal(got["risk"], want["risk"].to_numpy())


@pytest.mark.parametrize("percentiles", [(50,), (25, 50, 75)])
def test_km_by_risk_group(percentiles):
    res = fold_result(5, [f"S{i}" for i in range(30)])
    got = ta.km_by_risk_group(res, percentiles)
    want = ja.km_by_risk_group(res, percentiles)
    assert set(got) == set(want)
    for k in ("logrank_chi2", "logrank_p"):
        np.testing.assert_allclose(got[k], want[k], rtol=RTOL)
    for k in ("n_high", "n_low", "percentiles"):
        assert got[k] == want[k]
    assert [s["n"] for s in got["strata"]] == [s["n"] for s in
                                               want["strata"]]
    for g, w in zip(got["strata"] + [{"curve": got["high"]},
                                     {"curve": got["low"]}],
                    want["strata"] + [{"curve": want["high"]},
                                      {"curve": want["low"]}]):
        for a, b in zip(g["curve"], w["curve"]):
            np.testing.assert_allclose(a, b, rtol=RTOL)


def test_km_by_risk_group_empty_stratum():
    """Tied risks leave the middle strata empty: no curve, n 0; the
    logrank is taken (high, low) as in JAX."""
    res = fold_result(6, [f"S{i}" for i in range(8)])
    res["risk"] = np.array([0, 0, 0, 0, 1, 1, 1, 1], np.float32)
    got = ta.km_by_risk_group(res, (25, 50, 75))
    want = ja.km_by_risk_group(res, (25, 50, 75))
    assert [s["n"] for s in got["strata"]] == \
        [s["n"] for s in want["strata"]]
    assert any(s["curve"] is None for s in got["strata"])
    assert (got["high"] is None) == (want["high"] is None)
    np.testing.assert_allclose([got["logrank_chi2"], got["logrank_p"]],
                               [want["logrank_chi2"], want["logrank_p"]],
                               rtol=RTOL)


@pytest.mark.parametrize("kwargs", [{}, {"cutoff": 4.0},
                                    {"zscore": False, "bins": 7},
                                    {"density": False}])
def test_hazard_histogram_arrays(tmp_path, kwargs):
    """The port draws nothing and returns the arrays of JAX's drawn
    histogram, equal."""
    res = fold_result(8, [f"S{i}" for i in range(40)])
    got = ta.hazard_histogram(res, str(tmp_path / "port.png"), **kwargs)
    want = ja.hazard_histogram(pd.DataFrame(
        {k: res[k] for k in ("subject_id", "risk", "survival",
                             "censorship")}), str(tmp_path / "jax.png"),
        **kwargs)
    assert not (tmp_path / "port.png").exists()
    assert (tmp_path / "jax.png").exists()
    assert got["cutoff_years"] == want["cutoff_years"]
    assert (got["n_low"], got["n_high"]) == (want["n_low"], want["n_high"])
    for side in ("low", "high"):
        for a, b in zip(got[side], want[side]):
            np.testing.assert_array_equal(a, np.asarray(b))


def test_hazard_histogram_one_empty_group(tmp_path):
    res = fold_result(9, [f"S{i}" for i in range(6)])
    res["censorship"][:] = 0
    res["survival"][:] = 10.0
    got = ta.hazard_histogram(res, str(tmp_path / "p.png"))
    want = ja.hazard_histogram(pd.DataFrame(res), str(tmp_path / "j.png"))
    assert got["n_high"] == want["n_high"] == 0
    assert all(len(a) == 0 for a in got["high"])
    for a, b in zip(got["low"], want["low"]):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("seed", range(3))
def test_survival_auc(seed):
    tr_e, tr_t, _ = survival(seed + 10, n=60)
    e, t, r = survival(seed, n=30)
    np.testing.assert_allclose(ta.survival_auc(tr_e, tr_t, e, t, r),
                               ja.survival_auc(tr_e, tr_t, e, t, r),
                               rtol=RTOL)
    times = [20.0, 40.0, 60.0]
    np.testing.assert_allclose(
        ta.survival_auc(tr_e, tr_t, e, t, r, times),
        ja.survival_auc(tr_e, tr_t, e, t, r, times), rtol=RTOL)


def test_survival_auc_drops_and_raises():
    """Test subjects past the train cohort's last time are dropped; none
    left (another time unit) raises ValueError in both."""
    tr_e, tr_t, _ = survival(20, n=60)
    e, t, r = survival(21, n=30)
    t = t * 1.5  # some past the train cohort's follow-up
    np.testing.assert_allclose(ta.survival_auc(tr_e, tr_t, e, t, r),
                               ja.survival_auc(tr_e, tr_t, e, t, r),
                               rtol=RTOL)
    for mod in (ta, ja):
        with pytest.raises(ValueError, match="time unit"):
            mod.survival_auc(tr_e, tr_t / 100.0, e, t, r)


def test_summarize_and_pivot(tmp_path):
    """summarize_experiments over a tree of summary.csv files with
    different columns, an all-NaN column and an inf, and its pivot."""
    cases = {
        "brain/s/PATH_x": ",folds,val_cindex,val_ibs\n0,0,0.6,0.2\n"
                          "1,1,0.7,inf\n",
        "brain/s/OMICS_y": ",folds,val_cindex\n0,0,\n1,1,\n",
        "lung/s/OMICS_y": ",folds,val_cindex,test_cindex\n0,0,0.55,0.5\n"
                          "1,1,0.65,\n2,2,0.61234,0.7\n",
        "s/PATH_x": ",folds,val_cindex\n0,0,0.5\n",
        "PATH_z": ",folds,val_cindex\n0,0,0.51\n",
    }
    for rel, text in cases.items():
        os.makedirs(tmp_path / rel)
        (tmp_path / rel / "summary.csv").write_text(text)
    got = ta.summarize_experiments(str(tmp_path))
    with np.errstate(invalid="ignore"):
        want = ja.summarize_experiments(str(tmp_path))
    assert list(got) == list(want.columns)
    assert list(got["experiment"]) == list(want["experiment"])
    for k in got:
        if k != "experiment":
            np.testing.assert_allclose(got[k], want[k].to_numpy(float),
                                       rtol=RTOL)
    assert got["n_folds"].dtype == want["n_folds"].dtype
    for col in ("val_cindex_mean", "val_cindex_std", "val_ibs_mean"):
        pv_got = ta.pivot_summary(got, col)
        pv_want = ja.pivot_summary(want, col)
        assert list(pv_got) == ["model"] + list(pv_want.columns)
        assert list(pv_got["model"]) == list(pv_want.index)
        for c in pv_want.columns:
            np.testing.assert_array_equal(pv_got[c], pv_want[c].to_numpy())
    assert ta.plot_compare_bar(ta.pivot_summary(got), str(
        tmp_path / "bar.png")) is None
    assert not (tmp_path / "bar.png").exists()
    assert ta.summarize_experiments(str(tmp_path / "brain" / "none")) == {}
    assert ta.pivot_summary({}) == {}


def test_plot_km_writes_nothing(tmp_path):
    res = fold_result(5, [f"S{i}" for i in range(12)])
    assert ta.plot_km(ta.km_by_risk_group(res), str(tmp_path / "km.png"),
                      title="x") is None
    assert not os.listdir(tmp_path)


# ---------------------------------------------------------------------------
# both CLIs on synthetic results trees
# ---------------------------------------------------------------------------

def _write_tree(root):
    """cohort__splits__EXP directories of summary.csv and fold pkls:
    PATH_eleven (11 folds of 3 subjects, fold 10 pooled before fold 2 by
    sorted glob), OMICS_numeric (numeric ids, subjects in two folds),
    RADIO_small (3 subjects: skipped), PATH_partial (a pkl without
    'risk', an empty one, a good one), MMF_censored (no event: NaN
    c-index, first in the folder walk but last in the top-k order)."""
    def put(rel, folds, summary=None):
        d = root / rel
        os.makedirs(d)
        for k, res in folds.items():
            with open(d / f"split_train_val_{k}_results.pkl", "wb") as f:
                pickle.dump(res, f)
        n = len(folds)
        (d / "summary.csv").write_text(summary or (
            ",folds,val_cindex\n" + "".join(
                f"{k},{k},{0.5 + 0.01 * k}\n" for k in range(n))))
    put("c/s/PATH_eleven", {k: fold_result(k, [f"S{3 * k + j}" for j in
                                               range(3)])
                            for k in range(11)})
    ids = [str(5 + 13 * i) for i in range(10)]
    put("c/s/OMICS_numeric", {0: fold_result(20, ids[:7], numeric=True),
                              1: fold_result(21, ids[3:], numeric=True)})
    put("d/s/RADIO_small", {0: fold_result(30, ["a", "b", "c"])})
    bad = fold_result(40, [f"P{i}" for i in range(6)])
    bad.pop("risk")
    empty = fold_result(41, [])
    put("d/s/PATH_partial", {0: bad, 1: empty,
                             2: fold_result(42, [f"P{i}" for i in
                                                 range(6)])})
    cens = fold_result(50, [f"M{i}" for i in range(8)])
    cens["censorship"][:] = 1
    put("a/s/MMF_censored", {0: cens},
        ",folds,val_cindex,val_ibs\n0,0,,0.2\n")


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("synthetic_tree")
    _write_tree(root / "results")
    cohort = root / "cohort.csv"
    rng = np.random.default_rng(60)
    pd.DataFrame({"subject_id": [f"C{i}" for i in range(50)],
                  "survival_months": rng.uniform(1, 100, 50).round(1),
                  "censorship": (rng.uniform(size=50) < 0.3).astype(float)}
                 ).to_csv(cohort, index=False)
    days = root / "cohort_days.csv"
    pd.DataFrame({"survival_months": [0.1, 0.2, 0.3],
                  "censorship": [0.0, 0.0, 1.0]}).to_csv(days, index=False)
    return root


def test_cli_bootstrap_with_no_event_raises_in_both(tree, tmp_path):
    """MMF_censored has no event: the bootstrap's point c-index raises in
    the JAX CLI, and in the port's alike."""
    for name, cli in (("jax", jax_summarize), ("port", port_summarize)):
        with pytest.raises(ValueError, match="All samples are censored"):
            cli(["--results_root", str(tree / "results"), "--save_dir",
                 str(tmp_path / name), "--bootstrap", "10"])


@pytest.mark.parametrize("flags", [
    ["--km", "--pivot", "--hazard_hist"],
    ["--km", "--topk", "2", "--percentiles", "25,50,75",
     "--overall_func", "median"],
    ["--km", "--topk", "1", "--km_thresh", "1.0", "--overall_func", "max"],
], ids=["all", "topk2_quartiles", "topk1_thresh"])
@pytest.mark.parametrize("cohort", ["cohort.csv", "cohort_days.csv"])
def test_cli_corners_agree(tree, tmp_path, capsys, flags, cohort):
    """Both CLIs on the synthetic tree: the same CSVs cell by cell, the
    same pkls skipped, the same survival_auc skips, and a figure line
    printed by the port for each PNG that the JAX CLI draws."""
    outs = {}
    for name, cli in (("jax", jax_summarize), ("port", port_summarize)):
        capsys.readouterr()
        assert cli(["--results_root", str(tree / "results"), "--save_dir",
                    str(tmp_path / name), "--cohort_csv",
                    str(tree / cohort)] + flags) == 0
        outs[name] = capsys.readouterr().out
    for f in ("cv_summary.csv", "risk_group_stats.csv") + (
            ("cv_pivot.csv",) if "--pivot" in flags else ()):
        same_cells(tmp_path / "port" / f, tmp_path / "jax" / f)
    stats = read_rows(tmp_path / "port" / "risk_group_stats.csv")
    assert sorted(r[0] for r in stats[1:]) == [
        "a__s__MMF_censored", "c__s__OMICS_numeric", "c__s__PATH_eleven",
        "d__s__PATH_partial"]
    port_lines = set(outs["port"].splitlines())
    for line in outs["jax"].splitlines():
        if line.startswith("skipping ") or "survival_auc skipped" in line:
            assert line in port_lines, line
    drawn = sorted(f for f in os.listdir(tmp_path / "jax")
                   if f.endswith(".png"))
    named = sorted(w for line in port_lines if " not drawn " in line
                   for w in line.replace(";", " ").split()
                   if w.endswith(".png"))
    assert named == drawn
    if "--topk" in flags:
        k = int(flags[flags.index("--topk") + 1])
        assert len([f for f in drawn if f.endswith("_km.png")]) == k
        assert "a__s__MMF_censored_km.png" not in drawn
