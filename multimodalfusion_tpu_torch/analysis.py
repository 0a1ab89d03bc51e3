"""Survival analysis and reporting on host arrays (port of
multimodalfusion_tpu/analysis.py, itself a rewrite of the reference's
lifelines/sksurv analyses: ref utils_analysis/evaluation.py KM plots
:197-340, logrank :341-420, bootstrap CI :421-733, load_risk_df
:1448-1471; utils/utils_summary.py:15-120 CV aggregation).

A DataFrame of the JAX package is a dict of numpy columns here, in order,
read and written by ``utils/table.py`` (the machine with the card has no
pandas).  The figures are not drawn (no matplotlib there):
``plot_compare_bar`` and ``plot_km`` return without writing, and
``hazard_histogram`` returns the numbers that matplotlib's ``hist`` would
draw, ``np.histogram``'s.
"""
from __future__ import annotations

import os
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from multimodalfusion_tpu_torch import metrics as metrics_mod
from multimodalfusion_tpu_torch.utils import table

Columns = Dict[str, np.ndarray]


# ---------------------------------------------------------------------------
# Kaplan-Meier curves and the logrank test
# ---------------------------------------------------------------------------

def km_curve(event, time):
    """The KM curve with a step at t=0: (times, survival) to draw as steps."""
    t, s = metrics_mod.kaplan_meier(np.asarray(event, bool),
                                    np.asarray(time, float))
    return np.concatenate([[0.0], t]), np.concatenate([[1.0], s])


def logrank_test(event_a, time_a, event_b, time_b) -> Tuple[float, float]:
    """Two-sample logrank test (Mantel-Haenszel): at each distinct event
    time, group A's events against their hypergeometric expectation.
    Returns (chi2 statistic, p value)."""
    from scipy.stats import chi2 as chi2_dist
    event_a = np.asarray(event_a, bool)
    event_b = np.asarray(event_b, bool)
    time_a = np.asarray(time_a, float)
    time_b = np.asarray(time_b, float)
    ts = np.unique(np.concatenate([time_a[event_a], time_b[event_b]]))
    # at-risk counts by searchsorted on the sorted times, event counts on
    # the sorted event times (this runs inside bootstrap loops)
    sa, sb = np.sort(time_a), np.sort(time_b)
    n_a = len(sa) - np.searchsorted(sa, ts, side="left")
    n_b = len(sb) - np.searchsorted(sb, ts, side="left")
    ea, eb = np.sort(time_a[event_a]), np.sort(time_b[event_b])
    d_a = (np.searchsorted(ea, ts, side="right")
           - np.searchsorted(ea, ts, side="left"))
    d_b = (np.searchsorted(eb, ts, side="right")
           - np.searchsorted(eb, ts, side="left"))
    n = n_a + n_b
    d = d_a + d_b
    ok = n > 1
    n, n_a, n_b, d, d_a = n[ok], n_a[ok], n_b[ok], d[ok], d_a[ok]
    o_minus_e = float(np.sum(d_a - d * n_a / n))
    v = float(np.sum(d * (n_a / n) * (n_b / n) * (n - d) / (n - 1)))
    if v <= 0:
        return 0.0, 1.0
    chi2 = o_minus_e ** 2 / v
    return float(chi2), float(chi2_dist.sf(chi2, df=1))


def risk_groups(risk: np.ndarray, cutoff: Optional[float] = None
                ) -> np.ndarray:
    """High (1) / low (0) risk at ``cutoff``, by default the cohort's
    median risk (ref load_risk_df :1448-1471)."""
    risk = np.asarray(risk, float)
    if cutoff is None:
        cutoff = float(np.median(risk))
    return (risk > cutoff).astype(int)


def hazard2grade(risk: np.ndarray, cuts: Sequence[float]) -> np.ndarray:
    """Each risk's grade among the cutpoints (ref evaluation.py:80-84):
    grade g when cuts[g-1] <= risk < cuts[g]; 0 below cuts[0],
    len(cuts) at or above cuts[-1]."""
    return np.searchsorted(np.asarray(cuts, float), np.asarray(risk, float),
                           side="right")


def stratify_risk(risk: np.ndarray,
                  percentiles: Sequence[float] = (50,)) -> np.ndarray:
    """The grade of each subject among cutpoints at the risk percentiles
    (ref evaluation.py:95-113, 197-361; 0 is the lowest-risk stratum):
    [50] splits at the median, [25, 50, 75] gives quartiles."""
    risk = np.asarray(risk, float)
    return hazard2grade(risk, np.percentile(risk, list(percentiles)))


# ---------------------------------------------------------------------------
# bootstrap confidence intervals
# ---------------------------------------------------------------------------

def bootstrap_cindex_ci(event, time, risk, n_boot: int = 1000,
                        alpha: float = 0.05, seed: int = 0):
    """Percentile bootstrap CI of the censored c-index (ref
    evaluation.py:421-733), drawn from ``np.random.default_rng(seed)`` as
    the JAX package draws it; a resample without an event or a comparable
    pair is skipped.  Returns (cindex, lo, hi)."""
    event = np.asarray(event, bool)
    time = np.asarray(time, float)
    risk = np.asarray(risk, float)
    point = metrics_mod.concordance_index_censored(event, time, risk)[0]
    rng = np.random.default_rng(seed)
    n = len(time)
    stats = []
    for _ in range(n_boot):
        idx = rng.integers(0, n, n)
        try:
            stats.append(metrics_mod.concordance_index_censored(
                event[idx], time[idx], risk[idx])[0])
        except ValueError:
            continue
    if not stats:
        return point, float("nan"), float("nan")
    lo, hi = np.percentile(stats, [100 * alpha / 2, 100 * (1 - alpha / 2)])
    return point, float(lo), float(hi)


# ---------------------------------------------------------------------------
# fold results and summary.csv aggregation (ref utils_summary.py:15-120)
# ---------------------------------------------------------------------------

def load_risk_df(results_pkl: dict) -> Columns:
    """A fold's results dict as per-subject columns, with the event
    indicator and the median-split risk group."""
    df = {k: np.asarray(results_pkl[k])
          for k in ("subject_id", "risk", "survival", "censorship")}
    df["event"] = 1 - df["censorship"]
    df["risk_group"] = risk_groups(df["risk"])
    return df


def _rows(df: Columns, sel: np.ndarray) -> Columns:
    return {k: v[sel] for k, v in df.items()}


def summarize_experiments(results_root: str,
                          pattern: str = "summary.csv") -> Columns:
    """One row per experiment under ``results_root`` whose directory holds
    ``pattern`` (ref utils_summary.py:80-120): the mean and std (ddof 0)
    over its folds of every column ending in ``cindex`` or ``ibs``, NaN
    left out, and ``n_folds``.  Columns in order of first appearance in the
    walk, rows sorted by ``experiment``; no experiment gives an empty
    table."""
    rows = []
    for dirpath, _, files in os.walk(results_root):
        if pattern not in files:
            continue
        df = table.read_csv(os.path.join(dirpath, pattern))
        row = {"experiment": os.path.relpath(
            dirpath, results_root).replace(os.sep, "__")}
        for col, v in df.items():
            if col.endswith("cindex") or col.endswith("ibs"):
                vals = v.astype(float)
                # an all-NaN column (1-subject validation splits) reports
                # NaN without numpy's empty-slice warning; ~isnan, not
                # isfinite, so that an inf surfaces as nanmean reports it
                any_val = (~np.isnan(vals)).any()
                # nanstd of a column holding inf computes inf - inf: its
                # NaN beside the inf mean is the report, not a warning
                with np.errstate(invalid="ignore"):
                    row[f"{col}_mean"] = (float(np.nanmean(vals)) if any_val
                                          else float("nan"))
                    row[f"{col}_std"] = (float(np.nanstd(vals)) if any_val
                                         else float("nan"))
        row["n_folds"] = len(next(iter(df.values()))) if df else 0
        rows.append(row)
    # the columns in the walk's order of first appearance, then the rows
    # sorted
    cols = table.from_records(rows)
    order = sorted(range(len(rows)), key=lambda i: rows[i]["experiment"])
    return {k: v[order] for k, v in cols.items()}


def pivot_summary(summary: Columns,
                  value_col: str = "val_cindex_mean") -> Columns:
    """Model code x cohort pivot of one metric (ref utils_summary.py:
    315-329 pivot_summary): ``summary`` is ``summarize_experiments``'
    table, whose ``experiment`` is the cohort__splits__EXPCODE relpath.
    A relpath of fewer than 3 parts (``results_root`` was a cohort
    directory) goes to the "(root)" column.  The means are rounded to 4
    decimals; the first column is ``model``, as ``to_csv`` writes the
    pivot's index."""
    if not summary or not len(summary["experiment"]):
        return {}
    parts = [str(e).split("__") for e in summary["experiment"]]
    models, cohorts, grid = table.pivot_mean(
        [p[-1] for p in parts],
        [p[0] if len(p) >= 3 else "(root)" for p in parts],
        np.asarray(summary[value_col], float))
    if not models:
        return {"model": np.array([], object)}
    out = {"model": np.array(models, object)}
    out.update({c: grid[:, j] for j, c in enumerate(cohorts)})
    return out


def plot_compare_bar(pivot_df: Columns, out_path: str,
                     value_label: str = "c-index",
                     title: str = "k-fold CV c-index by experiment"):
    """The JAX package's grouped bar comparison of the pivot (ref
    utils_summary.py:330-335 plot_bar) is not drawn: no matplotlib on the
    card's machine.  Writes nothing; returns None."""
    return None


def km_by_risk_group(results_pkl: dict,
                     percentiles: Sequence[float] = (50,)):
    """KM curves of the percentile risk strata and the logrank p of the
    highest against the lowest (ref makeKaplanMeierPlot_Strat / getPValue,
    evaluation.py:95-113, 197-280): for [50] the median split, for [25,
    50, 75] the extreme quartiles (ref getPValue_25_75).  An empty stratum
    has n 0 and no curve."""
    df = load_risk_df(results_pkl)
    strat = stratify_risk(df["risk"], percentiles)
    n_strata = len(percentiles) + 1
    out = {"strata": []}
    for g in range(n_strata):
        sel = _rows(df, strat == g)
        if len(sel["risk"]) == 0:
            out["strata"].append({"n": 0, "curve": None})
            continue
        out["strata"].append({"n": len(sel["risk"]), "curve": km_curve(
            sel["event"], sel["survival"])})
    lo = _rows(df, strat == 0)
    hi = _rows(df, strat == n_strata - 1)
    chi2, p = logrank_test(hi["event"], hi["survival"], lo["event"],
                           lo["survival"])
    out.update({"high": out["strata"][-1]["curve"],
                "low": out["strata"][0]["curve"],
                "logrank_chi2": chi2, "logrank_p": p,
                "n_high": len(hi["risk"]), "n_low": len(lo["risk"]),
                "percentiles": list(percentiles)})
    return out


def pool_folds_by_subject(dfs: Sequence[Columns],
                          overall_func: str = "mean") -> Columns:
    """One row per subject over the folds' result columns: the mean,
    median or max of its risks across the folds that validated it, and
    the survival and censorship of its first row (ref utils_summary.py
    result_plot / overall_cindex), as the JAX package's ``groupby``,
    ``drop_duplicates`` and ``merge`` give them: subjects in
    ``table.group_keys``' order (ids held as text that all read as ints
    sort as numbers, so a numeric cohort pools in one order whichever
    package wrote its results), the risk in its column's dtype."""
    a = {k: np.concatenate([np.asarray(d[k]) for d in dfs])
         for k in ("subject_id", "risk", "censorship", "survival")}
    keys, labels = table.group_keys(a["subject_id"])
    risk = table.kahan_group_reduce(labels, len(keys), a["risk"],
                                    overall_func)
    first = np.full(len(keys), -1, np.int64)
    for row in range(len(labels) - 1, -1, -1):
        first[labels[row]] = row
    ids = np.array(keys, a["subject_id"].dtype if a["subject_id"].dtype
                   .kind in "iuf" else object)
    return {"subject_id": ids, "risk": risk,
            "censorship": a["censorship"][first],
            "survival": a["survival"][first]}


def hazard_histogram(results_df: Columns, out_path: str,
                     cutoff: float = 0.0, zscore: bool = True,
                     bins: int = 15, density: bool = True) -> dict:
    """The hazard histogram of z-scored risks of short- against
    long-surviving uncensored subjects (ref makeHazardHistogram,
    evaluation.py:115-157: by default the cutoff is the median uncensored
    survival in years, the groups split at 12 x cutoff months, censored
    subjects left out of both).  Draws nothing (``out_path`` is not
    written): returns each group's (counts or densities, bin edges), as
    matplotlib's ``hist`` computes them with ``np.histogram``."""
    risk = np.asarray(results_df["risk"])
    if zscore:
        risk = risk.astype(float)
        mu, sd = risk.mean(), risk.std()
        risk = (risk - mu) / (sd if sd > 0 else 1.0)
    censorship = np.asarray(results_df["censorship"])
    survival = np.asarray(results_df["survival"])
    events = censorship == 0
    if cutoff == 0.0:
        cutoff = float(np.median(survival[events])) / 12.0
    low = risk[events & (survival <= 12 * cutoff)]
    high = risk[events & (survival > 12 * cutoff)]
    h_low = h_high = (np.array([]), np.array([]))
    if len(low):
        h_low = np.histogram(low, bins=bins, density=density)
    if len(high):
        h_high = np.histogram(high, bins=bins, density=density)
    return {"cutoff_years": cutoff, "low": h_low, "high": h_high,
            "n_low": len(low), "n_high": len(high)}


def survival_auc(train_event, train_time, test_event, test_time, risk,
                 times=None):
    """The time-dependent AUC, IPCW c-index and Harrell c-index of a
    result set against a training cohort's censoring distribution (ref
    survival_AUC, utils_analysis/evaluation.py:559-580: sksurv's
    cumulative_dynamic_auc, concordance_index_ipcw at tau = times[-1] and
    concordance_index_censored at tied_tol 1e-5).  Test subjects past the
    training cohort's last time are dropped, as the reference drops them;
    the default grid is the 5th to 81st percentile of the test times in
    15 steps.  Returns (iauc, ipcw_cindex, harrell_cindex)."""
    train_event = np.asarray(train_event, bool)
    train_time = np.asarray(train_time, float)
    test_event = np.asarray(test_event, bool)
    test_time = np.asarray(test_time, float)
    risk = np.asarray(risk, float)
    harrell = metrics_mod.concordance_index_censored(
        test_event, test_time, risk, tied_tol=1e-5)[0]
    keep = test_time <= train_time.max()
    test_event, test_time, risk = (test_event[keep], test_time[keep],
                                   risk[keep])
    if len(test_time) == 0 or not test_event.any():
        raise ValueError(
            "no (uncensored) test subjects within the train cohort's "
            "follow-up — check that the cohort CSV and results use the "
            "same time unit")
    if times is None:
        times = np.percentile(test_time, np.linspace(5, 81, 15))
    times = np.asarray(times, float)
    _, iauc = metrics_mod.cumulative_dynamic_auc(
        train_event, train_time, test_event, test_time, risk, times)
    ipcw_c = metrics_mod.concordance_index_ipcw(
        train_event, train_time, test_event, test_time, risk,
        tau=float(times[-1]))[0]
    return float(iauc), float(ipcw_c), float(harrell)


def plot_km(groups: dict, out_path: str, title: str = ""):
    """The JAX package's KM plot of ``km_by_risk_group``'s output is not
    drawn: no matplotlib on the card's machine.  Writes nothing; returns
    None."""
    return None
