"""Survival label discretization in numpy (port of
multimodalfusion_tpu/data/labels.py, which uses pandas).

The reference (dataset_survival.py:36-74) computes, per cohort CSV:
  1. quantile bin edges from *uncensored, training* patients
     (``pd.qcut(..., q=n_bins, retbins=True)``): here linear quantiles at
     pandas' own quantile points, with its duplicate-edge check;
  2. widens the outermost edges to cover the full cohort
     (min - eps, max + eps);
  3. assigns every patient a ``disc_label`` with
     ``pd.cut(..., right=False, include_lowest=True)``: here a
     ``searchsorted`` into the edges;
  4. builds a (disc_label, censorship) -> class id dict used for
     weighted sampling.
"""
from __future__ import annotations

import numpy as np


def _quantile_points(q: int) -> np.ndarray:
    """pd.qcut's quantile points: linspace(0, 1, q + 1), rounded up where
    a point is not representable in base 2."""
    qs = np.linspace(0, 1, q + 1)
    np.putmask(qs, q * qs != np.arange(q + 1), np.nextafter(qs, 1))
    return qs


def compute_bins(times, censorship, train, n_bins: int = 4,
                 eps: float = 1e-6, label_col: str = "survival_months"
                 ) -> np.ndarray:
    """Quantile bin edges from uncensored train patients, widened to cover
    the whole cohort (ref dataset_survival.py:37-40).  ``times``,
    ``censorship`` and ``train`` hold one entry per patient.  Refuses,
    with the cause, a cohort that cannot give ``n_bins`` bins."""
    times = np.asarray(times, dtype=np.float64)
    sel = (np.asarray(censorship, dtype=np.float64) < 1) \
        & (np.asarray(train, dtype=np.float64) == 1)
    train_uncensored = times[sel]
    if len(train_uncensored) == 0:
        raise ValueError(
            f"cannot derive {n_bins} survival bins: the train split has "
            "no uncensored patients (binning quantiles come from "
            "uncensored training survival times, "
            "ref dataset_survival.py:38-42)")
    finite = train_uncensored[~np.isnan(train_uncensored)]
    n_distinct = len(np.unique(finite))
    if n_distinct < n_bins:
        raise ValueError(
            f"cannot derive {n_bins} survival bins: uncensored train "
            f"patients have only {n_distinct} distinct '{label_col}' "
            f"value(s); lower --n_classes or check the label column")
    q_bins = np.unique(np.quantile(finite, _quantile_points(n_bins)))
    if len(q_bins) != n_bins + 1:
        # tied quantile edges collapse (heavily tied times)
        raise ValueError(
            f"cannot derive {n_bins} survival bins: quantile edges "
            f"collapse to {len(q_bins) - 1} bins because '{label_col}' "
            "values are heavily tied; lower --n_classes")
    q_bins = q_bins.astype(np.float64)
    q_bins[-1] = np.nanmax(times) + eps
    q_bins[0] = np.nanmin(times) - eps
    return q_bins


def assign_bins(values, q_bins) -> np.ndarray:
    """``pd.cut(values, bins=q_bins, right=False, include_lowest=True)``
    (ref dataset_survival.py:41): half-open bins [edge_k, edge_{k+1}).
    A value outside the edges (pandas gives NaN) is refused."""
    values = np.asarray(values, dtype=np.float64)
    q_bins = np.asarray(q_bins, dtype=np.float64)
    ids = np.searchsorted(q_bins, values, side="right")
    ids[values == q_bins[0]] = 1
    outside = np.isnan(values) | (ids == 0) | (ids == len(q_bins))
    if outside.any():
        raise ValueError(f"values {values[outside][:5]} lie outside the "
                         f"bin edges {q_bins}")
    return (ids - 1).astype(np.int64)


def label_dict(n_bins: int) -> dict:
    """(bin, censorship) -> class id (ref dataset_survival.py:65-71)."""
    d = {}
    k = 0
    for i in range(n_bins):
        for c in (0, 1):
            d[(i, c)] = k
            k += 1
    return d


def discretize(times, censorship, train, n_bins: int = 4,
               eps: float = 1e-6, label_col: str = "survival_months"):
    """The reference's pipeline: returns (disc_label, label, q_bins,
    ldict).  ``label`` is the (bin, censorship) class id used only for
    weighted sampling; the training target Y is ``disc_label``."""
    q_bins = compute_bins(times, censorship, train, n_bins, eps, label_col)
    disc = assign_bins(times, q_bins)
    ldict = label_dict(len(q_bins) - 1)
    cens = np.asarray(censorship, dtype=np.float64).astype(int)
    lab = np.array([ldict[(int(b), int(c))] for b, c in zip(disc, cens)])
    return disc, lab, q_bins, ldict
