"""Global and per-patient attribution plots of genomic features (port of
multimodalfusion_tpu/interpret/explanations.py, the stand-in for the
reference's SHAP beeswarm and "local_bar" explanations, ref
utils_analysis/evaluation.py:1003-1405).

The numeric helpers are numpy and equal the JAX package's outputs
exactly: the percentile colour range with its collapse fallbacks
(``_robust_range``), the beeswarm's quantile-binned jitter
(``beeswarm_offsets``), the power-of-two x-range (``_symmetric_xlim``)
and the beeswarm's plot data (``global_beeswarm_data``).  The machine
with the card has no matplotlib, so the three plot functions draw
nothing and write no file, as ``analysis.plot_km`` does: each returns
what it would have drawn from.
"""
from __future__ import annotations

import math
import os
from typing import Optional, Sequence

import numpy as np


def _robust_range(values: np.ndarray):
    """Percentile colour range with the reference's collapse fallbacks
    (ref evaluation.py:1277-1292): the 5th-95th percentiles, else the
    1st-99th, else min-max; never inverted."""
    vmin = np.nanpercentile(values, 5)
    vmax = np.nanpercentile(values, 95)
    if vmin == vmax:
        vmin = np.nanpercentile(values, 1)
        vmax = np.nanpercentile(values, 99)
        if vmin == vmax:
            vmin = float(np.min(values))
            vmax = float(np.max(values))
    if vmin > vmax:
        vmin = vmax
    return float(vmin), float(vmax)


def beeswarm_offsets(shaps: np.ndarray, row_height: float = 0.4,
                     nbins: int = 100, seed: int = 0) -> np.ndarray:
    """Vertical jitter of one feature row of the beeswarm (ref
    evaluation.py:1049-1060): the attributions binned into ``nbins``
    quantile slots, the points of a bin fanned out alternately above and
    below the row line, scaled into ``0.9 * row_height``.  The
    reference's 1e-6 random tiebreak comes from a numpy generator seeded
    with ``seed``."""
    shaps = np.asarray(shaps, np.float64).reshape(-1)
    n = len(shaps)
    rng = np.random.default_rng(seed)
    quant = np.round(nbins * (shaps - np.min(shaps))
                     / (np.max(shaps) - np.min(shaps) + 1e-8))
    inds = np.argsort(quant + rng.normal(size=n) * 1e-6)
    ys = np.zeros(n)
    layer = 0
    last_bin = -1
    for ind in inds:
        if quant[ind] != last_bin:
            layer = 0
        ys[ind] = np.ceil(layer / 2) * ((layer % 2) * 2 - 1)
        layer += 1
        last_bin = quant[ind]
    ys *= 0.9 * (row_height / np.max(ys + 1))
    return ys


def _symmetric_xlim(attr_abs_max: float):
    """The reference's power-of-two symmetric x-range (ref
    evaluation.py:1010-1015): ceil the largest |attr|, halve while half
    still covers it; ticks every half range."""
    m = float(max(attr_abs_max, 1e-12))
    max_val = max(math.ceil(m), 1.0)
    while max_val / 2.0 > m:
        max_val /= 2.0
    return (-max_val, max_val), max_val / 2.0


def global_beeswarm_data(attr: np.ndarray, features: np.ndarray,
                         ref_features: Optional[np.ndarray] = None,
                         max_display: int = 20, row_height: float = 0.4,
                         seed: int = 0) -> dict:
    """Plot data of the global beeswarm (ref getGlobalShap,
    evaluation.py:1003-1141).  ``attr`` [N, G] signed attributions (the
    dots), ``features`` [N, G] the same samples' values (their colours),
    ``ref_features`` [M, G] the train cohort whose percentile range
    normalises the colours (default ``features``).

    Returns {"feature_order": the rows bottom to top by summed |attr|,
    "xlim", "xtick_stride", "rows": [{feature, pos, shaps, ys, nan_mask,
    cvals, vmin, vmax}, ...]}: ``cvals`` clipped into [vmin, vmax], NaN
    feature values left out of them."""
    attr = np.asarray(attr, np.float64)
    features = np.asarray(features, np.float64)
    if ref_features is None:
        ref_features = features
    ref_features = np.asarray(ref_features, np.float64)
    order = np.argsort(np.sum(np.abs(attr), axis=0))[-max_display:]
    xlim, stride = _symmetric_xlim(np.abs(attr).max() if attr.size else 0.0)
    rows = []
    for pos, i in enumerate(order):
        shaps = attr[:, i]
        values = features[:, i]
        vmin, vmax = _robust_range(ref_features[:, i])
        nan_mask = np.isnan(values)
        cvals = np.clip(values[~nan_mask], vmin, vmax)
        ys = beeswarm_offsets(shaps, row_height=row_height, seed=seed)
        rows.append({"feature": int(i), "pos": pos, "shaps": shaps,
                     "ys": ys, "nan_mask": nan_mask, "cvals": cvals,
                     "vmin": vmin, "vmax": vmax})
    return {"feature_order": order, "xlim": xlim, "xtick_stride": stride,
            "rows": rows}


def global_beeswarm_plot(attr: np.ndarray, features: np.ndarray,
                         gene_names: Sequence[str], save_path: str,
                         ref_features: Optional[np.ndarray] = None,
                         max_display: int = 20, row_height: float = 0.4,
                         alpha: float = 1.0, seed: int = 0) -> dict:
    """The JAX package's beeswarm figure is not drawn (no matplotlib on
    the card's machine): writes nothing to ``save_path`` and returns the
    plot data the figure is drawn from (``global_beeswarm_data``), with
    ``gene_names`` ordered as its rows under "labels"."""
    data = global_beeswarm_data(attr, features, ref_features,
                                max_display=max_display,
                                row_height=row_height, seed=seed)
    data["labels"] = [str(gene_names[i]) for i in data["feature_order"]]
    return data


def local_attr_plot(attr_row: np.ndarray, feat_row: np.ndarray,
                    ref_features: np.ndarray,
                    gene_names: Sequence[str], save_path: str,
                    max_display: int = 20,
                    title: Optional[str] = None) -> dict:
    """The JAX package's per-patient bar plot is not drawn (no matplotlib
    on the card's machine): writes nothing and returns what the plot is
    drawn from.  {"path": ``save_path``, the file JAX writes; "order":
    the genes of the ``max_display`` largest |attr|, ascending; "labels";
    "attr": their signed attributions; "color_frac": each bar's colour in
    [0, 1], the patient's value within the cohort's robust range (0.5
    where it collapses); "xlim": the symmetric x-range; "title"}."""
    attr_row = np.asarray(attr_row, np.float64).reshape(-1)
    feat_row = np.asarray(feat_row, np.float64).reshape(-1)
    order = np.argsort(np.abs(attr_row))[-max_display:]
    frac = []
    for i in order:
        vals = np.concatenate([np.asarray(ref_features[:, i], np.float64),
                               feat_row[i:i + 1]])
        vmin, vmax = _robust_range(vals)
        frac.append(0.5 if vmax == vmin else
                    float((np.clip(feat_row[i], vmin, vmax) - vmin)
                          / (vmax - vmin)))
    xmax = max(float(np.abs(attr_row[order]).max()), 1e-12) * 1.1
    return {"path": save_path, "order": order,
            "labels": [str(gene_names[i]) for i in order],
            "attr": attr_row[order], "color_frac": np.asarray(frac),
            "xlim": (-xmax, xmax),
            "title": title or f"Total attributions: {attr_row.sum():.2f}"}


def local_attr_plots(attr: np.ndarray, features: np.ndarray,
                     subject_ids: Sequence[str],
                     gene_names: Sequence[str], save_dir: str,
                     max_display: int = 20,
                     n_patients: Optional[int] = None) -> list:
    """``local_attr_plot``'s data for each patient, ranked by total
    |attribution| and capped at ``n_patients``, each with the path JAX
    writes (``{id}_local_attr.png`` under ``save_dir``); nothing is drawn
    or written."""
    attr = np.asarray(attr)
    order = np.argsort(-np.abs(attr).sum(axis=1))
    if n_patients is not None:
        order = order[:n_patients]
    return [local_attr_plot(
        attr[i], features[i], features, gene_names,
        os.path.join(save_dir, f"{subject_ids[i]}_local_attr.png"),
        max_display=max_display,
        title=f"{subject_ids[i]} — total attribution {attr[i].sum():.2f}")
        for i in order]
