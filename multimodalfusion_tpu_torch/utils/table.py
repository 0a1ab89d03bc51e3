"""The CSV files that the JAX package writes with pandas, written with the
standard library (the machine with the card has no pandas): the layout of
``DataFrame.to_csv`` and the means of ``DataFrame.groupby(key).mean()``.
"""
from __future__ import annotations

import csv
from typing import Dict, List, Sequence, Tuple

import numpy as np


def _cell(v) -> str:
    """A value as ``to_csv`` writes it: NaN as an empty cell, a float32 in
    numpy's shortest text for float32, any other float as Python's repr."""
    if isinstance(v, (float, np.floating)):
        if np.isnan(v):
            return ""
        return str(v) if isinstance(v, np.float32) else repr(float(v))
    return str(v)


def write_csv(path: str, cols: Dict[str, Sequence], index: bool = False
              ) -> None:
    """``pd.DataFrame(cols).to_csv(path, index=index)``: with ``index`` an
    unnamed column of row numbers first, then the columns in order.  (A
    frame whose index is named, as after ``groupby``, writes like one
    whose first column holds it.)"""
    n = len(next(iter(cols.values())))
    lead = (lambda i: [i]) if index else (lambda i: [])
    with open(path, "w", newline="") as f:
        w = csv.writer(f, lineterminator="\n")
        w.writerow(([""] if index else []) + list(cols))
        for i in range(n):
            w.writerow(lead(i) + [_cell(v[i]) for v in cols.values()])


def _sort_key(ids: Sequence[str]):
    """Keys of text ids in the order pandas sorts the column it would read
    from them: numbers when every id reads as an int (or else as a
    float), text otherwise."""
    for kind in (int, float):
        try:
            [kind(s) for s in ids]
        except ValueError:
            continue
        return kind
    return str


def group_mean(ids: Sequence[str], cols: Dict[str, np.ndarray]
               ) -> Tuple[List[str], Dict[str, np.ndarray]]:
    """``DataFrame(cols, index=ids).groupby(level=0).mean()``: the distinct
    ids, sorted as pandas sorts their column (the ids stay text), and each
    column's mean per id, in the column's dtype (accumulated in f64)."""
    ids = [str(s) for s in ids]
    keys = sorted(set(ids), key=_sort_key(ids))
    where = {k: i for i, k in enumerate(keys)}
    row = np.array([where[s] for s in ids], np.int64)
    count = np.bincount(row, minlength=len(keys))
    out = {}
    for name, v in cols.items():
        v = np.asarray(v)
        sums = np.bincount(row, weights=v.astype(np.float64),
                           minlength=len(keys))
        out[name] = (sums / count).astype(v.dtype)
    return keys, out
