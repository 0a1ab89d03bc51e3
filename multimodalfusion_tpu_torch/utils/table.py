"""The CSV files that the JAX package reads and writes with pandas, with the
standard library (the machine with the card has no pandas): the layout of
``DataFrame.to_csv`` and of what ``read_csv`` gives for these files, the
means of ``DataFrame.groupby(key).mean()``, and the pivot of the reporting
stage.  A table is a dict of numpy columns, in order.
"""
from __future__ import annotations

import csv
import re
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
    whose first column holds it.)  An empty table writes one empty
    line."""
    if not cols:
        with open(path, "w") as f:
            f.write("\n")
        return
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


def group_keys(ids: Sequence) -> Tuple[list, np.ndarray]:
    """``groupby``'s distinct keys, in its order, and each row's group:
    ids held as numbers sort as numbers; ids held as text sort as pandas
    sorts the column it would read from them (``_sort_key``), and stay
    text."""
    ids = np.asarray(ids)
    if ids.dtype.kind not in "iuf":
        ids = np.array([str(s) for s in ids], object)
    rows = ids.tolist()
    keys = sorted(set(rows), key=None if ids.dtype.kind in "iuf"
                  else _sort_key(rows))
    where = {k: i for i, k in enumerate(keys)}
    return keys, np.array([where[s] for s in rows], np.int64)


def group_mean(ids: Sequence[str], cols: Dict[str, np.ndarray]
               ) -> Tuple[List[str], Dict[str, np.ndarray]]:
    """``DataFrame(cols, index=ids).groupby(level=0).mean()``: the distinct
    ids in ``group_keys``' order (text ids stay text) and each float
    column's mean per id, in the column's dtype, as pandas computes it."""
    keys, labels = group_keys([str(s) for s in ids])
    return keys, {name: kahan_group_reduce(labels, len(keys), v)
                  for name, v in cols.items()}


def from_records(rows: Sequence[dict]) -> Dict[str, np.ndarray]:
    """``pd.DataFrame(rows)``: the columns in order of first appearance; a
    column of ints stays int unless a row lacks it, numbers become floats
    with NaN where a row lacks them, anything else is text (NaN where
    missing)."""
    names: List[str] = []
    for r in rows:
        names += [k for k in r if k not in names]
    out = {}
    for k in names:
        vals = [r.get(k) for r in rows]
        given = [v for v in vals if v is not None]
        if all(isinstance(v, (int, float, np.integer, np.floating))
               and not isinstance(v, (bool, np.bool_)) for v in given):
            if len(given) == len(vals) and all(
                    isinstance(v, (int, np.integer)) for v in vals):
                out[k] = np.array(vals, np.int64)
            else:
                out[k] = np.array([np.nan if v is None else float(v)
                                   for v in vals], np.float64)
        else:
            out[k] = np.array([np.nan if v is None else v for v in vals],
                              object)
    return out


_INT_CELL = re.compile(r"^[+-]?[0-9]+$")
_FLOAT_CELL = re.compile(r"""^[+-]?(?:[0-9]+\.?[0-9]*(?:[eE][+-]?[0-9]+)?
                         |\.[0-9]+(?:[eE][+-]?[0-9]+)?
                         |inf|Inf|INF|[Ii]nfinity|nan|NaN|NAN)$""", re.X)


_BOOL_CELL = {"True": True, "TRUE": True, "true": True, "False": False,
              "FALSE": False, "false": False}


def _column(cells: List[str]) -> np.ndarray:
    """One column as ``read_csv`` types it for these files: int64 when
    every cell is an int, bool when every cell is a boolean (booleans and
    NaN when some are empty), float64 (an empty cell NaN) when every
    filled cell is a number, else text with NaN for the empty cells."""
    filled = [c for c in cells if c != ""]
    if filled and len(filled) == len(cells) and all(
            _INT_CELL.match(c) for c in cells):
        return np.array([int(c) for c in cells], np.int64)
    if filled and all(c in _BOOL_CELL for c in filled):
        if len(filled) == len(cells):
            return np.array([_BOOL_CELL[c] for c in cells], bool)
        return np.array([_BOOL_CELL[c] if c else np.nan for c in cells],
                        object)
    if all(_FLOAT_CELL.match(c) for c in filled):
        return np.array([float(c) if c else np.nan for c in cells],
                        np.float64)
    return np.array([c if c else np.nan for c in cells], object)


def read_csv(path: str) -> Dict[str, np.ndarray]:
    """``pd.read_csv(path)`` for the files of this repo: the header row
    names the columns (an empty name is ``Unnamed: {i}``, as the index
    column of ``to_csv(index=True)`` reads), blank lines are skipped, and
    each column is typed by ``_column``.  Pandas' other NA strings are
    text here, as everywhere in the port."""
    with open(path, newline="") as f:
        lines = [r for r in csv.reader(f) if r]
    if not lines:
        return {}
    names = [h if h else f"Unnamed: {i}" for i, h in enumerate(lines[0])]
    if len(set(names)) != len(names):
        raise ValueError(f"{path}: repeated column names {names}")
    body = lines[1:]
    for r in body:
        if len(r) > len(names):
            raise ValueError(f"{path}: a row of {len(r)} cells under "
                             f"{len(names)} columns")
    return {n: _column([r[i] if i < len(r) else "" for r in body])
            for i, n in enumerate(names)}


def kahan_group_reduce(labels: np.ndarray, n_groups: int,
                       values: np.ndarray, how: str = "mean") -> np.ndarray:
    """What pandas' groupby gives per group of ``labels`` (0..n_groups-1),
    NaN skipped, in ``values``' float dtype: ``mean`` by a compensated sum
    in that dtype in row order (pandas' ``group_mean``), ``median`` in
    float64 cast back, ``max``.  A group with no number is NaN."""
    if how not in ("mean", "median", "max"):
        raise ValueError(f"aggregation {how!r}: mean, median or max")
    values = np.asarray(values)
    dtype = values.dtype if values.dtype.kind == "f" else np.dtype(
        np.float64)
    values = values.astype(dtype)
    out = np.full(n_groups, np.nan, dtype)
    if how == "mean":
        sumx = np.zeros(n_groups, dtype)
        comp = np.zeros(n_groups, dtype)
        nobs = np.zeros(n_groups, np.int64)
        with np.errstate(invalid="ignore"):  # inf - inf resets comp
            for lab, val in zip(labels, values):
                if val != val:
                    continue
                nobs[lab] += 1
                y = val - comp[lab]
                t = sumx[lab] + y
                comp[lab] = t - sumx[lab] - y
                if comp[lab] != comp[lab]:
                    comp[lab] = 0
                sumx[lab] = t
        seen = nobs > 0
        out[seen] = sumx[seen] / nobs[seen].astype(dtype)
        return out
    for g in range(n_groups):
        v = values[labels == g]
        v = v[~np.isnan(v)]
        if len(v):
            out[g] = (np.median(v.astype(np.float64)) if how == "median"
                      else v.max())
    return out


def pivot_mean(index: Sequence[str], columns: Sequence[str],
               values: np.ndarray, decimals: int = 4
               ) -> Tuple[List[str], List[str], np.ndarray]:
    """``DataFrame(...).pivot_table(index=, columns=, values=,
    aggfunc="mean").round(decimals)``: (row keys, column keys, the
    [rows, columns] means).  Keys are sorted; NaN values are left out of
    the means, a cell with none is NaN, and a row or column with no
    number at all is dropped (pandas 3's ``dropna``); the rounding is
    numpy's (half to even)."""
    index, columns = [str(v) for v in index], [str(v) for v in columns]
    rows, cols = sorted(set(index)), sorted(set(columns))
    cell = {(r, c): i for i, (r, c) in enumerate(
        sorted(set(zip(index, columns))))}
    labels = np.array([cell[(r, c)] for r, c in zip(index, columns)],
                      np.int64)
    means = kahan_group_reduce(labels, len(cell), np.asarray(values,
                                                             np.float64))
    grid = np.full((len(rows), len(cols)), np.nan)
    for (r, c), i in cell.items():
        grid[rows.index(r), cols.index(c)] = means[i]
    keep_r = ~np.isnan(grid).all(axis=1)
    keep_c = ~np.isnan(grid).all(axis=0)
    grid = np.round(grid[keep_r][:, keep_c], decimals)
    return ([r for r, k in zip(rows, keep_r) if k],
            [c for c, k in zip(cols, keep_c) if k], grid)
