"""Cohort CSVs, labels, splits and per-sample bag loading for pathology
(port of the ``mode="path"`` part of
multimodalfusion_tpu/data/survival_dataset.py, without pandas).

CSVs are read with the stdlib ``csv`` module.  Cells that pandas reads as
missing (its default NA strings) count as missing here too, so the
subject -> slides grouping, the label columns and the split columns follow
the JAX package's order and NaN rules.  Unlike pandas, identifiers stay
text: a numeric ``subject_id`` such as ``007`` keeps its leading zeros.

``SurvivalDataset`` reads a cohort with labels (``n_bins`` given: the
training CLI) or without (``n_bins=None``: the label-free scoring CLI).
"""
from __future__ import annotations

import csv
import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from multimodalfusion_tpu_torch.data import io
from multimodalfusion_tpu_torch.data import labels as labels_mod

# pandas.read_csv's default NA strings
_NA = frozenset({"", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN",
                 "-NaN", "-nan", "1.#IND", "1.#QNAN", "<NA>", "N/A", "NA",
                 "NULL", "NaN", "None", "n/a", "nan", "null"})


@dataclass
class Sample:
    subject_id: str
    path: Optional[np.ndarray] = None      # [N, D] bag
    present: Dict[str, bool] = field(default_factory=dict)
    # labels (0 for a label-free cohort)
    disc_label: int = 0
    event_time: float = 0.0
    censorship: float = 0.0


def _slide_pt_name(slide_id) -> str:
    """slide_id -> its per-slide bag filename.  The reference stores
    '{slide_stem}.pt' for .svs slides (dataset_survival.py:355-367); any
    known slide extension maps the same way."""
    sid = str(slide_id)
    stem, ext = os.path.splitext(sid)
    if ext.lower() in (".svs", ".tiff", ".tif", ".ndpi", ".png", ".jpg",
                       ".mrxs", ".pt"):
        return stem + ".pt"
    return sid + ".pt"


def _float(cell: Optional[str]) -> float:
    return np.nan if cell is None or cell in _NA else float(cell)


def read_cohort(csv_path: str):
    """(subject ids in first-appearance order, subject -> slide ids,
    subject -> its first row).

    A subject's slides are its rows' non-missing ``slide_id`` cells in
    file order; a CSV without that column gets ``<subject_id>.svs``, as
    the JAX serving CLI does.  Rows without a subject id are skipped.  The
    first row of a subject carries its labels, as pandas'
    ``drop_duplicates(["subject_id"])`` keeps it."""
    with open(csv_path, newline="") as f:
        reader = csv.DictReader(f)
        if reader.fieldnames is None or "subject_id" not in reader.fieldnames:
            raise ValueError(f"{csv_path}: no subject_id column")
        has_slides = "slide_id" in reader.fieldnames
        subjects: List[str] = []
        slides: Dict[str, List[str]] = {}
        first: Dict[str, dict] = {}
        for row in reader:
            sid = row["subject_id"]
            if sid in _NA:
                continue
            if sid not in slides:
                subjects.append(sid)
                slides[sid] = []
                first[sid] = row
            slide = row["slide_id"] if has_slides else f"{sid}.svs"
            if slide not in _NA:
                slides[sid].append(slide)
    return subjects, slides, first


class SurvivalDataset:
    """Cohort over pathology bags in ``<data_dir>/path_pt_files/<slide>.pt``.

    With ``n_bins``, the cohort's labels are read and discretized (ref
    Generic_Survival_Dataset.__init__ :14-93): ``disc_label``, ``label``
    (the (bin, censorship) class), event time (``label_col``) and
    censorship per patient; the bin edges come from the uncensored
    patients with ``train == 1``.  Without it, the cohort is label-free.
    """

    def __init__(self, csv_path: str, mode: str = "path",
                 data_dir: Optional[str] = None,
                 n_bins: Optional[int] = None,
                 label_col: str = "survival_months", eps: float = 1e-6,
                 print_info: bool = False):
        if mode != "path":
            raise NotImplementedError(
                f"mode {mode!r}: the port reads pathology bags only so far "
                "(ROADMAP.md, port queue: radio is item 3, omic item 4)")
        self.csv_path = csv_path
        self.mode = mode
        self.data_dir = data_dir
        self.label_col = label_col
        self.patients, self.slides_dict, first = read_cohort(csv_path)
        self.disc_label = self.label = self.event_time = None
        self.censorship = None
        if n_bins is None:
            return
        cols = first[self.patients[0]].keys() if self.patients else ()
        for col in (label_col, "censorship", "train"):
            if col not in cols:
                raise ValueError(f"{csv_path}: no {col!r} column for the "
                                 f"survival labels")
        rows = [first[s] for s in self.patients]
        self.event_time = np.array([_float(r[label_col]) for r in rows])
        self.censorship = np.array([_float(r["censorship"]) for r in rows])
        train = np.array([_float(r["train"]) for r in rows])
        (self.disc_label, self.label, self.bins,
         self.label_dict) = labels_mod.discretize(
            self.event_time, self.censorship, train, n_bins, eps, label_col)
        self.num_classes = len(self.label_dict)
        self.n_bins = len(self.bins) - 1
        if print_info:
            print(f"label column: {label_col}")
            print(f"label dictionary: {self.label_dict}")
            print(f"number of classes: {self.num_classes}")

    @property
    def labelled(self) -> bool:
        return self.disc_label is not None

    def __len__(self):
        return len(self.patients)

    def _slide_paths(self, subject_id: str) -> List[str]:
        if not self.data_dir:
            return []
        return [os.path.join(self.data_dir, "path_pt_files",
                             _slide_pt_name(s))
                for s in self.slides_dict.get(subject_id, [])]

    def probe_present(self, idx: int) -> Dict[str, bool]:
        """Cheap presence probe: file existence only, no array loads."""
        paths = self._slide_paths(self.patients[idx])
        return {"path": any(os.path.exists(p) for p in paths)}

    def get_sample(self, idx: int) -> Sample:
        """The subject's slides concatenated into one bag (ref :355-367),
        with its labels; a slide that fails to load is skipped."""
        s = Sample(subject_id=self.patients[idx])
        if self.labelled:
            s.disc_label = int(self.disc_label[idx])
            s.event_time = float(self.event_time[idx])
            s.censorship = float(self.censorship[idx])
        parts = []
        for p in self._slide_paths(s.subject_id):
            try:
                parts.append(io.load_pt(p))
            except (OSError, ValueError):
                pass
        if parts:
            s.path = np.concatenate(parts, axis=0).astype(np.float32)
        s.present["path"] = s.path is not None
        return s

    # ------------------------------------------------------------------
    # splits
    # ------------------------------------------------------------------

    def _split_from_ids(self, ids: Sequence[str]) -> Optional["Split"]:
        if not ids:
            return None
        wanted = set(ids)
        return Split(self, [i for i, s in enumerate(self.patients)
                            if s in wanted])

    def load_splits(self, csv_path: str, keys=("train", "val")
                    ) -> Tuple[Optional["Split"], ...]:
        """Read a splits_{i}.csv (columns train/val[/test]); a key whose
        column is missing or empty gives None.  A split keeps the cohort's
        patient order, whatever the order of its column (ref
        return_train_val(_test)_splits :141-171)."""
        with open(csv_path, newline="") as f:
            reader = csv.DictReader(f)
            columns = reader.fieldnames or []
            cells = {k: [] for k in keys if k in columns}
            for row in reader:
                for k, ids in cells.items():
                    if row[k] not in _NA and row[k] is not None:
                        ids.append(row[k])
        return tuple(self._split_from_ids(cells[k]) if k in cells else None
                     for k in keys)


class Split:
    """A view over a subset of a labelled cohort's patients (``rows``
    index ``ds.patients``), with lazy bag loading."""

    def __init__(self, ds: SurvivalDataset, rows: List[int]):
        self.ds = ds
        self.rows = list(rows)

    @property
    def mode(self) -> str:
        return self.ds.mode

    def __len__(self):
        return len(self.rows)

    @property
    def labels(self) -> np.ndarray:
        return self.ds.label[self.rows]

    def class_weights(self) -> np.ndarray:
        """Per-sample weights for balanced sampling (ref
        utils_original.py:164-172)."""
        lab = self.labels
        counts = np.bincount(lab, minlength=self.ds.num_classes).astype(
            float)
        return float(len(self.rows)) / counts[lab]

    def probe_present(self, idx: int) -> Dict[str, bool]:
        return self.ds.probe_present(self.rows[idx])

    def get_sample(self, idx: int) -> Sample:
        return self.ds.get_sample(self.rows[idx])
