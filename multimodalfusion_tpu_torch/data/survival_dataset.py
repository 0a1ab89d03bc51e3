"""Cohort CSVs, labels, splits, genomic features and per-sample loading
of radiology and pathology bags and genomics (stage 2) or of pretrained
256-d embeddings (stage 4) (port of multimodalfusion_tpu/data/
survival_dataset.py, without pandas, scikit-learn or h5py).

A radiology bag is the subject's per-sequence feature h5 files,
``<data_dir>/radio_h5_files/<modality>/<subject>.h5``, aligned on their
common slice ids (``data/bags.intersect_slices``) and concatenated along
the features in ``modalities`` order.  A subject has one when the CSV's
cells of every modality carry a value and every file loads: an
unreadable file (OSError, KeyError) counts as missing, and so does a
sequence with duplicate slice ids, with a warning (JAX
survival_dataset.py:175-198).

CSVs are read with the stdlib ``csv`` module.  Cells that pandas reads as
missing (its default NA strings) count as missing here too, so the
subject -> slides grouping, the label columns, the genomic columns and the
split columns follow the JAX package's order and NaN rules.  Unlike
pandas, identifiers stay text: a numeric ``subject_id`` such as ``007``
keeps its leading zeros.

``SurvivalDataset`` reads a cohort with labels (``n_bins`` given: the
training CLI) or without (``n_bins=None``: the label-free scoring CLI).
The genomic features belong to a ``Split``: each split holds its rows of
the cohort's genomic columns, z-scored with its fold's training split
(``Scaler``, ``StandardScaler`` semantics).  A mode with ``omic`` is
therefore read through splits (``load_splits``, ``whole_split``).

With ``pretrained=True`` a sample is the subject's embeddings,
``{radio,path,omic}_pt_files/<subject>.pt`` under ``data_dir``: a missing
or unreadable one is zeros with ``present`` False, and a present omic
embedding is min-max scaled per subject when its max exceeds its min
(ref dataset_survival.py:400-418).  Every subject is usable, whatever the
mode, and no genomic column is read.
"""
from __future__ import annotations

import csv
import os
from dataclasses import dataclass, field
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np

from multimodalfusion_tpu_torch.data import io
from multimodalfusion_tpu_torch.data import labels as labels_mod
from multimodalfusion_tpu_torch.data import stratified
from multimodalfusion_tpu_torch.utils import table
from multimodalfusion_tpu_torch.data.bags import intersect_slices

# pandas.read_csv's default NA strings
_NA = frozenset({"", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN",
                 "-NaN", "-nan", "1.#IND", "1.#QNAN", "<NA>", "N/A", "NA",
                 "NULL", "NaN", "None", "n/a", "nan", "null"})

# the cohort CSV's non-genomic columns (JAX survival_dataset.py:25-27);
# the radiology modality columns and the label column join them
METADATA_BASE = ["subject_id", "label", "disc_label", "slide_id"]
METADATA_TAIL = ["oncotree_code", "is_female", "age", "survival_months",
                 "censorship", "train"]
MODALITIES = ("T1", "T2", "T1Gd", "FLAIR")
EMBED_DIM = 256  # a stage-3 embedding's width


@dataclass
class Sample:
    subject_id: str
    radio: Optional[np.ndarray] = None     # [N, n_mod * D] aligned bag
    path: Optional[np.ndarray] = None      # [N, D] bag
    omic: Optional[np.ndarray] = None      # [G] z-scored genomic features
    # pretrained embeddings [256] (zeros when missing)
    h_radio: Optional[np.ndarray] = None
    h_path: Optional[np.ndarray] = None
    h_omic: Optional[np.ndarray] = None
    present: Dict[str, bool] = field(default_factory=dict)
    # labels (0 for a label-free cohort)
    disc_label: int = 0
    event_time: float = 0.0
    censorship: float = 0.0


class Scaler(NamedTuple):
    """``sklearn.preprocessing.StandardScaler`` fitted on float64 columns:
    NaN-ignoring mean, population variance by the corrected two-pass sum,
    scale 1 for a column that sklearn's bound calls constant, NaN kept as
    NaN (an all-NaN column has a NaN mean and scales to NaN)."""
    mean: np.ndarray
    scale: np.ndarray

    @classmethod
    def fit(cls, X: np.ndarray) -> "Scaler":
        X = np.asarray(X, np.float64)
        n = (~np.isnan(X)).sum(axis=0).astype(np.float64)
        with np.errstate(invalid="ignore", divide="ignore"):
            mean = np.nansum(X, axis=0) / n
            dev = X - mean
            correction = np.nansum(dev, axis=0)
            var = (np.nansum(dev ** 2, axis=0) - correction ** 2 / n) / n
        eps = np.finfo(np.float64).eps
        constant = var <= n * eps * var + (n * mean * eps) ** 2
        scale = np.sqrt(var)
        scale[constant] = 1.0
        return cls(mean, scale)

    def transform(self, X: np.ndarray) -> np.ndarray:
        return (np.asarray(X, np.float64) - self.mean) / self.scale


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
    """(column names, subject ids in first-appearance order, subject ->
    slide ids, subject -> its first row).

    A subject's slides are its rows' non-missing ``slide_id`` cells in
    file order; a CSV without that column gets ``<subject_id>.svs``, as
    the JAX serving CLI does.  Rows without a subject id are skipped.  The
    first row of a subject carries its labels and genomic features, as
    pandas' ``drop_duplicates(["subject_id"])`` keeps it."""
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
    return list(reader.fieldnames), subjects, slides, first


class SurvivalDataset:
    """Cohort over radiology bags in ``<data_dir>/radio_h5_files/``,
    pathology bags in ``<data_dir>/path_pt_files/<slide>.pt`` and the
    cohort CSV's genomic columns.

    ``mode`` names the modalities a sample needs: any of ``radio``,
    ``path`` and ``omic`` joined by ``_`` (the JAX CLI's modes).  With
    ``pretrained``, a sample is the subject's three embeddings instead.
    With ``n_bins``, the cohort's labels are read and discretized (ref
    Generic_Survival_Dataset.__init__ :14-93): ``disc_label``, ``label``
    (the (bin, censorship) class), event time (``label_col``) and
    censorship per patient; the bin edges come
    from the uncensored patients with ``train == 1``.  Without it, the
    cohort is label-free.  The genomic columns are every column outside
    ``METADATA_BASE + modalities + METADATA_TAIL + [label_col]``, read as
    float64 from each subject's first row, whatever the mode, as the JAX
    package reads them (their count is the width of the reference's
    genomic SNN, which mm_attention_mil builds in every mode); the
    genomic features of a sample are read in a mode with ``omic``.
    """

    def __init__(self, csv_path: str, mode: str = "path",
                 data_dir: Optional[str] = None,
                 n_bins: Optional[int] = None,
                 label_col: str = "survival_months", eps: float = 1e-6,
                 modalities: Sequence[str] = MODALITIES,
                 print_info: bool = False, pretrained: bool = False):
        if not any(m in mode for m in ("radio", "path", "omic")):
            raise ValueError(f"mode {mode!r} selects no modality (radio, "
                             f"path or omic)")
        self.csv_path = csv_path
        self.mode = mode
        self.pretrained = pretrained
        self.data_dir = data_dir
        self.label_col = label_col
        self.modalities = list(modalities)
        columns, self.patients, self.slides_dict, first = read_cohort(
            csv_path)
        self.columns = columns
        # the label column is always metadata, so a non-default label_col
        # never leaks into the features (JAX survival_dataset.py:291-293)
        metadata = set(METADATA_BASE + self.modalities + METADATA_TAIL
                       + [label_col])
        self.genomic_cols = ([c for c in columns if c not in metadata]
                             if not pretrained else [])
        self.genomic = np.array(
            [[_float(first[s][c]) for c in self.genomic_cols]
             for s in self.patients], np.float64).reshape(
                 len(self.patients), len(self.genomic_cols))
        self.disc_label = self.label = self.event_time = None
        self.censorship = None
        # the CSV's modality cells of each subject's first row (radio)
        self._first = first
        if n_bins is None:
            return
        for col in (label_col, "censorship", "train"):
            if col not in columns:
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

    def _radio_cells_present(self, subject_id: str) -> bool:
        """Do the CSV's cells of every modality carry a value (a missing
        column or a cell pandas reads as NA does not)?  Shared by the probe
        and the loader, as in the JAX package."""
        row = self._first[subject_id]
        return all(row.get(m) is not None and row.get(m) not in _NA
                   for m in self.modalities)

    def _radio_paths(self, subject_id: str) -> List[str]:
        return [os.path.join(self.data_dir, "radio_h5_files", m,
                             f"{subject_id}.h5") for m in self.modalities]

    def probe_present(self, idx: int) -> Dict[str, bool]:
        """Cheap presence probe of the bags: CSV cells and file existence
        only, no array loads (JAX Split.probe_present).  (A split adds the
        genomic features.)  Pretrained: every modality counts as present,
        a missing embedding being zeros."""
        if self.pretrained:
            return {m: True for m in ("radio", "path", "omic")}
        sid = self.patients[idx]
        present = {}
        if "radio" in self.mode:
            present["radio"] = (bool(self.data_dir)
                                and self._radio_cells_present(sid)
                                and all(os.path.exists(p)
                                        for p in self._radio_paths(sid)))
        if "path" in self.mode:
            present["path"] = any(os.path.exists(p)
                                  for p in self._slide_paths(sid))
        return present

    def _load_radio(self, subject_id: str) -> Optional[np.ndarray]:
        """The subject's aligned radiology bag [N, n_mod * D] float32, or
        None: a blank modality cell, a file that fails to load (OSError,
        KeyError) or one without slice ids or with duplicate ones (a
        warning) make it missing (JAX survival_dataset.py:175-198)."""
        if not self.data_dir or not self._radio_cells_present(subject_id):
            return None
        feats, sids = [], []
        try:
            for p in self._radio_paths(subject_id):
                f, si = io.load_features_h5(p)
                if si is None:
                    raise ValueError(f"{p} has no slice_index")
                feats.append(f)
                sids.append(np.asarray(si))
            return intersect_slices(feats, sids).astype(np.float32)
        except (OSError, KeyError):
            return None
        except ValueError as e:
            print(f"WARNING: skipping radio bag for {subject_id}: {e}")
            return None

    def get_sample(self, idx: int) -> Sample:
        """The subject's labels; in a mode with ``radio``, its aligned
        radiology bag; in a mode with ``path``, its slides concatenated
        into one float32 bag (ref :355-367) in one copy, or in none for a
        single float32 slide, a slide that fails to load being skipped.
        (A split adds the genomic features.)"""
        s = Sample(subject_id=self.patients[idx])
        if self.labelled:
            s.disc_label = int(self.disc_label[idx])
            s.event_time = float(self.event_time[idx])
            s.censorship = float(self.censorship[idx])
        if self.pretrained:
            self._load_pretrained(s)
            return s
        if "radio" in self.mode:
            s.radio = self._load_radio(s.subject_id)
            s.present["radio"] = s.radio is not None
        if "path" not in self.mode:
            return s
        parts = []
        for p in self._slide_paths(s.subject_id):
            try:
                parts.append(io.load_pt(p))
            except (OSError, ValueError):
                pass
        if len(parts) == 1:
            s.path = np.ascontiguousarray(parts[0], dtype=np.float32)
        elif parts:
            s.path = np.concatenate(parts, axis=0, dtype=np.float32,
                                    casting="unsafe")
        s.present["path"] = s.path is not None
        return s

    def _load_pretrained(self, s: Sample) -> None:
        """The subject's three embeddings (JAX survival_dataset.py:222-241):
        a file that is missing or does not hold 256 values gives zeros and
        ``present`` False; the omic one is min-max scaled when its max
        exceeds its min (ref dataset_survival.py:416)."""
        for m in ("radio", "path", "omic"):
            p = os.path.join(self.data_dir or "", f"{m}_pt_files",
                             f"{s.subject_id}.pt")
            try:
                h = io.load_pt(p).reshape(EMBED_DIM).astype(np.float32)
                s.present[m] = True
            except (OSError, ValueError):
                h = np.zeros(EMBED_DIM, np.float32)
                s.present[m] = False
            if m == "omic" and s.present[m]:
                lo, hi = h.min(), h.max()
                if hi > lo:
                    h = (h - lo) / (hi - lo)
            setattr(s, f"h_{m}", h)

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
        patient order, whatever the order of its column; every split's
        genomic features are z-scored with the train split's scaler (ref
        return_train_val(_test)_splits :141-171)."""
        cells = read_split_ids(csv_path, keys)
        out = tuple(self._split_from_ids(cells[k]) if k in cells else None
                    for k in keys)
        train = out[keys.index("train")] if "train" in keys else None
        if train is not None and train.genomic_features.size:
            scaler = train.get_scaler()
            for sp in out:
                if sp is not None:
                    sp.apply_scaler(scaler)
        return out

    def whole_split(self, csv_file: Optional[str] = None) -> "Split":
        """Every patient.  With a splits_{i}.csv, the genomic features are
        z-scored with the scaler of its train split (ref
        return_whole_splits :123-138; JAX survival_dataset.py:330-339);
        without one they stay as read."""
        split = Split(self, range(len(self.patients)))
        if csv_file is not None:
            train = self._split_from_ids(
                read_split_ids(csv_file, ("train",)).get("train", []))
            if train is not None and train.genomic_features.size:
                split.apply_scaler(train.get_scaler())
        return split


    # ------------------------------------------------------------------
    # writing splits (JAX survival_dataset.py:341-440)
    # ------------------------------------------------------------------

    def omics_columns(self) -> List[str]:
        return [c for c in self.columns if "_cnv" in c or "_mut" in c]

    def _rows_with(self, cols: Sequence[str], rows=None) -> List[int]:
        """The patients (of ``rows``) whose first row has every cell of
        ``cols`` (pandas' ``dropna(subset=cols)``, which raises KeyError
        for a column the CSV lacks)."""
        missing = [c for c in cols if c not in self.columns]
        if missing:
            raise KeyError(f"{missing} not in {self.csv_path}'s columns")
        rows = range(len(self.patients)) if rows is None else rows
        return [i for i in rows
                if all(self._first[self.patients[i]][c] not in _NA
                       and self._first[self.patients[i]][c] is not None
                       for c in cols)]

    def _strat_splits(self, rows: List[int], how: str,
                      test_size: Optional[float], k: int, seed: int
                      ) -> List[Dict[str, list]]:
        """Stratified train/val columns over ``rows`` by the (bin,
        censorship) class, with the reference's singleton-class fallback
        (ref :268-293): a class of one subject is left out of the split
        and added to fold 0's val and every other fold's train.  Both
        columns are padded to a common length with NaN cells."""
        labels = self.label[rows]
        count = {c: int(n) for c, n in zip(*np.unique(labels,
                                                      return_counts=True))}
        single = [self.patients[r] for r in rows if count[self.label[r]] == 1]
        work = [r for r in rows if count[self.label[r]] > 1]
        ids = np.array([self.patients[r] for r in work], dtype=object)
        y = self.label[work]
        folds = (stratified.stratified_kfold(y, k, seed) if how == "k_fold"
                 else stratified.stratified_shuffle_split(y, k, test_size,
                                                          seed))
        outs = []
        for i, (tr, va) in enumerate(folds):
            cols = {"train": list(ids[tr]), "val": list(ids[va])}
            cols["val" if i == 0 else "train"] += single
            n = max(map(len, cols.values()))
            outs.append({key: v + [np.nan] * (n - len(v))
                         for key, v in cols.items()})
        return outs

    def do_split(self, split: str, split_dir: str, k: int = 5,
                 seed: int = 7, overwrite: bool = True
                 ) -> List[Dict[str, list]]:
        """Write ``splits_{i}.csv`` for i < k into ``split_dir`` (ref
        do_split :173-243), seeded by ``seed`` (the JAX dataset's):

        - ``threemod``: the train == 1 patients with a slide, every
          modality and every omic (``_cnv``/``_mut``) cell; stratified
          k-fold from 120 of them, else k stratified shuffle splits with
          test_size 0.2; when the cohort has train == 0 patients, a
          ``test`` column of those with all three, sorted as pandas'
          ``np.unique`` sorts them (as numbers when every id is one).
        - ``pre_trained``: the patients with the mode's one modality
          (radio, omic or path), less the threemod ones; stratified
          shuffle splits with test_size 0.1.

        Returns the columns of each file."""
        if not self.labelled:
            raise ValueError("do_split needs a labelled cohort (n_bins)")
        omics = self.omics_columns()
        everything = ["slide_id"] + self.modalities + omics
        train = [_float(self._first[s]["train"]) for s in self.patients]
        three = self._rows_with(everything,
                                [i for i, t in enumerate(train) if t == 1])
        os.makedirs(split_dir, exist_ok=True)
        if os.listdir(split_dir) and not overwrite:
            raise FileExistsError(f"splits already exist in {split_dir}")
        if split == "threemod":
            how = "k_fold" if len(three) >= 120 else "shuffle_split"
            splits = self._strat_splits(three, how,
                                        None if how == "k_fold" else 0.2, k,
                                        seed)
            if any(t == 0 for t in train):
                held_out = [self.patients[i] for i in self._rows_with(
                    everything, [i for i, t in enumerate(train) if t == 0])]
                test = sorted(set(held_out), key=table._sort_key(held_out))
                for sp in splits:
                    n = max(len(sp["train"]), len(test))
                    for key in ("train", "val"):
                        sp[key] += [np.nan] * (n - len(sp[key]))
                    sp["test"] = test + [np.nan] * (n - len(test))
        elif split == "pre_trained":
            cols = {"radio": self.modalities, "omic": omics,
                    "path": ["slide_id"]}.get(self.mode)
            if cols is None:
                raise ValueError(self.mode)
            taken = {self.patients[i] for i in three}
            splits = self._strat_splits(
                [i for i in self._rows_with(cols)
                 if self.patients[i] not in taken],
                "shuffle_split", 0.1, k, seed)
        else:
            raise ValueError(split)
        for i, sp in enumerate(splits):
            table.write_csv(os.path.join(split_dir, f"splits_{i}.csv"), sp)
        return splits


def read_split_ids(csv_path: str, keys) -> Dict[str, List[str]]:
    """The non-missing ids of each of ``keys`` that is a column of a
    splits_{i}.csv, in file order."""
    with open(csv_path, newline="") as f:
        reader = csv.DictReader(f)
        columns = reader.fieldnames or []
        cells = {k: [] for k in keys if k in columns}
        for row in reader:
            for k, ids in cells.items():
                if row[k] not in _NA and row[k] is not None:
                    ids.append(row[k])
    return cells


class Split:
    """A view over a subset of a cohort's patients (``rows`` index
    ``ds.patients``), with lazy bag loading and the subset's genomic
    features (float64 [len, G], NaN where a cell is missing)."""

    def __init__(self, ds: SurvivalDataset, rows: Sequence[int]):
        self.ds = ds
        self.rows = list(rows)
        self.genomic_cols = list(ds.genomic_cols)
        self.genomic_features = ds.genomic[self.rows]
        # an all-NaN column marks every subject omic-absent (ref
        # survival_dataset.py:75-87): usually a scan-path column that the
        # modalities did not exclude
        self.all_nan_genomic_cols: List[str] = []
        if self.rows and "omic" in ds.mode:
            all_nan = np.isnan(self.genomic_features).all(axis=0)
            if all_nan.any():
                self.all_nan_genomic_cols = [
                    c for c, b in zip(self.genomic_cols, all_nan) if b]
                print(f"WARNING: genomic columns "
                      f"{self.all_nan_genomic_cols} are entirely NaN in "
                      f"this split — every subject will be treated as "
                      f"omic-absent; if they are scan-path columns, "
                      f"exclude them via --modality (dataset modalities="
                      f"{ds.modalities})")

    @property
    def mode(self) -> str:
        return self.ds.mode

    @property
    def modalities(self) -> List[str]:
        return self.ds.modalities

    @property
    def pretrained(self) -> bool:
        return self.ds.pretrained

    @property
    def event_time(self) -> np.ndarray:
        return self.ds.event_time[self.rows]

    @property
    def censorship(self) -> np.ndarray:
        return self.ds.censorship[self.rows]

    def __len__(self):
        return len(self.rows)

    def get_scaler(self) -> Scaler:
        return Scaler.fit(self.genomic_features)

    def apply_scaler(self, scaler: Scaler) -> None:
        self.genomic_features = scaler.transform(self.genomic_features)

    def reorder_genomic(self, columns: Sequence[str]) -> None:
        """Re-read the (not yet z-scored) genomic features in the order of
        ``columns``, which must hold the same names."""
        if sorted(columns) != sorted(self.genomic_cols):
            raise ValueError(f"genomic columns differ: "
                             f"{sorted(set(columns) ^ set(self.genomic_cols))}")
        pos = {c: i for i, c in enumerate(self.ds.genomic_cols)}
        self.genomic_cols = list(columns)
        self.genomic_features = self.ds.genomic[self.rows][
            :, [pos[c] for c in columns]]

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

    def _omic(self, idx: int) -> Optional[np.ndarray]:
        g = self.genomic_features[idx]
        return None if np.isnan(g).any() else g

    def probe_present(self, idx: int) -> Dict[str, bool]:
        present = self.ds.probe_present(self.rows[idx])
        if "omic" in self.mode and not self.pretrained:
            present["omic"] = self._omic(idx) is not None
        return present

    def get_sample(self, idx: int) -> Sample:
        s = self.ds.get_sample(self.rows[idx])
        if "omic" in self.mode and not self.pretrained:
            g = self._omic(idx)
            s.omic = None if g is None else g.astype(np.float32)
            s.present["omic"] = s.omic is not None
        return s
