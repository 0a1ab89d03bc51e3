"""Label-free cohort reader for pathology bags (port of the ``mode="path"``
serving part of multimodalfusion_tpu/data/survival_dataset.py, without
pandas).

The cohort CSV is read with the stdlib ``csv`` module.  Cells that pandas
reads as missing (its default NA strings) count as missing here too, so
the subject -> slides grouping follows the JAX package's order and NaN
rules.  Unlike pandas, identifiers stay text: a numeric ``subject_id``
such as ``007`` keeps its leading zeros.
"""
from __future__ import annotations

import csv
import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from multimodalfusion_tpu_torch.data import io

# pandas.read_csv's default NA strings
_NA = frozenset({"", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN",
                 "-NaN", "-nan", "1.#IND", "1.#QNAN", "<NA>", "N/A", "NA",
                 "NULL", "NaN", "None", "n/a", "nan", "null"})


@dataclass
class Sample:
    subject_id: str
    path: Optional[np.ndarray] = None      # [N, D] bag
    present: Dict[str, bool] = field(default_factory=dict)


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


def read_cohort(csv_path: str):
    """(subject ids in first-appearance order, subject -> slide ids).

    A subject's slides are its rows' non-missing ``slide_id`` cells in
    file order; a CSV without that column gets ``<subject_id>.svs``, as
    the JAX serving CLI does.  Rows without a subject id are skipped."""
    with open(csv_path, newline="") as f:
        reader = csv.DictReader(f)
        if reader.fieldnames is None or "subject_id" not in reader.fieldnames:
            raise ValueError(f"{csv_path}: no subject_id column")
        has_slides = "slide_id" in reader.fieldnames
        subjects: List[str] = []
        slides: Dict[str, List[str]] = {}
        for row in reader:
            sid = row["subject_id"]
            if sid in _NA:
                continue
            if sid not in slides:
                subjects.append(sid)
                slides[sid] = []
            slide = row["slide_id"] if has_slides else f"{sid}.svs"
            if slide not in _NA:
                slides[sid].append(slide)
    return subjects, slides


class SurvivalDataset:
    """Label-free cohort over pathology bags in
    ``<data_dir>/path_pt_files/<slide>.pt``."""

    def __init__(self, csv_path: str, mode: str = "path",
                 data_dir: Optional[str] = None):
        if mode != "path":
            raise NotImplementedError(
                f"mode {mode!r}: the port reads pathology bags only so far "
                "(ROADMAP.md, port queue: radio is item 3, omic item 4)")
        self.csv_path = csv_path
        self.mode = mode
        self.data_dir = data_dir
        self.patients, self.slides_dict = read_cohort(csv_path)

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
        """The subject's slides concatenated into one bag (ref :355-367);
        a slide that fails to load is skipped."""
        s = Sample(subject_id=self.patients[idx])
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
