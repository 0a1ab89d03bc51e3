"""On-disk artifact IO (port of multimodalfusion_tpu/data/io.py):
per-slide bags are torch-serialized float tensors (ref
feature_extraction.py:149-156); radiology bags are feature h5 files with
datasets ``features`` [N, D] float32 and ``slice_index`` [N] (ref
feature_extraction.py:57-61), read and written by the port's own
``data/hdf5.py``, as are the WSI patch coordinates with their
attributes: it reads what h5py writes, in its default format or with
``libver`` "v108" to "latest" and ``track_order`` (every chunk index,
dense groups and attributes, gzip, shuffle, fletcher32 and lzf), and
writes h5py's default format; fold results are pickles (ref
utils/file_utils.py:22-33)."""
from __future__ import annotations

import os
import pickle
from typing import Dict, Optional

import numpy as np
import torch

from multimodalfusion_tpu_torch.data import hdf5


def save_hdf5(output_path: str, asset_dict: Dict[str, np.ndarray],
              attr_dict: Optional[dict] = None, mode: str = "w") -> str:
    """Write a new feature h5 holding one dataset per entry of
    ``asset_dict`` (contiguous; the JAX writer makes chunked resizable
    ones, which read back the same), with ``attr_dict[name]`` as the
    attributes of dataset ``name`` (numbers and ``str``, as the WSI
    patcher writes on ``coords``).  Only mode ``"w"``: no caller of the
    JAX writer appends."""
    if mode != "w":
        raise NotImplementedError(
            f"save_hdf5 mode {mode!r}: the port writes new files only "
            f"(mode 'w'); no caller of the JAX writer appends")
    return hdf5.write(output_path, asset_dict, attr_dict)


def load_features_h5(path: str):
    """(features, slice_index) of a radiology or pathology feature h5, in
    any format ``data/hdf5.py`` reads (h5py's default and its
    ``libver`` "v108" to "latest" layouts, lzf included); slice_index is
    None when the file has none.  A missing, truncated or non-HDF5 file
    raises OSError and a file without ``features`` KeyError, as h5py
    does; so does a corrupt metadata block, with the class h5py raises
    there (``data/hdf5.py``)."""
    with hdf5.File(path) as f:
        features = f["features"]
        slice_index = f["slice_index"] if "slice_index" in f else None
    return features, slice_index


def save_pt(path: str, array: np.ndarray) -> None:
    """Write a torch-format tensor file."""
    torch.save(torch.from_numpy(np.array(array, copy=True)), path)


def load_pt(path: str) -> np.ndarray:
    """Read a torch-format tensor file into numpy (cpu)."""
    t = torch.load(path, map_location="cpu", weights_only=True)
    return np.asarray(t.detach().numpy())


def save_pkl(filename: str, obj) -> None:
    with open(filename, "wb") as f:
        pickle.dump(obj, f)


def load_pkl(filename: str):
    """A pickle of either package: a fold's results are a dict of numpy
    arrays (JAX's ``subject_id`` holds numbers for a numeric cohort, the
    port's holds text)."""
    with open(filename, "rb") as f:
        return pickle.load(f)


def ensure_dir(path: str) -> str:
    os.makedirs(path, exist_ok=True)
    return path
