"""On-disk artifact IO (port of the ``.pt`` and ``.pkl`` parts of
multimodalfusion_tpu/data/io.py): per-slide bags are torch-serialized
float tensors (ref feature_extraction.py:149-156); fold results are
pickles (ref utils/file_utils.py:22-33)."""
from __future__ import annotations

import os
import pickle

import numpy as np
import torch


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


def ensure_dir(path: str) -> str:
    os.makedirs(path, exist_ok=True)
    return path
