"""Host-side batch iterators producing fixed-shape (bucketed) numpy
batches (port of the serving part of multimodalfusion_tpu/data/loaders.py).

Batches are dicts of numpy arrays with static shapes per (batch_size,
bag-bucket) pair; partial batches are padded and masked via ``valid``.
"""
from __future__ import annotations

from typing import Dict, Iterator, List, Optional

import numpy as np

from multimodalfusion_tpu_torch.data.bags import pad_bags
from multimodalfusion_tpu_torch.data.survival_dataset import (Sample,
                                                              SurvivalDataset)

# per-instance feature width of stage-1 extraction (truncated ResNet50)
FEAT_DIM = 1024


def usable_indices(ds: SurvivalDataset) -> List[int]:
    """Subjects whose required modalities are present on disk (ref
    core_utils.py:185-192 skips the others in its loop)."""
    return [i for i in range(len(ds))
            if ds.probe_present(i).get(ds.mode, False)]


def _batch_from_samples(samples: List[Sample], batch_size: int,
                        n_path_feat: int = FEAT_DIM
                        ) -> Dict[str, np.ndarray]:
    B, n = batch_size, len(samples)
    valid = np.zeros(B, np.float32)
    valid[:n] = 1.0
    bags, mask = pad_bags([s.path for s in samples] + [None] * (B - n),
                          n_path_feat)
    return {"valid": valid,
            "subject_ids": np.array([s.subject_id for s in samples]
                                    + [""] * (B - n), dtype=object),
            "path_bags": bags, "path_mask": mask}


def iter_batches(ds: SurvivalDataset, batch_size: int = 1,
                 indices: Optional[List[int]] = None
                 ) -> Iterator[Dict[str, np.ndarray]]:
    """Yield fixed-shape batches in subject order (serving never
    shuffles).  A subject whose bag exists but fails to load is dropped
    with a warning instead of being collated as a zero bag with valid=1."""
    if indices is None:
        indices = usable_indices(ds)
    warned = False
    for start in range(0, len(indices), batch_size):
        samples = [ds.get_sample(i)
                   for i in indices[start:start + batch_size]]
        kept = [s for s in samples if s.present.get(ds.mode, False)]
        if len(kept) < len(samples) and not warned:
            bad = [s.subject_id for s in samples
                   if not s.present.get(ds.mode, False)]
            print(f"WARNING: dropping samples with unloadable "
                  f"modalities (corrupt files?): {bad[:5]}...")
            warned = True
        if kept:
            yield _batch_from_samples(kept, batch_size)
