"""Padded/bucketed batching of variable-length MIL bags (port of the numpy
path of multimodalfusion_tpu/data/bags.py).

Each batch of bags is padded to a shared bucketed length and carries a
mask; the bucket ladder keeps the number of distinct shapes small.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np

# bucket ladder for bag lengths: 128 … 65536 by powers of two
_BUCKETS = [128 * (2 ** k) for k in range(10)]


def bucket_len(n: int) -> int:
    """Smallest bucket >= n (at least 128)."""
    for b in _BUCKETS:
        if n <= b:
            return b
    return ((n + _BUCKETS[-1] - 1) // _BUCKETS[-1]) * _BUCKETS[-1]


def pad_bags(bags: Sequence[Optional[np.ndarray]], feat_dim: int,
             dtype=np.float32) -> Tuple[np.ndarray, np.ndarray]:
    """Stack a list of [n_i, D] bags (None = missing modality -> all-pad)
    into (padded [B, N_bucket, D], mask [B, N_bucket])."""
    n_max = max([b.shape[0] for b in bags if b is not None], default=1)
    n_pad = bucket_len(n_max)
    out = np.zeros((len(bags), n_pad, feat_dim), dtype=dtype)
    mask = np.zeros((len(bags), n_pad), dtype=np.float32)
    for i, b in enumerate(bags):
        if b is None or b.shape[0] == 0:
            continue
        n = b.shape[0]
        out[i, :n] = b
        mask[i, :n] = 1.0
    return out, mask
