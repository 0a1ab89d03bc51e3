"""Padded/bucketed batching of variable-length MIL bags (port of
multimodalfusion_tpu/data/bags.py).

Each batch of bags is padded to a shared bucketed length and carries a
mask; the bucket ladder keeps the number of distinct shapes small.
``pad_bags`` collates through the threaded native library
(``multimodalfusion_tpu_torch/native.py``), into page-locked buffers of a
``PinnedPool`` when the batch is bound for a CUDA device.  The numpy
version stays as ``pad_bags_plain``, the oracle of the tests.
``intersect_slices`` aligns the sequences of a radiology bag.
"""
from __future__ import annotations

import threading
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from multimodalfusion_tpu_torch import native

# bucket ladder for bag lengths: 128 … 65536 by powers of two
_BUCKETS = [128 * (2 ** k) for k in range(10)]


def bucket_len(n: int) -> int:
    """Smallest bucket >= n (multiples of 65536 past the ladder)."""
    for b in _BUCKETS:
        if n <= b:
            return b
    return ((n + _BUCKETS[-1] - 1) // _BUCKETS[-1]) * _BUCKETS[-1]


def _padded_len(bags) -> int:
    return bucket_len(max([b.shape[0] for b in bags if b is not None],
                          default=1))


def pad_bags_plain(bags: Sequence[Optional[np.ndarray]], feat_dim: int,
                   dtype=np.float32) -> Tuple[np.ndarray, np.ndarray]:
    """Stack a list of [n_i, D] bags (None = missing modality -> all-pad)
    into (padded [B, N_bucket, D], mask [B, N_bucket]), in numpy."""
    n_pad = _padded_len(bags)
    out = np.zeros((len(bags), n_pad, feat_dim), dtype=dtype)
    mask = np.zeros((len(bags), n_pad), dtype=np.float32)
    for i, b in enumerate(bags):
        if b is None or b.shape[0] == 0:
            continue
        n = b.shape[0]
        out[i, :n] = b
        mask[i, :n] = 1.0
    return out, mask


def pad_bags(bags: Sequence[Optional[np.ndarray]], feat_dim: int,
             pool: Optional["PinnedPool"] = None,
             length: Optional[int] = None
             ) -> Tuple[np.ndarray, np.ndarray]:
    """``pad_bags_plain`` for float32, collated by the native library into
    buffers of ``pool`` (page-locked, for a batch bound for a CUDA device)
    or, without one, into new arrays.  A bag that is not float32
    C-contiguous is converted first.  ``length``: the padded length
    instead of the bucket (a bag-sharded block's; no bag may be
    longer)."""
    bags = [None if b is None else np.ascontiguousarray(b, np.float32)
            for b in bags]
    if length is not None and any(b is not None and b.shape[0] > length
                                  for b in bags):
        raise ValueError(f"a bag is longer than the padded length {length}")
    shape = (len(bags), _padded_len(bags) if length is None else length,
             feat_dim)
    if pool is None:
        out = np.empty(shape, np.float32)
        mask = np.empty(shape[:2], np.float32)
    else:
        out, mask = pool.take(shape), pool.take(shape[:2])
    native.pad_bags_into(bags, out, mask)
    return out, mask


def intersect_slices(features: List[np.ndarray],
                     slice_ids: List[np.ndarray],
                     return_ids: bool = False):
    """Align multi-sequence radiology bags on their common slice ids and
    concatenate them along the feature axis (ref dataset_survival.py:
    346-348; JAX data/bags.py:55-89).

    Row i of the result is slice ``sorted(common)[i]`` of every modality:
    each modality is reindexed to the shared sorted id order (the
    reference's boolean-mask indexing misaligns rows when modalities
    store their slices in different orders).  Duplicate ids within a
    modality raise ValueError.  Returns [N_common, sum(D_m)], plus the
    sorted common ids when ``return_ids`` is set."""
    for s in slice_ids:
        if len(np.unique(s)) != len(s):
            raise ValueError(
                "duplicate slice ids within a modality: "
                f"{np.asarray(s).tolist()}")
    common = set(np.asarray(slice_ids[0]).tolist())
    for s in slice_ids[1:]:
        common &= set(np.asarray(s).tolist())
    common_sorted = np.array(sorted(common))
    aligned = []
    for f, s in zip(features, slice_ids):
        pos = {v: i for i, v in enumerate(np.asarray(s).tolist())}
        order = np.array([pos[v] for v in common_sorted.tolist()],
                         dtype=np.intp)
        aligned.append(np.asarray(f)[order])
    out = np.concatenate(aligned, axis=1)
    if return_ids:
        return out, common_sorted
    return out


def _pinned_empty(shape) -> np.ndarray:
    return torch.empty(shape, dtype=torch.float32, pin_memory=True).numpy()


class PinnedPool:
    """Page-locked float32 host buffers for batches bound for a CUDA
    device, reused by shape and holding at most ``max_bytes`` in all.

    ``take`` hands out a buffer; ``release`` gives buffers back once the
    copies that read them are enqueued: it records one event on that
    stream, and a buffer is handed out again only after its event has
    completed.  When a new buffer would pass ``max_bytes`` and no idle
    buffer can be dropped to make room, ``take`` waits for the oldest
    released buffer of the same shape; failing that, the buffer is
    ordinary memory outside the pool, so a 65,536-row bucket cannot pin
    tens of GB.  (A dropped buffer goes back to PyTorch's own cache of
    page-locked blocks, which serves later allocations of its size.)
    Thread-safe: the loader thread takes, the consumer releases.

    ``alloc`` makes a page-locked array and ``new_event`` an unrecorded
    ``torch.cuda.Event``; tests pass host stand-ins.
    """

    def __init__(self, max_bytes: int = 4 << 30,
                 alloc: Callable[[tuple], np.ndarray] = _pinned_empty,
                 new_event: Callable[[], object] = torch.cuda.Event):
        self.max_bytes = max_bytes
        self._alloc, self._new_event = alloc, new_event
        self._lock = threading.Lock()
        self._idle: Dict[tuple, List[tuple]] = {}  # shape -> [(arr, event)]
        self._out: Dict[int, np.ndarray] = {}      # address -> taken array
        self.held_bytes = 0                        # idle + taken, pooled

    def take(self, shape) -> np.ndarray:
        shape = tuple(int(s) for s in shape)
        nbytes = int(np.prod(shape)) * 4
        with self._lock:
            idle = self._idle.setdefault(shape, [])
            for i, (arr, ev) in enumerate(idle):
                if ev.query():
                    del idle[i]
                    return self._hand_out(arr)
            self._drop_idle(nbytes)
            if self.held_bytes + nbytes <= self.max_bytes:
                self.held_bytes += nbytes
                return self._hand_out(self._alloc(shape))
            if not idle:
                return np.empty(shape, np.float32)
            arr, ev = idle.pop(0)
        ev.synchronize()
        with self._lock:
            return self._hand_out(arr)

    def release(self, arrays: Sequence[np.ndarray], stream=None) -> None:
        """Give back the pool's buffers among ``arrays`` (others are
        ignored) once the copies that read them are enqueued on ``stream``
        (the current stream when None)."""
        with self._lock:
            mine = [self._out.pop(a.ctypes.data) for a in arrays
                    if self._out.get(a.ctypes.data) is a]
        if not mine:
            return
        ev = self._new_event()
        ev.record(stream)
        with self._lock:
            for arr in mine:
                self._idle.setdefault(arr.shape, []).append((arr, ev))

    def _hand_out(self, arr: np.ndarray) -> np.ndarray:
        self._out[arr.ctypes.data] = arr
        return arr

    def _drop_idle(self, nbytes: int) -> None:
        """Drop idle buffers whose copies have completed, largest first,
        until ``nbytes`` more fit under ``max_bytes``."""
        done = sorted(((arr, shape) for shape, idle in self._idle.items()
                       for arr, ev in idle if ev.query()),
                      key=lambda x: -x[0].nbytes)
        for arr, shape in done:
            if self.held_bytes + nbytes <= self.max_bytes:
                return
            self._idle[shape] = [(a, e) for a, e in self._idle[shape]
                                 if a is not arr]
            self.held_bytes -= arr.nbytes
