"""Host-side batch iterators producing fixed-shape (bucketed) numpy
batches (port of multimodalfusion_tpu/data/loaders.py).

Batches are dicts of numpy arrays with static shapes per (batch_size,
bag-bucket) pair; partial batches are padded and masked via ``valid``.
A pretrained view's batches carry the embeddings ``h_radio``, ``h_path``
and ``h_omic`` [B, 256] instead of bags, with no collation library.
A view is a ``SurvivalDataset`` or a ``Split`` of one: anything with
``mode``, ``modalities``, ``pretrained``, ``__len__``, ``probe_present``
and ``get_sample``.  A radiology bag is ``len(modalities) * 1024`` wide
(the sequences side by side, JAX data/loaders.py:119).
Bags are collated by the native library (``data/bags.py``), into the
page-locked buffers of a ``PinnedPool`` when one is given.
"""
from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator, List, Optional

import numpy as np

from multimodalfusion_tpu_torch.data.bags import PinnedPool, pad_bags
from multimodalfusion_tpu_torch.data.survival_dataset import (EMBED_DIM,
                                                               Sample)

# per-instance feature width of stage-1 extraction (truncated ResNet50)
FEAT_DIM = 1024


def _needed(mode: str) -> List[str]:
    return [m for m in ("radio", "path", "omic") if m in mode]


def _usable(present: Dict[str, bool], mode: str) -> bool:
    return all(present.get(m, False) for m in _needed(mode))


def usable_indices(view) -> List[int]:
    """Subjects that have every modality their mode needs (ref
    core_utils.py:185-192 skips the others in its loop): bags by file
    existence, genomic features by a row without NaN.  Every subject of a
    pretrained view (a missing embedding is zeros)."""
    if view.pretrained:
        return list(range(len(view)))
    return [i for i in range(len(view))
            if _usable(view.probe_present(i), view.mode)]


def _batch_from_samples(samples: List[Sample], mode: str, batch_size: int,
                        pool: Optional[PinnedPool] = None,
                        n_path_feat: int = FEAT_DIM,
                        pretrained: bool = False, n_radio_feat: int = 0
                        ) -> Dict[str, np.ndarray]:
    B, n = batch_size, len(samples)
    batch = {"Y": np.zeros(B, np.int32), "t": np.zeros(B, np.float32),
             "c": np.zeros(B, np.float32), "valid": np.zeros(B, np.float32)}
    for i, s in enumerate(samples):
        batch["Y"][i] = s.disc_label
        batch["t"][i] = s.event_time
        batch["c"][i] = s.censorship
    batch["valid"][:n] = 1.0
    batch["subject_ids"] = np.array([s.subject_id for s in samples]
                                    + [""] * (B - n), dtype=object)
    if pretrained:
        # the padding rows stay zeros: MaskedBatchNorm leaves them out of
        # its statistics through `valid`
        for m in ("radio", "path", "omic"):
            h = np.zeros((B, EMBED_DIM), np.float32)
            for i, s in enumerate(samples):
                h[i] = getattr(s, f"h_{m}")
            batch[f"h_{m}"] = h
        return batch
    if "radio" in mode:
        batch["radio_bags"], batch["radio_mask"] = pad_bags(
            [s.radio for s in samples] + [None] * (B - n), n_radio_feat, pool)
    if "path" in mode:
        batch["path_bags"], batch["path_mask"] = pad_bags(
            [s.path for s in samples] + [None] * (B - n), n_path_feat, pool)
    if "omic" in mode:
        G = next((s.omic.shape[0] for s in samples if s.omic is not None), 1)
        genomic = np.zeros((B, G), np.float32)
        for i, s in enumerate(samples):
            if s.omic is not None:
                genomic[i] = s.omic
        batch["genomic"] = genomic
    return batch


def iter_batches(view, batch_size: int = 1, shuffle: bool = False,
                 weighted: bool = False, seed: int = 0,
                 indices: Optional[List[int]] = None,
                 pool: Optional[PinnedPool] = None
                 ) -> Iterator[Dict[str, np.ndarray]]:
    """Yield fixed-shape batches.  The order is the JAX package's for the
    same seed: ``weighted`` replicates the reference's
    WeightedRandomSampler over (bin, censorship) classes (ref
    utils/utils.py:116-117), ``shuffle`` permutes.  A subject whose bag
    exists but fails to load is dropped with a warning instead of being
    collated as a zero bag with valid=1 (a pretrained view drops none).
    With ``pool``, the bags are collated into its page-locked buffers: the
    consumer hands them back (``PinnedPool.release``) once their copy to
    the card is enqueued."""
    if indices is None:
        indices = usable_indices(view)
    if not indices:
        return
    rng = np.random.default_rng(seed)
    order = list(indices)
    if weighted:
        w = view.class_weights()[indices]
        order = list(rng.choice(indices, size=len(indices), replace=True,
                                p=w / w.sum()))
    elif shuffle:
        rng.shuffle(order)
    warned = False
    for start in range(0, len(order), batch_size):
        chunk = order[start:start + batch_size]
        samples = [view.get_sample(i) for i in chunk]
        if view.pretrained:
            yield _batch_from_samples(samples, view.mode, batch_size,
                                      pretrained=True)
            continue
        kept = [s for s in samples if _usable(s.present, view.mode)]
        if len(kept) < len(samples) and not warned:
            bad = [s.subject_id for s in samples
                   if not _usable(s.present, view.mode)]
            print(f"WARNING: dropping samples with unloadable "
                  f"modalities (corrupt files?): {bad[:5]}...")
            warned = True
        if kept:
            yield _batch_from_samples(
                kept, view.mode, batch_size, pool,
                n_radio_feat=len(view.modalities) * FEAT_DIM)


def prefetch(iterator: Iterator, depth: int = 2) -> Iterator:
    """Background-thread prefetch: overlap host-side batch assembly (file
    IO + collation) with device work.  The reference relies on torch
    DataLoader workers for this (ref utils/utils.py:112); here a single
    daemon thread feeds a bounded queue.  A loader error is raised in the
    consumer; an abandoned consumer stops the worker."""
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    end = object()
    stop = threading.Event()

    def _put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        try:
            for item in iterator:
                if not _put(item):
                    return
            _put(end)
        except BaseException as e:  # surface loader errors to consumer
            _put(e)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is end:
                return
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        stop.set()
