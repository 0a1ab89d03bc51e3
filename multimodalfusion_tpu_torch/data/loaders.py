"""Host-side batch iterators producing fixed-shape (bucketed) numpy
batches (port of multimodalfusion_tpu/data/loaders.py).

Batches are dicts of numpy arrays with static shapes per (batch_size,
bag-bucket) pair; partial batches are padded and masked via ``valid``.
A pretrained view's batches carry the embeddings ``h_radio``, ``h_path``
and ``h_omic`` [B, 256] instead of bags, with no collation library.
A view is a ``SurvivalDataset`` or a ``Split`` of one: anything with
``mode``, ``modalities``, ``pretrained``, ``__len__``, ``probe_present``
and ``get_sample``, and ``genomic_cols`` for a genomic mode.  A
radiology bag is ``len(modalities) * 1024`` wide (the sequences side by
side, JAX data/loaders.py:119).
Bags are collated by the native library (``data/bags.py``), into the
page-locked buffers of a ``PinnedPool`` when one is given.

Given a ``Mesh`` (``parallel/mesh.py``), every rank computes the same
global batch order from the seed; on a "data" axis a rank loads and
collates only its block of each global batch's rows (the batch padded to
a multiple of the axis with valid=0 rows), and on a "bag" axis it keeps
its block of each bag's instances (the bag padded to a multiple of the
axis with masked rows), as the JAX package's ``shard_batch_dp_bags``
places a whole batch.  Such a batch records where its rows sit: ``rows``
= [start, stop, batch_size] and ``{kind}_rows`` = [start, stop,
instances].
"""
from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator, List, Optional

import numpy as np

from multimodalfusion_tpu_torch.data.bags import (PinnedPool, bucket_len,
                                                  pad_bags)
from multimodalfusion_tpu_torch.data.survival_dataset import (EMBED_DIM,
                                                               Sample)
from multimodalfusion_tpu_torch.parallel.mesh import (BAG_AXIS, DATA_AXIS,
                                                      block)

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


def _collate(bags: List[Optional[np.ndarray]], feat_dim: int,
             pool: Optional[PinnedPool], bag) -> tuple:
    """(padded bags, mask, [start, stop, instances]): every instance, or
    with ``bag`` = (index, size) of a "bag" mesh axis this rank's block of
    the bucketed instance axis."""
    if bag is None:
        out, mask = pad_bags(bags, feat_dim, pool)
        return out, mask, (0, out.shape[1], out.shape[1])
    N = bucket_len(max([b.shape[0] for b in bags if b is not None],
                       default=1))
    lo, hi = block(N, bag[1], bag[0])
    out, mask = pad_bags([None if b is None else b[lo:hi] for b in bags],
                         feat_dim, pool, length=hi - lo)
    return out, mask, (lo, hi, N)


def _batch_from_samples(samples: List[Optional[Sample]], mode: str,
                        pool: Optional[PinnedPool] = None,
                        n_path_feat: int = FEAT_DIM,
                        pretrained: bool = False, n_radio_feat: int = 0,
                        bag=None, rows=None, n_omic: int = 1
                        ) -> Dict[str, np.ndarray]:
    """One batch of ``len(samples)`` rows; a None sample is a padding row
    (valid 0) and ``n_omic`` the genomic width of a batch of such rows.
    ``bag``/``rows``: this rank's place on a "bag" and a "data" mesh
    axis, recorded in the batch (``{kind}_rows``, ``rows``)."""
    B = len(samples)
    batch = {"Y": np.zeros(B, np.int32), "t": np.zeros(B, np.float32),
             "c": np.zeros(B, np.float32), "valid": np.zeros(B, np.float32)}
    for i, s in enumerate(samples):
        if s is None:
            continue
        batch["Y"][i] = s.disc_label
        batch["t"][i] = s.event_time
        batch["c"][i] = s.censorship
        batch["valid"][i] = 1.0
    batch["subject_ids"] = np.array(["" if s is None else s.subject_id
                                     for s in samples], dtype=object)
    if rows is not None:
        batch["rows"] = np.array(rows, np.int64)
    if pretrained:
        # the padding rows stay zeros: MaskedBatchNorm leaves them out of
        # its statistics through `valid`
        for m in ("radio", "path", "omic"):
            h = np.zeros((B, EMBED_DIM), np.float32)
            for i, s in enumerate(samples):
                if s is not None:
                    h[i] = getattr(s, f"h_{m}")
            batch[f"h_{m}"] = h
        return batch
    for kind, feat in (("radio", n_radio_feat), ("path", n_path_feat)):
        if kind not in mode:
            continue
        bags, mask, span = _collate(
            [None if s is None else getattr(s, kind) for s in samples], feat,
            pool, bag)
        batch[f"{kind}_bags"], batch[f"{kind}_mask"] = bags, mask
        if bag is not None or rows is not None:
            batch[f"{kind}_rows"] = np.array(span, np.int64)
    if "omic" in mode:
        G = next((s.omic.shape[0] for s in samples
                  if s is not None and s.omic is not None), n_omic)
        genomic = np.zeros((B, G), np.float32)
        for i, s in enumerate(samples):
            if s is not None and s.omic is not None:
                genomic[i] = s.omic
        batch["genomic"] = genomic
    return batch


def _axis(mesh, axis: str):
    """(this rank's index, size) of ``mesh``'s ``axis``, or None."""
    if mesh is None or axis not in mesh.axis_names \
            or mesh.shape[axis] < 2:
        return None
    return mesh.index(axis), mesh.shape[axis]


def iter_batches(view, batch_size: int = 1, shuffle: bool = False,
                 weighted: bool = False, seed: int = 0,
                 indices: Optional[List[int]] = None,
                 pool: Optional[PinnedPool] = None, mesh=None
                 ) -> Iterator[Dict[str, np.ndarray]]:
    """Yield fixed-shape batches.  The order is the JAX package's for the
    same seed: ``weighted`` replicates the reference's
    WeightedRandomSampler over (bin, censorship) classes (ref
    utils/utils.py:116-117), ``shuffle`` permutes.  A subject whose bag
    exists but fails to load is dropped with a warning instead of being
    collated as a zero bag with valid=1 (a pretrained view drops none); on
    a "data" mesh axis it becomes a padding row instead, since one rank
    cannot drop a row of the global batch alone.  With ``pool``, the bags
    are collated into its page-locked buffers: the consumer hands them
    back (``PinnedPool.release``) once their copy to the card is enqueued.
    ``mesh``: this rank's rows only (see the module's docstring); every
    rank yields every batch, if need be of padding rows alone."""
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
    data, bag = _axis(mesh, DATA_AXIS), _axis(mesh, BAG_AXIS)
    kw = dict(pool=pool, pretrained=view.pretrained, bag=bag,
              n_radio_feat=len(view.modalities) * FEAT_DIM)
    if "omic" in view.mode and not view.pretrained:
        # a rank's rows of a global batch may all be padding
        kw["n_omic"] = len(view.genomic_cols)
    warned = False
    for start in range(0, len(order), batch_size):
        chunk = order[start:start + batch_size]
        rows = None
        if data is not None:
            rows = block(batch_size, data[1], data[0]) + (batch_size,)
            chunk = [chunk[i] if i < len(chunk) else None
                     for i in range(*rows[:2])]
        samples = [None if i is None else view.get_sample(i) for i in chunk]
        if not view.pretrained:
            bad = [s.subject_id for s in samples
                   if s is not None and not _usable(s.present, view.mode)]
            if bad and not warned:
                print(f"WARNING: dropping samples with unloadable "
                      f"modalities (corrupt files?): {bad[:5]}...")
                warned = True
            samples = [s if s is None or _usable(s.present, view.mode)
                       else None for s in samples]
        if rows is None:
            kept = [s for s in samples if s is not None]
            if not kept:
                continue
            samples = kept + [None] * (batch_size - len(kept))
        yield _batch_from_samples(samples, view.mode, rows=rows, **kw)


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
