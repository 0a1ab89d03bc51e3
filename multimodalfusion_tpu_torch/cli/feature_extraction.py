"""Radiology feature-extraction CLI, stage 1 (port of
multimodalfusion_tpu/cli/feature_extraction.py, a rewrite of ref
feature_extraction.py): per subject and sequence, preprocess the scan,
embed every kept axial slice with the truncated ResNet50, and write
``{output_dir}/{cancer_type}/radio_h5_files/{modality}/{subject}.h5``
(``features`` [N, 1024] float32, ``slice_index`` [N] int64) and a
``radio_pt_files`` ``.pt`` copy of the features: the files that stage-2
training reads (ref feature_extraction.py:57-61, 149-156).

Glioma: NIfTI MRI sequences (FLAIR, T1, T1Gd, T2) named in the CSV's
columns; a subject missing any of them is dropped.  Lung: the CSV's ``CT``
column names a DICOM series directory (the port's own reader) or a NIfTI
file; lung segmentation is classical.  A scan that fails goes to
``not_processed.pkl`` as ``(subject[, modality], error)``; a scan whose
h5 exists is skipped.  The host preprocessing of scan k+1 runs in a
prefetch thread while scan k is embedded.  Subject ids stay text: ``007``
writes ``007.h5``, where the JAX CLI, through pandas, writes ``7.h5``.

Runs on ``cuda`` unless ``--device cpu`` is given.  ``--data_parallel``
under torchrun gives rank r of K every K-th scan of the cohort, then one
collective gathers the failed scans for rank 0's ``not_processed.pkl``:
the PyTorch form of the JAX CLI's batch-sharded trunk with replicated
parameters.  A scan's features depend on that scan alone, so the files
are those of one process.

    python -m multimodalfusion_tpu_torch.cli.feature_extraction \\
        --radio_dir SCANS --csv_path scans.csv --output_dir FEATURES \\
        --cancer_type glioma --weights resnet50.pt [--dtype float32] \\
        [--device cpu]
    torchrun --nproc_per_node=K -m \\
        multimodalfusion_tpu_torch.cli.feature_extraction --data_parallel ...
"""
from __future__ import annotations

import argparse
import csv
import os
import sys
import time
from typing import Dict, List

import numpy as np
import torch.distributed as dist

from multimodalfusion_tpu_torch.data.io import (ensure_dir, save_hdf5,
                                                save_pkl, save_pt)
from multimodalfusion_tpu_torch.data.loaders import prefetch
from multimodalfusion_tpu_torch.data.radiology import (preprocess_glioma_scan,
                                                       preprocess_lung_scan)
from multimodalfusion_tpu_torch.data.survival_dataset import _NA
from multimodalfusion_tpu_torch.extract.features import Embedder
from multimodalfusion_tpu_torch.parallel import mesh as par

GLIOMA_MODALITIES = ["FLAIR", "T1", "T1Gd", "T2"]


def build_parser():
    p = argparse.ArgumentParser(description="Feature Extraction")
    p.add_argument("--radio_dir", type=str, required=True)
    p.add_argument("--csv_path", type=str, required=True)
    p.add_argument("--output_dir", type=str, required=True)
    p.add_argument("--batch_size", type=int, default=128)
    p.add_argument("--data_parallel", action="store_true", default=False,
                   help="shard embedding batches over all visible devices "
                        "(1-D data mesh; params replicated)")
    p.add_argument("--planes", type=str, default="axial")
    p.add_argument("--cancer_type", type=str, default="glioma",
                   choices=["glioma", "lung"])
    p.add_argument("--segment", action="store_true", default=False)
    p.add_argument("--weights", type=str, default=None,
                   help="torch-format ResNet50 state_dict for ImageNet "
                        "parity")
    p.add_argument("--allow_random_weights", action="store_true",
                   default=False,
                   help="proceed with a randomly initialized ResNet50 "
                        "(test/debug only — embeddings are meaningless)")
    p.add_argument("--no_s2d_stem", action="store_true",
                   default=False,
                   help="accepted for the JAX CLI's sake and changes "
                        "nothing: this package runs only the canonical "
                        "7x7/s2 stem, whose outputs the JAX "
                        "space-to-depth stem equals")
    p.add_argument("--dtype", type=str, default="bfloat16",
                   choices=["bfloat16", "float32"],
                   help="conv compute dtype: bfloat16 (autocast, the "
                        "default) or float32 (TF32 off) for reference "
                        "parity")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device to run on (cuda, cuda:1, cpu)")
    return p


def read_scans_csv(path: str, columns: List[str]) -> List[List[str]]:
    """The rows of ``columns`` (``subject_id`` first) whose cells are all
    present, in file order: pandas' ``df[columns].dropna()`` with its
    default NA strings, the ids kept as text."""
    with open(path, newline="") as f:
        reader = csv.DictReader(f)
        missing = [c for c in columns if c not in (reader.fieldnames or [])]
        if missing:
            raise KeyError(f"{path}: no column(s) {missing}")
        rows = [[r[c] for c in columns] for r in reader]
    return [r for r in rows if all(v is not None and v not in _NA
                                   for v in r)]


def _resolve_scan(radio_dir: str, subject: str, fname: str) -> str:
    """Reference layout is radio_dir/<subject>/<filename>
    (ref feature_extraction.py:135,187); fall back to radio_dir/<filename>
    for flat layouts."""
    nested = os.path.join(radio_dir, str(subject), str(fname))
    if os.path.exists(nested):
        return nested
    return os.path.join(radio_dir, str(fname))


def _write_outputs(h5_path: str, pt_path: str, features: np.ndarray,
                   slice_index: np.ndarray):
    save_hdf5(h5_path, {"features": features.astype(np.float32),
                        "slice_index": slice_index.astype(np.int64)},
              mode="w")
    save_pt(pt_path, features.astype(np.float32))


def _scans(args, out_root):
    """(label, h5_path, pt_path, preprocess_thunk) of every scan of the
    cohort, in the CSV's order."""
    if args.cancer_type == "glioma":
        subj_mods: Dict[str, Dict[str, str]] = {}
        for subject, *files in read_scans_csv(
                args.csv_path, ["subject_id"] + GLIOMA_MODALITIES):
            subj_mods[subject] = dict(zip(GLIOMA_MODALITIES, files))
        for m in GLIOMA_MODALITIES:
            ensure_dir(os.path.join(out_root, "radio_h5_files", m))
            ensure_dir(os.path.join(out_root, "radio_pt_files", m))
        return [((subject, modality),
                 os.path.join(out_root, "radio_h5_files", modality,
                              f"{subject}.h5"),
                 os.path.join(out_root, "radio_pt_files", modality,
                              f"{subject}.pt"),
                 lambda p=_resolve_scan(args.radio_dir, subject, fname):
                 preprocess_glioma_scan(p))
                for subject, mods in subj_mods.items()
                for modality, fname in mods.items()]
    # lung CT
    ensure_dir(os.path.join(out_root, "radio_h5_files", "CT"))
    ensure_dir(os.path.join(out_root, "radio_pt_files", "CT"))
    return [((subject,),
             os.path.join(out_root, "radio_h5_files", "CT", f"{subject}.h5"),
             os.path.join(out_root, "radio_pt_files", "CT", f"{subject}.pt"),
             lambda p=_resolve_scan(args.radio_dir, subject, scan_dir):
             preprocess_lung_scan(p, segment_each_slice=args.segment))
            for subject, scan_dir in read_scans_csv(args.csv_path,
                                                    ["subject_id", "CT"])]


def _iter_jobs(args, out_root, shard=(0, 1)):
    """Yield (label, h5_path, pt_path, preprocess_thunk) per pending scan:
    with ``shard`` = (rank, ranks) every ranks-th scan of the cohort from
    the rank-th, counted before the scans whose h5 exists are skipped
    (idempotent, ref :184-186), so the ranks split the cohort alike
    whatever has been written."""
    for i, job in enumerate(_scans(args, out_root)):
        if i % shard[1] == shard[0] and not os.path.exists(job[1]):
            yield job


def _preprocessed(jobs):
    """Run each job's host preprocessing, trapping per-scan failures so a
    bad scan can't kill the prefetch pipeline."""
    for label, h5_path, pt_path, thunk in jobs:
        t0 = time.perf_counter()
        try:
            slices, slice_ids = thunk()
            yield (label, h5_path, pt_path, slices, slice_ids, None,
                   time.perf_counter() - t0)
        except Exception as e:
            yield (label, h5_path, pt_path, None, None, e,
                   time.perf_counter() - t0)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    with par.distributed(args.device, args.data_parallel) as device:
        args.device = device
        with par.quiet_unless_rank0():
            return _run(args)


def _run(args) -> int:
    shard = (0, 1)
    if args.data_parallel:
        if par.world_size() < 2:
            print("--data_parallel: only one device visible, running "
                  "unsharded")
        else:
            shard = (par.rank(), par.world_size())
            print(f"--data_parallel: scans split over {shard[1]} ranks")
    t_start = time.perf_counter()
    embedder = Embedder(weights_path=args.weights,
                        batch_size=args.batch_size,
                        allow_random=args.allow_random_weights,
                        dtype=args.dtype, device=args.device)
    out_root = ensure_dir(os.path.join(args.output_dir, args.cancer_type))
    not_processed = []
    wall = {"preprocess": 0.0, "embed": 0.0, "write": 0.0}
    n_slices = n_scans = 0

    # host preprocessing of scan k+1 overlaps the embedding of scan k
    # (the reference gets this from DataLoader workers, :97-101)
    t_loop = time.perf_counter()
    jobs = _preprocessed(_iter_jobs(args, out_root, shard))
    for label, h5_path, pt_path, slices, slice_ids, err, prep_dt in \
            prefetch(jobs, depth=2):
        name = "/".join(str(p) for p in label)
        wall["preprocess"] += prep_dt
        if err is None:
            try:
                t0 = time.perf_counter()
                feats = embedder.embed_slices(slices)
                t1 = time.perf_counter()
                _write_outputs(h5_path, pt_path, feats, slice_ids)
                t2 = time.perf_counter()
                wall["embed"] += t1 - t0
                wall["write"] += t2 - t1
                n_slices += feats.shape[0]
                n_scans += 1
                print(f"{name}: {feats.shape[0]} slices in "
                      f"{prep_dt + t2 - t0:.1f}s (prep {prep_dt:.1f}s)")
                continue
            except Exception as e:  # per-scan fault isolation
                err = e
        print(f"FAILED {name}: {err}")
        not_processed.append(label + (str(err),))

    if shard[1] > 1:
        # the one barrier: every rank's failures reach rank 0
        parts = [None] * shard[1]
        dist.all_gather_object(parts, not_processed)
        not_processed = [job for part in parts for job in part]
    if not_processed and shard[0] == 0:
        save_pkl(os.path.join(out_root, "not_processed.pkl"), not_processed)
        print(f"{len(not_processed)} scans failed -> not_processed.pkl")
    t_end = time.perf_counter()
    loop = t_end - t_loop
    print(f"stage 1 wall s: {n_scans} scans, {n_slices} slices; preprocess "
          f"{wall['preprocess']:.3f} (prefetch thread), embed "
          f"{wall['embed']:.3f}, write {wall['write']:.3f}, waiting for "
          f"preprocessing {loop - wall['embed'] - wall['write']:.3f}, "
          f"loop {loop:.3f}, total {t_end - t_start:.3f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
