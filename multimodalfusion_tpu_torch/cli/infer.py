"""Label-free scoring CLI (port of multimodalfusion_tpu/cli/infer.py).

Loads a trained stage-2 experiment (``path_attention_mil``,
``radio_attention_mil``, ``max_net`` or ``mm_attention_mil``, in any of
their modes) or stage-4 experiment (a head over pretrained embeddings:
its settings carry ``train_type``), reads a cohort CSV that may lack
labels, and writes ``risks.csv`` with one row per scoreable subject: ``subject_id``,
``risk`` and, for the discrete-hazard heads, ``hazard_k`` and ``S_k``.
The weights come from the reference-layout ``.pt`` export that JAX
training writes beside every checkpoint
(``s_{k}_minloss_checkpoint.pt``).  Genomic inputs are z-scored with the
training fold's scaler, refitted from the experiment's own cohort CSV and
``splits_{k}.csv``, in the training cohort's column order (JAX
cli/infer.py:89-114).  A stage-4 experiment reads the subjects'
embeddings from ``{data_root_dir}/{radio,path,omic}_pt_files/``, a
missing one as zeros, the omic one min-max scaled per subject (JAX
cli/infer.py:76-86); every subject of the cohort is scored.

Radiology bags are read from ``{data_root_dir}/radio_h5_files/`` with
the experiment's sequences (``radio_modality``).  Runs on ``cuda`` unless
``--device cpu`` is given; the attention pooling of each radiology and
pathology branch then goes through the hand-written CUDA kernel, fed
from page-locked buffers.

    python -m multimodalfusion_tpu_torch.cli.infer --model_path EXP \\
        --which_k 0 [--csv COHORT.csv] [--out risks.csv] [--device cuda]
"""
from __future__ import annotations

import argparse
import csv
import os
import sys

import torch

from multimodalfusion_tpu_torch import resolve_device
from multimodalfusion_tpu_torch.data.bags import PinnedPool
from multimodalfusion_tpu_torch.data.loaders import (iter_batches,
                                                     usable_indices)
from multimodalfusion_tpu_torch.data.survival_dataset import (
    MODALITIES, SurvivalDataset, Split, read_split_ids)
from multimodalfusion_tpu_torch.engine.train import (check_supported,
                                                     model_inputs)
from multimodalfusion_tpu_torch.utils.experiment import (
    config_from_settings, load_experiment_model, read_experiment)


def build_parser():
    p = argparse.ArgumentParser(description="label-free risk scoring")
    p.add_argument("--model_path", type=str, required=True,
                   help="experiment dir (stage-2 or stage-4)")
    p.add_argument("--which_k", type=int, default=0,
                   help="fold checkpoint to serve")
    p.add_argument("--csv", type=str, default=None,
                   help="cohort CSV to score (labels optional); default "
                        "= the experiment's own cohort CSV")
    p.add_argument("--data_root_dir", type=str, default=None,
                   help="feature/embedding store root; default = the "
                        "experiment's")
    p.add_argument("--out", type=str, default=None,
                   help="output CSV path (default "
                        "<model_path>/risks_k{which_k}.csv)")
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device to run on (cuda, cuda:1, cpu)")
    return p


def _rows(out, sids, valid):
    """risks.csv rows of one batch: real subjects only."""
    def host(k):
        t = out[k]
        return (None if t is None else
                t.float().cpu().numpy().reshape(len(sids), -1))
    risk, haz, S = host("risk"), host("hazards"), host("S")
    rows = []
    for i, sid in enumerate(sids):
        if not sid or valid[i] == 0:
            continue
        row = {"subject_id": sid, "risk": float(risk[i, 0])}
        if haz is not None:
            row.update({f"hazard_{k}": float(v)
                        for k, v in enumerate(haz[i])})
        if S is not None:
            row.update({f"S_{k}": float(v) for k, v in enumerate(S[i])})
        rows.append(row)
    return rows


def _scored_split(settings: dict, csv_path: str, data_dir: str,
                  which_k: int) -> Split:
    """Every subject of the cohort to score, with its genomic features
    z-scored by the training fold's scaler: refitted on the train split
    of the experiment's own cohort, the cohort's columns reordered to the
    training order (a differing set raises).  For a stage-4 experiment,
    the subjects' embeddings."""
    mode = settings["mode"]
    modalities = settings.get("radio_modality", MODALITIES)
    pretrained = bool(settings.get("train_type"))
    whole = SurvivalDataset(csv_path=csv_path, mode=mode, data_dir=data_dir,
                            modalities=modalities,
                            pretrained=pretrained).whole_split()
    if "omic" in mode and not pretrained:
        train_ds = SurvivalDataset(csv_path=settings["csv_path"], mode=mode,
                                   data_dir=data_dir, modalities=modalities)
        split_csv = os.path.join(settings["split_dir"],
                                 f"splits_{which_k}.csv")
        tr = train_ds._split_from_ids(read_split_ids(split_csv,
                                                     ("train",))["train"])
        if tr.genomic_cols != whole.genomic_cols:
            whole.reorder_genomic(tr.genomic_cols)  # raises on another set
        whole.apply_scaler(tr.get_scaler())
    return whole


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    settings = read_experiment(args.model_path)
    cfg = config_from_settings(settings, batch_size=args.batch_size)
    check_supported(cfg)
    view = _scored_split(settings, args.csv or settings["csv_path"],
                         args.data_root_dir or settings["data_root_dir"],
                         args.which_k)
    # the genomic width: the scored cohort's columns, which a mode with
    # omic has checked against the training cohort's; without omic, the
    # training cohort's (the width of mm_attention_mil's placeholder SNN)
    cfg.omic_input_dim = (view.genomic_features.shape[1]
                          if "omic" in cfg.mode or cfg.pretrained else
                          len(SurvivalDataset(
                              settings["csv_path"], mode=cfg.mode,
                              modalities=cfg.modalities).genomic_cols))
    idx = usable_indices(view)
    if not idx:
        print("no scoreable subjects (missing modalities?)",
              file=sys.stderr)
        return 1
    model = load_experiment_model(args.model_path, args.which_k, cfg, device)

    pool = (PinnedPool() if device.type == "cuda" and not cfg.pretrained
            else None)
    rows = []
    with torch.inference_mode():
        for batch in iter_batches(view, batch_size=cfg.batch_size,
                                  indices=idx, pool=pool):
            out = model(**model_inputs(cfg, batch, device, pool))
            rows += _rows(out, batch["subject_ids"], batch["valid"])

    out_path = args.out or os.path.join(args.model_path,
                                        f"risks_k{args.which_k}.csv")
    with open(out_path, "w", newline="") as f:
        writer = csv.DictWriter(
            f, fieldnames=list(rows[0]) if rows else ["subject_id", "risk"])
        writer.writeheader()
        writer.writerows(rows)
    print(f"scored {len(rows)} subjects -> {out_path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
