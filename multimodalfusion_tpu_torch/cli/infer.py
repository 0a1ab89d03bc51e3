"""Label-free scoring CLI (port of multimodalfusion_tpu/cli/infer.py).

Loads a trained stage-2 pathology attention-MIL experiment, reads a cohort
CSV that may lack labels, and writes ``risks.csv`` with one row per
scoreable subject: ``subject_id``, ``risk``, ``hazard_k`` and ``S_k``.
The weights come from the reference-layout ``.pt`` export that JAX
training writes beside every checkpoint
(``s_{k}_minloss_checkpoint.pt``).

Runs on ``cuda`` unless ``--device cpu`` is given; the attention pooling
then goes through the hand-written CUDA kernel.  Other experiment kinds
raise NotImplementedError naming the ROADMAP.md item that ports them.

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
from multimodalfusion_tpu_torch.data.loaders import (iter_batches,
                                                     usable_indices)
from multimodalfusion_tpu_torch.data.survival_dataset import SurvivalDataset
from multimodalfusion_tpu_torch.engine.train import (build_model,
                                                     load_checkpoint,
                                                     model_inputs)
from multimodalfusion_tpu_torch.utils.experiment import (config_from_settings,
                                                         read_settings)


def build_parser():
    p = argparse.ArgumentParser(description="label-free risk scoring")
    p.add_argument("--model_path", type=str, required=True,
                   help="experiment dir (stage-2)")
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
    risk = out["risk"].float().cpu().numpy().reshape(len(sids), -1)
    haz = out["hazards"].float().cpu().numpy().reshape(len(sids), -1)
    S = out["S"].float().cpu().numpy().reshape(len(sids), -1)
    rows = []
    for i, sid in enumerate(sids):
        if not sid or valid[i] == 0:
            continue
        row = {"subject_id": sid, "risk": float(risk[i, 0])}
        row.update({f"hazard_{k}": float(v) for k, v in enumerate(haz[i])})
        row.update({f"S_{k}": float(v) for k, v in enumerate(S[i])})
        rows.append(row)
    return rows


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    exp_code = os.path.basename(os.path.normpath(args.model_path))
    settings = read_settings(os.path.join(args.model_path,
                                          f"experiment_{exp_code}.txt"))
    cfg = config_from_settings(settings, batch_size=args.batch_size)
    model = build_model(cfg)  # raises for the kinds not ported yet
    ds = SurvivalDataset(csv_path=args.csv or settings["csv_path"],
                         mode=settings["mode"],
                         data_dir=args.data_root_dir
                         or settings["data_root_dir"])
    idx = usable_indices(ds)
    if not idx:
        print("no scoreable subjects (missing modalities?)",
              file=sys.stderr)
        return 1
    model = model.to(device).eval()
    load_checkpoint(model, os.path.join(
        args.model_path, f"s_{args.which_k}_minloss_checkpoint.pt"))

    rows = []
    with torch.inference_mode():
        for batch in iter_batches(ds, batch_size=cfg.batch_size,
                                  indices=idx):
            out = model(**model_inputs(cfg, batch, device))
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
