"""Stage-4 evaluation CLI: c-index and integrated Brier score of each
fold's minloss checkpoint (port of
multimodalfusion_tpu/cli/eval_pretrained.py, a rewrite of the reference's
eval_pretrained.py).

    python -m multimodalfusion_tpu_torch.cli.eval_pretrained \\
        --model_path EXP [--which_splits S] [--split_mode M] \\
        [--overwrite] [--device cuda]

The settings come from the experiment's ``experiment_{code}.txt`` (read
with ``ast.literal_eval``), the weights from ``s_{k}_minloss_checkpoint.pt``
(the port's, or the ``.pt`` that JAX training writes).  It writes
``eval_val_{k}_results.pkl`` (and ``eval_test_{k}_results.pkl`` with
``train_val_test``) and ``eval_summary.csv``, with the JAX CLI's columns
(``folds``, ``val_cindex``, ``val_ibs``[, ``test_cindex``,
``test_ibs``]) and no index column.  The IBS is NaN outside the nll
family.  An existing ``eval_summary.csv`` is kept unless ``--overwrite``.
Runs on ``cuda`` unless ``--device cpu`` is given.
"""
from __future__ import annotations

import argparse
import os
import sys

import numpy as np

from multimodalfusion_tpu_torch.data.io import save_pkl
from multimodalfusion_tpu_torch.data.survival_dataset import (MODALITIES,
                                                              SurvivalDataset)
from multimodalfusion_tpu_torch.engine.evaluate import eval_model
from multimodalfusion_tpu_torch.utils.experiment import (config_from_settings,
                                                         read_experiment)
from multimodalfusion_tpu_torch.utils.table import write_csv


def build_parser():
    p = argparse.ArgumentParser(description="Evaluate pretrained-head folds")
    p.add_argument("--model_path", type=str, required=True,
                   help="results dir containing experiment_*.txt and "
                        "s_{k}_minloss_checkpoint.pt")
    p.add_argument("--results_dir", type=str, default=None,
                   help="where eval outputs go (default: model_path)")
    p.add_argument("--k_start", type=int, default=-1)
    p.add_argument("--k_end", type=int, default=-1)
    p.add_argument("--batch_size", type=int, default=None)
    p.add_argument("--which_splits", type=str, default=None,
                   help="evaluate against a different split set: replaces "
                        "the last component of the training split_dir "
                        "(ref eval_pretrained.py:97,120)")
    p.add_argument("--split_mode", type=str, default=None,
                   choices=["train_val", "train_val_test"],
                   help="override the training run's split_mode "
                        "(ref eval_pretrained.py:99)")
    p.add_argument("--overwrite", action="store_true", default=False,
                   help="re-evaluate even if eval_summary.csv already "
                        "exists (ref eval_pretrained.py:101,160-162)")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device to run on (cuda, cuda:1, cpu)")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    settings = read_experiment(args.model_path)
    out_dir = args.results_dir or args.model_path
    os.makedirs(out_dir, exist_ok=True)
    summary_path = os.path.join(out_dir, "eval_summary.csv")
    if os.path.exists(summary_path) and not args.overwrite:
        print(f"eval results already exist at {summary_path} — pass "
              "--overwrite to re-evaluate (ref eval_pretrained.py:160)")
        return 0
    if args.which_splits:
        settings["split_dir"] = os.path.join(
            os.path.dirname(os.path.normpath(settings["split_dir"])),
            args.which_splits)
    split_mode = args.split_mode or settings.get("split_mode", "train_val")
    cfg = config_from_settings(
        settings, batch_size=args.batch_size or settings.get("batch_size", 1),
        results_dir=args.model_path, split_mode=split_mode, pretrained=True,
        device=args.device)
    dataset = SurvivalDataset(
        settings["csv_path"], mode=settings["mode"],
        data_dir=settings["data_root_dir"], n_bins=settings["n_classes"],
        label_col="survival_months",
        modalities=settings.get("radio_modality", MODALITIES),
        print_info=True, pretrained=True)

    k = settings["num_splits"]
    start = 0 if args.k_start == -1 else args.k_start
    end = k if args.k_end == -1 else args.k_end
    keys = (("train", "val", "test") if split_mode == "train_val_test"
            else ("train", "val"))
    rows = []
    for i in range(start, end):
        splits = dataset.load_splits(
            os.path.join(settings["split_dir"], f"splits_{i}.csv"), keys)
        out = eval_model(splits, i, cfg, dataset.bins,
                         model_path=args.model_path)
        row = {"folds": i, "val_cindex": out[1], "val_ibs": out[2]}
        if split_mode == "train_val_test":
            row.update(test_cindex=out[4], test_ibs=out[5])
            save_pkl(os.path.join(out_dir, f"eval_test_{i}_results.pkl"),
                     out[3])
        save_pkl(os.path.join(out_dir, f"eval_val_{i}_results.pkl"), out[0])
        rows.append(row)
        print(f"fold {i}: " + ", ".join(
            f"{k2}={v:.4f}" if isinstance(v, float) else f"{k2}={v}"
            for k2, v in row.items()))

    cols = {c: [r[c] for r in rows] for c in rows[0]}
    write_csv(summary_path, cols)
    print("mean:", {c: float(np.nanmean(v)) for c, v in cols.items()
                    if c != "folds"})
    return 0


if __name__ == "__main__":
    sys.exit(main())
