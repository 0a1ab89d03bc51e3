"""Modality attribution CLI (port of
multimodalfusion_tpu/cli/create_attributions.py, a rewrite of the
reference's create_attributions.py): per fold, load the stage-4 head's
``s_{k}_minloss_checkpoint.pt`` (the port's, or the ``.pt`` that JAX
training writes), compute integrated gradients of the risk with respect
to each present modality's embedding over the fold's validation split
(a missing modality is zeros), and write per-subject sums of |attr|
(``attr.csv``) and of attr (``attr_orig.csv``), averaged across folds,
under ``save_dir/{cancer_type}/{split set}/{experiment}``: the JAX CLI's
files, with pandas' layout (``utils/table.py``).  It prints the largest
IG completeness gap of a batch.

The head runs in eval mode (its BatchNorms on their running statistics,
no dropout), as the JAX CLI's ``deterministic=True``.  Stock torch ops:
no kernel.  Runs on ``cuda`` unless ``--device cpu`` is given.

    python -m multimodalfusion_tpu_torch.cli.create_attributions \\
        --model_path S4_EXP [--save_dir ./attributions] [--n_steps 20] \\
        [--batch_size 16] [--device cuda]
"""
from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

from multimodalfusion_tpu_torch import resolve_device
from multimodalfusion_tpu_torch.data.loaders import iter_batches
from multimodalfusion_tpu_torch.data.survival_dataset import (MODALITIES,
                                                              SurvivalDataset)
from multimodalfusion_tpu_torch.interpret.ig import (completeness_gap,
                                                     integrated_gradients)
from multimodalfusion_tpu_torch.utils.experiment import (
    config_from_settings, load_experiment_model, read_experiment)
from multimodalfusion_tpu_torch.utils.table import group_mean, write_csv

_ATTR_COL = {"radio": "radio_attr", "path": "path_attr",
             "omic": "omic_attr"}


def build_parser():
    p = argparse.ArgumentParser(description="IG modality attributions")
    p.add_argument("--model_path", type=str, required=True)
    p.add_argument("--save_dir", type=str, default="./attributions")
    p.add_argument("--n_steps", type=int, default=20)
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device to run on (cuda, cuda:1, cpu)")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    settings = read_experiment(args.model_path)
    mode = settings["mode"]
    present = [m for m in ("radio", "path", "omic") if m in mode]
    dataset = SurvivalDataset(
        settings["csv_path"], mode=mode, data_dir=settings["data_root_dir"],
        n_bins=settings["n_classes"], label_col="survival_months",
        modalities=settings.get("radio_modality", MODALITIES),
        pretrained=True)
    cfg = config_from_settings(settings, batch_size=args.batch_size,
                               pretrained=True, device=args.device)

    ids, attr, attr_orig = [], {m: [] for m in present}, \
        {m: [] for m in present}
    gap = 0.0
    for k in range(settings["num_splits"]):
        _, val_split = dataset.load_splits(os.path.join(
            settings["split_dir"], f"splits_{k}.csv"))
        model = load_experiment_model(args.model_path, k, cfg, device)

        def risk_fn(*embeds):
            kw = dict(zip([f"h_{m}" for m in present], embeds))
            for m in ("radio", "path", "omic"):
                kw.setdefault(f"h_{m}", torch.zeros_like(embeds[0]))
            return model(**kw)["risk"]

        for batch in iter_batches(val_split, batch_size=cfg.batch_size):
            valid = batch["valid"] > 0
            embeds = [torch.from_numpy(batch[f"h_{m}"]).to(device)
                      for m in present]
            attrs = integrated_gradients(risk_fn, embeds,
                                         n_steps=args.n_steps)
            gap = max(gap, completeness_gap(risk_fn, embeds, attrs))
            # the padding rows go before the ids are paired
            ids += list(batch["subject_ids"][valid])
            for m, a in zip(present, attrs):
                a = a.detach().cpu().numpy()[valid]
                attr[m].append(np.abs(a).sum(axis=1))
                attr_orig[m].append(a.sum(axis=1))

    save_path = os.path.join(args.save_dir, settings["cancer_type"],
                             os.path.basename(settings["split_dir"]),
                             os.path.basename(os.path.normpath(
                                 args.model_path)))
    os.makedirs(save_path, exist_ok=True)
    for name, sums in (("attr.csv", attr), ("attr_orig.csv", attr_orig)):
        keys, means = group_mean(ids, {_ATTR_COL[m]: np.concatenate(v)
                                       for m, v in sums.items()})
        write_csv(os.path.join(save_path, name),
                  {"subject_id": keys, **means})
    print(f"wrote attributions for {len(set(ids))} subjects to {save_path}; "
          f"IG completeness gap |sum(attr) - (f(x) - f(0))|, largest over "
          f"batches: {gap:.3e}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
