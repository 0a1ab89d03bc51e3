"""Stage-4 evaluation: c-index and integrated Brier score (port of
multimodalfusion_tpu/engine/evaluate.py, itself a rewrite of ref
utils/core_utils_pretrained.py:393-559 without sksurv)."""
from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np
import torch

from multimodalfusion_tpu_torch import metrics as metrics_mod
from multimodalfusion_tpu_torch import resolve_device
from multimodalfusion_tpu_torch.data.loaders import usable_indices
from multimodalfusion_tpu_torch.engine.train import (TrainConfig,
                                                     build_model,
                                                     load_checkpoint,
                                                     make_optimizer,
                                                     make_steps,
                                                     summary_survival)
from multimodalfusion_tpu_torch.utils.params import spec_from_config


def compute_ibs(train_event, train_time, test_event, test_time, S_bins,
                bins) -> float:
    """IBS at the discrete bin edges with the reference's clamps (ref
    core_utils_pretrained.py:539-556): test times past the training
    maximum are clamped to it; the grid is bins[1:] with its first and
    last points moved just inside the observed test range.  The survival
    columns pair with the grid by position (column k with times[k]), as
    the reference hands them to sksurv: the clamps do not shift them."""
    train_time = np.asarray(train_time, float)
    test_time = np.asarray(test_time, float).copy()
    tmax = train_time.max()
    test_time[test_time > tmax] = tmax
    times = np.asarray(bins[1:], float).copy()
    if times[0] <= test_time.min():
        times[0] = test_time.min() + 0.001
    if times[-1] >= test_time.max():
        times[-1] = test_time.max() - 0.001
    return float(metrics_mod.integrated_brier_score(
        train_event, train_time, test_event, test_time,
        np.asarray(S_bins, np.float64), times))


def summary_survival_ibs(cfg: TrainConfig, split, eval_step, bins,
                         survival_train: Tuple[np.ndarray, np.ndarray],
                         indices=None):
    """(per-subject results, c-index, IBS) of ``split``.  The IBS is NaN
    for a loss outside the nll family; for an nll loss the censoring
    distribution comes from ``survival_train`` = (event, time) of the
    training split, and the results gain the grid ``times`` = bins[1:]."""
    results, cindex = summary_survival(cfg, split, eval_step, indices)
    if "nll" not in cfg.bag_loss:
        return results, cindex, float("nan")
    event = (1 - results["censorship"]).astype(bool)
    ibs = compute_ibs(survival_train[0], survival_train[1], event,
                      results["survival"], results["prob"], bins)
    results["times"] = np.asarray(bins[1:])
    return results, cindex, ibs


def eval_model(datasets, cur: int, cfg: TrainConfig, bins,
               model_path: Optional[str] = None):
    """Load fold ``cur``'s ``s_{cur}_minloss_checkpoint.pt`` and score its
    validation split (and test split, with ``train_val_test``) with the
    c-index and the IBS (ref eval_model :393-474).  For an nll loss the
    censoring distribution is the training split's labels: no forward
    pass over it.  Returns (results_val, val_c, val_ibs[, results_test,
    test_c, test_ibs])."""
    if cfg.split_mode == "train_val_test":
        train_split, val_split, test_split = datasets
    else:
        train_split, val_split = datasets
        test_split = None
    device = resolve_device(cfg.device)
    model = build_model(cfg).to(device)
    load_checkpoint(model, os.path.join(model_path or cfg.results_dir,
                                        f"s_{cur}_minloss_checkpoint.pt"),
                    spec_from_config(cfg))
    _, eval_step = make_steps(cfg, model,
                              make_optimizer(cfg, model.parameters()),
                              device)
    if "nll" in cfg.bag_loss:
        rows = usable_indices(train_split)
        survival_train = (
            (1 - train_split.censorship[rows]).astype(bool),
            train_split.event_time[rows].astype(float))
    else:
        survival_train = (np.zeros(0, bool), np.zeros(0))
    with torch.no_grad():
        out = summary_survival_ibs(cfg, val_split, eval_step, bins,
                                   survival_train)
        if cfg.split_mode == "train_val_test":
            out += summary_survival_ibs(cfg, test_split, eval_step, bins,
                                        survival_train)
    return out
