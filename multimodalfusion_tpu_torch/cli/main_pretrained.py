"""Stage 4: k-fold training of the fusion heads over pretrained 256-d
embeddings (port of multimodalfusion_tpu/cli/main_pretrained.py, itself
flag-compatible with the reference's main_pretrained.py).

    python -m multimodalfusion_tpu_torch.cli.main_pretrained \\
        --model_type mm_attention_mil --mode path_omic \\
        --train_type kronecker --bag_loss nll_surv \\
        --data_root_dir pretrained_feature ... [--device cuda]

``--model_type mm_attention_mil`` trains a multimodal head
(``late-fcnn``, ``late-highway``, ``early-fcnn``, ``early-highway``,
``kronecker`` or ``multimodal-dropout``) over the embeddings its mode
names; any other model type a unimodal head (``fcnn``, ``highway``,
``residual``) over the one embedding of ``--mode radio|path|omic``.  The
embeddings are ``{data_root_dir}/{cancer_type}/{radio,path,omic}_pt_files/
{subject}.pt`` (stage 3's output); a missing one is zeros.  The heads are
[B, 256] products on stock torch ops: stage 4 launches no hand-written
kernel.

It takes the JAX CLI's flags and defaults plus ``--device`` (``cuda``
unless ``cpu`` is asked for) and writes the JAX CLI's files:
``experiment_{code}.txt``, ``{k}/metrics.jsonl``, the
``s_{k}_*checkpoint.pt`` state_dicts (BatchNorm running statistics
included), ``split_train_val_{k}_results.pkl`` and ``summary.csv``.
``--resume``, ``--tb`` and ``--ckpt_format orbax`` work as in
``cli.main``; ``--split`` is parsed and unused, as in the JAX CLI.
``--data_parallel``
splits each batch's rows over the ranks of a torchrun launch (``torchrun
--nproc_per_node=K -m multimodalfusion_tpu_torch.cli.main_pretrained
--data_parallel ...``), the heads' batch statistics over the global
batch; only rank 0 prints and writes.
"""
from __future__ import annotations

import argparse
import os
import sys
from timeit import default_timer as timer

import numpy as np

from multimodalfusion_tpu_torch.data.io import ensure_dir, save_pkl
from multimodalfusion_tpu_torch.data.survival_dataset import SurvivalDataset
from multimodalfusion_tpu_torch.engine.train import (TrainConfig,
                                                     check_supported,
                                                     train_fold)
from multimodalfusion_tpu_torch.parallel import mesh as par
from multimodalfusion_tpu_torch.utils.experiment import (experiment_code,
                                                         write_settings)
from multimodalfusion_tpu_torch.utils.table import write_csv


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Configurations for MMF pretrained-head training")
    p.add_argument("--data_root_dir", type=str, default="./features")
    p.add_argument("--which_splits", type=str, default="10foldcv")
    p.add_argument("--mode", type=str, default="radio")
    p.add_argument("--model_type", type=str, default=None)
    p.add_argument("--modality", type=str, default="FLAIR,T1,T2,T1Gd")
    p.add_argument("--test", type=str, default="")
    p.add_argument("--n_classes", type=int, default=4)
    p.add_argument("--split", type=str, default=None,
                   help="accepted and unused, as in the JAX CLI")
    p.add_argument("--split_mode", type=str, default="train_val")
    p.add_argument("--cancer_type", choices=["brain", "lung"], type=str,
                   default="brain")
    p.add_argument("--train_type", type=str, default="multimodal-early-fcnn")
    p.add_argument("--max_epochs", type=int, default=20)
    p.add_argument("--lr", type=float, default=2e-4)
    p.add_argument("--label_frac", type=float, default=1.0)
    p.add_argument("--bag_weight", type=float, default=0.7)
    p.add_argument("--reg", type=float, default=1e-5)
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--k", type=int, default=10)
    p.add_argument("--k_start", type=int, default=-1)
    p.add_argument("--k_end", type=int, default=-1)
    p.add_argument("--results_dir", default="./results")
    p.add_argument("--log_data", action="store_true", default=True)
    p.add_argument("--testing", action="store_true", default=False)
    p.add_argument("--early_stopping", action="store_true", default=False)
    p.add_argument("--opt", type=str, choices=["adam", "sgd"],
                   default="adam")
    p.add_argument("--drop_out", action="store_true", default=False)
    p.add_argument("--inst_loss", type=str, default=None)
    p.add_argument("--bag_loss", type=str,
                   choices=["ce_surv", "nll_surv", "cox_surv",
                            "ranking_surv", "ranking_nll_surv"],
                   default="nll_surv")
    p.add_argument("--alpha_surv", type=float, default=0.0)
    p.add_argument("--reg_type", type=str, choices=["None", "all"],
                   default="None")
    p.add_argument("--lambda_reg", type=float, default=1e-4)
    p.add_argument("--weighted_sample", action="store_true", default=False)
    p.add_argument("--gc", type=int, default=1)
    p.add_argument("--batch_size", type=int, default=1)
    p.add_argument("--data_parallel", action="store_true", default=False,
                   help="shard training batches over all visible devices")
    p.add_argument("--tb", action="store_true", default=False,
                   help="also write tensorboard event files per fold "
                        "(reference core_utils.py:31-36 writer tags)")
    p.add_argument("--nll_ratio", type=float, default=0.2)
    p.add_argument("--n_layers", type=int, default=1)
    p.add_argument("--overwrite", action="store_true", default=False)
    p.add_argument("--task", type=str, default="survival")
    p.add_argument("--dataset_root", type=str, default="dataset_csv")
    p.add_argument("--splits_root", type=str, default="./splits")
    p.add_argument("--resume", action="store_true", default=False,
                   help="continue each fold from its last saved epoch")
    p.add_argument("--ckpt_format", type=str, default="msgpack",
                   choices=["msgpack", "orbax"],
                   help="resume-bundle format, kept for the JAX CLI's "
                        "command lines: the port writes one .pt file in "
                        "either, and refuses the JAX bundle of the one "
                        "named")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device to run on (cuda, cuda:1, cpu)")
    return p


def _config(args, results_dir: str) -> TrainConfig:
    return TrainConfig(
        model_type=args.model_type, mode=args.mode,
        modalities=tuple(args.modality.split(",")),
        n_classes=args.n_classes, bag_loss=args.bag_loss,
        alpha_surv=args.alpha_surv, nll_ratio=args.nll_ratio,
        reg_type=args.reg_type, lambda_reg=args.lambda_reg, lr=args.lr,
        reg=args.reg, opt=args.opt, max_epochs=args.max_epochs,
        batch_size=args.batch_size, gc=args.gc,
        early_stopping=args.early_stopping,
        weighted_sample=args.weighted_sample, seed=args.seed,
        results_dir=results_dir, split_mode=args.split_mode,
        train_type=args.train_type, n_layers=args.n_layers,
        pretrained=True, resume=args.resume,
        data_parallel=args.data_parallel, tb=args.tb,
        ckpt_format=args.ckpt_format, device=args.device)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    check_supported(_config(args, args.results_dir))
    with par.distributed(args.device, args.data_parallel) as device:
        args.device = device
        with par.quiet_unless_rank0():
            return _run(args)


def _run(args) -> int:
    writer = par.rank() == 0
    dataset_path = os.path.join(args.dataset_root, args.cancer_type)
    args.results_dir = os.path.join(args.results_dir, args.cancer_type)
    split_dir = os.path.join(args.splits_root, args.cancer_type,
                             args.which_splits)
    data_root_dir = os.path.join(args.data_root_dir, args.cancer_type)
    modalities = args.modality.split(",")

    exp_code = experiment_code(args, pretrained=True)
    print("Experiment Name:", exp_code)

    csv_path = os.path.join(dataset_path, f"{args.task}.csv")
    dataset = SurvivalDataset(csv_path, mode=args.mode,
                              data_dir=data_root_dir, n_bins=args.n_classes,
                              label_col="survival_months",
                              modalities=modalities, print_info=True,
                              pretrained=True)
    ensure_dir(args.results_dir)
    results_dir = ensure_dir(os.path.join(args.results_dir,
                                          args.which_splits, exp_code))
    if "summary.csv" in os.listdir(results_dir) and not args.overwrite:
        print(f"Exp Code <{exp_code}> already exists! Exiting script.")
        return 1

    settings = {
        "data_root_dir": data_root_dir, "csv_path": csv_path,
        "split_dir": split_dir, "cancer_type": args.cancer_type,
        "mode": args.mode, "num_splits": args.k,
        "n_classes": args.n_classes, "k_start": args.k_start,
        "k_end": args.k_end, "task": args.task,
        "max_epochs": args.max_epochs, "results_dir": results_dir,
        "lr": args.lr, "reg": args.reg, "bag_loss": args.bag_loss,
        "seed": args.seed, "model_type": args.model_type,
        "weighted_sample": args.weighted_sample, "gc": args.gc,
        "opt": args.opt, "nll_ratio": args.nll_ratio,
        "train_type": args.train_type, "batch_size": args.batch_size,
        "n_layers": args.n_layers, "radio_modality": modalities,
        "split_mode": args.split_mode, "alpha_surv": args.alpha_surv,
        "reg_type": args.reg_type, "lambda_reg": args.lambda_reg,
        "early_stopping": args.early_stopping,
    }
    if writer:
        write_settings(results_dir, exp_code, settings)

    start_fold = 0 if args.k_start == -1 else args.k_start
    end_fold = args.k if args.k_end == -1 else args.k_end
    folds = list(range(start_fold, end_fold))
    val_cindex, test_cindex = [], []
    for i in folds:
        t0 = timer()
        keys = (("train", "val", "test")
                if args.split_mode == "train_val_test" else ("train", "val"))
        splits = dataset.load_splits(
            os.path.join(split_dir, f"splits_{i}.csv"), keys=keys)
        out = train_fold(splits, i, _config(args, results_dir))
        if args.split_mode == "train_val_test":
            val_res, val_c, test_res, test_c = out
            test_cindex.append(test_c)
            if writer:
                save_pkl(os.path.join(results_dir,
                                      f"split_train_test_{i}_results.pkl"),
                         test_res)
        else:
            val_res, val_c = out
        val_cindex.append(val_c)
        if writer:
            save_pkl(os.path.join(results_dir,
                                  f"split_train_val_{i}_results.pkl"),
                     val_res)
        print(f"Fold {i} Time: {timer() - t0:.1f} seconds")

    print(f"Average validation c_index: {np.mean(val_cindex)}")
    save_name = ("summary.csv" if len(folds) == args.k else
                 f"summary_partial_{start_fold}_{end_fold}.csv")
    cols = {"folds": folds, "val_cindex": val_cindex}
    if args.split_mode == "train_val_test":
        cols["test_cindex"] = test_cindex
    if writer:
        write_csv(os.path.join(results_dir, save_name), cols, index=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
