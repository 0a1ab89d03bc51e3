"""Stage-2 k-fold training CLI (port of multimodalfusion_tpu/cli/main.py,
itself flag-compatible with the reference's main.py).

    python -m multimodalfusion_tpu_torch.cli.main --cancer_type brain \\
        --model_type path_attention_mil --mode path --gate_path \\
        --drop_out --bag_loss nll_surv --which_splits 5foldcv ... \\
        [--device cuda]

The models: ``path_attention_mil`` (``--mode path``),
``radio_attention_mil`` (``--mode radio``; ``--radio_fusion concat``, the
default, or ``tensor``), ``max_net`` (``--mode omic``) and
``mm_attention_mil`` (any ``--mode`` of radio, path and omic joined by
``_``; ``--fusion tensor``, the default, or ``concat``).  A radiology bag
holds the ``--modality`` sequences, in that order (the settings keep it
as ``radio_modality``).  The genomic input width is the cohort's number
of genomic columns.

It takes the JAX CLI's flags plus ``--device`` (``cuda`` unless ``cpu`` is
asked for) and writes the JAX CLI's files: ``experiment_{code}.txt``,
per-fold ``{k}/metrics.jsonl``, ``split_train_val_{k}_results.pkl`` (a dict
of numpy arrays), the ``s_{k}_*checkpoint.pt`` state_dicts and
``summary.csv`` (or ``summary_partial_{a}_{b}.csv``, ``eval_``-prefixed
with ``--eval_only``) with pandas' ``to_csv`` layout.  Operations:
``--split threemod|pre_trained`` first writes the stratified
``splits_{k}.csv`` files (``SurvivalDataset.do_split``); ``--resume``
continues each fold from its resume bundle (``s_{k}_resume.pt``, in
either ``--ckpt_format``);
``--tb`` writes TensorBoard event files per fold; ``--profile_dir DIR``
writes a ``torch.profiler`` Chrome trace per fold (per rank under
torchrun), ``fold{k}[.rank{r}].pt.trace.json``, and
``stage_timings.json``.

Multi-GPU runs start one process per GPU with torchrun:

    torchrun --nproc_per_node=K -m multimodalfusion_tpu_torch.cli.main \
        --data_parallel [--bag_shard --bag_shard_devices S] ...

``--data_parallel`` splits each batch's rows over the ranks,
``--bag_shard`` each bag's instances (AMIL models), both together a 2-D
(K / S data) x (S bag) layout.  The ranks join NCCL (gloo with ``--device
cpu``); only rank 0 prints and writes, the files of a one-process run.
Without torchrun's environment the run is one process, and raises on a
machine with more than one visible GPU.
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
from multimodalfusion_tpu_torch.utils.profiling import StageTimer, trace
from multimodalfusion_tpu_torch.utils.table import write_csv


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Configurations for MMF Training")
    p.add_argument("--data_root_dir", type=str, default="./features")
    p.add_argument("--which_splits", type=str, default="10foldcv")
    p.add_argument("--k", type=int, default=5)
    p.add_argument("--results_dir", default="./results")
    p.add_argument("--data_parallel", action="store_true", default=False,
                   help="shard training batches over all visible devices")
    p.add_argument("--tb", action="store_true", default=False,
                   help="also write tensorboard event files per fold "
                        "(reference core_utils.py:31-36 writer tags)")
    p.add_argument("--bag_shard", action="store_true", default=False,
                   help="shard the bag (instance) axis over all devices: "
                        "AMIL attention pooling runs as fused per-shard "
                        "partials combined with collectives (for bags "
                        "beyond one chip's HBM)")
    p.add_argument("--bag_shard_devices", type=int, default=0,
                   help="with --data_parallel: bag-axis size of the 2-D "
                        "(data, bag) mesh (DP x SP composition)")
    p.add_argument("--profile_dir", type=str, default=None,
                   help="write a torch.profiler Chrome trace per fold "
                        "(Perfetto, chrome://tracing) and the stage "
                        "timings JSON here")
    p.add_argument("--mode", type=str, default="radio")
    p.add_argument("--modality", type=str, default="T1,T2,T1Gd,FLAIR")
    p.add_argument("--task", type=str, default="survival")
    p.add_argument("--cancer_type", choices=["brain", "lung"], type=str,
                   default="brain")
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--split", type=str, default=None,
                   choices=["threemod", "pre_trained"],
                   help="first write stratified splits_{k}.csv files into "
                        "the split directory (seeded by --seed)")
    p.add_argument("--model_type", type=str, default=None)
    p.add_argument("--n_classes", type=int, default=4)
    p.add_argument("--split_mode", type=str,
                   choices=["train_val", "train_val_test"],
                   default="train_val")
    p.add_argument("--max_epochs", type=int, default=20)
    p.add_argument("--lr", type=float, default=2e-4)
    p.add_argument("--label_frac", type=float, default=1.0)
    p.add_argument("--bag_weight", type=float, default=0.7)
    p.add_argument("--reg", type=float, default=1e-5)
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
    p.add_argument("--nll_ratio", type=float, default=0.2)
    p.add_argument("--reg_type", type=str,
                   choices=["None", "all", "omic_mm"], default="None")
    p.add_argument("--lambda_reg", type=float, default=1e-4)
    p.add_argument("--weighted_sample", action="store_true", default=False)
    p.add_argument("--model_size_wsi", type=str, default="small")
    p.add_argument("--model_size_radio", type=str, default="small")
    p.add_argument("--model_size_omic", type=str, default="small")
    p.add_argument("--gc", type=int, default=1)
    p.add_argument("--batch_size", type=int, default=1)
    p.add_argument("--gate_path", action="store_true", default=False)
    p.add_argument("--gate_omic", action="store_true", default=False)
    p.add_argument("--gate_radio", action="store_true", default=False)
    p.add_argument("--fusion", type=str, default=None)
    p.add_argument("--radio_fusion", type=str, default=None)
    p.add_argument("--radio_mil_type", type=str, default=None)
    p.add_argument("--k_start", type=int, default=-1)
    p.add_argument("--k_end", type=int, default=-1)
    p.add_argument("--log_data", action="store_true", default=True)
    p.add_argument("--overwrite", action="store_true", default=False)
    p.add_argument("--apply_mad", action="store_true", default=True)
    p.add_argument("--test", type=str, default="")
    p.add_argument("--dataset_root", type=str, default="dataset_csv",
                   help="root containing {cancer_type}/{task}.csv")
    p.add_argument("--splits_root", type=str, default="./splits")
    p.add_argument("--resume", action="store_true", default=False,
                   help="continue each fold from its last saved epoch")
    p.add_argument("--ckpt_format", type=str, default="msgpack",
                   choices=["msgpack", "orbax"],
                   help="resume-bundle format, kept for the JAX CLI's "
                        "command lines: the port writes one .pt file in "
                        "either, and refuses the JAX bundle of the one "
                        "named")
    p.add_argument("--eval_only", action="store_true", default=False,
                   help="evaluate existing minloss checkpoints instead of "
                        "training (ref core_utils.py eval_mode :109-127)")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device to run on (cuda, cuda:1, cpu)")
    return p


def _config(args, results_dir: str, omic_dim: int = 0) -> TrainConfig:
    return TrainConfig(
        model_type=args.model_type, mode=args.mode,
        n_classes=args.n_classes, bag_loss=args.bag_loss,
        alpha_surv=args.alpha_surv, nll_ratio=args.nll_ratio,
        reg_type=args.reg_type, lambda_reg=args.lambda_reg, lr=args.lr,
        reg=args.reg, opt=args.opt, max_epochs=args.max_epochs,
        batch_size=args.batch_size, gc=args.gc,
        early_stopping=args.early_stopping,
        weighted_sample=args.weighted_sample, drop_out=args.drop_out,
        gate_path=args.gate_path, gate_radio=args.gate_radio,
        gate=args.gate_omic, fusion=args.fusion,
        radio_fusion=args.radio_fusion,
        modalities=tuple(args.modality.split(",")),
        model_size_wsi=args.model_size_wsi,
        model_size_radio=args.model_size_radio,
        model_size_omic=args.model_size_omic, omic_input_dim=omic_dim,
        seed=args.seed,
        results_dir=results_dir, split_mode=args.split_mode,
        resume=args.resume, data_parallel=args.data_parallel,
        bag_shard=args.bag_shard, bag_shard_devices=args.bag_shard_devices,
        tb=args.tb, ckpt_format=args.ckpt_format, device=args.device)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    # raise before any work for a model, mode or layout the run cannot take
    check_supported(_config(args, args.results_dir))
    with par.distributed(args.device,
                         args.data_parallel or args.bag_shard) as device:
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

    exp_code = experiment_code(args)
    print("Experiment Name:", exp_code)

    csv_path = os.path.join(dataset_path, f"{args.task}.csv")
    if not os.path.exists(csv_path):
        have = sorted(f[:-4] for f in os.listdir(dataset_path)
                      if f.endswith(".csv")) if os.path.isdir(dataset_path) \
            else []
        raise SystemExit(f"--task {args.task!r}: {csv_path} not found; "
                         f"available tasks in {dataset_path}: {have}")
    dataset = SurvivalDataset(csv_path=csv_path, mode=args.mode,
                              data_dir=data_root_dir, n_bins=args.n_classes,
                              label_col="survival_months",
                              modalities=modalities, print_info=True)
    if args.split is not None:
        if writer:
            dataset.do_split(args.split, split_dir, k=args.k, seed=args.seed)
            print(f"wrote splits to {split_dir}")
        par.barrier()

    ensure_dir(args.results_dir)
    results_dir = ensure_dir(os.path.join(args.results_dir,
                                          args.which_splits, exp_code))
    if args.eval_only:
        args.overwrite = True  # evaluation never clobbers training outputs
    if "summary.csv" in os.listdir(results_dir) and not args.overwrite:
        print(f"Exp Code <{exp_code}> already exists! Exiting script. "
              "set --overwrite or rename using --test")
        return 1

    settings = {
        "data_root_dir": data_root_dir, "csv_path": csv_path,
        "split_dir": split_dir, "cancer_type": args.cancer_type,
        "mode": args.mode, "num_splits": args.k,
        "n_classes": args.n_classes, "k_start": args.k_start,
        "k_end": args.k_end, "task": args.task,
        "max_epochs": args.max_epochs, "results_dir": results_dir,
        "lr": args.lr, "reg": args.reg, "label_frac": args.label_frac,
        "inst_loss": args.inst_loss, "bag_loss": args.bag_loss,
        "bag_weight": args.bag_weight, "seed": args.seed,
        "model_type": args.model_type,
        "model_size_wsi": args.model_size_wsi,
        "model_size_omic": args.model_size_omic,
        "model_size_radio": args.model_size_radio,
        "use_drop_out": args.drop_out,
        "weighted_sample": args.weighted_sample, "gc": args.gc,
        "opt": args.opt, "fusion": args.fusion,
        "radio_fusion": args.radio_fusion,
        "radio_mil_type": args.radio_mil_type,
        "radio_modality": modalities,
        "batch_size": args.batch_size,
        "split_mode": args.split_mode,
        "alpha_surv": args.alpha_surv,
        "reg_type": args.reg_type, "lambda_reg": args.lambda_reg,
        "gate_path": args.gate_path, "gate_radio": args.gate_radio,
        "gate_omic": args.gate_omic,
        "early_stopping": args.early_stopping,
    }
    if writer:
        write_settings(results_dir, exp_code, settings)
    print("################# Settings ###################")
    for key, val in settings.items():
        print(f"{key}:  {val}")

    start_fold = 0 if args.k_start == -1 else args.k_start
    end_fold = args.k if args.k_end == -1 else args.k_end
    folds = list(range(start_fold, end_fold))
    val_cindex, test_cindex = [], []
    timings = StageTimer()
    trace_suffix = f".rank{par.rank()}" if par.world_size() > 1 else ""
    for i in folds:
        t0 = timer()
        keys = (("train", "val", "test")
                if args.split_mode == "train_val_test" else ("train", "val"))
        splits = dataset.load_splits(
            os.path.join(split_dir, f"splits_{i}.csv"), keys=keys)
        omic_dim = (splits[0].genomic_features.shape[1]
                    if splits[0] is not None else 0)
        with trace(args.profile_dir, f"fold{i}{trace_suffix}"), \
                timings.stage(f"fold{i}"):
            out = train_fold(splits, i, _config(args, results_dir, omic_dim),
                             eval_only=args.eval_only)
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

    if args.profile_dir and writer:
        ensure_dir(args.profile_dir)
        timings.dump(os.path.join(args.profile_dir, "stage_timings.json"))
    print(f"Average validation c_index: {np.mean(val_cindex)}")
    if args.split_mode == "train_val_test":
        print(f"Average test c_index: {np.mean(test_cindex)}")
    save_name = ("summary.csv" if len(folds) == args.k else
                 f"summary_partial_{start_fold}_{end_fold}.csv")
    if args.eval_only:
        save_name = "eval_" + save_name
    cols = {"folds": folds, "val_cindex": val_cindex}
    if args.split_mode == "train_val_test":
        cols["test_cindex"] = test_cindex
    if writer:
        write_csv(os.path.join(results_dir, save_name), cols, index=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
