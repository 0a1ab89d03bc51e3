"""Interpretability CLI driven by the heatmap YAML configs (port of
multimodalfusion_tpu/cli/create_heatmaps.py, a rewrite of the reference's
create_heatmaps.py; the config's sections as in
``examples/heatmap_{path,radio,omic}.yaml``, read by the port's own
``utils/yaml_subset.py``).  ``exp_arguments.branch`` picks the branch:

- ``radio``: for each subject of ``data_arguments.process_list`` (a CSV
  with a ``subject_id`` column), its sequences' feature h5 files
  (``feat_dir/radio_h5_files/{sequence}/{subject}.h5``), aligned on their
  common slices, through the trained radiology model's attention
  read-out (``attention_only``); each slice's raw score, ranked into top,
  mid and low groups (``slice_group_size``), goes to ``scores.csv``;
- ``omic``: per-gene attributions of a ``max_net`` experiment's risk
  over its fold's cohort, ``heatmap_arguments.method`` ``ig`` (zero
  baseline integrated gradients) or ``expected_gradients`` (the
  reference's SHAP GradientExplainer semantics over the fold's train rows,
  ``shap_samples`` draws, 200 by default, from a generator seeded with
  the experiment's seed): ``omic_attr_per_patient.csv`` and
  ``omic_attr_global.csv``.

With ``data_arguments.scan_list`` (``subject_id`` and one scan path per
sequence, relative to ``scan_dir``) the radio branch also renders each
subject's top and low slices of ``display_modality`` as grayscale PNGs
``slice{id}_a{attention:.3f}.png`` under ``{subject}/{top,low}`` (one
sequence named) or ``{subject}/{sequence}/{top,low}`` (a list), from the
scan preprocessed again (lung CT when ``cancer_type`` is ``lung`` or the
sequence is ``CT``), through the port's PNG writer (``utils/png.py``).

The CSVs have pandas' layout, the JAX CLI's columns and row order.  The
``path`` branch needs a slide reader (the machine with the card has none
of openslide, OpenCV or PIL): it raises ``NotImplementedError`` before any
work, naming ROADMAP.md port queue item 6d; the omic branch writes no
figures (no matplotlib there) and says so after its CSVs.  The weights
come from ``s_{k}_minloss_checkpoint.pt`` (``model_arguments.which_k``).
Stock torch ops: no kernel.  Runs on ``cuda`` unless ``--device cpu`` is
given.

    python -m multimodalfusion_tpu_torch.cli.create_heatmaps \\
        --config CONFIG.yaml [--device cuda]
"""
from __future__ import annotations

import argparse
import csv
import os
import sys
from types import SimpleNamespace

import numpy as np
import torch

from multimodalfusion_tpu_torch import resolve_device
from multimodalfusion_tpu_torch.data.bags import intersect_slices
from multimodalfusion_tpu_torch.data.io import ensure_dir, load_features_h5
from multimodalfusion_tpu_torch.data.loaders import (iter_batches,
                                                     usable_indices)
from multimodalfusion_tpu_torch.data.radiology import preprocess_scan
from multimodalfusion_tpu_torch.data.survival_dataset import (
    _NA, MODALITIES, SurvivalDataset, read_split_ids)
from multimodalfusion_tpu_torch.interpret.ig import (expected_gradient_draws,
                                                     expected_gradients,
                                                     integrated_gradients)
from multimodalfusion_tpu_torch.utils import yaml_subset
from multimodalfusion_tpu_torch.utils.experiment import (
    config_from_settings, load_experiment_model, read_experiment)
from multimodalfusion_tpu_torch.utils.png import write_png
from multimodalfusion_tpu_torch.utils.table import write_csv

_WSI = "ROADMAP.md, port queue item 6d"


def build_parser():
    p = argparse.ArgumentParser(description="attention heatmaps")
    p.add_argument("--config", "--config_file", dest="config", type=str,
                   required=True,
                   help="YAML config (--config_file is the reference "
                        "spelling, ref create_heatmaps.py:53)")
    p.add_argument("--save_exp_code", type=str, default=None,
                   help="override the experiment output dir: results go "
                        "to exp_arguments.raw_save_dir/<code> (or the "
                        "save_dir's parent when raw_save_dir is unset; "
                        "ref create_heatmaps.py:50,164)")
    p.add_argument("--overlap", type=float, default=None,
                   help="override heatmap_arguments.overlap "
                        "(ref create_heatmaps.py:52)")
    p.add_argument("--sampling", action="store_true", default=False,
                   help="run the patch-sampling phase (path branch); "
                        "passing --sampling or --heatmap runs EXACTLY the "
                        "requested phases (ref create_heatmaps.py:54-55)")
    p.add_argument("--heatmap", action="store_true", default=False,
                   help="run the heatmap-rendering phase (see --sampling)")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device to run on (cuda, cuda:1, cpu)")
    return p


def load_config(path: str) -> SimpleNamespace:
    raw = yaml_subset.load_file(path)
    ns = SimpleNamespace()
    for section, vals in raw.items():
        setattr(ns, section, SimpleNamespace(**(vals or {})))
    return ns


def apply_cli_overrides(cfg_ns, args) -> None:
    """Reference-parity CLI overrides on top of the YAML
    (ref create_heatmaps.py:50-55)."""
    exp = cfg_ns.exp_arguments
    if args.save_exp_code:
        base = getattr(exp, "raw_save_dir", None) or os.path.dirname(
            os.path.normpath(getattr(exp, "save_dir", ".")))
        exp.save_dir = os.path.join(base, args.save_exp_code)
    if args.overlap is not None:
        if not hasattr(cfg_ns, "heatmap_arguments"):
            cfg_ns.heatmap_arguments = SimpleNamespace()
        cfg_ns.heatmap_arguments.overlap = args.overlap
    if args.sampling or args.heatmap:
        exp.heatmap_mode = bool(args.heatmap)
        exp.sampling_mode = bool(args.sampling)


def slice_group_size(n: int) -> int:
    """Top/low slice group size for the radio branch (JAX
    create_heatmaps.py:368-382): the reference's max(ceil(n * 0.1), 20),
    capped at n // 2 so that the two groups never overlap; one slice is
    "top"."""
    if n <= 1:
        return n
    return min(max(int(np.ceil(n * 0.1)), 20), n // 2)


def _column(csv_path: str, name: str):
    with open(csv_path, newline="") as f:
        return [row[name] for row in csv.DictReader(f)]


def run_path_branch(cfg_ns, device) -> int:
    raise NotImplementedError(
        f"the path branch (attention heatmaps over a slide, patch "
        f"sampling) needs a slide reader and OpenCV: not ported yet "
        f"({_WSI})")


def run_radio_branch(cfg_ns, device) -> int:
    d = cfg_ns.data_arguments
    save_dir = ensure_dir(cfg_ns.exp_arguments.save_dir)
    subjects = _column(d.process_list, "subject_id")
    modalities = list(getattr(d, "modalities",
                              ["FLAIR", "T1", "T1Gd", "T2"]))
    m = cfg_ns.model_arguments
    settings = read_experiment(m.ckpt_path)
    cfg = config_from_settings(settings, batch_size=1, device=str(device))
    model = load_experiment_model(m.ckpt_path, int(getattr(m, "which_k", 0)),
                                  cfg, device)
    rows = {"subject_id": [], "slice_index": [], "attention": [],
            "group": []}
    for subject in subjects:
        feats, sids = [], []
        try:
            for mod in modalities:
                f, si = load_features_h5(os.path.join(
                    d.feat_dir, "radio_h5_files", mod, f"{subject}.h5"))
                feats.append(f)
                sids.append(np.asarray(si))
        except OSError:
            print(f"missing features for {subject}")
            continue
        try:
            bag, common = intersect_slices(feats, sids, return_ids=True)
        except ValueError as e:
            print(f"skipping {subject}: corrupt slice ids ({e})")
            continue
        with torch.inference_mode():
            scores = model(torch.from_numpy(bag[None]).to(device),
                           torch.ones(1, len(bag), device=device),
                           attention_only=True)[0].float().cpu().numpy()
        n = len(scores)
        k = slice_group_size(n)
        for rank, idx in enumerate(np.argsort(-scores)):
            rows["subject_id"].append(subject)
            rows["slice_index"].append(int(common[idx]))
            rows["attention"].append(float(scores[idx]))
            rows["group"].append("top" if rank < k else
                                 "low" if rank >= n - k else "mid")
    write_csv(os.path.join(save_dir, "scores.csv"), rows)
    print(f"wrote slice attention scores -> {save_dir}/scores.csv")

    # the top and low slices of the display sequence(s), re-preprocessed
    # from the raw scans (ref create_heatmaps.py:604-659,
    # heatmap_utils.radio_img :177-226)
    scan_csv = getattr(d, "scan_list", None)
    if scan_csv:
        with open(scan_csv, newline="") as f:
            scans = {r["subject_id"]: r for r in csv.DictReader(f)}
        # one sequence (text) keeps subject/{top,low}; a list renders each
        # under subject/{sequence}/{top,low}
        display = getattr(d, "display_modality", modalities[0])
        nest = not isinstance(display, str)
        for display_mod in (list(display) if nest else [display]):
            _render_radio_slices(d, rows, scans, display_mod, save_dir,
                                 nest)
    return 0


def _render_radio_slices(d, rows, scans, display_mod, save_dir, nest):
    """The top and low slices of ``display_mod`` of every scored subject
    as grayscale PNGs (JAX create_heatmaps.py:458-512)."""
    is_ct = (getattr(d, "cancer_type", "glioma") == "lung"
             or display_mod == "CT")
    by_subject = {}
    for i, subject in enumerate(rows["subject_id"]):
        by_subject.setdefault(subject, []).append(i)
    for subject, idx in by_subject.items():
        scan = scans.get(subject)
        if scan is None or display_mod not in scan:
            continue
        cell = scan[display_mod]
        if cell is None or cell in _NA:
            print(f"cannot render {subject}: no {display_mod} scan in "
                  f"the scan list")
            continue
        path = os.path.join(getattr(d, "scan_dir", "."), cell)
        # the display sequence's feature h5 holds the slice ids that the
        # preprocessed volume will have: skip the preprocessing when none
        # of the selected slices is among them
        sel_ids = {rows["slice_index"][i] for i in idx
                   if rows["group"][i] in ("top", "low")}
        try:
            _, disp_ids = load_features_h5(os.path.join(
                d.feat_dir, "radio_h5_files", display_mod, f"{subject}.h5"))
            if disp_ids is not None and not sel_ids & {
                    int(s) for s in np.asarray(disp_ids).reshape(-1)}:
                print(f"skipping {subject}: no selected slice exists "
                      f"in {display_mod}")
                continue
        except (OSError, KeyError, TypeError, ValueError):
            pass  # no usable h5 to pre-check; preprocess and see
        try:
            slices, slice_ids, _ = preprocess_scan(path, is_ct)
        except (OSError, ValueError) as e:
            print(f"cannot render {subject}: {e}")
            continue
        id_to_slice = {int(s): j for j, s in enumerate(slice_ids)}
        for group in ("top", "low"):
            parts = ([subject, display_mod, group] if nest
                     else [subject, group])
            out_dir = ensure_dir(os.path.join(save_dir, *parts))
            for i in idx:
                j = id_to_slice.get(rows["slice_index"][i])
                if rows["group"][i] != group or j is None:
                    continue
                write_png(os.path.join(
                    out_dir, f"slice{rows['slice_index'][i]}_"
                             f"a{rows['attention'][i]:.3f}.png"),
                    (np.clip(slices[j], 0, 1) * 255).astype(np.uint8))


def run_omic_branch(cfg_ns, device) -> int:
    m = cfg_ns.model_arguments
    save_dir = ensure_dir(cfg_ns.exp_arguments.save_dir)
    settings = read_experiment(m.ckpt_path)
    which_k = int(getattr(m, "which_k", 0))
    split_csv = os.path.join(settings["split_dir"], f"splits_{which_k}.csv")
    dataset = SurvivalDataset(
        settings["csv_path"], mode="omic", data_dir=settings["data_root_dir"],
        n_bins=settings["n_classes"],
        modalities=settings.get("radio_modality", MODALITIES))
    split = dataset.whole_split(split_csv)
    idx = usable_indices(split)
    batch = next(iter_batches(split, batch_size=len(idx), indices=idx))
    cfg = config_from_settings(settings, model_type="max_net", mode="omic",
                               batch_size=len(idx), pretrained=False,
                               omic_input_dim=len(split.genomic_cols),
                               device=str(device))
    model = load_experiment_model(m.ckpt_path, which_k, cfg, device)

    def risk_fn(g):
        return model(genomic_features=g)["risk"]

    h_args = getattr(cfg_ns, "heatmap_arguments", SimpleNamespace())
    method = getattr(h_args, "method", "ig")
    valid = batch["valid"] > 0
    genomic = torch.from_numpy(batch["genomic"]).to(device)
    ids_valid = batch["subject_ids"][valid]
    if method == "expected_gradients":
        # the background: the fold's train rows (all rows when none loaded)
        train = set(read_split_ids(split_csv, ("train",)).get("train", []))
        train_rows = np.isin(ids_valid, list(train))
        background = genomic[torch.from_numpy(valid)]
        if train_rows.any():
            background = background[torch.from_numpy(train_rows).to(device)]
        draws = expected_gradient_draws(
            int(getattr(h_args, "shap_samples", 200)), len(genomic),
            len(background),
            torch.Generator().manual_seed(int(settings.get("seed", 1))))
        attr = expected_gradients(risk_fn, genomic, background, draws)
    elif method == "ig":
        (attr,) = integrated_gradients(risk_fn, (genomic,))
    else:
        raise NotImplementedError(method)
    attr = attr.detach().cpu().numpy()[valid]
    genes = split.genomic_cols
    write_csv(os.path.join(save_dir, "omic_attr_per_patient.csv"),
              {"subject_id": list(ids_valid),
               **{g: attr[:, j] for j, g in enumerate(genes)}})
    mean_abs, mean = np.mean(np.abs(attr), axis=0), np.mean(attr, axis=0)
    order = np.argsort(-mean_abs, kind="stable")
    write_csv(os.path.join(save_dir, "omic_attr_global.csv"),
              {"gene": [genes[j] for j in order],
               "mean_abs_attr": mean_abs[order], "mean_attr": mean[order]})
    print(f"wrote omic attributions ({method}) -> {save_dir}; not drawn: "
          f"omic_attr_global.png, omic_attr_beeswarm.png and the local/ "
          f"plots (no matplotlib on the card's machine; ROADMAP.md, port "
          f"queue 3, kept on purpose)")
    return 0


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    cfg_ns = load_config(args.config)
    apply_cli_overrides(cfg_ns, args)
    branch = getattr(cfg_ns.exp_arguments, "branch", "path")
    if branch == "path":
        return run_path_branch(cfg_ns, device)
    if branch == "radio":
        return run_radio_branch(cfg_ns, device)
    if branch == "omic":
        return run_omic_branch(cfg_ns, device)
    raise NotImplementedError(branch)


if __name__ == "__main__":
    sys.exit(main())
