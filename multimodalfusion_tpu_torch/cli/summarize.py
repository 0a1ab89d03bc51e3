"""Cross-validation reporting CLI (port of multimodalfusion_tpu/cli/
summarize.py, a rewrite of ref utils/utils_summary.py :15-120 aggregation
and :98-313 result_plot / kmplot, and of the utils_analysis/evaluation.py
report tail: :80-157 hazard2grade and hazard histograms, :559-580
survival_AUC, :734-786 generate_heatmap_yamls).

It walks a results tree written by either package's training CLIs: every
experiment's k-fold ``summary.csv`` becomes a mean/std row of
``cv_summary.csv`` (``--pivot``: ``cv_pivot.csv``, model x cohort); each
experiment's fold result pkls are pooled per subject, its risks stratified
at ``--percentiles`` and the extreme strata compared by the logrank test,
with bootstrap c-index CIs (``--bootstrap``) and the IPCW c-index and
time-dependent AUC against a cohort (``--cohort_csv``), in
``risk_group_stats.csv``; ``--emit_heatmap_yamls`` writes the
``create_heatmaps`` configs that link stage 2 to stage 5.  The JAX CLI's
flags and file names.

Host numpy only: no ``--device``, no torch work.  The figures of the JAX
CLI (``cv_compare.png``, ``{exp}_hist.png``, ``{exp}_km.png``) are not
drawn (no matplotlib on the card's machine): one line names each figure
that the JAX CLI would draw.  A fold is emitted when its
``s_{k}_minloss_checkpoint.pt`` exists, which the port's
``create_heatmaps`` reads and JAX training writes beside every
``.msgpack``.
"""
from __future__ import annotations

import argparse
import glob
import os
import sys

import numpy as np

from multimodalfusion_tpu_torch import analysis
from multimodalfusion_tpu_torch import metrics as metrics_mod
from multimodalfusion_tpu_torch.data.io import ensure_dir, load_pkl
from multimodalfusion_tpu_torch.utils import table, yaml_subset

_NOT_DRAWN = "not drawn (no matplotlib on the card's machine)"


def build_parser():
    p = argparse.ArgumentParser(description="CV summary + KM reports")
    p.add_argument("--results_root", type=str, required=True)
    p.add_argument("--save_dir", type=str, required=True)
    p.add_argument("--km", action="store_true", default=False,
                   help="per-experiment risk-group KM plots (named, not "
                        "drawn)")
    p.add_argument("--km_thresh", type=float, default=None,
                   help="name a KM plot only when logrank p < thresh (ref "
                        "kmplot_orig gates at 0.05)")
    p.add_argument("--topk", type=int, default=0,
                   help="name KM plots only for the top-k experiments by "
                        "pooled c-index (0 = all)")
    p.add_argument("--percentiles", type=str, default="50",
                   help="comma-separated risk percentiles for "
                        "stratification, e.g. 25,50,75 (ref "
                        "getPValue_25_75 compares the extreme strata)")
    p.add_argument("--overall_func", type=str, default="mean",
                   choices=["mean", "median", "max"],
                   help="per-subject risk aggregation across folds "
                        "(ref utils_summary.py result_plot)")
    p.add_argument("--hazard_hist", action="store_true", default=False,
                   help="per-experiment hazard histograms (ref "
                        "makeHazardHistogram; named, not drawn)")
    p.add_argument("--cohort_csv", type=str, default=None,
                   help="cohort CSV with survival_months/censorship "
                        "columns; enables time-dependent AUC + IPCW "
                        "c-index against its censoring distribution "
                        "(ref survival_AUC)")
    p.add_argument("--bootstrap", type=int, default=0,
                   help="bootstrap iterations for c-index CIs (0 = off)")
    p.add_argument("--pivot", action="store_true", default=False,
                   help="write a model x cohort pivot of the summary "
                        "metric (ref utils_summary.py pivot_summary; its "
                        "bar plot is named, not drawn)")
    p.add_argument("--pivot_col", type=str, default="val_cindex_mean",
                   help="cv_summary column to pivot")
    p.add_argument("--emit_heatmap_yamls", type=str, default=None,
                   metavar="DIR",
                   help="bridge stage 4 -> stage 5 (ref "
                        "generate_heatmap_yamls, evaluation.py:734-786): "
                        "write ready-to-run create_heatmaps config YAMLs "
                        "into DIR, one per experiment at its best fold")
    p.add_argument("--heatmap_template", type=str, default=None,
                   help="template YAML whose data/patching/heatmap/"
                        "sample sections are carried into every emitted "
                        "config (ref template_%%s.yaml)")
    p.add_argument("--heatmap_branch", type=str, default="auto",
                   choices=["auto", "path", "radio", "omic"],
                   help="heatmap branch; auto infers from the "
                        "experiment name prefix (PATH/RADIO/OMICS)")
    p.add_argument("--all_folds", action="store_true", default=False,
                   help="emit a YAML per fold instead of only the best "
                        "val-c-index fold (ref generate_best=False loop)")
    p.add_argument("--heatmap_save_root", type=str, default=None,
                   help="save_dir root written into the emitted configs "
                        "(default: DIR/heatmap_results)")
    return p


# experiment-name prefix -> heatmap branch (stage-2 codes are
# {PATH,RADIO,OMICS,MMF}_..., utils/experiment.py); the MMF fusion heads
# have no attention or gene heatmap (stage 5 covers them through
# create_attributions)
_BRANCH_PREFIXES = (("PATH", "path"), ("RADIO", "radio"),
                    ("OMIC", "omic"))


def _infer_branch(exp_code: str):
    for prefix, branch in _BRANCH_PREFIXES:
        if exp_code.upper().startswith(prefix):
            return branch
    return None


def emit_heatmap_yamls(results_root: str, out_dir: str,
                       template: str | None = None,
                       branch: str = "auto", all_folds: bool = False,
                       save_root: str | None = None) -> list:
    """Write ready-to-run create_heatmaps config YAMLs for every trained
    experiment under ``results_root`` (ref generate_heatmap_yamls,
    evaluation.py:734-786: the template's sections, with the experiment's
    branch, save_dir, ckpt_path and fold, as heatmap_config_*_val_*.yaml).
    The fold is the one of the highest val c-index in summary.csv (the
    reference's ``generate_best`` path), or every fold with ``all_folds``;
    a fold without its minloss checkpoint is skipped with a note.
    Returns the written paths."""
    ensure_dir(out_dir)
    if save_root is None:
        save_root = os.path.join(out_dir, "heatmap_results")
    tpl = (yaml_subset.load_file(template) or {}) if template else {}
    written = []
    for dirpath, _, files in os.walk(results_root):
        if "summary.csv" not in files:
            continue
        exp_code = os.path.basename(os.path.normpath(dirpath))
        b = branch if branch != "auto" else _infer_branch(exp_code)
        if b is None:
            print(f"{exp_code}: no heatmap branch for this model "
                  "family, skipping")
            continue
        summary = table.read_csv(os.path.join(dirpath, "summary.csv"))
        if "val_cindex" not in summary or not len(summary["val_cindex"]):
            continue
        folds = (summary["folds"].astype(int).tolist() if "folds" in summary
                 else list(range(len(summary["val_cindex"]))))
        if not all_folds:
            vals = summary["val_cindex"].astype(float)
            if np.all(np.isnan(vals)):
                print(f"{exp_code}: every fold's val_cindex is NaN, "
                      "skipping")
                continue
            folds = [folds[int(np.nanargmax(vals))]]
        exp = os.path.relpath(dirpath, results_root).replace(os.sep, "__")
        for k in folds:
            ckpt = os.path.join(dirpath, f"s_{k}_minloss_checkpoint.pt")
            if not os.path.isfile(ckpt):
                print(f"{exp}: fold {k} has no minloss checkpoint, "
                      "skipping")
                continue
            cfg = {
                "exp_arguments": {
                    **dict(tpl.get("exp_arguments") or {}),
                    "branch": b,
                    "save_dir": os.path.join(save_root, f"{exp}_val_{k}"),
                },
                "data_arguments": dict(tpl.get("data_arguments") or {}),
                "model_arguments": {
                    **dict(tpl.get("model_arguments") or {}),
                    "ckpt_path": os.path.abspath(dirpath),
                    "which_k": int(k),
                },
                "heatmap_arguments": dict(tpl.get("heatmap_arguments")
                                          or {}),
            }
            # optional template sections pass through untouched
            for sec in ("patching_arguments", "sample_arguments"):
                if sec in tpl:
                    cfg[sec] = tpl[sec]
            path = os.path.join(out_dir,
                                f"heatmap_config_{exp}_val_{k}.yaml")
            yaml_subset.dump_file(cfg, path)
            written.append(path)
    print(f"{len(written)} heatmap configs -> {out_dir}")
    return written


_NEEDED = ("subject_id", "risk", "survival", "censorship")


def _fold_frames(pkls):
    """Each pkl's result columns; a pkl that lacks one of them or holds no
    subject is skipped, saying why."""
    frames = []
    for p in pkls:
        res = load_pkl(p)
        cols = {k: np.asarray(v) for k, v in res.items() if k in _NEEDED}
        if all(k in cols for k in _NEEDED) and len(cols["subject_id"]):
            frames.append(cols)
        else:
            print(f"skipping {p}: missing "
                  f"{sorted(set(_NEEDED) - set(cols))}")
    return frames


def _n_rows(cols) -> int:
    return len(next(iter(cols.values()))) if cols else 0


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    ensure_dir(args.save_dir)
    percentiles = [float(x) for x in args.percentiles.split(",") if x]
    summary = analysis.summarize_experiments(args.results_root)
    out_csv = os.path.join(args.save_dir, "cv_summary.csv")
    table.write_csv(out_csv, summary)
    print(f"{_n_rows(summary)} experiments -> {out_csv}")

    if args.pivot and _n_rows(summary):
        if args.pivot_col not in summary:
            print(f"--pivot_col {args.pivot_col!r} not in cv_summary "
                  f"columns {sorted(summary)}; skipping pivot")
        else:
            pv = analysis.pivot_summary(summary, args.pivot_col)
            pv_csv = os.path.join(args.save_dir, "cv_pivot.csv")
            table.write_csv(pv_csv, pv)
            print(f"pivot {_n_rows(pv)}x{max(len(pv) - 1, 0)} -> {pv_csv}; "
                  f"cv_compare.png {_NOT_DRAWN}")

    if args.emit_heatmap_yamls:
        emit_heatmap_yamls(args.results_root, args.emit_heatmap_yamls,
                           template=args.heatmap_template,
                           branch=args.heatmap_branch,
                           all_folds=args.all_folds,
                           save_root=args.heatmap_save_root)

    cohort = None
    if args.cohort_csv:
        cdf = table.read_csv(args.cohort_csv)
        cohort = ((1 - cdf["censorship"]).astype(bool),
                  cdf["survival_months"].astype(float))

    rows = []
    km_jobs = []
    for dirpath, _, files in os.walk(args.results_root):
        pkls = sorted(glob.glob(os.path.join(
            dirpath, "split_train_val_*_results.pkl")))
        if not pkls:
            continue
        # the relative path tells same-named experiments of other cancer
        # types or split directories apart
        exp = os.path.relpath(dirpath, args.results_root).replace(
            os.sep, "__")
        frames = _fold_frames(pkls)
        if not frames:
            continue
        # one row per subject: its risk over the folds that validated it
        pooled = analysis.pool_folds_by_subject(frames, args.overall_func)
        if len(pooled["risk"]) < 4:
            continue
        try:
            groups = analysis.km_by_risk_group(pooled,
                                               percentiles=percentiles)
        except ValueError:
            continue
        event = (1 - pooled["censorship"]).astype(bool)
        try:
            pooled_c = metrics_mod.concordance_index_censored(
                event, pooled["survival"], pooled["risk"])[0]
        except ValueError:
            pooled_c = float("nan")
        row = {"experiment": exp, "n": len(pooled["risk"]),
               "pooled_cindex": pooled_c,
               "logrank_chi2": groups["logrank_chi2"],
               "logrank_p": groups["logrank_p"]}
        if cohort is not None:
            try:
                iauc, ipcw_c, _ = analysis.survival_auc(
                    cohort[0], cohort[1], event, pooled["survival"],
                    pooled["risk"])
                row.update({"iauc": iauc, "ipcw_cindex": ipcw_c})
            except (ValueError, IndexError, ZeroDivisionError) as e:
                print(f"{exp}: survival_auc skipped ({e})")
        if args.bootstrap:
            _, lo, hi = analysis.bootstrap_cindex_ci(
                event, pooled["survival"], pooled["risk"],
                n_boot=args.bootstrap)
            row.update({"cindex_lo": lo, "cindex_hi": hi})
        rows.append(row)
        if args.hazard_hist:
            h = analysis.hazard_histogram(
                pooled, os.path.join(args.save_dir, f"{exp}_hist.png"))
            print(f"{exp}_hist.png {_NOT_DRAWN}: {h['n_low']} short- and "
                  f"{h['n_high']} long-surviving events, cutoff "
                  f"{h['cutoff_years']:.2f} years")
        if args.km:
            km_jobs.append((exp, pooled_c, groups))

    # the threshold and top-k gates of the KM plots (ref kmplot_orig
    # p < thresh; result_plot's best experiments); NaN c-indices last
    if km_jobs:
        if args.topk:
            km_jobs.sort(key=lambda j: (np.isnan(j[1]), -j[1]))
            km_jobs = km_jobs[:args.topk]
        for exp, _, groups in km_jobs:
            if args.km_thresh is not None and \
                    not (groups["logrank_p"] < args.km_thresh):
                continue
            analysis.plot_km(groups,
                             os.path.join(args.save_dir, f"{exp}_km.png"),
                             title=exp)
            print(f"{exp}_km.png {_NOT_DRAWN}: logrank p "
                  f"{groups['logrank_p']:.2e}, strata "
                  f"{[s['n'] for s in groups['strata']]}")
    if rows:
        km_csv = os.path.join(args.save_dir, "risk_group_stats.csv")
        table.write_csv(km_csv, table.from_records(rows))
        print(f"risk-group stats for {len(rows)} experiments -> {km_csv}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
