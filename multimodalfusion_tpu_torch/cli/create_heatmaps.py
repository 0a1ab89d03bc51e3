"""Interpretability CLI driven by the heatmap YAML configs (port of
multimodalfusion_tpu/cli/create_heatmaps.py, a rewrite of the reference's
create_heatmaps.py; the config's sections as in
``examples/heatmap_{path,radio,omic}.yaml``, read by the port's own
``utils/yaml_subset.py``).  ``exp_arguments.branch`` picks the branch:

- ``path`` (the default): for each slide of ``data_arguments.
  process_list`` (a CSV with a ``slide_id`` column, and optionally the
  ROI columns ``x1``, ``x2``, ``y1``, ``y2``), its patch features
  ``feat_dir/h5_files/{stem}.h5`` (segmented, patched, embedded and
  written there first when missing) through the trained PathAMIL's
  attention read-out (``attention_only``, no kernel):
  ``{stem}_blockmap.h5`` (``attention_scores``, ``coords``), the overlay
  ``{stem}_heatmap.{save_ext}`` and with ``save_orig`` the slide
  ``{stem}_orig.{save_ext}`` (``interpret/heatmaps.draw_heatmap`` on the
  port's stand-ins for OpenCV, PIL and matplotlib), with ``overlap`` > 0
  the fine pass ``{stem}_fine_heatmap.jpg`` (the tissue re-gridded at the
  overlapping stride and embedded again), and the sampled patches
  ``{stem}_{name}/{rank}_x{x}_y{y}_a{score:.3f}.png`` with their mosaic
  ``{stem}_{name}_mosaic.png``, from ``sample_arguments``' shorthand
  (``floor``, ``save_n``: top-k and reverse top-k of the dynamic k) or its
  list form (``samples``).  JPEGs come from the port's encoder
  (``utils/jpeg.py``), PNGs from its writer (``utils/png.py``); an
  unsupported ``cmap`` or ``save_ext`` raises before any work, and so do
  slides the port does not open (openslide formats other than Aperio
  ``.svs``, which it reads tile by tile).  The embedder (ResNet50 trunk) takes
  ``model_arguments.resnet_weights`` (or ``allow_random_weights``) and
  ``patching_arguments.batch_size`` / ``target_patch_size``.  Each slide
  prints one line of its stage timings;
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
omic branch writes no figures (no matplotlib on the card's machine) and
says so after its CSVs.  The weights come from
``s_{k}_minloss_checkpoint.pt`` (``model_arguments.which_k``), loaded
once.  No kernel: the read-outs are stock torch ops.  Runs on ``cuda``
unless ``--device cpu`` is given.

    python -m multimodalfusion_tpu_torch.cli.create_heatmaps \\
        --config CONFIG.yaml [--device cuda]
"""
from __future__ import annotations

import argparse
import csv
import os
import sys
import time
from concurrent.futures import ThreadPoolExecutor
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
from multimodalfusion_tpu_torch.data import hdf5
from multimodalfusion_tpu_torch.data import wsi as wsi_mod
from multimodalfusion_tpu_torch.data.io import save_hdf5
from multimodalfusion_tpu_torch.interpret.heatmaps import (
    compute_fine_scores, draw_heatmap, dynamic_k, patch_mosaic, sample_rois,
    score_to_percentile)
from multimodalfusion_tpu_torch.utils import image_ops, yaml_subset
from multimodalfusion_tpu_torch.utils.experiment import (
    config_from_settings, load_experiment_model, read_experiment)
from multimodalfusion_tpu_torch.utils.jpeg import write_jpeg
from multimodalfusion_tpu_torch.utils.png import write_png
from multimodalfusion_tpu_torch.utils.table import write_csv

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


SAVE_EXTS = ("jpg", "jpeg", "png")


def _write_image(path: str, rgb: np.ndarray) -> str:
    """``cv2.imwrite`` of an RGB image as JAX calls it (the BGR array of
    the same pixels): PNG by the port's writer, JPEG by its encoder."""
    if path.lower().endswith(".png"):
        return write_png(path, rgb)
    return write_jpeg(path, rgb)


def _embedder_from_config(m, p, device):
    from multimodalfusion_tpu_torch.extract.features import Embedder
    return Embedder(
        weights_path=getattr(m, "resnet_weights", None),
        batch_size=int(getattr(p, "batch_size", 128)),
        image_size=int(getattr(p, "target_patch_size", 224)),
        allow_random=bool(getattr(m, "allow_random_weights", False)),
        device=device)


def _extract_missing_features(slide, feat_h5, tissue, holes, embedder,
                              patch_size, patch_level=0, chunk=512):
    """Segment -> patch -> embed a slide whose features h5 is missing, and
    write ``features`` (f32) and ``coords`` (int64) there (JAX
    create_heatmaps.py:106-143, ref heatmap_utils.process_single_slide
    :288-411): the patches read ``chunk`` at a time on a prefetch thread
    and resized to the trunk's input on its device."""
    from multimodalfusion_tpu_torch.data.loaders import prefetch
    coords, _ = wsi_mod.process_contours(slide, tissue, holes,
                                         patch_level=patch_level,
                                         patch_size=patch_size,
                                         step_size=patch_size)
    if len(coords) == 0:
        raise ValueError("no tissue patches found for on-the-fly "
                         "feature extraction")

    def chunks():
        for start in range(0, len(coords), chunk):
            yield wsi_mod.read_patches(slide, coords[start:start + chunk],
                                       patch_level, patch_size)

    feats = np.concatenate(
        [embedder.embed_images(x, resize=x.shape[1] != embedder.image_size)
         for x in prefetch(chunks(), depth=2)], axis=0)
    ensure_dir(os.path.dirname(feat_h5))
    save_hdf5(feat_h5, {"features": feats.astype(np.float32),
                        "coords": np.asarray(coords, np.int64)}, mode="w")
    return feats, np.asarray(coords)


def _roi(row):
    """The ROI (top_left, bot_right) of a process-list row, or None when
    a column is missing or a cell is empty or NA (``pd.isna`` in JAX)."""
    cells = [row.get(c) for c in ("x1", "x2", "y1", "y2")]
    if any(c is None or c in _NA for c in cells):
        return None
    x1, x2, y1, y2 = (int(float(c)) for c in cells)
    return (x1, y1), (x2, y2)


def _sample_specs(s, n_scores, sampling_mode):
    """The sampling specs (JAX create_heatmaps.py:313-327): the list form
    ``samples``, or the shorthand ``floor`` / ``save_n`` as top-k and
    reverse top-k of the dynamic k; none when sampling is off."""
    if not sampling_mode:
        return []
    specs = getattr(s, "samples", None)
    if specs is not None:
        return specs
    k = dynamic_k(n_scores, floor=int(getattr(s, "floor", 200)))
    save_n = int(getattr(s, "save_n", 8))
    return [{"name": "topk", "mode": "topk", "k": k, "save_n": save_n},
            {"name": "reverse_topk", "mode": "reverse_topk", "k": k,
             "save_n": save_n}]


def run_path_branch(cfg_ns, device) -> int:
    d = cfg_ns.data_arguments
    m = cfg_ns.model_arguments
    h = getattr(cfg_ns, "heatmap_arguments", SimpleNamespace())
    s = getattr(cfg_ns, "sample_arguments", SimpleNamespace())
    p = getattr(cfg_ns, "patching_arguments", SimpleNamespace())
    # checked before any work
    cmap = getattr(h, "cmap", "RdYlBu_r")
    image_ops.colormap(cmap)
    ext = str(getattr(h, "save_ext", "jpg"))
    if ext.lower() not in SAVE_EXTS:
        raise ValueError(f"heatmap_arguments.save_ext {ext!r}: the port "
                         f"writes {', '.join(SAVE_EXTS)}")
    with open(d.process_list, newline="") as f:
        rows = list(csv.DictReader(f))
    save_dir = ensure_dir(cfg_ns.exp_arguments.save_dir)
    # phase gating (ref create_heatmaps.py:54-55,69-70): both on unless
    # --sampling / --heatmap asked for exactly one
    heatmap_mode = bool(getattr(cfg_ns.exp_arguments, "heatmap_mode", True))
    sampling_mode = bool(getattr(cfg_ns.exp_arguments, "sampling_mode",
                                 True))
    which_k = int(getattr(m, "which_k", 0))
    settings = read_experiment(m.ckpt_path)
    cfg = config_from_settings(settings, batch_size=1, device=str(device))
    model = load_experiment_model(m.ckpt_path, which_k, cfg, device)

    def read_out(feats: np.ndarray) -> np.ndarray:
        with torch.inference_mode():
            bag = torch.from_numpy(np.ascontiguousarray(
                feats, np.float32))[None].to(device)
            return model(bag, torch.ones(1, bag.shape[1], device=device),
                         attention_only=True)[0].float().cpu().numpy()

    segment = bool(getattr(h, "segment", True))
    patch_size = int(getattr(p, "patch_size", 256))
    alpha = float(getattr(h, "alpha", 0.4))
    use_ref_scores = bool(getattr(h, "use_ref_scores", False))
    overlap = float(getattr(h, "overlap", 0.0) or 0.0)
    vis_level = getattr(h, "vis_level", None)
    if vis_level is not None and int(vis_level) < 0:
        vis_level = None
    elif vis_level is not None:
        vis_level = int(vis_level)
    embedder = None
    for row in rows:
        slide_file = row["slide_id"]
        stem = os.path.splitext(slide_file)[0]
        slide = wsi_mod.open_slide(os.path.join(d.data_dir, slide_file))
        wall = {}
        tissue = holes = None

        def contours():
            nonlocal tissue, holes
            if tissue is None:
                tissue, holes = wsi_mod.segment_tissue(
                    slide, seg_level=getattr(p, "seg_level", None),
                    a_t=float(getattr(p, "a_t", 100.0)),
                    a_h=float(getattr(p, "a_h", 16.0)), device=device)
            return tissue, holes

        feat_h5 = os.path.join(d.feat_dir, "h5_files", f"{stem}.h5")
        if os.path.isfile(feat_h5):
            with hdf5.File(feat_h5) as f:
                feats, coords = f["features"], f["coords"]
        else:
            print(f"{stem}: features h5 missing, extracting inline")
            if embedder is None:
                embedder = _embedder_from_config(m, p, device)
            t0 = time.perf_counter()
            feats, coords = _extract_missing_features(
                slide, feat_h5, *contours(), embedder, patch_size)
            wall["extract"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        scores = read_out(feats)
        wall["readout"] = time.perf_counter() - t0

        # the blockmap: coarse attention and coords (ref :306-309)
        blockmap = os.path.join(save_dir, f"{stem}_blockmap.h5")
        if not os.path.isfile(blockmap):
            save_hdf5(blockmap,
                      {"attention_scores": scores.astype(np.float32),
                       "coords": np.asarray(coords, np.int64)}, mode="w")

        seg_kwargs = {}
        if segment and heatmap_mode:
            t, hl = contours()
            seg_kwargs = dict(segment=True, tissue=t, holes=hl,
                              use_holes=bool(getattr(h, "use_holes", True)))
        roi = _roi(row) if bool(getattr(h, "use_roi", False)) else None
        roi_kwargs = ({} if roi is None else
                      dict(top_left=roi[0], bot_right=roi[1]))
        # use_ref_scores: the scores reach draw_heatmap as percentiles of
        # the coarse blockmap's distribution (ref heatmap_utils.py:99,138)
        draw_scores = scores
        if use_ref_scores:
            draw_scores = score_to_percentile(scores, scores) / 100.0
        images = []
        if heatmap_mode:
            heat = draw_heatmap(
                slide, draw_scores, coords, patch_size=patch_size,
                vis_level=vis_level, **roi_kwargs, alpha=alpha,
                blur=bool(getattr(h, "blur", False)),
                use_percentiles=not use_ref_scores,
                binarize=bool(getattr(h, "binarize", False)),
                threshold=float(getattr(h, "binary_thresh", -1.0)),
                blank_canvas=bool(getattr(h, "blank_canvas", False)),
                custom_downsample=int(getattr(h, "custom_downsample", 1)),
                cmap=cmap, device=device, timings=wall, **seg_kwargs)
            out = os.path.join(save_dir, f"{stem}_heatmap.{ext}")
            images.append((out, heat))
            print(f"{stem}: heatmap -> {out}")
            if bool(getattr(h, "save_orig", False)):
                vl = vis_level if vis_level is not None \
                    else slide.level_count - 1
                images.append((os.path.join(save_dir, f"{stem}_orig.{ext}"),
                               slide.read_region((0, 0), vl,
                                                 slide.level_dimensions[vl])))

        # the fine heatmap at an overlapping stride (ref
        # heatmap_utils.compute_from_patches)
        n_fine = 0
        if overlap > 0 and heatmap_mode:
            if embedder is None:
                embedder = _embedder_from_config(m, p, device)
            fscores, fcoords = compute_fine_scores(
                slide, *contours(), embedder, read_out,
                patch_size=patch_size, overlap=overlap,
                use_center_shift=bool(getattr(h, "use_center_shift", True)),
                timings=wall)
            n_fine = len(fcoords)
            if n_fine:
                # use_ref_scores ranks the fine scores on the coarse
                # blockmap's distribution
                fdraw = fscores
                if use_ref_scores:
                    fdraw = score_to_percentile(fscores, scores) / 100.0
                fine_wall = {}
                fine = draw_heatmap(slide, fdraw, fcoords,
                                    patch_size=patch_size, alpha=alpha,
                                    blur=True, overlap=overlap,
                                    use_percentiles=not use_ref_scores,
                                    cmap=cmap, device=device,
                                    timings=fine_wall, **seg_kwargs)
                for k, v in fine_wall.items():
                    wall[f"fine_{k}"] = v
                out_f = os.path.join(save_dir, f"{stem}_fine_heatmap.jpg")
                images.append((out_f, fine))
                print(f"{stem}: fine heatmap ({n_fine} patches at "
                      f"overlap {overlap}) -> {out_f}")
        # the slide's images encoded at once, one host thread each (numpy
        # releases the GIL in the encoders' array work)
        t0 = time.perf_counter()
        with ThreadPoolExecutor(max(len(images), 1)) as pool:
            list(pool.map(lambda item: _write_image(*item), images))
        wall["encode"] = time.perf_counter() - t0

        # patch sampling (ref :481-556)
        t0 = time.perf_counter()
        n_png = n_mosaic = 0
        for spec in _sample_specs(s, len(scores), sampling_mode):
            if not spec.get("sample", True):
                continue
            mode_name = spec.get("mode", "topk")
            k = min(int(spec.get("k", 8)), len(scores))
            sc, cc = sample_rois(
                scores, coords, k=k, mode=mode_name,
                seed=int(spec.get("seed", 1)),
                score_range=(float(spec.get("score_start", 0.45)),
                             float(spec.get("score_end", 0.55))))
            name = spec.get("name", mode_name)
            sample_dir = ensure_dir(os.path.join(save_dir,
                                                 f"{stem}_{name}"))
            save_n = int(spec.get("save_n", spec.get("k", 8)))
            sampled = []
            for rank, (sc_i, (x, y)) in enumerate(
                    zip(sc[:save_n], cc[:save_n])):
                patch = slide.read_region((int(x), int(y)), 0,
                                          (patch_size, patch_size))
                sampled.append(patch)
                write_png(os.path.join(
                    sample_dir, f"{rank}_x{x}_y{y}_a{sc_i:.3f}.png"), patch)
                n_png += 1
            if sampled:
                mosaic = patch_mosaic(
                    np.stack(sampled),
                    n_cols=int(spec.get("mosaic_cols", 5)),
                    downscale=int(spec.get("mosaic_downscale", 2)))
                write_png(os.path.join(save_dir,
                                       f"{stem}_{name}_mosaic.png"), mosaic)
                n_mosaic += 1
        wall["sampling"] = time.perf_counter() - t0
        if n_fine and "fine_embed" in wall:
            wall["fine_embed_us_a_patch"] = wall["fine_embed"] / n_fine * 1e6
        print(f"{stem}: path heatmap stages: coarse {len(scores)} patches, "
              f"fine {n_fine} patches, {n_png} sampled PNGs, {n_mosaic} "
              f"mosaics; seconds " + ", ".join(
                  f"{k} {v:.6f}" for k, v in wall.items()))
    return 0


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
