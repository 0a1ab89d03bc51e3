"""Radiology GradCAM++ CLI (port of multimodalfusion_tpu/cli/gradcam.py, a
rewrite of ref gradcam.py and utils_ig.py:176): the truncated ResNet50
and a stage-2 radio AMIL end to end on raw MRI or CT slices; GradCAM++ on
the layer3 map, weighted by each slice's attention, written as per-slice
PNG overlays and NIfTI CAM volumes.

Two modes, with the JAX CLI's flags and file names:

* single scan (``--scan``): one volume filling the bag slot of
  ``--modality``: ``cam_volume.nii.gz`` and ``slice{id}_a{score:.3f}.png``
  for the top ``--top_frac`` of the slices by attention;
* cohort (``--csv_path``): a scan list (``subject_id`` and one scan path
  per modality), slices selected by the heatmap radio branch's
  ``scores.csv`` (``--scores_csv``) or, without it, by the first rendered
  modality's own attention; overlays ``{subject}/ig_heatmap/{mod}_{k}_
  {id}.png`` or, with ``--all_slices``, the attention-weighted, blurred
  CAM volumes ``{subject}_{mod}_{attr,orig}.nii.gz``, side-by-side PNGs
  ``ig_heatmap_all/{mod}/all_{i:03d}.png`` and ``heatmap.pkl``.

One ``CamRunner`` serves both.  Per scan and augmentation variant the
trunk runs once, in float32 with TF32 off, without autograd; its layer3
map is then the leaf of the gradient of the radio AMIL's risk (eval mode),
whose attention pooling runs the CUDA forward and backward kernels on the
card (``ops/mil_attention.py``).  The bag is the scan's real slices: the
JAX runner pads them to a power-of-two bucket so that XLA compiles once,
and the padded rows carry no weight.  The attention scores come from the
unfused read-out (``attention_only``, no kernel) of the same map.

Where the port differs from the JAX CLI:
- the radio AMIL is read from ``s_{k}_minloss_checkpoint.pt`` (the JAX
  export's ``.pt``, or the port's), a 2- or 3-sequence tensor fusion
  taking its trained fusion from the flax msgpack beside it; JAX reads
  its msgpack;
- CSVs are read with the stdlib ``csv`` module and ids stay text, so
  numeric ids such as ``007`` match ``scores.csv`` (JAX compares its
  text ids with pandas' integer column and renders none of them);
- slices are ranked by attention with a stable sort, where pandas'
  ``sort_values`` uses quicksort: tied scores may order differently;
- images are written RGB by the port's PNG writer (``utils/png.py``):
  the pixels of JAX's ``cv2.imwrite`` files, other bytes.

Runs on ``cuda`` unless ``--device cpu`` is given.

    python -m multimodalfusion_tpu_torch.cli.gradcam --ckpt_path S2_EXP \\
        --csv_path scans.csv --radio_dir SCANS --scores_csv scores.csv \\
        --weights resnet50.pt --save_dir OUT [--all_slices] [--device cpu]
"""
from __future__ import annotations

import argparse
import csv
import os
import pickle
import sys
from typing import Optional

import numpy as np
import torch
from torch.nn import functional as F

from multimodalfusion_tpu_torch import resolve_device
from multimodalfusion_tpu_torch.data.io import ensure_dir
from multimodalfusion_tpu_torch.data.nifti import write_nifti
from multimodalfusion_tpu_torch.data.radiology import preprocess_scan
from multimodalfusion_tpu_torch.data.survival_dataset import _NA
from multimodalfusion_tpu_torch.extract.features import Embedder
from multimodalfusion_tpu_torch.interpret.gradcam import (cam_overlay,
                                                          gradcam_for,
                                                          upsample_cams)
from multimodalfusion_tpu_torch.models.resnet import FEATURE_DIM
from multimodalfusion_tpu_torch.utils.experiment import (
    config_from_settings, load_experiment_model, read_experiment)
from multimodalfusion_tpu_torch.utils.image_ops import (gaussian_blur,
                                                        repeat_rgb,
                                                        to_uint8_gray)
from multimodalfusion_tpu_torch.utils.png import write_png


def build_parser():
    p = argparse.ArgumentParser(description="radiology GradCAM++")
    p.add_argument("--scan", type=str, default=None,
                   help="NIfTI path (or DICOM dir for lung) — single-scan "
                        "mode; mutually exclusive with --csv_path")
    p.add_argument("--ckpt_path", type=str, required=True,
                   help="stage-2 radio AMIL results dir")
    p.add_argument("--which_k", type=int, default=0)
    p.add_argument("--modality", type=str, default="T1",
                   help="single-scan mode: which bag slot the scan fills")
    p.add_argument("--cancer_type", type=str, default="glioma",
                   choices=["glioma", "lung"])
    p.add_argument("--save_dir", type=str, required=True)
    p.add_argument("--weights", type=str, default=None,
                   help="torch ResNet50 state_dict")
    p.add_argument("--allow_random_weights", action="store_true",
                   default=False,
                   help="proceed with a randomly initialized ResNet50 "
                        "(test/debug only — the CAM volume is noise)")
    p.add_argument("--image_size", type=int, default=224)
    p.add_argument("--top_frac", type=float, default=0.1,
                   help="single-scan mode: fraction of top-attention "
                        "slices to render")
    p.add_argument("--no_aug_smooth", action="store_true", default=False,
                   help="disable the flip x brightness test-time "
                        "augmentation the reference always applies "
                        "(ref gradcam.py:105 aug_smooth=True)")
    p.add_argument("--csv_path", type=str, default=None,
                   help="cohort scan list: subject_id + one scan-path "
                        "column per modality (ref gradcam.py:31)")
    p.add_argument("--radio_dir", type=str, default="",
                   help="base dir the CSV's scan paths are relative to "
                        "(ref gradcam.py:30)")
    p.add_argument("--scores_csv", type=str, default=None,
                   help="scores.csv from the heatmap radio branch "
                        "(subject_id, slice_index, attention): slice "
                        "selection + attention weights; without it each "
                        "subject's attention is recomputed from the "
                        "rendered modality's own slices")
    p.add_argument("--subject", type=str, default=None,
                   help="restrict the cohort to one subject "
                        "(ref gradcam.py:37)")
    p.add_argument("--top", type=int, default=20,
                   help="cohort mode: top-attention slices to render "
                        "(ref gradcam.py:36,87)")
    p.add_argument("--all_slices", action="store_true", default=False,
                   help="cohort mode: render full attention-weighted CAM "
                        "volumes instead of top slices "
                        "(ref gradcam.py:38,125-189)")
    p.add_argument("--segment", action="store_true", default=False,
                   help="lung segmentation-masked preprocessing (ref "
                        "gradcam.py:35; implied by --cancer_type lung)")
    p.add_argument("--modalities", type=str, default=None,
                   help="comma list of modality columns to render "
                        "(default: the checkpoint's radio_modality; "
                        "ref gradcam.py:34)")
    p.add_argument("--overwrite", action="store_true", default=False,
                   help="re-render subjects whose output dir exists "
                        "(ref gradcam.py:39,75)")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device to run on (cuda, cuda:1, cpu)")
    return p


def _load_resnet(args, device) -> Optional[Embedder]:
    """The float32 trunk of ``--weights`` (or a seeded random one with
    ``--allow_random_weights``), or None after an error message."""
    if args.weights and not os.path.isfile(args.weights):
        print(f"error: --weights {args.weights!r} does not exist",
              file=sys.stderr)
        return None
    if not args.weights and not args.allow_random_weights:
        print("error: --weights is required (torch ResNet50 state_dict; "
              "export once with torch.save(torchvision.models.resnet50("
              "weights='IMAGENET1K_V1').state_dict(), 'resnet50.pt')). "
              "Pass --allow_random_weights to override for tests.",
              file=sys.stderr)
        return None
    return Embedder(weights_path=args.weights or None,
                    allow_random=args.allow_random_weights,
                    dtype="float32", image_size=args.image_size,
                    device=device)


def _load_amil(args, settings, device):
    """The stage-2 radio AMIL of ``--ckpt_path`` in eval mode."""
    cfg = config_from_settings(settings, model_type="radio_attention_mil",
                               mode="radio", batch_size=1,
                               device=str(device))
    return load_experiment_model(args.ckpt_path, args.which_k, cfg, device)


class CamRunner:
    """(CAMs [N, h, w], attention scores [N]) of a scan's normalised
    slices filling bag slot ``slot`` of an ``n_mod``-sequence radio AMIL:
    the gradient of its risk with respect to the trunk's layer3 map, whose
    spatial mean is each slice's feature."""

    def __init__(self, embedder: Embedder, amil, n_mod: int,
                 aug_smooth: bool):
        self.embedder, self.amil = embedder, amil
        self.n_mod, self.aug = n_mod, aug_smooth

    def _bag(self, act: torch.Tensor, slot: int) -> torch.Tensor:
        emb = act.mean(dim=(2, 3))                         # [N, 1024]
        return F.pad(emb, (slot * FEATURE_DIM,
                           (self.n_mod - 1 - slot) * FEATURE_DIM))[None]

    def __call__(self, x_norm: torch.Tensor, slot: int):
        """``x_norm``: [N, 3, S, S] normalised slices on the trunk's
        device.  Returns float32 numpy arrays."""
        mask = torch.ones(1, x_norm.shape[0], device=x_norm.device)

        def head(act):
            return self.amil(self._bag(act, slot), mask)["risk"]

        cams, act = gradcam_for(self.embedder.spatial_maps, head, x_norm,
                                self.aug)
        with torch.no_grad():
            scores = self.amil(self._bag(act, slot), mask,
                               attention_only=True)[0]
        return (cams.float().cpu().numpy(),
                scores.float().cpu().numpy())


def _overlay_png(path, gray, cam, mask=None):
    write_png(path, cam_overlay(torch.from_numpy(gray), torch.from_numpy(
        cam), None if mask is None else torch.from_numpy(mask)).numpy())


def run_single_scan(args, device) -> int:
    save_dir = ensure_dir(args.save_dir)
    settings = read_experiment(args.ckpt_path)
    modalities = list(settings["radio_modality"])
    embedder = _load_resnet(args, device)
    if embedder is None:
        return 2
    lung = args.cancer_type == "lung" or args.segment
    # lung CAMs are zeroed outside the lung segmentation
    # (ref gradcam.py:124-189 via PreprocessDatasetMask)
    slices, slice_ids, lung_mask = preprocess_scan(args.scan, lung)
    if slices.shape[0] == 0:
        print("empty scan")
        return 1
    amil = _load_amil(args, settings, device)
    slot = (modalities.index(args.modality) if args.modality in modalities
            else 0)
    runner = CamRunner(embedder, amil, len(modalities),
                       not args.no_aug_smooth)
    cams, scores = runner(embedder.slice_inputs(slices), slot)
    attn = np.exp(scores - scores.max())
    attn = attn / attn.sum()
    weighted = cams * (attn / max(attn.max(), 1e-12))[:, None, None]
    ups = upsample_cams(torch.from_numpy(weighted), slices.shape[1:3])
    if lung_mask is not None:
        # zero outside the lungs, then smooth the hard mask edge
        ups = gaussian_blur(ups * torch.from_numpy(lung_mask).float())
    ups = ups.numpy()
    write_nifti(os.path.join(save_dir, "cam_volume.nii.gz"), ups)
    n_top = max(int(np.ceil(len(scores) * args.top_frac)), 1)
    for i in np.argsort(-scores, kind="stable")[:n_top]:
        _overlay_png(os.path.join(
            save_dir, f"slice{int(slice_ids[i])}_a{scores[i]:.3f}.png"),
            slices[i], ups[i])
    print(f"wrote {n_top} overlays + cam_volume.nii.gz -> {save_dir}")
    return 0


def _read_rows(path):
    with open(path, newline="") as f:
        return list(csv.DictReader(f))


def _subject_slice_selection(score_rows, subject, top, all_slices):
    """(selected slice ids, {slice id: attention}) of ``subject`` in the
    heatmap radio branch's scores.csv rows (ref gradcam.py:83-88): the
    ``top`` highest attention (a stable sort) or, with ``all_slices``,
    every slice by id; (None, None) when the subject has no row."""
    grp = [r for r in score_rows if r["subject_id"] == subject]
    if not grp:
        return None, None
    att = {int(r["slice_index"]): float(r["attention"]) for r in grp}
    if all_slices:
        return sorted(att), att
    by_score = sorted(grp, key=lambda r: -float(r["attention"]))
    return [int(r["slice_index"]) for r in by_score[:top]], att


def run_cohort(args, device) -> int:
    if args.scan is not None:
        print("error: pass either --scan or --csv_path, not both",
              file=sys.stderr)
        return 2
    save_dir = ensure_dir(args.save_dir)
    settings = read_experiment(args.ckpt_path)
    ckpt_mods = list(settings["radio_modality"])
    modalities = (args.modalities.split(",") if args.modalities
                  else ckpt_mods)
    cohort = _read_rows(args.csv_path)
    if args.subject is not None:
        cohort = [r for r in cohort if r["subject_id"] == args.subject]
        if not cohort:
            print(f"error: subject {args.subject} not in {args.csv_path}",
                  file=sys.stderr)
            return 2
    score_rows = _read_rows(args.scores_csv) if args.scores_csv else None
    lung = args.cancer_type == "lung" or args.segment
    # a bad --weights path fails before any subject is preprocessed
    embedder = _load_resnet(args, device)
    if embedder is None:
        return 2
    runner = CamRunner(embedder, _load_amil(args, settings, device),
                       len(ckpt_mods), not args.no_aug_smooth)
    out_name = "ig_heatmap_all" if args.all_slices else "ig_heatmap"
    n_done = 0
    for row in cohort:
        subject = row["subject_id"]
        sub_dir = os.path.join(save_dir, subject)
        if os.path.isdir(os.path.join(sub_dir, out_name)) \
                and not args.overwrite:
            print(f"{subject}: {out_name} exists, skipping "
                  "(--overwrite to redo)")
            continue
        mods = [m for m in modalities
                if row.get(m) is not None and row[m] not in _NA]
        if not mods:
            print(f"{subject}: no modality paths in the CSV, skipping")
            continue

        # per-modality preprocessing and CAMs over the whole scan
        per_mod = {}
        for m in mods:
            path = os.path.join(args.radio_dir, row[m])
            try:
                slices, sids, lmask = preprocess_scan(path, lung)
            except (OSError, ValueError) as e:
                print(f"{subject}/{m}: cannot preprocess ({e})")
                continue
            if slices.shape[0] == 0:
                print(f"{subject}/{m}: empty scan")
                continue
            slot = ckpt_mods.index(m) if m in ckpt_mods else 0
            cams, scores = runner(embedder.slice_inputs(slices), slot)
            per_mod[m] = {"slices": slices,
                          "ids": [int(s) for s in sids],
                          "mask": lmask,
                          "cams": upsample_cams(torch.from_numpy(cams),
                                                slices.shape[1:3]).numpy(),
                          "scores": scores}
        if not per_mod:
            continue

        if score_rows is not None:
            sel, att = _subject_slice_selection(
                score_rows, subject, args.top, args.all_slices)
            if sel is None:
                print(f"{subject}: not in --scores_csv, skipping")
                continue
        else:
            # rank by the first RENDERED modality's own attention (a
            # modality that failed preprocessing is not in per_mod)
            first = per_mod[next(m for m in mods if m in per_mod)]
            att = dict(zip(first["ids"],
                           [float(s) for s in first["scores"]]))
            order = np.argsort(-first["scores"], kind="stable")
            sel = (sorted(att) if args.all_slices
                   else [first["ids"][i] for i in order[:args.top]])

        if args.all_slices:
            _write_volumes(sub_dir, subject, per_mod, sel, att)
        else:
            out_dir = ensure_dir(os.path.join(sub_dir, "ig_heatmap"))
            n_png = 0
            for k, sid in enumerate(sel):
                for m, d in per_mod.items():
                    if sid not in d["ids"]:
                        continue
                    i = d["ids"].index(sid)
                    cam = d["cams"][i]
                    if d["mask"] is not None:
                        cam = cam * d["mask"][i].astype(np.float32)
                    # ref gradcam.py:114: {modality}_{k}_{slide}.png
                    _overlay_png(os.path.join(out_dir, f"{m}_{k}_{sid}.png"),
                                 d["slices"][i], cam)
                    n_png += 1
            print(f"{subject}: {n_png} overlays -> {out_dir}")
        n_done += 1
    print(f"gradcam cohort: {n_done} subjects rendered")
    return 0


def _write_volumes(sub_dir, subject, per_mod, sel, att):
    """--all_slices composite (ref gradcam.py:125-189): per modality, the
    mask-zeroed CAM volume normalised on the cross-modality range,
    weighted by the min-max-scaled attention, gaussian-blurred (sigma 5
    along slices, 1 in-plane), renormalised across modalities; written as
    NIfTI volumes, side-by-side PNGs and a pickle of the raw CAMs."""
    from scipy.ndimage import gaussian_filter
    ensure_dir(sub_dir)
    a = np.asarray([att.get(s, 0.0) for s in sel], np.float32)
    rng_a = max(float(a.max() - a.min()), 1e-12)
    w = (a - a.min()) / rng_a

    vols, origs, raw = {}, {}, {}
    for m, d in per_mod.items():
        idx = [d["ids"].index(s) for s in sel if s in d["ids"]]
        keep = [j for j, s in enumerate(sel) if s in d["ids"]]
        if not idx:
            continue
        cam = d["cams"][idx]
        if d["mask"] is not None:
            cam = cam * d["mask"][idx].astype(np.float32)
        else:
            # glioma: zero the CAM on the black background
            # (ref masks via all_masks, gradcam.py:138-145)
            cam = cam * (d["slices"][idx] > 0)
        raw[m] = cam
        vols[m] = (cam, w[keep])
        origs[m] = d["slices"][idx]
    if not vols:
        return
    g_lo = min(float(c.min()) for c, _ in vols.values())
    g_hi = max(float(c.max()) for c, _ in vols.values())
    g_rng = max(g_hi - g_lo, 1e-12)
    blurred = {m: gaussian_filter((cam - g_lo) / g_rng * wm[:, None, None],
                                  sigma=[5, 1, 1])
               for m, (cam, wm) in vols.items()}
    b_lo = min(float(c.min()) for c in blurred.values())
    b_hi = max(float(c.max()) for c in blurred.values())
    b_rng = max(b_hi - b_lo, 1e-12)
    for m in blurred:
        attr = ((blurred[m] - b_lo) / b_rng).astype(np.float32)
        write_nifti(os.path.join(sub_dir, f"{subject}_{m}_orig.nii.gz"),
                    origs[m].astype(np.float32))
        write_nifti(os.path.join(sub_dir, f"{subject}_{m}_attr.nii.gz"),
                    attr)
        png_dir = ensure_dir(os.path.join(sub_dir, "ig_heatmap_all", m))
        for i in range(attr.shape[0]):
            gray = torch.from_numpy(origs[m][i])
            overlay = cam_overlay(gray, torch.from_numpy(attr[i]))
            side = torch.cat([repeat_rgb(to_uint8_gray(gray)), overlay],
                             dim=1)
            write_png(os.path.join(png_dir, f"all_{i:03d}.png"),
                      side.numpy())
    with open(os.path.join(sub_dir, "heatmap.pkl"), "wb") as f:
        pickle.dump(raw, f, protocol=pickle.HIGHEST_PROTOCOL)
    print(f"{subject}: attr/orig NIfTIs + ig_heatmap_all PNGs -> "
          f"{sub_dir}")


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    if args.csv_path is not None:
        return run_cohort(args, device)
    if args.scan is None:
        print("error: one of --scan or --csv_path is required",
              file=sys.stderr)
        return 2
    return run_single_scan(args, device)


if __name__ == "__main__":
    sys.exit(main())
