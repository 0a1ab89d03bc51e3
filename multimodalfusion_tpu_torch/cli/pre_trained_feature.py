"""Stage 3: the 256-d embedding of every subject, taken from a trained
stage-2 model (port of multimodalfusion_tpu/cli/pre_trained_feature.py,
itself a rewrite of the reference's pre_trained_feature.py).

Reads the stage-2 experiment's settings and its fold's
``s_{k}_minloss_checkpoint.pt`` (the port's own, or the ``.pt`` that JAX
training writes beside its msgpack), runs every usable subject of the
cohort through the model's features, and writes
``{output_dir}/{cancer_type}/{radio,path,omic}_pt_files/{subject}.pt`` as
[1, 256] tensors, the files stage 4 reads.  Genomic inputs are z-scored
with the fold's training split, as training saw them.  An existing file
is kept, not rewritten; ``--extraction_csv_path`` (a CSV with a
``subject_id`` column) limits which subjects are written.

Radiology and path experiments (``radio_attention_mil``,
``path_attention_mil``) pool through the hand-written CUDA forward kernel
on the card, once per batch; a radiology bag holds the experiment's
sequences (``radio_modality``).  Genomic experiments (``max_net``) run
stock torch ops.  Runs on ``cuda`` unless ``--device cpu`` is given.

    python -m multimodalfusion_tpu_torch.cli.pre_trained_feature \\
        --checkpoint_path EXP --which_k 0 --output_dir OUT [--device cuda]
"""
from __future__ import annotations

import argparse
import csv
import os
import sys

import torch

from multimodalfusion_tpu_torch import resolve_device
from multimodalfusion_tpu_torch.data.bags import PinnedPool
from multimodalfusion_tpu_torch.data.io import ensure_dir, save_pt
from multimodalfusion_tpu_torch.data.loaders import (iter_batches,
                                                     usable_indices)
from multimodalfusion_tpu_torch.data.survival_dataset import (
    MODALITIES, SurvivalDataset, _NA)
from multimodalfusion_tpu_torch.engine.train import model_inputs
from multimodalfusion_tpu_torch.utils.experiment import (
    config_from_settings, load_experiment_model, read_experiment)

_MODE_TO_MODEL = {"radio": "radio_attention_mil",
                  "path": "path_attention_mil", "omic": "max_net"}


def build_parser():
    p = argparse.ArgumentParser(
        description="Pre-trained Unimodal Model Feature Extraction")
    p.add_argument("--checkpoint_path", type=str, required=True)
    p.add_argument("--output_dir", type=str, default="pretrained_feature")
    p.add_argument("--which_k", type=int, required=True)
    p.add_argument("--extraction_csv_path", type=str, default=None,
                   help="CSV with a subject_id column restricting which "
                        "subjects are extracted")
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device to run on (cuda, cuda:1, cpu)")
    return p


def _subject_ids(csv_path: str) -> set:
    with open(csv_path, newline="") as f:
        return {row["subject_id"] for row in csv.DictReader(f)
                if row["subject_id"] not in _NA}


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    settings = read_experiment(args.checkpoint_path)
    mode = settings["mode"]
    if mode not in _MODE_TO_MODEL:
        raise ValueError(f"stage 3 extracts the embedding of a unimodal "
                         f"experiment (mode radio, path or omic), not of "
                         f"mode {mode!r}")
    cfg = config_from_settings(
        settings, batch_size=args.batch_size, pretrained=False,
        model_type=settings.get("model_type") or _MODE_TO_MODEL[mode],
        device=args.device)
    if cfg.model_type != _MODE_TO_MODEL[mode]:
        raise ValueError(f"stage 3 extracts the embeddings of "
                         f"{', '.join(_MODE_TO_MODEL.values())} "
                         f"experiments, not of {cfg.model_type}")
    device = resolve_device(args.device)

    dataset = SurvivalDataset(
        settings["csv_path"], mode=mode, data_dir=settings["data_root_dir"],
        modalities=settings.get("radio_modality", MODALITIES))
    whole = dataset.whole_split(os.path.join(
        settings["split_dir"], f"splits_{args.which_k}.csv"))
    cfg.omic_input_dim = whole.genomic_features.shape[1]
    keep = (_subject_ids(args.extraction_csv_path)
            if args.extraction_csv_path else None)
    output_dir = ensure_dir(os.path.join(args.output_dir,
                                         settings["cancer_type"],
                                         f"{mode}_pt_files"))

    model = load_experiment_model(args.checkpoint_path, args.which_k, cfg,
                                  device)
    pool = PinnedPool() if device.type == "cuda" else None
    n_written = 0
    with torch.inference_mode():
        for batch in iter_batches(whole, batch_size=cfg.batch_size,
                                  indices=usable_indices(whole), pool=pool):
            feats = model(**model_inputs(cfg, batch, device, pool),
                          return_features=True).float().cpu().numpy()
            for i, sid in enumerate(batch["subject_ids"]):
                if not sid or batch["valid"][i] == 0:
                    continue
                if keep is not None and sid not in keep:
                    continue
                out_path = os.path.join(output_dir, f"{sid}.pt")
                if os.path.isfile(out_path):
                    continue  # idempotent (ref :125-133)
                save_pt(out_path, feats[i].reshape(1, -1))
                n_written += 1
    print(f"wrote {n_written} embeddings to {output_dir}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
