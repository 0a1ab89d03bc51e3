"""Export a trained experiment to a single-file serving artifact (port of
multimodalfusion_tpu/cli/export_model.py).

It loads a fold's ``s_{k}_minloss_checkpoint.pt`` as ``cli.infer`` does
(the port's or the one JAX training writes) and writes a ``torch.export``
program with the weights inside (``utils/model_export.py``), plus a
``.json`` sidecar with its input and output signatures:

    python -m multimodalfusion_tpu_torch.cli.export_model \\
        --model_path results/brain/5foldcv/EXP --which_k 0 \\
        --out exp_k0.pt2 --platforms cuda --check

``--platforms cuda`` (the default) keeps the forward kernel in the graph,
and the export and ``--check`` run on the card; ``--platforms cpu`` (or
any other list of cuda and cpu) traces the plain pooling, and both run on
the CPU.  A ``tpu`` platform raises.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import sys

import numpy as np
import torch

from multimodalfusion_tpu_torch.engine.train import check_supported
from multimodalfusion_tpu_torch.utils import model_export
from multimodalfusion_tpu_torch.utils.experiment import (
    config_from_settings, load_experiment_model, read_experiment)


def build_parser():
    p = argparse.ArgumentParser(description="export a fold checkpoint to a "
                                            "torch.export artifact")
    p.add_argument("--model_path", type=str, required=True,
                   help="experiment dir (stage-2 or stage-4)")
    p.add_argument("--which_k", type=int, default=0,
                   help="fold checkpoint to export")
    p.add_argument("--out", type=str, default=None,
                   help="artifact path (default "
                        "<model_path>/s_{k}_scorer.pt2)")
    p.add_argument("--batch_size", type=int, default=8,
                   help="serving batch size baked into the artifact")
    p.add_argument("--bag_len", type=int, default=512,
                   help="padded bag length baked into the artifact "
                        "(MIL models)")
    p.add_argument("--platforms", type=str, nargs="+", default=None,
                   help="cuda (the default: keeps the forward kernel, "
                        "exported on the card) or any other list of cuda "
                        "and cpu (plain pooling, exported on the CPU)")
    p.add_argument("--check", action="store_true",
                   help="after writing, load the artifact and verify that "
                        "it reproduces the checkpoint's outputs on random "
                        "inputs (rtol and atol 2e-5)")
    return p


def omic_width(ckpt: str) -> int:
    """The genomic input width of a checkpoint: the input side of its first
    omic layer (the width is the cohort's, not in the settings)."""
    sd = torch.load(ckpt, map_location="cpu", weights_only=True)
    return int(sd["fc_omic.0.0.weight"].shape[1])


def probe_inputs(sidecar: dict) -> dict:
    """The JAX CLI's probe: normal draws from ``default_rng(0)`` in the
    sidecar's input order, masks and ``valid`` all ones."""
    rng = np.random.default_rng(0)
    return {k: rng.normal(size=spec["shape"]).astype(spec["dtype"])
            if not k.endswith("mask") and k != "valid"
            else np.ones(spec["shape"], spec["dtype"])
            for k, spec in sidecar["inputs"].items()}


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    device = model_export.export_device(args.platforms)
    settings = read_experiment(args.model_path)
    cfg = config_from_settings(settings, batch_size=args.batch_size)
    check_supported(cfg)
    ckpt = os.path.join(args.model_path,
                        f"s_{args.which_k}_minloss_checkpoint.pt")
    if "omic" in cfg.mode and not cfg.pretrained:
        cfg = dataclasses.replace(cfg, omic_input_dim=omic_width(ckpt))
    model = load_experiment_model(args.model_path, args.which_k, cfg, device)

    out_path = args.out or os.path.join(args.model_path,
                                        f"s_{args.which_k}_scorer.pt2")
    sidecar = model_export.save_scorer(out_path, model, cfg,
                                       batch_size=args.batch_size,
                                       bag_len=args.bag_len,
                                       platforms=args.platforms)
    size = os.path.getsize(out_path)
    print(f"exported {cfg.model_type} fold {args.which_k} -> {out_path} "
          f"({size / 1e6:.2f} MB, inputs {sorted(sidecar['inputs'])}, "
          f"platforms {sidecar['platforms']})")

    if args.check:
        scorer = model_export.load_scorer(out_path)
        probe = probe_inputs(sidecar)
        got = scorer(probe)
        # the eager model on the export device: the kernel on the card,
        # the plain pooling on the CPU, as the artifact was traced
        with torch.inference_mode():
            want = model(**{k: torch.as_tensor(v, device=device)
                            for k, v in probe.items()})
        for k in got:
            np.testing.assert_allclose(got[k].cpu().numpy(),
                                       want[k].cpu().numpy(),
                                       rtol=2e-5, atol=2e-5, err_msg=k)
        print(f"check OK: artifact reproduces the checkpoint on "
              f"{sorted(got)} at rtol 2e-5")
    return 0


if __name__ == "__main__":
    sys.exit(main())
