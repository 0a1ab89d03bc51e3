"""Experiment naming and the settings round-trip (port of
multimodalfusion_tpu/utils/experiment.py).

The reference encodes hyperparameters into an experiment code string
(ref main.py:156-192) and dumps a python-dict text file that downstream
CLIs re-hydrate with ``eval()`` (ref main.py:275-277).  The same file is
written here, and read back with ``ast.literal_eval`` (no code
execution).
"""
from __future__ import annotations

import ast
import os
from typing import Optional


def experiment_code(args, pretrained: bool = False) -> str:
    """The reference's param_code naming."""
    code = ""
    if args.model_type == "path_attention_mil":
        code += "PATH"
    elif args.model_type == "radio_attention_mil":
        code += "RADIO"
    elif args.model_type == "max_net":
        code += "OMICS"
    elif args.model_type == "mm_attention_mil":
        code += "MMF"
        if "radio" in args.mode:
            code += "_RADIO"
        if "path" in args.mode:
            code += "_PATH"
        if "omic" in args.mode:
            code += "_OMICS"
    else:
        raise NotImplementedError(
            f"model_type {args.model_type!r}; note pretrained head names "
            "(fcnn/highway/early-*/late-*/kronecker) belong in --train_type")

    code += "_a%s" % str(args.alpha_surv)
    if pretrained and getattr(args, "bag_loss", "") == "ranking_nll_surv":
        code += "_n%s" % str(args.nll_ratio)
    if args.lr != 2e-4:
        code += "_lr%s" % format(args.lr, ".0e")
    if args.reg_type != "None":
        code += "_reg%s" % format(args.lambda_reg, ".0e")
    if args.gc != 1:
        code += "_gc%s" % str(args.gc)
    code += "_s%s" % str(args.seed)
    if pretrained:
        code += "_%s" % str(args.train_type)
        if "highway" in (args.train_type or "") or \
                "residual" in (args.train_type or ""):
            code += "_nl%s" % str(args.n_layers)
    if getattr(args, "test", ""):
        code += f"_{args.test}"
    return code


def write_settings(results_dir: str, exp_code: str, settings: dict) -> str:
    path = os.path.join(results_dir, f"experiment_{exp_code}.txt")
    with open(path, "w") as f:
        print(settings, file=f)
    return path


def read_settings(path: str) -> dict:
    """Safe replacement for the reference's ``eval(f.read())``."""
    with open(path) as f:
        return ast.literal_eval(f.read())


def read_experiment(results_dir: str) -> dict:
    """The settings of the experiment in ``results_dir``: its
    ``experiment_{code}.txt``, the code being the directory's name."""
    code = os.path.basename(os.path.normpath(results_dir))
    return read_settings(os.path.join(results_dir, f"experiment_{code}.txt"))


def find_settings(results_dir: str) -> Optional[str]:
    """The first ``experiment_*.txt`` of ``results_dir`` in sorted order,
    or None (JAX utils/experiment.py:110)."""
    for name in sorted(os.listdir(results_dir)):
        if name.startswith("experiment_") and name.endswith(".txt"):
            return os.path.join(results_dir, name)
    return None


def load_experiment_model(results_dir: str, which_k: int, cfg, device):
    """``cfg``'s model on ``device`` in eval mode, holding fold
    ``which_k``'s weights from ``s_{which_k}_minloss_checkpoint.pt`` in
    ``results_dir`` (the port's, or the ``.pt`` that JAX exports)."""
    from multimodalfusion_tpu_torch.engine.train import (build_model,
                                                         load_checkpoint)
    from multimodalfusion_tpu_torch.utils.params import spec_from_config
    model = build_model(cfg).to(device).eval()
    return load_checkpoint(model, os.path.join(
        results_dir, f"s_{which_k}_minloss_checkpoint.pt"),
        spec_from_config(cfg))


def config_from_settings(settings: dict, **overrides):
    """Hydrate a TrainConfig from an experiment settings dict, with the
    JAX package's key mapping and defaults (JAX utils/experiment.py:72-107).
    ``pretrained`` is inferred from train_type unless overridden; pass
    overrides for CLI-level knobs (batch_size, omic_input_dim, ...)."""
    from multimodalfusion_tpu_torch.engine.train import TrainConfig
    kwargs = dict(
        model_type=settings.get("model_type"), mode=settings["mode"],
        modalities=tuple(settings.get("radio_modality",
                                      TrainConfig.modalities)),
        n_classes=settings["n_classes"],
        bag_loss=settings.get("bag_loss", "nll_surv"),
        alpha_surv=settings.get("alpha_surv", 0.0),
        nll_ratio=settings.get("nll_ratio", 0.2),
        model_size_wsi=settings.get("model_size_wsi", "small"),
        model_size_radio=settings.get("model_size_radio", "small"),
        model_size_omic=settings.get("model_size_omic", "small"),
        fusion=settings.get("fusion"),
        radio_fusion=settings.get("radio_fusion") or "concat",
        gate=settings.get("gate_omic", False),
        gate_path=settings.get("gate_path", True),
        gate_radio=settings.get("gate_radio", True),
        drop_out=settings.get("use_drop_out", False),
        train_type=settings.get("train_type"),
        n_layers=settings.get("n_layers", 1),
        pretrained=bool(settings.get("train_type")),
        batch_size=settings.get("batch_size", 1),
        seed=settings.get("seed", 1),
        split_mode=settings.get("split_mode", "train_val"),
    )
    kwargs.update(overrides)
    return TrainConfig(**kwargs)
