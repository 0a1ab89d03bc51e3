"""Experiment settings txt -> TrainConfig (port of the serving part of
multimodalfusion_tpu/utils/experiment.py)."""
from __future__ import annotations

import ast


def read_settings(path: str) -> dict:
    """Safe replacement for the reference's ``eval(f.read())``."""
    with open(path) as f:
        return ast.literal_eval(f.read())


def config_from_settings(settings: dict, **overrides):
    """Hydrate a TrainConfig from an experiment settings dict, with the
    JAX package's key mapping and defaults for the fields serving reads.
    ``pretrained`` is inferred from train_type unless overridden; pass
    overrides for CLI-level knobs (batch_size, ...)."""
    from multimodalfusion_tpu_torch.engine.train import TrainConfig
    kwargs = dict(
        model_type=settings.get("model_type"), mode=settings["mode"],
        n_classes=settings["n_classes"],
        model_size_wsi=settings.get("model_size_wsi", "small"),
        gate_path=settings.get("gate_path", True),
        drop_out=settings.get("use_drop_out", False),
        pretrained=bool(settings.get("train_type")),
        batch_size=settings.get("batch_size", 1),
    )
    kwargs.update(overrides)
    return TrainConfig(**kwargs)
