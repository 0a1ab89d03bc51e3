"""Genomic SNN (port of multimodalfusion_tpu/models/genomic.py; ref MaxNet,
models/model_genomic.py:13-72)."""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from multimodalfusion_tpu_torch.models.heads import (scalar_risk_outputs,
                                                     survival_outputs)
from multimodalfusion_tpu_torch.models.modules import Dense, SNNBlock

SIZE_DICT_OMIC = {"small": (256, 256), "big": (1024, 256)}


def per_bin_head(bag_loss: str) -> bool:
    """Hazard-family losses (nll, ce) need per-bin logits; cox and ranking
    a scalar risk.  The reference keys on 'nll' only
    (model_genomic.py:33), which gives ce_surv a scalar head that its own
    training loop cannot use; the JAX package fixes that, and so does
    the port."""
    return "nll" in bag_loss or "ce" in bag_loss


class MaxNet(nn.Module):
    """SELU SNN over the genomic feature vector: [B, G] -> SNNBlock
    (hidden[0]) -> SNNBlock(hidden[1]) -> classifier (n_classes logits for
    nll/ce losses, a scalar risk otherwise).  State_dict keys are the
    reference's: ``fc_omic.{0,1}.0``, ``classifier``."""

    def __init__(self, omic_input_dim: int, model_size: str = "small",
                 bag_loss: str = "nll_surv", n_classes: int = 4,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        hidden = SIZE_DICT_OMIC[model_size]
        widths = (omic_input_dim,) + hidden
        self.fc_omic = nn.ModuleList(
            SNNBlock(a, b, 0.25, generator)
            for a, b in zip(widths[:-1], widths[1:]))
        self.per_bin = per_bin_head(bag_loss)
        self.classifier = Dense(hidden[-1], n_classes if self.per_bin else 1,
                                generator)

    def forward(self, genomic_features, return_features: bool = False,
                generator: Optional[torch.Generator] = None):
        x = genomic_features
        for block in self.fc_omic:
            x = block(x, generator)
        if return_features:
            return x
        logits = self.classifier(x)
        out = (survival_outputs(logits) if self.per_bin
               else scalar_risk_outputs(logits))
        out["features"] = x
        return out
