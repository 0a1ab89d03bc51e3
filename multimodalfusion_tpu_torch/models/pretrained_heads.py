"""Stage-4 heads over frozen 256-d unimodal embeddings (port of
multimodalfusion_tpu/models/pretrained_heads.py).

Both reference families in one pair of modules, chosen by ``bag_loss``
as the JAX package chooses (``is_nll``): the nll family
(ref models/nll_models_pretrained.py) emits per-bin logits and
(hazards, S, risk), the cox/ranking family
(ref models/coxranking_models_pretrained.py) a scalar risk.  Every
BatchNorm is a ``MaskedBatchNorm`` fed the batch's ``valid`` rows, and
every dropout draws from the ``generator`` passed to ``forward``.
Submodules carry the reference's state_dict names (the JAX package's
``.pt`` export, JAX utils/torch_interop.py:248-305).
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn
from torch.nn import functional as F

from multimodalfusion_tpu_torch.models.heads import (scalar_risk_outputs,
                                                     survival_outputs)
from multimodalfusion_tpu_torch.models.modules import (Dense, Dropout,
                                                       Highway,
                                                       MaskedBatchNorm,
                                                       Residual,
                                                       XlinearFusion)

EMBED_DIM = 256
UNIMODAL_TYPES = ("fcnn", "highway", "residual")
MULTIMODAL_TYPES = ("late-fcnn", "late-highway", "early-fcnn",
                    "early-highway", "kronecker", "multimodal-dropout")
# the reference's branch names of the late-fcnn head, which the
# multimodal-dropout freeze keys on (JAX engine/train.py:306-310)
LATE_NAMES = {"radio": "MRI", "path": "WSI", "omic": "omic"}


def is_nll(bag_loss: str) -> bool:
    """Hazard-family losses (nll, ce) need per-bin logits.  The reference
    keys on 'nll_surv' only, which leaves ce_surv a scalar head its own
    loss cannot use; the JAX package fixes that (pretrained_heads.py:21),
    and so does the port."""
    bl = bag_loss or ""
    return "nll_surv" in bl or "ce" in bl


def present_modalities(mode: str):
    return [m for m in ("radio", "path", "omic") if m in (mode or "")]


def _outputs(logits, nll: bool):
    return survival_outputs(logits) if nll else scalar_risk_outputs(logits)


class _FCBlock(nn.Sequential):
    """Linear -> MaskedBatchNorm -> ReLU -> Dropout(0.7) [-> Linear], at
    the reference Sequential's indices 0, 1, (2, 3), 4."""

    def __init__(self, n_in: int, hidden: int, n_out: Optional[int],
                 generator: Optional[torch.Generator]):
        parts = [Dense(n_in, hidden, generator), MaskedBatchNorm(hidden),
                 nn.ReLU(), Dropout(0.7)]
        if n_out is not None:
            parts.append(Dense(hidden, n_out, generator))
        super().__init__(*parts)

    def forward(self, x, valid=None,
                generator: Optional[torch.Generator] = None):
        z = self[3](F.relu(self[1](self[0](x), valid)), generator)
        return self[4](z) if len(self) > 4 else z


class UnimodalPretrained(nn.Module):
    """fcnn / highway / residual head on one embedding, the one ``mode``
    names (ref nll_models_pretrained.py:14-62,
    coxranking_models_pretrained.py:14-58; JAX pretrained_heads.py:29-80).

    fcnn: nll ``classifier`` = [Linear(256, n_classes), Dropout(0.7)]
    (the reference's dropout on the logits, kept); cox
    ``classifier`` = [Linear(256, 128), BN, ReLU, Dropout(0.7),
    Linear(128, 1)].  highway / residual: ``highway`` or ``residual``
    over 256, then a Linear ``classifier``."""

    def __init__(self, mode: str = "omic", train_type: str = "fcnn",
                 bag_loss: str = "nll_surv", n_classes: int = 4,
                 n_layers: int = 1,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if mode not in ("radio", "path", "omic"):
            raise ValueError(f"a unimodal head reads one embedding (radio, "
                             f"path or omic), not mode {mode!r}")
        if train_type not in UNIMODAL_TYPES:
            raise ValueError(f"train_type {train_type!r}: a unimodal head "
                             f"is one of {UNIMODAL_TYPES}")
        self.mode, self.train_type = mode, train_type
        self.nll = is_nll(bag_loss)
        width = n_classes if self.nll else 1
        if train_type == "fcnn":
            self.classifier = (
                nn.Sequential(Dense(EMBED_DIM, width, generator),
                              Dropout(0.7)) if self.nll
                else _FCBlock(EMBED_DIM, 128, 1, generator))
            return
        if train_type == "highway":
            self.highway = Highway(EMBED_DIM, n_layers, generator)
        else:
            self.residual = Residual(EMBED_DIM, n_layers, generator)
        self.classifier = Dense(EMBED_DIM, width, generator)

    def forward(self, h_radio=None, h_path=None, h_omic=None, valid=None,
                generator: Optional[torch.Generator] = None):
        h = {"radio": h_radio, "path": h_path, "omic": h_omic}[self.mode]
        if self.train_type == "fcnn":
            if self.nll:
                linear, drop = self.classifier
                return _outputs(drop(linear(h), generator), True)
            return _outputs(self.classifier(h, valid, generator), False)
        if self.train_type == "highway":
            h = self.highway(h, valid, generator)
        else:
            h = self.residual(h, valid)
        return _outputs(self.classifier(h), self.nll)


class MultimodalPretrained(nn.Module):
    """early/late fcnn/highway or Kronecker fusion head over the
    embeddings ``mode`` names (ref nll_models_pretrained.py:66-197,
    coxranking_models_pretrained.py:62-183; JAX
    pretrained_heads.py:83-155).  ``multimodal-dropout`` builds
    ``late-fcnn``: its training freezes a branch for a step whose batch
    lacks that modality (``engine/train.py``).

    late-fcnn: per modality ``layer_{MRI,WSI,omic}`` = [Linear(256, 128),
    BN, ReLU, Dropout(0.7)] (+ Linear(128, 1) for cox), concatenated into
    ``classifier.0``.  late-highway: ``highway_{m}`` per modality, then
    ``classifier``.  early-fcnn: the concatenated embeddings through
    ``classifier`` = [Linear(n*256, 128), BN, ReLU, Dropout(0.7),
    Linear].  early-highway: ``highway`` over n*256, then ``classifier``.
    kronecker: ``xfusion`` = XlinearFusion(256, scale 16, mmhid 256,
    dropout 0.7, skip), then ``classifier``."""

    def __init__(self, mode: str = "radio_path_omic",
                 train_type: str = "early-fcnn", bag_loss: str = "nll_surv",
                 n_classes: int = 4, n_layers: int = 1,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if train_type not in MULTIMODAL_TYPES:
            raise ValueError(f"train_type {train_type!r}: a multimodal head "
                             f"is one of {MULTIMODAL_TYPES}")
        self.present = present_modalities(mode)
        if not self.present:
            raise ValueError(f"mode {mode!r} names no embedding")
        if train_type == "multimodal-dropout":
            train_type = "late-fcnn"
        self.train_type = train_type
        self.nll = is_nll(bag_loss)
        n, width = len(self.present), n_classes if self.nll else 1
        if train_type == "late-fcnn":
            for m in self.present:
                setattr(self, f"layer_{LATE_NAMES[m]}", _FCBlock(
                    EMBED_DIM, 128, None if self.nll else 1, generator))
            self.classifier = nn.Sequential(
                Dense(n * (128 if self.nll else 1), width, generator))
        elif train_type == "late-highway":
            for m in self.present:
                setattr(self, f"highway_{m}",
                        Highway(EMBED_DIM, n_layers, generator))
            self.classifier = Dense(n * EMBED_DIM, width, generator)
        elif train_type == "early-fcnn":
            self.classifier = _FCBlock(n * EMBED_DIM, 128, width, generator)
        elif train_type == "early-highway":
            self.highway = Highway(n * EMBED_DIM, n_layers, generator)
            self.classifier = Dense(n * EMBED_DIM, width, generator)
        else:
            self.xfusion = XlinearFusion(
                dim=EMBED_DIM, scale_dim=16, num_modalities=n, mmhid1=256,
                mmhid2=256, dropout_rate=0.7, skip=True, generator=generator)
            self.classifier = Dense(256, width, generator)

    def forward(self, h_radio=None, h_path=None, h_omic=None, valid=None,
                generator: Optional[torch.Generator] = None):
        given = {"radio": h_radio, "path": h_path, "omic": h_omic}
        embeds = [given[m] for m in self.present]
        tt = self.train_type
        if tt == "late-fcnn":
            MM = torch.cat([getattr(self, f"layer_{LATE_NAMES[m]}")(
                h, valid, generator) for m, h in zip(self.present, embeds)],
                dim=1)
            logits = self.classifier(MM)
        elif tt == "late-highway":
            MM = torch.cat([getattr(self, f"highway_{m}")(h, valid,
                                                          generator)
                            for m, h in zip(self.present, embeds)], dim=1)
            logits = self.classifier(MM)
        elif tt == "early-fcnn":
            logits = self.classifier(torch.cat(embeds, dim=1), valid,
                                     generator)
        elif tt == "early-highway":
            logits = self.classifier(self.highway(
                torch.cat(embeds, dim=1), valid, generator))
        else:
            logits = self.classifier(self.xfusion(embeds, generator))
        return _outputs(logits, self.nll)
