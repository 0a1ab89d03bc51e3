"""Multimodal attention-MIL fusion, pathology + genomics (port of
multimodalfusion_tpu/models/mm_amil.py; ref MM_MIL_Attention_fc_surv,
models/model_mm_attention_mil.py:117-200), batched.

The pathology branch pools through ``models/pooling.AttentionPool``, and so
through the fused pooling kernels on the card.  The radiology branch is
not ported yet (ROADMAP.md, port queue item 4).  Only the branches of the
mode are built, as in the JAX package; ``utils/params.py`` adds the
reference's never-trained placeholders of the others to a checkpoint.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from multimodalfusion_tpu_torch.models.heads import survival_outputs
from multimodalfusion_tpu_torch.models.modules import (Dense, Dropout,
                                                       SNNBlock,
                                                       XlinearFusion)
from multimodalfusion_tpu_torch.models.pooling import AttentionPool

SIZE_WSI = {"small": (1024, 256, 256), "big": (1024, 256, 384)}
SIZE_OMIC = {"small": (256, 256), "big": (1024, 256)}


class MMAttentionMIL(nn.Module):
    """Pathology AMIL + genomic SNN branches fused by Kronecker products
    (``fusion="tensor"``, the CLI's default) or concatenation
    (``"concat"``).

    Inputs (those of the mode): path_bags [B, N, 1024], path_mask [B, N],
    genomic [B, G].  State_dict keys are the reference's:
    ``attention_net_WSI.{0,3}`` (FC, attention net), ``fc_omic.{0,1}.0``,
    ``mm.*`` and ``classifier.{0,3}`` (tensor) or ``classifier`` (concat).
    ``gate`` gates the fusion (the CLI's ``--gate_omic``), ``gate_path`` the
    attention net.
    """

    def __init__(self, mode: str = "path_omic", omic_input_dim: int = 80,
                 fusion: str = "tensor", gate: bool = True,
                 gate_path: bool = True, attn_dropout: bool = False,
                 model_size_wsi: str = "small",
                 model_size_omic: str = "small", n_classes: int = 4,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if "radio" in mode:
            raise NotImplementedError(
                f"mode {mode!r}: the radiology branch of mm_attention_mil "
                "is not ported yet (ROADMAP.md, port queue item 4)")
        if fusion not in ("tensor", "concat"):
            raise ValueError(f"fusion {fusion!r}: tensor or concat")
        self.mode, self.fusion = mode, fusion
        n_branches = 0
        if "path" in mode:
            size = SIZE_WSI[model_size_wsi]
            self.attention_net_WSI = nn.ModuleList([
                Dense(size[0], size[1], generator), nn.ReLU(), Dropout(0.25),
                AttentionPool(size[1], size[2], gated=gate_path,
                              attn_dropout=attn_dropout,
                              generator=generator)])
            n_branches += 1
        if "omic" in mode:
            widths = (omic_input_dim,) + SIZE_OMIC[model_size_omic]
            self.fc_omic = nn.ModuleList(
                SNNBlock(a, b, 0.25, generator)
                for a, b in zip(widths[:-1], widths[1:]))
            n_branches += 1
        if not n_branches:
            raise ValueError(f"mode {mode!r} selects no branch")
        if fusion == "tensor":
            self.mm = XlinearFusion(dim=256, scale_dim=16, mmhid1=512,
                                    mmhid2=512, num_modalities=n_branches,
                                    skip=True, gate=gate, generator=generator)
            self.classifier = nn.Sequential(
                Dense(512, 256, generator), nn.ReLU(), Dropout(0.25),
                Dense(256, n_classes, generator))
        else:
            self.classifier = Dense(256 * n_branches, n_classes, generator)

    def forward(self, path_bags=None, path_mask=None, genomic=None,
                generator: Optional[torch.Generator] = None):
        branches = []
        if "path" in self.mode:
            fc, relu, drop, pool = self.attention_net_WSI
            h = drop(relu(fc(path_bags)), generator)
            branches.append(pool(h, path_mask, generator).float())
        if "omic" in self.mode:
            x = genomic
            for block in self.fc_omic:
                x = block(x, generator)
            branches.append(x)
        if self.fusion == "tensor":
            fc0, relu, drop, fc1 = self.classifier
            z = drop(relu(fc0(self.mm(branches, generator))), generator)
            logits = fc1(z)
        else:
            logits = self.classifier(torch.cat(branches, dim=1))
        out = survival_outputs(logits)
        out["features"] = branches
        return out
