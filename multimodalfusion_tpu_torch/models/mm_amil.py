"""Multimodal attention-MIL fusion of radiology, pathology and genomics
(port of multimodalfusion_tpu/models/mm_amil.py; ref
MM_MIL_Attention_fc_surv, models/model_mm_attention_mil.py:117-200),
batched.

The radiology and pathology branches pool through
``models/pooling.AttentionPool``, and so through the fused pooling kernels
on the card.  Only the branches of the mode are built, as in the JAX
package; ``utils/params.py`` adds the reference's never-trained
placeholders of the others to a checkpoint.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from multimodalfusion_tpu_torch.models.heads import survival_outputs
from multimodalfusion_tpu_torch.models.modules import (Dense, Dropout,
                                                       RadioFusion, SNNBlock,
                                                       XlinearFusion)
from multimodalfusion_tpu_torch.models.pooling import AttentionPool
from multimodalfusion_tpu_torch.parallel import mesh

SIZE_RADIO = {"small": (1024, 256, 256), "big": (1024, 256, 384)}
SIZE_WSI = {"small": (1024, 256, 256), "big": (1024, 256, 384)}
SIZE_OMIC = {"small": (256, 256), "big": (1024, 256)}


class MMAttentionMIL(RadioFusion, nn.Module):
    """Radiology AMIL + pathology AMIL + genomic SNN branches, those of the
    mode, fused by Kronecker products (``fusion="tensor"``, the CLI's
    default) or concatenation (``"concat"``), in the order radio, path,
    omic.

    Inputs (those of the mode): radio_bags [B, Nr, n_modalities * 1024],
    radio_mask [B, Nr], path_bags [B, Np, 1024], path_mask [B, Np],
    genomic [B, G].  The radiology branch fuses its sequences as
    ``RadioAMIL`` does (``modules.RadioFusion``).  State_dict keys are the
    reference's: ``attention_net_radio.{0,3}`` and ``attention_net_WSI.{0,3}`` (FC,
    attention net), ``fc_omic.{0,1}.0``, ``mm.*`` and ``classifier.{0,3}``
    (tensor) or ``classifier`` (concat).  ``gate`` gates the fusion (the
    CLI's ``--gate_omic``), ``gate_radio`` and ``gate_path`` the attention
    nets.
    """

    def __init__(self, mode: str = "path_omic", omic_input_dim: int = 80,
                 fusion: str = "tensor", gate: bool = True,
                 gate_path: bool = True, attn_dropout: bool = False,
                 model_size_wsi: str = "small",
                 model_size_omic: str = "small", n_classes: int = 4,
                 n_modalities: int = 4, radio_fusion: str = "concat",
                 gate_radio: bool = True, model_size_radio: str = "small",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if fusion not in ("tensor", "concat"):
            raise ValueError(f"fusion {fusion!r}: tensor or concat")
        self.mode, self.fusion = mode, fusion
        n_branches = 0
        if "radio" in mode:
            size = SIZE_RADIO[model_size_radio]
            self.init_radio_fusion(n_modalities, radio_fusion, size[0],
                                   generator)
            self.attention_net_radio = nn.ModuleList([
                Dense(size[0], size[1], generator), nn.ReLU(), Dropout(0.25),
                AttentionPool(size[1], size[2], gated=gate_radio,
                              attn_dropout=attn_dropout,
                              generator=generator)])
            n_branches += 1
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

    def forward(self, radio_bags=None, radio_mask=None, path_bags=None,
                path_mask=None, genomic=None, return_attention: bool = False,
                generator: Optional[torch.Generator] = None):
        """Survival outputs, ``features`` (the branches' features) and
        ``A_raw``: with ``return_attention`` the raw attention scores
        [B, N] of the ``"radiology"`` and ``"pathology"`` branches, whose
        pooled features then come from the read-out (no kernel; JAX
        mm_amil.py:51, 76-95), else empty."""
        A_raw, branches = {}, []

        def pooled(pool, h, mask, name):
            if not return_attention:
                return pool(h, mask, generator).float()
            M, _, A_raw[name] = pool(h, mask, generator, return_attn=True)
            return M

        if "radio" in self.mode:
            fc, relu, drop, pool = self.attention_net_radio
            with mesh.bag_axis("radio"):
                h = self.fuse_radio(radio_bags, generator)
                h = drop(relu(fc(h)), generator)
                branches.append(pooled(pool, h, radio_mask, "radiology"))
        if "path" in self.mode:
            fc, relu, drop, pool = self.attention_net_WSI
            with mesh.bag_axis("path"):
                h = drop(relu(fc(path_bags)), generator)
                branches.append(pooled(pool, h, path_mask, "pathology"))
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
        out["A_raw"] = A_raw
        out["features"] = branches
        return out
