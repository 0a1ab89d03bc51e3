"""Attention-MIL survival models over padded, batched bags (port of
multimodalfusion_tpu/models/amil.py): ``PathAMIL`` over pathology bags,
``RadioAMIL`` over radiology bags.

Every random draw of a training forward (the FC dropout and the
attention-branch masks) comes from the ``generator`` passed to
``forward``.

``bag_group`` (cfg.bag_shard; JAX ``bag_mesh``): the bags arrive as this
rank's block of their instances and the attention pool is sharded over
the group.  The layers before the pooling see only the block's rows, so
their gradients (``instance_parameters``) are partial sums over the
group; the classifier sees the same pooled features on every rank."""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn
from torch.nn import functional as F

from multimodalfusion_tpu_torch.models.heads import survival_outputs
from multimodalfusion_tpu_torch.models.modules import (Dense, Dropout,
                                                       RadioFusion)
from multimodalfusion_tpu_torch.models.pooling import AttentionPool
from multimodalfusion_tpu_torch.parallel import mesh

SIZE_DICT = {"small": (1024, 256, 256), "big": (1024, 512, 384)}


class PathAMIL(nn.Module):
    """WSI bag -> FC(1024->256)+ReLU+Drop(.25) -> attention pool ->
    Linear classifier (ref MIL_Attention_fc_surv_path:45-72).

    Parameters follow the reference's state_dict: ``attention_net_WSI``
    = [fc, ReLU, Dropout(.25), AttentionPool] and ``classifier``, so the
    JAX package's ``.pt`` side export loads with ``strict=True``.

    ``compute_dtype``: dtype of the bag-sized work (fc and the pooling
    input); parameters stay f32, and the pooled features and the
    classifier stay f32.
    """

    def __init__(self, model_size: str = "small", gate: bool = True,
                 attn_dropout: bool = False, n_classes: int = 4,
                 compute_dtype: str = "float32",
                 generator: Optional[torch.Generator] = None,
                 bag_group=None):
        super().__init__()
        size = SIZE_DICT[model_size]
        self.compute_dtype = getattr(torch, compute_dtype)
        self.attention_net_WSI = nn.ModuleList([
            Dense(size[0], size[1], generator), nn.ReLU(), Dropout(0.25),
            AttentionPool(size[1], size[2], gated=gate,
                          attn_dropout=attn_dropout, generator=generator,
                          bag_group=bag_group)])
        self.classifier = Dense(size[1], n_classes, generator)

    @property
    def pool(self) -> AttentionPool:
        return self.attention_net_WSI[3]

    def instance_parameters(self):
        """The parameters of the per-instance layers before the pooling
        (``fc``)."""
        return list(self.attention_net_WSI[0].parameters())

    def embed(self, bags, generator: Optional[torch.Generator] = None):
        """Per-instance features h [B, N, L] in the compute dtype."""
        fc, relu, drop = self.attention_net_WSI[:3]
        cdt = self.compute_dtype
        h = F.linear(bags.to(cdt), fc.weight.to(cdt), fc.bias.to(cdt))
        return drop(relu(h), generator)

    def head(self, M):
        """Survival outputs of the pooled features M [B, L] (f32)."""
        out = survival_outputs(self.classifier(M))
        out["features"] = M
        return out

    def forward(self, bags, mask, return_features: bool = False,
                attention_only: bool = False,
                generator: Optional[torch.Generator] = None):
        """Survival outputs; the pooled features [B, L] with
        ``return_features``; with ``attention_only`` the raw attention
        scores [B, N] of the read-out (no kernel; JAX amil.py:51-53)."""
        with mesh.bag_axis("path"):
            h = self.embed(bags, generator)
            if attention_only:
                return self.pool(h, mask, generator, return_attn=True)[2]
            M = self.pool(h, mask, generator).float()
        if return_features:
            return M
        return self.head(M)


class RadioAMIL(RadioFusion, nn.Module):
    """Radiology bag -> modality fusion -> FC+ReLU+Drop(.25) -> attention
    pool -> Linear classifier (ref MIL_Attention_fc_surv_radio:66-115; JAX
    models/amil.py:63-128).

    ``bags`` [B, N, n_modalities * 1024]: each slice's features of every
    sequence side by side, slice-aligned by the data layer's
    intersection; [B, N, 1024] with one sequence (lung CT), which goes
    straight to ``fc``.  With more than one, ``radio_fusion`` is
    ``concat`` or ``tensor`` (``modules.RadioFusion``).

    Parameters follow the reference's state_dict: ``attention_net_radio``
    = [fc, ReLU, Dropout(.25), AttentionPool], ``classifier`` and
    ``reduce_dim`` or ``radio_xfusion``.  ``compute_dtype`` as in
    ``PathAMIL`` (``reduce_dim`` and ``fc``; the Kronecker fusion stays
    f32, as in the JAX package).
    """

    def __init__(self, n_modalities: int = 4, radio_fusion: str = "concat",
                 model_size: str = "small", gate: bool = True,
                 attn_dropout: bool = False, n_classes: int = 4,
                 compute_dtype: str = "float32",
                 generator: Optional[torch.Generator] = None,
                 bag_group=None):
        super().__init__()
        size = SIZE_DICT[model_size]
        self.compute_dtype = getattr(torch, compute_dtype)
        self.init_radio_fusion(n_modalities, radio_fusion, size[0],
                               generator)
        self.attention_net_radio = nn.ModuleList([
            Dense(size[0], size[1], generator), nn.ReLU(), Dropout(0.25),
            AttentionPool(size[1], size[2], gated=gate,
                          attn_dropout=attn_dropout, generator=generator,
                          bag_group=bag_group)])
        self.classifier = Dense(size[1], n_classes, generator)

    @property
    def pool(self) -> AttentionPool:
        return self.attention_net_radio[3]

    def instance_parameters(self):
        """The parameters of the per-instance layers before the pooling
        (``reduce_dim`` or ``radio_xfusion``, and ``fc``)."""
        fusion = [m for name in ("reduce_dim", "radio_xfusion")
                  for m in [getattr(self, name, None)] if m is not None]
        return [p for m in fusion + [self.attention_net_radio[0]]
                for p in m.parameters()]

    def embed(self, bags, generator: Optional[torch.Generator] = None):
        """Per-instance features h [B, N, L] in the compute dtype."""
        fc, relu, drop = self.attention_net_radio[:3]
        cdt = self.compute_dtype
        h = self.fuse_radio(bags, generator, cdt).to(cdt)
        h = F.linear(h, fc.weight.to(cdt), fc.bias.to(cdt))
        return drop(relu(h), generator)

    def head(self, M):
        """Survival outputs of the pooled features M [B, L] (f32)."""
        out = survival_outputs(self.classifier(M))
        out["features"] = M
        return out

    def forward(self, bags, mask, return_features: bool = False,
                attention_only: bool = False,
                generator: Optional[torch.Generator] = None):
        """Survival outputs; the pooled features [B, L] with
        ``return_features``; with ``attention_only`` the raw attention
        scores [B, N] of the read-out (no kernel; JAX amil.py:51-53)."""
        with mesh.bag_axis("radio"):
            h = self.embed(bags, generator)
            if attention_only:
                return self.pool(h, mask, generator, return_attn=True)[2]
            M = self.pool(h, mask, generator).float()
        if return_features:
            return M
        return self.head(M)
