"""Shared building blocks (port of multimodalfusion_tpu/models/modules.py).

``Dense``: the reference's generic Linear layer init (ref
utils/utils.py:217 ``initialize_weights``: Xavier-normal weights, zero
bias).  ``Dropout`` and ``AlphaDropout``: dropout whose mask comes from an
explicit generator.  ``SNNBlock``: Linear -> SELU -> AlphaDropout with the
SNN init (ref utils/utils.py:228 ``init_max_weights``).
``XlinearFusion``: the Kronecker fusion of modality embeddings.
Submodules carry the reference's state_dict names.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
from torch import nn
from torch.nn import functional as F


class Dense(nn.Linear):
    """``nn.Linear`` with Xavier-normal weights and zero bias, drawn from
    ``generator`` (the global RNG when None)."""

    def __init__(self, in_features: int, out_features: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__(in_features, out_features)
        nn.init.xavier_normal_(self.weight, generator=generator)
        nn.init.zeros_(self.bias)


class Dropout(nn.Module):
    """Inverted dropout with rate ``p`` (flax ``nn.Dropout`` semantics:
    keep with probability 1 - p, scale kept values by 1 / (1 - p)).  In
    training the keep mask is drawn with the ``generator`` passed to
    ``forward``, so two runs with the same seeds draw the same bits; in
    eval mode, or with p = 0, it is the identity.  Holds no parameters,
    like ``nn.Dropout``, so state_dict keys do not change."""

    def __init__(self, p: float = 0.5):
        super().__init__()
        self.p = p

    def forward(self, x, generator: Optional[torch.Generator] = None):
        if not self.training or self.p == 0.0:
            return x
        keep = torch.rand(x.shape, generator=generator, device=x.device,
                          dtype=torch.float32) >= self.p
        return x * keep.to(x.dtype) / (1.0 - self.p)

    def extra_repr(self) -> str:
        return f"p={self.p}"


# SELU fixed point constants (Klambauer et al. 2017)
_SELU_ALPHA = 1.6732632423543772
_SELU_LAMBDA = 1.0507009873554805
_ALPHA_PRIME = -_SELU_LAMBDA * _SELU_ALPHA


class AlphaDropout(Dropout):
    """Self-normalizing dropout for SELU nets (``nn.AlphaDropout``
    semantics, JAX models/modules.py:38-54): a dropped unit becomes
    alpha', and the output is corrected by ``a x + b`` to keep its mean and
    variance.  The keep mask is drawn as ``Dropout`` draws it."""

    def forward(self, x, generator: Optional[torch.Generator] = None):
        if not self.training or self.p == 0.0:
            return x
        p, q = self.p, 1.0 - self.p
        keep = torch.rand(x.shape, generator=generator, device=x.device,
                          dtype=torch.float32) >= p
        a = (q + _ALPHA_PRIME ** 2 * q * p) ** -0.5
        b = -a * _ALPHA_PRIME * p
        return a * torch.where(keep, x, torch.full_like(x, _ALPHA_PRIME)) + b


class SNNBlock(nn.Sequential):
    """Linear -> SELU -> AlphaDropout (ref SNN_Block, model_modules.py:64;
    JAX models/modules.py:57-68).  The Linear, at index 0 as in the
    reference's Sequential, takes normal(0, 1/sqrt(fan_in)) weights and a
    zero bias from ``generator``."""

    def __init__(self, in_features: int, out_features: int,
                 dropout: float = 0.25,
                 generator: Optional[torch.Generator] = None):
        linear = nn.Linear(in_features, out_features)
        nn.init.normal_(linear.weight, 0.0, 1.0 / math.sqrt(in_features),
                        generator=generator)
        nn.init.zeros_(linear.bias)
        super().__init__(linear, nn.SELU(), AlphaDropout(dropout))

    def forward(self, x, generator: Optional[torch.Generator] = None):
        return self[2](F.selu(self[0](x)), generator)


class XlinearFusion(nn.Module):
    """Late fusion by iterated Kronecker (outer) products of gated,
    reduced modality embeddings (ref XlinearFusion, model_modules.py:
    113-178; JAX models/modules.py:167-220).

    Per modality i: h = relu(W_h v_i), gated by sigmoid(W_z [v_1 .. v_n])
    when ``gate``, o_i = dropout(relu(W_o h)) with a 1 appended.  The outer
    products of the o_i pass dropout, ``encoder1`` (+ relu, dropout),
    the inputs concatenated when ``skip``, and ``encoder2`` (+ relu,
    dropout).  State_dict layout: ``reduce.{i}.0.0`` (h), ``reduce.{i}.1.0``
    (z, gated) and ``reduce.{i}.{2|1}.0`` (o), ``encoder{1,2}.0``.
    """

    def __init__(self, dim: int = 256, scale_dim: int = 16,
                 num_modalities: int = 4, mmhid1: int = 256,
                 mmhid2: int = 256, dropout_rate: float = 0.25,
                 skip: bool = True, gate: bool = True,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        d = dim // scale_dim
        self.num_modalities, self.skip, self.gate = num_modalities, skip, gate
        self.drop = Dropout(dropout_rate)

        # each Linear sits at index 0 of a Sequential, as in the reference
        def reduce_block():
            parts = [nn.Sequential(Dense(dim, d, generator))]
            if gate:
                parts.append(nn.Sequential(
                    Dense(dim * num_modalities, d, generator)))
            parts.append(nn.Sequential(Dense(d, d, generator)))
            return nn.ModuleList(parts)
        self.reduce = nn.ModuleList(reduce_block()
                                    for _ in range(num_modalities))
        skip_dim = dim * num_modalities if skip else 0
        self.encoder1 = nn.Sequential(
            Dense((d + 1) ** num_modalities, mmhid1, generator))
        self.encoder2 = nn.Sequential(
            Dense(mmhid1 + skip_dim, mmhid2, generator))

    def forward(self, v_list: Sequence[torch.Tensor],
                generator: Optional[torch.Generator] = None):
        if len(v_list) != self.num_modalities:
            raise ValueError(f"expected {self.num_modalities} modalities, "
                             f"got {len(v_list)}")
        v_cat = torch.cat(list(v_list), dim=1)
        fused = None
        for v, block in zip(v_list, self.reduce):
            h = F.relu(block[0][0](v))
            if self.gate:
                h = torch.sigmoid(block[1][0](v_cat)) * h
            o = self.drop(F.relu(block[-1][0](h)), generator)
            o = torch.cat([o, torch.ones_like(o[:, :1])], dim=1)
            fused = o if fused is None else torch.einsum(
                "bi,bj->bij", fused, o).reshape(o.shape[0], -1)
        out = self.drop(fused, generator)
        out = self.drop(F.relu(self.encoder1[0](out)), generator)
        if self.skip:
            out = torch.cat([out] + list(v_list), dim=1)
        return self.drop(F.relu(self.encoder2[0](out)), generator)
