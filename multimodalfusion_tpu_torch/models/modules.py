"""Shared building blocks (port of multimodalfusion_tpu/models/modules.py).

``Dense``: the reference's generic Linear layer init (ref
utils/utils.py:217 ``initialize_weights``: Xavier-normal weights, zero
bias).  ``Dropout``: inverted dropout whose mask comes from an explicit
generator.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn


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
