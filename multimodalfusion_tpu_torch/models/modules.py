"""Shared building blocks (port of multimodalfusion_tpu/models/modules.py).

Only ``Dense`` so far: the reference's generic Linear layer init
(ref utils/utils.py:217 ``initialize_weights``: Xavier-normal weights,
zero bias).
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
