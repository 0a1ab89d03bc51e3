"""AttentionPool: the attention-net parameters in the reference's layout,
pooled through ``ops/mil_attention.py`` (port of
multimodalfusion_tpu/models/pooling.py): the fused pooling kernels, the
bag-sharded pooling over a process group (``ops/sharded_pool.py``), or
the unfused read-out that also returns the attention and its raw
scores."""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from multimodalfusion_tpu_torch.models.modules import Dense
from multimodalfusion_tpu_torch.ops import mil_attention as mil
from multimodalfusion_tpu_torch.parallel import mesh


class AttentionPool(nn.Module):
    """Masked attention-MIL pooling over padded bags: h [B, N, L], mask
    [B, N] -> pooled [B, L] in f32.

    Submodules carry the reference's state_dict names (ref
    model_modules.py:70-110): gated ``attention_a = [Linear, Tanh(,
    Dropout)]``, ``attention_b = [Linear, Sigmoid(, Dropout)]``,
    ``attention_c = Linear``; ungated ``module = [Linear, Tanh(, Dropout),
    Linear]``.  The Dropout entries hold no parameters; they fix the index
    of the last Linear (``module.2`` or ``module.3``).

    ``bag_group``: a process group over which the instance axis is
    sharded (cfg.bag_shard): h and mask are then this rank's block of
    every bag, and the fused pooling merges the blocks over the group
    (``ops/sharded_pool.py``).
    """

    def __init__(self, L: int, D: int = 256, gated: bool = True,
                 attn_dropout: bool = False,
                 generator: Optional[torch.Generator] = None,
                 bag_group=None):
        super().__init__()
        self.gated = gated
        self.attn_dropout = attn_dropout
        self.bag_group = bag_group

        def branch(act):
            layers = [Dense(L, D, generator), act]
            if attn_dropout:
                layers.append(nn.Dropout(mil.ATTN_DROPOUT_RATE))
            return layers

        if gated:
            self.attention_a = nn.Sequential(*branch(nn.Tanh()))
            self.attention_b = nn.Sequential(*branch(nn.Sigmoid()))
            self.attention_c = Dense(D, 1, generator)
        else:
            self.module = nn.Sequential(*branch(nn.Tanh()),
                                        Dense(D, 1, generator))

    def attn_params(self) -> mil.AttnParams:
        """The parameters in the JAX package's [in, out] layout."""
        if self.gated:
            a, b, c = (self.attention_a[0], self.attention_b[0],
                       self.attention_c)
            Wb, bb = b.weight.t(), b.bias
        else:
            a, c = self.module[0], self.module[-1]
            Wb, bb = torch.zeros_like(a.weight.t()), torch.zeros_like(a.bias)
        return mil.AttnParams(Wa=a.weight.t(), ba=a.bias, Wb=Wb, bb=bb,
                              wc=c.weight.t(), cc=c.bias)

    def forward(self, h, mask, generator: Optional[torch.Generator] = None,
                return_attn: bool = False):
        """In training with ``attn_dropout`` the branch keep masks are drawn
        with ``generator`` (on h's device; this rank's block of the global
        batch's masks, ``mesh.draw``) and applied inside the fused
        kernels, forward and backward alike (JAX models/pooling.py:53-74);
        otherwise no dropout.

        ``return_attn``: the unfused read-out (JAX models/pooling.py:
        76-90), (pooled [B, L], attn [B, N], raw scores s [B, N]) through
        stock ops in h's type promoted with the parameters', with the same
        keep masks, scaled by 1/(1-rate), on both branches.  It launches
        no kernel."""
        params = self.attn_params()
        da = db = None
        if self.attn_dropout and self.training:
            da, db = mesh.draw(
                lambda shape, g: mil.make_dropout_masks(
                    g, shape, gated=self.gated, device=h.device),
                (h.shape[0], h.shape[1], params.Wa.shape[1]), generator,
                h.device)
        if return_attn:
            if self.bag_group is not None:
                raise ValueError("the attention read-out runs on whole "
                                 "bags, not on a bag-sharded pool")
            h = h.to(torch.promote_types(h.dtype, params.Wa.dtype))
            return mil.attention_pool_with_attn(h, mask, params, self.gated,
                                                da, db)
        if da is not None:
            return mil.attention_pool_dropout(h, mask, da, db, params,
                                              self.gated,
                                              group=self.bag_group)
        return mil.attention_pool(h, mask, params, self.gated,
                                  group=self.bag_group)
