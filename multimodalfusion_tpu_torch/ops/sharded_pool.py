"""Bag-sharded attention pooling: the instance axis of each bag split
over the ranks of a process group (port of
multimodalfusion_tpu/ops/sharded_pool.py).

Each rank holds a contiguous block of every bag's rows (padded to a
group-size multiple with masked rows, ``data/loaders.py``).
``mil_attention.attention_pool`` and ``attention_pool_dropout``, given
the group, pool the block with the fused forward (the ``mil_pool_fwd``
kernel on the card, the plain version on the CPU), which also returns the
block's softmax residuals (m_r, l_r), and ``merge`` joins the blocks with
collectives, the flash-style decomposition of the softmax:

    m   = max_r m_r                      (all_reduce MAX)
    w_r = l_r exp(m_r - m)
    W   = sum_r w_r                      (all_reduce SUM, with out_r w_r)
    out = sum_r out_r w_r / max(W, 1e-30)

A block with no valid row has (m_r, l_r) = (NEG_INF, 0) and out_r = 0, so
its w_r is 0 * exp(NEG_INF - m) = 0.  The backward runs the fused
backward (``mil_pool_bwd`` on the card) on each block with the GLOBAL
(out, m, W): the per-row gradient a_i (alpha_i - g.out) is the block's
restriction of the unsharded one, so dh stays on its rank (a masked row,
and so a masked block, gets dh = 0) and the attention parameters'
gradients take one SUM over the group (``sum_over``).  The layers after
the pooling see the same pooled rows on every rank of the group, so
nothing else is summed here.

The merge runs stock ops and collectives (XLA collectives in the JAX
package); the pooling itself is only ever the fused kernels.  Without a
group both functions return their input: the unsharded pooling.
"""
from __future__ import annotations

import torch
import torch.distributed as dist


def merge(out_l, ml_l, group):
    """(pooled [B, D] f32, ml [B, 2] = (m, W)) of the whole bags from this
    rank's block's (out_l, ml_l = (m_r, l_r)), the same on every rank of
    ``group``; (out_l, ml_l) itself when ``group`` is None."""
    if group is None:
        return out_l, ml_l
    m_l, l_l = ml_l[:, 0], ml_l[:, 1]
    m = m_l.clone()
    dist.all_reduce(m, op=dist.ReduceOp.MAX, group=group)
    w = l_l * torch.exp(m_l - m)
    acc = torch.cat([out_l * w[:, None], w[:, None]], dim=1)
    dist.all_reduce(acc, group=group)
    W = acc[:, -1].clamp_min(1e-30)
    return acc[:, :-1] / W[:, None], torch.stack([m, W], dim=1)


def sum_over(grads, group):
    """The attention parameters' gradients (an ``AttnParams``) summed over
    ``group`` in one collective; ``grads`` itself when it is None."""
    if group is None:
        return grads
    flat = torch.cat([t.reshape(-1) for t in grads])
    dist.all_reduce(flat, group=group)
    return type(grads)(*(part.view_as(t) for t, part in zip(
        grads, flat.split([t.numel() for t in grads]))))
