"""Shared building blocks (port of multimodalfusion_tpu/models/modules.py).

``Dense``: the reference's generic Linear layer init (ref
utils/utils.py:217 ``initialize_weights``: Xavier-normal weights, zero
bias).  ``Dropout`` and ``AlphaDropout``: dropout whose mask comes from an
explicit generator.  ``SNNBlock``: Linear -> SELU -> AlphaDropout with the
SNN init (ref utils/utils.py:228 ``init_max_weights``).
``XlinearFusion``: the Kronecker fusion of modality embeddings.
``RadioFusion``: the radiology branch's fusion of its sequences.
``MaskedBatchNorm``, ``Highway`` and ``Residual``: the stage-4 heads'
blocks, with batch statistics over the valid rows of a padded batch.
Submodules carry the reference's state_dict names.

Under data parallelism (``parallel/mesh.py``) a dropout mask is this
rank's block of the global batch's mask and the batch statistics span the
global batch.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
from torch import nn
from torch.nn import functional as F

from multimodalfusion_tpu_torch.parallel import mesh


class Dense(nn.Linear):
    """``nn.Linear`` with Xavier-normal weights and zero bias, drawn from
    ``generator`` (the global RNG when None)."""

    def __init__(self, in_features: int, out_features: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__(in_features, out_features)
        nn.init.xavier_normal_(self.weight, generator=generator)
        nn.init.zeros_(self.bias)


def _uniform(x, generator: Optional[torch.Generator]) -> torch.Tensor:
    """Uniform [0, 1) f32 draws of x's shape from ``generator``: this
    rank's block of the global batch's draw (``mesh.draw``)."""
    return mesh.draw(lambda shape, g: torch.rand(
        shape, generator=g, device=x.device, dtype=torch.float32),
        x.shape, generator, x.device)


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
        keep = _uniform(x, generator) >= self.p
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
        keep = _uniform(x, generator) >= p
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


class RadioFusion:
    """Mixin of the models with a radiology branch (``RadioAMIL`` and
    ``MMAttentionMIL``): the fusion of each slice's sequences into one
    ``dim``-wide instance.  One sequence (lung CT) goes straight in; more
    are fused by ``reduce_dim`` (``concat``: Linear(n * dim -> dim)) or
    ``radio_xfusion`` (``tensor``: a per-instance Kronecker fusion, as the
    JAX package implements the reference's broken tensor path).  Both are
    registered on the model itself, so their state_dict keys are the
    reference's top-level ones."""

    def init_radio_fusion(self, n_modalities: int, radio_fusion: str,
                          dim: int,
                          generator: Optional[torch.Generator] = None):
        if radio_fusion not in ("concat", "tensor"):
            raise ValueError(f"radio_fusion {radio_fusion!r}: concat or "
                             f"tensor")
        self.n_modalities, self.radio_fusion = n_modalities, radio_fusion
        if n_modalities == 1:
            return
        if radio_fusion == "concat":
            self.reduce_dim = Dense(dim * n_modalities, dim, generator)
        else:
            self.radio_xfusion = XlinearFusion(
                dim=dim, scale_dim=64, num_modalities=n_modalities,
                mmhid1=dim, mmhid2=dim, skip=False, generator=generator)

    def fuse_radio(self, bags, generator: Optional[torch.Generator] = None,
                   compute_dtype: torch.dtype = torch.float32):
        """Bags [B, N, n_modalities * dim] fused to [B, N, dim]:
        ``reduce_dim`` in ``compute_dtype``, the Kronecker fusion in f32."""
        if self.n_modalities == 1:
            return bags
        if self.radio_fusion == "concat":
            rd, cdt = self.reduce_dim, compute_dtype
            return F.linear(bags.to(cdt), rd.weight.to(cdt), rd.bias.to(cdt))
        B, N, _ = bags.shape
        per_mod = bags.float().reshape(B * N, self.n_modalities, -1)
        return self.radio_xfusion(list(per_mod.unbind(1)),
                                  generator).reshape(B, N, -1)


class MaskedBatchNorm(nn.Module):
    """``nn.BatchNorm1d`` with a row-validity mask (JAX models/modules.py:
    75-112).  In training, the statistics come from the rows whose
    ``valid`` is 1 (all rows when it is None), so the padding of a partial
    batch stays out of them, as the reference's genuinely smaller final
    batch would; a batch with one valid row normalises by a zero variance
    instead of raising.  It normalises with the biased variance and moves
    ``running_var`` by the unbiased one (n / max(n - 1, 1)); ``momentum``
    is torch's (0.1, flax's 0.9).  In eval mode it uses the running
    statistics.  The buffers are ``nn.BatchNorm1d``'s, so the
    reference-layout state_dict round-trips.  Under data parallelism the
    statistics span the valid rows of the global batch, as the JAX
    package's program over the whole batch computes them: the sums over
    rows are summed over the data group (with their backward), so every
    rank normalises alike and keeps the same running statistics."""

    def __init__(self, num_features: int, momentum: float = 0.1,
                 eps: float = 1e-5):
        super().__init__()
        self.momentum, self.eps = momentum, eps
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))
        self.register_buffer("num_batches_tracked",
                             torch.tensor(0, dtype=torch.long))

    def forward(self, x, valid: Optional[torch.Tensor] = None):
        if not self.training:
            mean, var = self.running_mean, self.running_var
        else:
            v = (torch.ones(x.shape[0], dtype=x.dtype, device=x.device)
                 if valid is None else valid.to(x.dtype))
            group = mesh.active_data_group()

            def total(t):  # a sum over the valid rows of the global batch
                return t if group is None else mesh.all_reduce_sum(t, group)
            sums = total(torch.cat([(x * v[:, None]).sum(0), v.sum()[None]]))
            n = sums[-1].clamp_min(1.0)
            mean = sums[:-1] / n
            var = total((v[:, None] * (x - mean) ** 2).sum(0)) / n
            with torch.no_grad():
                m = 1.0 - self.momentum
                unbiased = var * n / (n - 1.0).clamp_min(1.0)
                self.running_mean.copy_(m * self.running_mean
                                        + (1.0 - m) * mean)
                self.running_var.copy_(m * self.running_var
                                       + (1.0 - m) * unbiased)
                self.num_batches_tracked += 1
        return (x - mean) / torch.sqrt(var + self.eps) * self.weight \
            + self.bias

    def extra_repr(self) -> str:
        return (f"{self.weight.shape[0]}, eps={self.eps}, "
                f"momentum={self.momentum}")


class Highway(nn.Module):
    """BN -> Dropout(0.7) -> ``num_layers`` gated highway layers
    (x = g * relu(W_n x) + (1 - g) * W_l x, g = sigmoid(W_g x)) -> BN
    (ref Highway, model_modules.py:5-26; JAX models/modules.py:115-131).
    State_dict: ``bn1``, ``nonlinear.{i}``, ``linear.{i}``, ``gate.{i}``,
    ``bn2``."""

    def __init__(self, size: int, num_layers: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.bn1 = MaskedBatchNorm(size)
        self.drop = Dropout(0.7)
        self.nonlinear = nn.ModuleList(Dense(size, size, generator)
                                       for _ in range(num_layers))
        self.linear = nn.ModuleList(Dense(size, size, generator)
                                    for _ in range(num_layers))
        self.gate = nn.ModuleList(Dense(size, size, generator)
                                  for _ in range(num_layers))
        self.bn2 = MaskedBatchNorm(size)

    def forward(self, x, valid=None,
                generator: Optional[torch.Generator] = None):
        x = self.drop(self.bn1(x, valid), generator)
        for nonlinear, linear, gate in zip(self.nonlinear, self.linear,
                                           self.gate):
            g = torch.sigmoid(gate(x))
            x = g * F.relu(nonlinear(x)) + (1.0 - g) * linear(x)
        return self.bn2(x, valid)


class ResidualBlock(nn.Module):
    """relu(bn2(fc2(relu(bn1(fc1(x))))) + x) (ref ResidualBlock,
    model_modules.py:28-49; JAX models/modules.py:134-147)."""

    def __init__(self, size: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.fc1 = Dense(size, size, generator)
        self.bn1 = MaskedBatchNorm(size)
        self.fc2 = Dense(size, size, generator)
        self.bn2 = MaskedBatchNorm(size)

    def forward(self, x, valid=None):
        out = F.relu(self.bn1(self.fc1(x), valid))
        return F.relu(self.bn2(self.fc2(out), valid) + x)


class Residual(nn.Module):
    """``n_layers`` residual blocks, state_dict ``blocks.{i}`` (ref
    model_modules.py:51-59; JAX models/modules.py:150-159)."""

    def __init__(self, size: int, n_layers: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.blocks = nn.ModuleList(ResidualBlock(size, generator)
                                    for _ in range(n_layers))

    def forward(self, x, valid=None):
        for block in self.blocks:
            x = block(x, valid)
        return x
