"""Survival losses over batched tensors (port of
multimodalfusion_tpu/losses.py).

Numerically the JAX package's functions (ref loss_utils.py nll_loss:22,
ce_loss:41, ranking_loss:58, CoxSurvLoss:124, RankingNLLSurvLoss:151),
vectorized over the batch.  Every loss takes an optional ``valid`` mask
[B] so that the padded entries of a partial batch contribute nothing.

Conventions:
  hazards: [B, K] per-bin conditional hazard, sigmoid(logits)
  S:       [B, K] survival = cumprod(1 - hazards)
  Y:       [B] int discrete time-bin label in [0, K)
  c:       [B] censorship (1 = censored, 0 = event observed)
  t:       [B] continuous event/censoring time
  risks:   [B] scalar risk score (higher = worse prognosis)
"""
from __future__ import annotations

from typing import Iterable, Union

import torch


def _as_valid(valid, n, like):
    if valid is None:
        return torch.ones(n, dtype=like.dtype, device=like.device)
    return valid.to(like.dtype)


def _take(x, idx):
    return torch.gather(x, 1, idx[:, None])[:, 0]


def _survival_terms(hazards, S, Y):
    """(S_pad[Y], hazards[Y], S_pad[Y + 1], S) with S_pad = [1, S]."""
    if S is None:
        S = torch.cumprod(1.0 - hazards, dim=1)
    Y = Y.to(torch.int64)
    S_padded = torch.cat([torch.ones_like(S[:, :1]), S], dim=1)
    return (_take(S_padded, Y), _take(hazards, Y), _take(S_padded, Y + 1),
            S)


def _mean(per_sample, valid):
    v = _as_valid(valid, per_sample.shape[0], per_sample)
    return (per_sample * v).sum() / v.sum().clamp_min(1.0)


def nll_loss(hazards, S, Y, c, alpha: float = 0.15, eps: float = 1e-7,
             valid=None):
    """Discrete-hazard negative log-likelihood (ref loss_utils.py:22-39).

    loss_i = (1-alpha) * (censored_i + uncensored_i) + alpha * uncensored_i
    where  uncensored_i = -(1-c_i) [log S_pad[Y_i] + log h[Y_i]]
           censored_i   = -c_i log S_pad[Y_i + 1]
    and S_pad = [1, S].  Mean over (valid) batch entries.
    """
    s_prev, h_y, s_y, _ = _survival_terms(hazards, S, Y)
    c = c.to(hazards.dtype)
    uncensored = -(1.0 - c) * (torch.log(s_prev.clamp_min(eps))
                               + torch.log(h_y.clamp_min(eps)))
    censored = -c * torch.log(s_y.clamp_min(eps))
    per_sample = (1.0 - alpha) * (censored + uncensored) + alpha * uncensored
    return _mean(per_sample, valid)


def ce_loss(hazards, S, Y, c, alpha: float = 0.15, eps: float = 1e-7,
            valid=None):
    """Cross-entropy-flavoured survival loss (ref loss_utils.py:41-56).
    The reference's log(x + eps) in the first term and clamps in the others
    are kept as they are."""
    s_prev, h_y, _, S = _survival_terms(hazards, S, Y)
    s_y = _take(S, Y.to(torch.int64))
    c = c.to(hazards.dtype)
    reg = -(1.0 - c) * (torch.log(s_prev + eps)
                        + torch.log(h_y.clamp_min(eps)))
    ce_l = (-c * torch.log(s_y.clamp_min(eps))
            - (1.0 - c) * torch.log(1.0 - s_y.clamp_min(eps)))
    per_sample = (1.0 - alpha) * ce_l + alpha * reg
    return _mean(per_sample, valid)


def cox_loss(risks, times, c, valid=None):
    """Cox partial-likelihood loss (ref loss_utils.py:124-139).  The risk
    set R[i, j] = (t_j >= t_i) is built by broadcasting; the inner
    log-sum-exp is shifted by the largest VALID risk, so an extreme padded
    risk neither underflows the valid terms nor makes inf * 0 = nan."""
    theta = risks.reshape(-1)
    c = c.to(theta.dtype)
    v = _as_valid(valid, theta.shape[0], theta)
    times = times.reshape(-1)
    R = (times[None, :] >= times[:, None]).to(theta.dtype) * v[None, :]
    theta_masked = torch.where(v > 0, theta,
                               torch.full_like(theta, -torch.inf))
    m = theta_masked.max()
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    shifted = theta_masked[None, :] - m
    lse = torch.log((torch.exp(shifted) * R).sum(dim=1) + 1e-30) + m
    per_sample = -(theta - lse) * (1.0 - c)
    # a plain mean: censored rows add 0 but count in the denominator
    return _mean(per_sample, valid)


def ranking_loss(risks, times, c, phi: str = "sigmoid",
                 reduction: str = "mean", valid=None):
    """Pairwise ranking (approximate c-index) loss (ref loss_utils.py:58-101).

    Comparable pair (i, j): t_i < t_j and event_i.  phi(r_i - r_j) is the
    concordance surrogate; loss = -mean (or -sum) over comparable pairs,
    0 when there is no comparable pair (ref :84-85).
    """
    risks = risks.reshape(-1)
    events = 1.0 - c.to(risks.dtype)
    v = _as_valid(valid, risks.shape[0], risks)
    times = times.reshape(-1)
    comp = ((times[:, None] < times[None, :]).to(risks.dtype)
            * events[:, None] * v[:, None] * v[None, :])
    r = risks[:, None] - risks[None, :]
    if phi == "sigmoid":
        vals = torch.sigmoid(r)
    elif phi == "relu":
        vals = torch.relu(r)
    else:
        raise ValueError(f"unknown phi {phi!r}")
    total = (vals * comp).sum()
    n_pairs = comp.sum()
    zero = torch.zeros_like(total)
    if reduction == "mean":
        return torch.where(n_pairs > 0, -total / n_pairs.clamp_min(1.0),
                           zero)
    if reduction == "sum":
        return torch.where(n_pairs > 0, -total, zero)
    raise ValueError(f"unknown reduction {reduction!r}")


def ranking_nll_loss(hazards, risks, S, Y, c, alpha: float = 0.15,
                     phi: str = "sigmoid", reduction: str = "mean",
                     nll_ratio: float = 0.5, valid=None):
    """Combined ranking + NLL (ref loss_utils.py:151-164).  As in the
    reference, the ranking term takes the bin label Y as its times
    (loss_utils.py:159)."""
    r = ranking_loss(risks, Y.to(hazards.dtype), c, phi=phi,
                     reduction=reduction, valid=valid)
    n = nll_loss(hazards, S, Y, c, alpha=alpha, valid=valid)
    return r + n * nll_ratio


class LossSpec:
    """A survival loss by name (the bag_loss dispatch of ref
    core_utils.py:52-64); call via apply()."""

    NAMES = ("nll_surv", "ce_surv", "cox_surv", "ranking_surv",
             "ranking_nll_surv")

    def __init__(self, name: str, alpha: float = 0.0, nll_ratio: float = 0.2,
                 phi: str = "sigmoid", reduction: str = "mean"):
        if name not in self.NAMES:
            raise NotImplementedError(f"bag_loss {name!r}")
        self.name = name
        self.alpha = alpha
        self.nll_ratio = nll_ratio
        self.phi = phi
        self.reduction = reduction

    def apply(self, *, hazards=None, S=None, risks=None, Y=None, times=None,
              c=None, valid=None):
        if self.name == "nll_surv":
            return nll_loss(hazards, S, Y, c, alpha=self.alpha, valid=valid)
        if self.name == "ce_surv":
            return ce_loss(hazards, S, Y, c, alpha=self.alpha, valid=valid)
        if self.name == "cox_surv":
            return cox_loss(risks, times, c, valid=valid)
        if self.name == "ranking_surv":
            return ranking_loss(risks, times, c, phi=self.phi,
                                reduction=self.reduction, valid=valid)
        return ranking_nll_loss(hazards, risks, S, Y, c, alpha=self.alpha,
                                phi=self.phi, reduction=self.reduction,
                                nll_ratio=self.nll_ratio, valid=valid)

    def __repr__(self):
        return (f"LossSpec({self.name!r}, alpha={self.alpha}, "
                f"nll_ratio={self.nll_ratio})")


class _AbsSum(torch.autograd.Function):
    """sum |x| whose derivative at x = 0 is +1, as jnp.abs's is in the JAX
    package (torch.abs's is 0).  The L1 term then moves zero-initialized
    biases on the first step exactly as the JAX package does."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return x.abs().sum()

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return torch.where(x >= 0, g, -g)


def _abs_sum(x):
    return _AbsSum.apply(x)


def l1_reg(params: Union[torch.nn.Module, Iterable[torch.Tensor]]
           ) -> torch.Tensor:
    """L1 regularization over every parameter (ref utils/utils.py:249):
    a module's parameters or an iterable of tensors."""
    if isinstance(params, torch.nn.Module):
        params = params.parameters()
    leaves = list(params)
    if not leaves:
        return torch.zeros(())
    return sum(_abs_sum(p) for p in leaves)


def l1_reg_subtree(named_params, key_substrings=("fc_omic", "mm")
                   ) -> torch.Tensor:
    """L1 over the parameters whose name contains any of the given
    substrings (ref utils/utils.py:260-268: fc_omic + mm modules).
    ``named_params``: a module or an iterable of (name, tensor)."""
    if isinstance(named_params, torch.nn.Module):
        named_params = named_params.named_parameters()
    total = torch.zeros(())
    for name, p in named_params:
        if any(s in name for s in key_substrings):
            total = total.to(p.device) + _abs_sum(p)
    return total
