"""Integrated and expected gradients with torch autograd (port of
multimodalfusion_tpu/interpret/ig.py; the reference runs Captum's
IntegratedGradients, ref create_attributions.py:43-50, and SHAP's
GradientExplainer, ref create_heatmaps.py:173-175).

``integrated_gradients`` works on any function of one or more input
tensors whose output is summed to a scalar:
IG_i = (x_i - x0_i) * sum_k w_k grad_i f(x0 + a_k (x - x0)).  The default
quadrature is Gauss-Legendre with n_steps nodes, Captum's default;
'riemann_middle' is also available.

Both loop over their quadrature nodes or draws, one forward and one
backward each, as the JAX package's ``lax.scan`` does, and add the
gradients up in its order.  Stacking the nodes into the batch would run
one larger pass instead, but it holds only for a function whose rows are
independent (a head in train mode normalizes over its batch), and it
multiplies the memory by n_steps; the loop holds for any function.  The
caller puts a model in ``eval()``.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch


def _quadrature(n_steps: int, method: str) -> Tuple[np.ndarray, np.ndarray]:
    """(alphas, weights) on [0, 1], f32: the attribution sums
    w_k grad(x0 + a_k dx)."""
    if method == "gausslegendre":
        a, w = np.polynomial.legendre.leggauss(n_steps)
        return ((np.asarray(a) + 1.0) / 2.0).astype(np.float32), \
            (np.asarray(w) / 2.0).astype(np.float32)
    if method == "riemann_middle":
        a = (np.arange(1, n_steps + 1) - 0.5) / n_steps
        return a.astype(np.float32), np.full(n_steps, 1.0 / n_steps,
                                             np.float32)
    raise NotImplementedError(method)


def _grads(fn: Callable, xs: Sequence[torch.Tensor]) -> Tuple[torch.Tensor,
                                                                ...]:
    """d sum(fn(*xs)) / d xs, with no gradient kept on any parameter."""
    xs = tuple(x.detach().requires_grad_(True) for x in xs)
    with torch.enable_grad():
        return torch.autograd.grad(fn(*xs).sum(), xs)


def integrated_gradients(fn: Callable, inputs: Sequence[torch.Tensor],
                         baselines: Optional[Sequence[torch.Tensor]] = None,
                         n_steps: int = 20, method: str = "gausslegendre"
                         ) -> Tuple[torch.Tensor, ...]:
    """IG of sum(fn(*inputs)) for each input (zero baselines by default);
    one attribution tensor per input, in its shape."""
    inputs = tuple(inputs)
    if baselines is None:
        baselines = tuple(torch.zeros_like(x) for x in inputs)
    alphas, weights = _quadrature(n_steps, method)
    total = [torch.zeros_like(x) for x in inputs]
    for alpha, w in zip(alphas.tolist(), weights.tolist()):
        g = _grads(fn, [b + alpha * (x - b)
                        for x, b in zip(inputs, baselines)])
        total = [t + w * gi for t, gi in zip(total, g)]
    return tuple((x - b) * t for x, b, t in zip(inputs, baselines, total))


def expected_gradient_draws(n_samples: int, batch: int, n_background: int,
                            generator: torch.Generator
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The random part of ``expected_gradients``: background row indices
    [n_samples, batch] (int64) and interpolation points [n_samples,
    batch] (f32, uniform on [0, 1)), drawn with ``generator``.  The draws
    differ from the JAX package's ``PRNGKey`` draws by design."""
    bidx = torch.randint(0, n_background, (n_samples, batch),
                         generator=generator, device=generator.device)
    alphas = torch.rand((n_samples, batch), generator=generator,
                        device=generator.device)
    return bidx, alphas


def expected_gradients(fn: Callable, x: torch.Tensor,
                       background: torch.Tensor,
                       draws: Tuple[torch.Tensor, torch.Tensor]
                       ) -> torch.Tensor:
    """SHAP GradientExplainer semantics (expected gradients), the
    attribution the reference computes for genomics:

        attr_i = E_{b ~ background, a ~ U(0,1)}
                   [(x_i - b_i) * d f / d x_i (b + a (x - b))]

    over the given ``draws`` = (background indices, alphas), each
    [n_samples, B] (``expected_gradient_draws``).  ``x`` [B, G],
    ``background`` [M, G]."""
    bidx, alphas = (d.to(x.device) for d in draws)
    total = torch.zeros_like(x)
    for bi, alpha in zip(bidx, alphas):
        b = background[bi]
        (g,) = _grads(fn, [b + alpha[:, None] * (x - b)])
        total = total + (x - b) * g
    return total / bidx.shape[0]


def modality_attributions(fn: Callable, inputs: Sequence[torch.Tensor],
                          names: Sequence[str], n_steps: int = 20
                          ) -> Dict[str, torch.Tensor]:
    """Per-modality sums of |IG| over every axis but the first (ref
    create_attributions.py:118-160): {name: [B]}."""
    attrs = integrated_gradients(fn, inputs, n_steps=n_steps)
    return {name: a.abs().sum(dim=tuple(range(1, a.dim())))
            for name, a in zip(names, attrs)}


def completeness_gap(fn: Callable, inputs: Sequence[torch.Tensor],
                     attrs: Sequence[torch.Tensor],
                     baselines: Optional[Sequence[torch.Tensor]] = None
                     ) -> float:
    """The IG sanity check |sum(attr) - (f(x) - f(x0))|."""
    if baselines is None:
        baselines = tuple(torch.zeros_like(x) for x in inputs)
    with torch.no_grad():
        fx = float(fn(*inputs).sum())
        f0 = float(fn(*baselines).sum())
    total = sum(float(a.sum()) for a in attrs)
    return abs(total - (fx - f0))
