"""Stand-ins for the OpenCV and matplotlib calls of the JAX package's image
paths (the machine with the card has neither): each function is named
after the call it replaces and works on tensors on any device.

- ``resize_bilinear(x, (h, w))`` is ``cv2.resize(x, (w, h))`` on float
  images (bilinear, half-pixel centres, no antialiasing).  OpenCV's
  ``dsize`` is (width, height); this takes (height, width).
- ``gaussian_blur(x, k)`` is ``cv2.GaussianBlur(x, (k, k), 0)`` on float
  images: sigma from the kernel size as OpenCV derives it, the border
  reflected without repeating the edge (``BORDER_REFLECT_101``).
- ``jet(x)`` is ``(matplotlib.cm.jet(x)[..., :3] * 255).astype(uint8)``:
  matplotlib's 256-entry lookup table, indexed by ``int(x * 256)``.
- ``add_weighted(a, alpha, b, beta)`` is ``cv2.addWeighted`` on uint8
  images: rounded half to even and saturated.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
from torch.nn import functional as F

# matplotlib's segment data of "jet" (matplotlib/_cm.py): per channel,
# rows (x, y left of x, y right of x)
_JET_SEGMENTS = (
    ((0.0, 0, 0), (0.35, 0, 0), (0.66, 1, 1), (0.89, 1, 1), (1.0, 0.5, 0.5)),
    ((0.0, 0, 0), (0.125, 0, 0), (0.375, 1, 1), (0.64, 1, 1), (0.91, 0, 0),
     (1.0, 0, 0)),
    ((0.0, 0.5, 0.5), (0.11, 1, 1), (0.34, 1, 1), (0.65, 0, 0), (1.0, 0, 0)),
)
JET_N = 256


def _lookup_table(segments, n: int) -> np.ndarray:
    """One channel of a segmented colormap's table, computed as
    matplotlib's ``colors._create_lookup_table`` computes it (float64)."""
    data = np.array(segments, dtype=float)
    x, y0, y1 = data[:, 0] * (n - 1), data[:, 1], data[:, 2]
    xind = (n - 1) * np.linspace(0, 1, n)
    ind = np.searchsorted(x, xind)[1:-1]
    distance = (xind[1:-1] - x[ind - 1]) / (x[ind] - x[ind - 1])
    lut = np.concatenate([[y1[0]], distance * (y0[ind] - y1[ind - 1])
                          + y1[ind - 1], [y0[-1]]])
    return np.clip(lut, 0.0, 1.0)


def jet_table() -> np.ndarray:
    """matplotlib's jet as float64 RGB [256, 3]: ``cm.jet(np.arange(256))``
    without its alpha column."""
    return np.stack([_lookup_table(s, JET_N) for s in _JET_SEGMENTS], axis=1)


# what jet() reads: the table times 255, truncated, as matplotlib's callers
# in the JAX package convert it
_JET_U8 = torch.from_numpy((jet_table() * 255).astype(np.uint8))


def jet(x: torch.Tensor) -> torch.Tensor:
    """uint8 RGB [..., 3] of float values ``x``: entry ``int(x * 256)`` of
    the table, 1.0 and above taking entry 255, values below 0 entry 0, and
    NaN black, as ``matplotlib.cm.jet`` indexes it."""
    xa = x * JET_N  # in x's own float type, exact (a power of two)
    bad = torch.isnan(xa)
    idx = xa.nan_to_num(0.0).clamp(0, JET_N - 1).to(torch.int64)
    out = _JET_U8.to(x.device)[idx]
    return out.masked_fill(bad.unsqueeze(-1), 0)


def resize_bilinear(x: torch.Tensor, size: Sequence[int]) -> torch.Tensor:
    """Float images [..., H, W] resized to ``size`` = (h, w) by bilinear
    interpolation at half-pixel centres (``cv2.resize(x, (w, h))``)."""
    h, w = int(size[0]), int(size[1])
    lead = x.shape[:-2]
    flat = x.reshape((-1, 1) + tuple(x.shape[-2:]))
    out = F.interpolate(flat, size=(h, w), mode="bilinear",
                        align_corners=False)
    return out.reshape(lead + (h, w))


def gaussian_kernel(ksize: int) -> torch.Tensor:
    """``cv2.getGaussianKernel(ksize, 0, CV_32F)`` [ksize]: OpenCV's sigma
    for the size, the taps rounded to float32, then scaled by the inverse
    of their sum in float64."""
    sigma = 0.3 * ((ksize - 1) * 0.5 - 1) + 0.8
    t = np.exp(-0.5 / (sigma * sigma)
               * (np.arange(ksize) - (ksize - 1) * 0.5) ** 2)
    t = t.astype(np.float32).astype(np.float64)
    return torch.from_numpy((t * (1.0 / t.sum())).astype(np.float32))


def _reflect101(n: int, pad: int, device) -> torch.Tensor:
    """Source index of each of ``n + 2 pad`` positions for a border
    reflected about the edge pixel (``BORDER_REFLECT_101``), for any
    ``n`` (reflected again where ``pad`` exceeds the row)."""
    i = torch.arange(-pad, n + pad, device=device)
    if n == 1:
        return torch.zeros_like(i)
    period = 2 * (n - 1)
    i = i.remainder(period)
    return torch.where(i >= n, period - i, i)


def _blur_axis(x: torch.Tensor, taps: torch.Tensor, dim: int
               ) -> torch.Tensor:
    k = taps.numel()
    n = x.shape[dim]
    xp = x.index_select(dim, _reflect101(n, k // 2, x.device))
    out = xp.narrow(dim, 0, n) * taps[0]
    for j in range(1, k):
        out = out + xp.narrow(dim, j, n) * taps[j]
    return out


def gaussian_blur(x: torch.Tensor, ksize: int = 11) -> torch.Tensor:
    """Float32 images [..., H, W] blurred by a ``ksize`` x ``ksize``
    Gaussian (``cv2.GaussianBlur(x, (ksize, ksize), 0)``): separable, rows
    first, as multiply-adds (no convolution routine, so no TF32)."""
    taps = gaussian_kernel(ksize).to(x.device)
    return _blur_axis(_blur_axis(x.float(), taps, -1), taps, -2)


def add_weighted(a: torch.Tensor, alpha: float, b: torch.Tensor,
                 beta: float) -> torch.Tensor:
    """``cv2.addWeighted(a, alpha, b, beta, 0)`` on uint8 images:
    OpenCV's ``fma(a, alpha, b * beta)`` with float32 weights, each
    product and fused multiply-add rounded once to float32 (float64 holds
    its exact value for uint8 inputs), then rounded half to even and
    saturated to [0, 255]."""
    alpha, beta = float(np.float32(alpha)), float(np.float32(beta))
    t = (b.double() * beta).float()
    s = (a.double() * alpha + t.double()).float()
    return torch.round(s).clamp(0, 255).to(torch.uint8)


def to_uint8_gray(img: torch.Tensor) -> torch.Tensor:
    """``(np.clip(img, 0, 1) * 255).astype(np.uint8)``: truncated."""
    return (img.clamp(0, 1) * 255).to(torch.uint8)


def repeat_rgb(gray: torch.Tensor) -> torch.Tensor:
    """[..., H, W] -> [..., H, W, 3], the channel repeated."""
    return gray.unsqueeze(-1).expand(*gray.shape, 3)
