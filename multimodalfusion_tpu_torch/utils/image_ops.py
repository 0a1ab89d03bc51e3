"""Stand-ins for the OpenCV and matplotlib calls of the JAX package's image
paths (the machine with the card has neither): each function is named
after the call it replaces and works on tensors on any device.

- ``resize_bilinear(x, (h, w))`` is ``cv2.resize(x, (w, h))`` on float
  images (bilinear, half-pixel centres, no antialiasing).  OpenCV's
  ``dsize`` is (width, height); this takes (height, width).
- ``gaussian_blur(x, k)`` is ``cv2.GaussianBlur(x, (k, k), 0)`` on float
  images: sigma from the kernel size as OpenCV derives it, the border
  reflected without repeating the edge (``BORDER_REFLECT_101``).
- ``add_weighted(a, alpha, b, beta)`` is ``cv2.addWeighted`` on uint8
  images: rounded half to even and saturated.

The uint8 stand-ins of the WSI stages equal OpenCV bit for bit (tests/
test_torch_wsi_ops.py holds them to cv2 by seeded fuzz):

- ``hsv_saturation(rgb)`` is channel 1 of ``cv2.cvtColor(rgb,
  COLOR_RGB2HSV)``: OpenCV's fixed-point division table, not
  ``round(255 (v - min) / v)``.
- ``median_blur(x, k)`` is ``cv2.medianBlur`` for odd ``k``, the border
  replicated.
- ``threshold(x, t, maxval, otsu)`` is ``cv2.threshold`` with
  ``THRESH_BINARY`` (``> t``), with ``THRESH_OTSU`` the threshold from the
  256-bin histogram as OpenCV searches it.
- ``morph_close(x, k)`` is ``cv2.morphologyEx(x, MORPH_CLOSE, ones((k,
  k)))``: the anchor at (k // 2, k // 2) for both passes, so an even
  ``k`` shifts the mask by one pixel; outside the image takes no part.
- ``resize_u8(x, (h, w))`` is ``cv2.resize(x, (w, h))`` (INTER_LINEAR) on
  uint8: 11-bit coefficients, OpenCV's fixed-point vertical pass.

These run on tensors on any device.  The drawing calls work in place on
host uint8 arrays [H, W, C], as OpenCV does: ``rectangle`` (thickness
1), ``ellipse`` (filled: OpenCV's polygon of the ellipse filled by its
fixed-point convex fill, edges included) and ``draw_contours`` (thickness
2: every segment clipped to the image grown by 2, then OpenCV's thick
line, a filled rectangle and a radius-1 disc at its end).

The heatmap path's stand-ins, equal to their libraries bit for bit
(tests/test_torch_heatmap_ops.py holds them by seeded fuzz):

- ``gaussian_blur_u8(x, (kx, ky))`` is ``cv2.GaussianBlur(x, (kx, ky), 0)``
  on uint8 images: OpenCV's bit-exact 8-bit path, taps in units of 1/256
  (the cumulative sums of the float kernel rounded, so that they sum to
  256), integer rows then columns, rounded once at the end; on tensors
  on any device.
- ``fill_contours(img, contours, idx, color, offset)`` is
  ``cv2.drawContours(..., contourIdx=idx, thickness=-1, offset=offset)``
  in place on a host array: every edge drawn as an 8-connected line, then
  the even-odd scanline fill of pixel centres between the edges, an edge
  that leaves the image running between its clipped ends.
- ``resize_bicubic_pil(x, (h, w))`` is ``np.asarray(Image.fromarray(x)
  .resize((w, h)))``: PIL's bicubic (a = -0.5), its support widened by
  the downscale factor, 22-bit coefficients, a horizontal pass then a
  vertical one, each rounded and clipped to uint8; on tensors on any
  device.
- ``colormap(name)`` is ``(matplotlib.colormaps[name](x)[..., :3] *
  255).astype(uint8)`` for ``jet``, ``coolwarm`` and ``RdYlBu`` and their
  ``_r`` reversals, from matplotlib's segment data; another name raises.
"""
from __future__ import annotations

import functools
import math
from typing import List, Sequence, Tuple

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
# matplotlib's "coolwarm" (_cm._coolwarm_data): per channel, the value at
# x = i / 32, equal on both sides
_COOLWARM = (
    (0.2298057, 0.26623388, 0.30386891, 0.342804478, 0.38301334,
     0.424369608, 0.46666708, 0.509635204, 0.552953156, 0.596262162,
     0.639176211, 0.681291281, 0.722193294, 0.761464949, 0.798691636,
     0.833466556, 0.865395197, 0.897787179, 0.924127593, 0.944468518,
     0.958852946, 0.96732803, 0.969954137, 0.966811177, 0.958003065,
     0.943660866, 0.923944917, 0.89904617, 0.869186849, 0.834620542,
     0.795631745, 0.752534934, 0.705673158),
    (0.298717966, 0.353094838, 0.406535296, 0.458757618, 0.50941904,
     0.558148092, 0.604562568, 0.648280772, 0.688929332, 0.726149107,
     0.759599947, 0.788964712, 0.813952739, 0.834302879, 0.849786142,
     0.860207984, 0.86541021, 0.848937047, 0.827384882, 0.800927443,
     0.769767752, 0.734132809, 0.694266682, 0.650421156, 0.602842431,
     0.551750968, 0.49730856, 0.439559467, 0.378313092, 0.312874446,
     0.24128379, 0.157246067, 0.01555616),
    (0.753683153, 0.801466763, 0.84495867, 0.883725899, 0.917387822,
     0.945619588, 0.968154911, 0.98478814, 0.995375608, 0.999836203,
     0.998151185, 0.990363227, 0.976574709, 0.956945269, 0.931688648,
     0.901068838, 0.865395561, 0.820880546, 0.774508472, 0.726736146,
     0.678007945, 0.628751763, 0.579375448, 0.530263762, 0.481775914,
     0.434243684, 0.387970225, 0.343229596, 0.300267182, 0.259301199,
     0.220525627, 0.184115123, 0.150232812),
)
# ColorBrewer's "RdYlBu" (_cm._RdYlBu_data, each value k / 255), which
# matplotlib spreads evenly over [0, 1] (LinearSegmentedColormap.from_list)
_RDYLBU = ((165, 0, 38), (215, 48, 39), (244, 109, 67), (253, 174, 97),
           (254, 224, 144), (255, 255, 191), (224, 243, 248),
           (171, 217, 233), (116, 173, 209), (69, 117, 180), (49, 54, 149))
CMAPS = ("jet", "coolwarm", "RdYlBu")
CMAP_N = 256  # matplotlib's table size of these maps


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


def _segments(name: str):
    """Per channel, the rows (x, y0, y1) of matplotlib's segment data of
    ``name``; ``_r`` reverses them as ``LinearSegmentedColormap.reversed``
    does.  Any other name raises ``ValueError``."""
    base = name[:-2] if name.endswith("_r") else name
    if base == "jet":
        segs = [[tuple(map(float, row)) for row in ch] for ch in _JET_SEGMENTS]
    elif base == "coolwarm":
        segs = [[(i / 32, v, v) for i, v in enumerate(ch)] for ch in _COOLWARM]
    elif base == "RdYlBu":
        vals = np.linspace(0, 1, len(_RDYLBU))
        rgb = np.array(_RDYLBU, np.float64) / 255
        segs = [np.column_stack([vals, rgb[:, c], rgb[:, c]])
                for c in range(3)]
    else:
        raise ValueError(
            f"colormap {name!r} is not supported: the port has "
            f"{', '.join(CMAPS)} and their _r reversals")
    if base != name:
        segs = [[(1.0 - x, y1, y0) for x, y0, y1 in reversed(list(ch))]
                for ch in segs]
    return segs


@functools.lru_cache(maxsize=None)
def colormap_table(name: str) -> np.ndarray:
    """matplotlib's ``name`` as float64 RGB [256, 3]:
    ``colormaps[name](np.arange(256))`` without its alpha column."""
    table = np.stack([_lookup_table(s, CMAP_N) for s in _segments(name)],
                     axis=1)
    table.flags.writeable = False
    return table


@functools.lru_cache(maxsize=None)
def _table_u8(name: str) -> torch.Tensor:
    # what a colormap reads: the table times 255, truncated, as
    # matplotlib's callers in the JAX package convert it
    return torch.from_numpy((colormap_table(name) * 255).astype(np.uint8))


def colormap(name: str):
    """The function x -> uint8 RGB [..., 3] of matplotlib's colormap
    ``name`` on float values ``x``: entry ``int(x * 256)`` of the table,
    1.0 and above taking entry 255, values below 0 entry 0, and NaN black,
    as matplotlib indexes it.  An unsupported name raises here, before any
    work."""
    table = _table_u8(name)

    def apply(x: torch.Tensor) -> torch.Tensor:
        xa = x * CMAP_N  # in x's own float type, exact (a power of two)
        bad = torch.isnan(xa)
        idx = xa.nan_to_num(0.0).clamp(0, CMAP_N - 1).to(torch.int64)
        out = table.to(x.device)[idx]
        return out.masked_fill(bad.unsqueeze(-1), 0)
    return apply


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


# OpenCV's fixed taps of the small 8-bit kernels, in units of 1/256
_SMALL_TAPS_U8 = {1: (256,), 3: (64, 128, 64), 5: (16, 64, 96, 64, 16),
                  7: (8, 28, 56, 72, 56, 28, 8),
                  9: (4, 13, 30, 51, 60, 51, 30, 13, 4)}


def gaussian_taps_u8(ksize: int) -> Tuple[int, ...]:
    """The taps (units of 1/256, summing to 256) of OpenCV's bit-exact
    8-bit Gaussian of odd size ``ksize`` and sigma 0: the fixed small
    kernels up to 9; above, the float kernel's cumulative sums from the
    edge, rounded, differenced, and the centre the rest of 256."""
    if ksize in _SMALL_TAPS_U8:
        return _SMALL_TAPS_U8[ksize]
    sigma = ksize * 0.15 + 0.35
    scale2 = -0.125 / (sigma * sigma)
    half = (ksize - 1) // 2
    values = [math.exp(float(x * x) * scale2)
              for x in range(1 - ksize, 0, 2)]
    total = 0.0
    for v in values:
        total += v
    mul = 1.0 / (total * 2.0 + 1.0)
    taps, cum, prev = [0] * ksize, 0.0, 0
    for i, v in enumerate(values):
        cum += v * mul
        r = int(np.rint(cum * 256))
        taps[i] = taps[ksize - 1 - i] = r - prev
        prev = r
    taps[half] = 256 - 2 * prev
    return tuple(taps)


def _blur_axis_u8(x: torch.Tensor, taps, dim: int) -> torch.Tensor:
    k, n = len(taps), x.shape[dim]
    xp = x.index_select(dim, _reflect101(n, k // 2, x.device))
    out = xp.narrow(dim, 0, n) * taps[0]
    for j in range(1, k):
        if taps[j]:
            out += xp.narrow(dim, j, n) * taps[j]
    return out


def gaussian_blur_u8(x: torch.Tensor, ksize: Sequence[int]) -> torch.Tensor:
    """``cv2.GaussianBlur(x, (kx, ky), 0)`` of a uint8 image [H, W] or
    [H, W, C] (``ksize`` = (kx, ky), OpenCV's order, both odd): the rows
    by ``gaussian_taps_u8(kx)``, then the columns by
    ``gaussian_taps_u8(ky)``, in int32, the border reflected
    (``BORDER_REFLECT_101``), then ``(sum + 2**15) >> 16``.  Integer work
    only, so every device gives the same bytes."""
    kx, ky = int(ksize[0]), int(ksize[1])
    if kx < 1 or ky < 1 or kx % 2 != 1 or ky % 2 != 1:
        raise ValueError(f"gaussian_blur_u8 takes odd kernel sizes, got "
                         f"{(kx, ky)}")
    gray = x.dim() == 2
    img = (x.unsqueeze(-1) if gray else x).to(torch.int32)
    acc = _blur_axis_u8(img, gaussian_taps_u8(kx), 1)
    acc = _blur_axis_u8(acc, gaussian_taps_u8(ky), 0)
    out = ((acc + (1 << 15)) >> 16).clamp_(0, 255).to(torch.uint8)
    return out.squeeze(-1) if gray else out


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


# ---------------------------------------------------------------------------
# uint8 pixel filters of the WSI stages (tensors on any device)
# ---------------------------------------------------------------------------

# OpenCV's table for the saturation of uint8 HSV: round((255 << 12) / v)
_SAT_TAB = torch.tensor([0] + [int(round((255 << 12) / v))
                               for v in range(1, 256)], dtype=torch.int32)


def hsv_saturation(rgb: torch.Tensor) -> torch.Tensor:
    """uint8 [..., H, W] saturation of uint8 RGB [..., H, W, 3]:
    ``((v - min) * tab[v] + 2048) >> 12`` with ``v`` the largest channel."""
    x = rgb.to(torch.int32)
    v = x.amax(dim=-1)
    diff = v - x.amin(dim=-1)
    s = (diff * _SAT_TAB.to(x.device)[v] + (1 << 11)) >> 12
    return s.to(torch.uint8)


def median_blur(x: torch.Tensor, ksize: int, rows: int = 256
                ) -> torch.Tensor:
    """``cv2.medianBlur(x, ksize)`` of a uint8 image [H, W], ``ksize`` odd:
    the median of each ``ksize`` x ``ksize`` window, the border replicated.
    ``rows`` output rows at a time bound the window stack."""
    if ksize % 2 != 1 or ksize < 1:
        raise ValueError(f"median_blur takes an odd ksize, got {ksize}")
    if ksize == 1:
        return x.clone()
    h, w = x.shape
    r = ksize // 2
    xp = x.index_select(1, torch.arange(-r, w + r, device=x.device).clamp(
        0, w - 1))
    out = torch.empty_like(x)
    for y0 in range(0, h, rows):
        n = min(rows, h - y0)
        rows_in = torch.arange(y0 - r, y0 + n + r, device=x.device)
        band = xp.index_select(0, rows_in.clamp(0, h - 1))
        win = band.unfold(0, ksize, 1).unfold(1, ksize, 1)
        out[y0:y0 + n] = win.reshape(n, w, ksize * ksize).median(
            dim=-1).values
    return out


def otsu_threshold(x: torch.Tensor) -> int:
    """The threshold ``cv2.threshold(..., THRESH_OTSU)`` picks for a uint8
    image: OpenCV's search over the 256-bin histogram in double."""
    hist = torch.bincount(x.reshape(-1).to(torch.int64),
                          minlength=256).cpu().tolist()
    scale = 1.0 / x.numel()
    mu = 0.0
    for i, h in enumerate(hist):
        mu += i * float(h)
    mu *= scale
    eps = float(np.finfo(np.float32).eps)
    mu1 = q1 = 0.0
    max_sigma = max_val = 0.0
    for i, h in enumerate(hist):
        p_i = h * scale
        mu1 *= q1
        q1 += p_i
        q2 = 1.0 - q1
        if min(q1, q2) < eps or max(q1, q2) > 1.0 - eps:
            continue
        mu1 = (mu1 + i * p_i) / q1
        mu2 = (mu - q1 * mu1) / q2
        sigma = q1 * q2 * (mu1 - mu2) * (mu1 - mu2)
        if sigma > max_sigma:
            max_sigma = sigma
            max_val = i
    return int(max_val)


def threshold(x: torch.Tensor, thresh: float, maxval: int,
              otsu: bool = False) -> Tuple[int, torch.Tensor]:
    """``cv2.threshold(x, thresh, maxval, THRESH_BINARY [+ THRESH_OTSU])``
    of a uint8 image: (the threshold used, ``maxval`` where ``x`` exceeds
    it, else 0)."""
    t = otsu_threshold(x) if otsu else int(math.floor(thresh))
    fill = max(0, min(255, int(round(maxval))))
    out = torch.where(x > t, fill, 0).to(torch.uint8)
    return t, out


def _sweep(x: torch.Tensor, k: int, dim: int, grow: bool) -> torch.Tensor:
    """max (``grow``) or min over offsets -k//2 .. k-1-k//2 along ``dim``,
    positions outside the image taking no part."""
    a, n = k // 2, x.shape[dim]
    lo, hi = list(x.shape), list(x.shape)
    lo[dim], hi[dim] = a, k - 1 - a
    fill = 0 if grow else 255
    xp = torch.cat([x.new_full(lo, fill), x, x.new_full(hi, fill)], dim)
    pick = torch.maximum if grow else torch.minimum
    out = xp.narrow(dim, 0, n)
    for j in range(1, k):
        out = pick(out, xp.narrow(dim, j, n))
    return out


def morph_close(x: torch.Tensor, ksize: int) -> torch.Tensor:
    """``cv2.morphologyEx(x, MORPH_CLOSE, np.ones((k, k), np.uint8))`` of a
    uint8 image [H, W]: dilation then erosion, both over offsets
    -k//2 .. k-1-k//2 in each direction."""
    dil = _sweep(_sweep(x, ksize, 1, True), ksize, 0, True)
    return _sweep(_sweep(dil, ksize, 1, False), ksize, 0, False)


def _linear_taps(n_src: int, n_dst: int):
    """OpenCV's INTER_LINEAR source index and fraction of each output
    position: centres at (d + 0.5) * scale - 0.5 in float32."""
    scale = 1.0 / (n_dst / n_src)
    f = torch.from_numpy(((np.arange(n_dst) + 0.5) * scale - 0.5).astype(
        np.float32))
    s = torch.floor(f)
    return s.to(torch.int64), f - s


def _weights(f: torch.Tensor):
    """11-bit weights (1 - f, f), rounded half to even as OpenCV's
    ``saturate_cast<short>``."""
    one = torch.tensor(2048.0, dtype=torch.float32)
    return (torch.round((1 - f) * one).to(torch.int32),
            torch.round(f * one).to(torch.int32))


def resize_u8(x: torch.Tensor, size: Sequence[int],
              rows: int = 1024) -> torch.Tensor:
    """``cv2.resize(x, (w, h))`` (INTER_LINEAR) of uint8 images
    [..., H, W, C] or [H, W], ``size`` = (h, w), in int32 on ``x``'s
    device, ``rows`` output rows at a time.  Columns: the centre clamped
    into the image, weights (2048 - a, a); rows: the two taps clamped,
    then OpenCV's ``((S0 >> 4) b0 >> 16) + ((S1 >> 4) b1 >> 16)`` and
    ``(y + 2) >> 2``."""
    h, w = int(size[0]), int(size[1])
    gray = x.dim() == 2
    img = x.unsqueeze(-1) if gray else x
    H, W = img.shape[-3], img.shape[-2]
    dev = x.device
    # columns: the centre itself clamped (weight 0 on the far tap)
    sx, fx = _linear_taps(W, w)
    fx = torch.where((sx < 0) | (sx >= W - 1), torch.zeros_like(fx), fx)
    sx = sx.clamp(0, W - 1)
    a0, a1 = (a.to(dev).unsqueeze(-1) for a in _weights(fx))
    x0, x1 = sx.to(dev), (sx + 1).clamp(max=W - 1).to(dev)
    # rows: both taps clamped, the weights kept
    sy, fy = _linear_taps(H, h)
    b0, b1 = (b.view(-1, 1, 1) for b in _weights(fy))
    y0, y1 = sy.clamp(0, H - 1), (sy + 1).clamp(0, H - 1)
    out = torch.empty(img.shape[:-3] + (h, w, img.shape[-1]),
                      dtype=torch.uint8, device=dev)
    for r0 in range(0, h, rows):
        r1 = min(r0 + rows, h)
        lo, hi = int(y0[r0:r1].min()), int(y1[r0:r1].max()) + 1
        p = img.narrow(-3, lo, hi - lo).to(torch.int32)
        S = p.index_select(-2, x0) * a0 + p.index_select(-2, x1) * a1
        t0 = ((S.index_select(-3, (y0[r0:r1] - lo).to(dev)) >> 4)
              * b0[r0:r1].to(dev)) >> 16
        t1 = ((S.index_select(-3, (y1[r0:r1] - lo).to(dev)) >> 4)
              * b1[r0:r1].to(dev)) >> 16
        out.narrow(-3, r0, r1 - r0).copy_(((t0 + t1 + 2) >> 2).clamp(0, 255))
    return out.squeeze(-1) if gray else out


PIL_BITS = 22  # PIL's fixed-point precision for 8-bit images


def _bicubic(x: float) -> float:
    """PIL's bicubic filter, a = -0.5."""
    a = -0.5
    if x < 0.0:
        x = -x
    if x < 1.0:
        return ((a + 2.0) * x - (a + 3.0)) * x * x + 1
    if x < 2.0:
        return (((x - 5) * x + 8) * x - 4) * a
    return 0.0


def _pil_coeffs(n_in: int, n_out: int):
    """PIL's ``precompute_coeffs`` and ``normalize_coeffs_8bpc`` for the
    bicubic filter: (first source index [n_out], int64 coefficients
    [n_out, ksize], zero past each output's window)."""
    scale = n_in / n_out
    fs = max(scale, 1.0)
    support = 2.0 * fs
    ksize = int(math.ceil(support)) * 2 + 1
    first = np.zeros(n_out, np.int64)
    kk = np.zeros((n_out, ksize), np.int64)
    ss = 1.0 / fs
    for o in range(n_out):
        center = (o + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), n_in) - xmin
        w = [_bicubic((x + xmin - center + 0.5) * ss) for x in range(xmax)]
        total = 0.0
        for v in w:
            total += v
        for x, v in enumerate(w):
            if total != 0.0:
                v /= total
            kk[o, x] = int((-0.5 if v < 0 else 0.5) + v * (1 << PIL_BITS))
        first[o] = xmin
    return first, kk


def _pil_pass(x: torch.Tensor, n_out: int, dim: int, rows: int
              ) -> torch.Tensor:
    n_in = x.shape[dim]
    first, kk = _pil_coeffs(n_in, n_out)
    dev = x.device
    shape = list(x.shape)
    shape[dim] = n_out
    out = torch.empty(shape, dtype=torch.uint8, device=dev)
    view = [1] * x.dim()
    view[dim] = -1
    for o0 in range(0, n_out, rows):
        o1 = min(o0 + rows, n_out)
        acc = None
        for t in range(kk.shape[1]):
            w = torch.from_numpy(kk[o0:o1, t]).to(dev)
            if not bool(w.any()):
                continue
            idx = torch.from_numpy(np.minimum(first[o0:o1] + t, n_in - 1))
            term = x.index_select(dim, idx.to(dev)).to(torch.int64) * \
                w.view(view)
            acc = term if acc is None else acc + term
        acc = acc + (1 << (PIL_BITS - 1))
        out.narrow(dim, o0, o1 - o0).copy_(
            (acc >> PIL_BITS).clamp_(0, 255))
    return out


def resize_bicubic_pil(x: torch.Tensor, size: Sequence[int],
                       rows: int = 512) -> torch.Tensor:
    """``np.asarray(Image.fromarray(x).resize((w, h)))`` (PIL's default
    bicubic) of a uint8 image [H, W, C] or [H, W], ``size`` = (h, w): the
    horizontal pass when the width changes, then the vertical pass when
    the height does, each from its own 22-bit coefficients, accumulated in
    int64 on ``x``'s device ``rows`` output lines at a time, then
    ``(sum + 2**21) >> 22`` clipped to uint8."""
    h, w = int(size[0]), int(size[1])
    if h < 1 or w < 1:
        raise ValueError(f"resize_bicubic_pil takes a positive size, got "
                         f"{(h, w)}")
    out = x
    if w != x.shape[1]:
        out = _pil_pass(out, w, 1, rows)
    if h != x.shape[0]:
        out = _pil_pass(out, h, 0, rows)
    return out.clone() if out is x else out


# ---------------------------------------------------------------------------
# drawing on host uint8 arrays (OpenCV's fixed-point rasteriser)
# ---------------------------------------------------------------------------

XY_SHIFT = 16
XY_ONE = 1 << XY_SHIFT
# OpenCV's table of sin(i degrees), i = 0..450, as float32 of the value
# rounded to 7 decimals
_SIN_TABLE = np.array([round(math.sin(math.radians(i)), 7)
                       for i in range(451)], np.float32)


def _tdiv(a: int, b: int) -> int:
    """C's integer division (toward zero)."""
    q = abs(a) // abs(b)
    return q if (a >= 0) == (b > 0) else -q


def _put(img: np.ndarray, xs, ys, color) -> None:
    xs, ys = np.asarray(xs, np.int64), np.asarray(ys, np.int64)
    keep = (xs >= 0) & (xs < img.shape[1]) & (ys >= 0) & (ys < img.shape[0])
    img[ys[keep], xs[keep]] = color


def _clip_line(w: int, h: int, p1: List[int], p2: List[int]) -> bool:
    """OpenCV's ``clipLine`` on fixed-point points of an image of (w, h)
    (already shifted): clips both ends in place; False when the line
    misses the image."""
    right, bottom = w - 1, h - 1
    x1, y1 = p1
    x2, y2 = p2
    c1 = (x1 < 0) + (x1 > right) * 2 + (y1 < 0) * 4 + (y1 > bottom) * 8
    c2 = (x2 < 0) + (x2 > right) * 2 + (y2 < 0) * 4 + (y2 > bottom) * 8
    if (c1 & c2) == 0 and (c1 | c2) != 0:
        if c1 & 12:
            a = 0 if c1 < 8 else bottom
            x1 += int(float(a - y1) * (x2 - x1) / (y2 - y1))
            y1 = a
            c1 = (x1 < 0) + (x1 > right) * 2
        if c2 & 12:
            a = 0 if c2 < 8 else bottom
            x2 += int(float(a - y2) * (x2 - x1) / (y2 - y1))
            y2 = a
            c2 = (x2 < 0) + (x2 > right) * 2
        if (c1 & c2) == 0 and (c1 | c2) != 0:
            if c1:
                a = 0 if c1 == 1 else right
                y1 += int(float(a - x1) * (y2 - y1) / (x2 - x1))
                x1 = a
                c1 = 0
            if c2:
                a = 0 if c2 == 1 else right
                y2 += int(float(a - x2) * (y2 - y1) / (x2 - x1))
                x2 = a
                c2 = 0
    p1[:] = [x1, y1]
    p2[:] = [x2, y2]
    return (c1 | c2) == 0


def _line2(img: np.ndarray, p1, p2, color) -> None:
    """OpenCV's ``Line2``: an 8-connected line between fixed-point points
    (XY_SHIFT bits), as ``FillConvexPoly`` draws a polygon's edges."""
    h, w = img.shape[:2]
    p1, p2 = list(p1), list(p2)
    if not _clip_line(w << XY_SHIFT, h << XY_SHIFT, p1, p2):
        return
    dx, dy = p2[0] - p1[0], p2[1] - p1[1]
    ax, ay = abs(dx), abs(dy)
    if ax > ay:
        if dx < 0:
            p1, p2 = p2, p1
            dy = -dy
        x_step, y_step = XY_ONE, _tdiv(dy << XY_SHIFT, ax | 1)
        ecount = (p2[0] - p1[0]) >> XY_SHIFT
    else:
        if dy < 0:
            p1, p2 = p2, p1
            dx = -dx
        x_step, y_step = _tdiv(dx << XY_SHIFT, ay | 1), XY_ONE
        ecount = (p2[1] - p1[1]) >> XY_SHIFT
    x1 = p1[0] + (XY_ONE >> 1)
    y1 = p1[1] + (XY_ONE >> 1)
    _put(img, [(p2[0] + (XY_ONE >> 1)) >> XY_SHIFT],
         [(p2[1] + (XY_ONE >> 1)) >> XY_SHIFT], color)
    if ecount < 0:
        return
    k = np.arange(ecount + 1, dtype=np.int64)
    if ax > ay:
        _put(img, (x1 >> XY_SHIFT) + k, (y1 + k * y_step) >> XY_SHIFT, color)
    else:
        _put(img, (x1 + k * x_step) >> XY_SHIFT, (y1 >> XY_SHIFT) + k, color)


def _fill_convex_poly(img: np.ndarray, v: Sequence[Tuple[int, int]],
                      color) -> None:
    """OpenCV's ``FillConvexPoly`` for LINE_8 at XY_SHIFT: the edges drawn
    by ``_line2``, then the scanlines between the two edge chains."""
    npts = len(v)
    shift = XY_SHIFT
    delta = 1 << shift >> 1
    delta1 = delta2 = XY_ONE >> 1
    h, w = img.shape[:2]
    xs = [p[0] for p in v]
    ys = [p[1] for p in v]
    imin = int(np.argmin(ys))
    p0 = v[-1]
    for p in v:
        _line2(img, p0, p, color)
        p0 = p
    xmin = (min(xs) + delta) >> shift
    xmax = (max(xs) + delta) >> shift
    ymin = (min(ys) + delta) >> shift
    ymax = (max(ys) + delta) >> shift
    if npts < 3 or xmax < 0 or ymax < 0 or xmin >= w or ymin >= h:
        return
    ymax = min(ymax, h - 1)
    edge = [{"idx": imin, "di": 1, "x": -XY_ONE, "dx": 0, "ye": ymin},
            {"idx": imin, "di": npts - 1, "x": -XY_ONE, "dx": 0,
             "ye": ymin}]
    edges = npts
    y = ymin
    while True:
        for e in edge:
            if y < e["ye"]:
                continue
            idx0, di = e["idx"], e["di"]
            idx = idx0 + di
            if idx >= npts:
                idx -= npts
            while True:
                left = edges
                edges -= 1
                if left <= 0:
                    break
                ty = (v[idx][1] + delta) >> shift
                if ty > y:
                    xs0, xe = v[idx0][0], v[idx][0]
                    e["ye"] = ty
                    e["dx"] = _tdiv((xe - xs0) * 2 + (ty - y),
                                    2 * (ty - y))
                    e["x"] = xs0
                    e["idx"] = idx
                    break
                idx0 = idx
                idx += di
                if idx >= npts:
                    idx -= npts
        if edges < 0:
            break
        if y >= 0:
            lo, hi = (1, 0) if edge[0]["x"] > edge[1]["x"] else (0, 1)
            xx1 = (edge[lo]["x"] + delta1) >> XY_SHIFT
            xx2 = (edge[hi]["x"] + delta2) >> XY_SHIFT
            if xx2 >= 0 and xx1 < w:
                img[y, max(xx1, 0):min(xx2, w - 1) + 1] = color
        edge[0]["x"] += edge[0]["dx"]
        edge[1]["x"] += edge[1]["dx"]
        y += 1
        if y > ymax:
            break


def _ellipse_poly(center, axes, angle: float) -> List[Tuple[int, int]]:
    """The fixed-point polygon ``cv2.ellipse`` fills for a whole ellipse
    (``ellipse2Poly`` at OpenCV's step for the axes, rounded to XY_SHIFT
    bits, repeated points dropped)."""
    cx, cy = (int(c) << XY_SHIFT for c in center)
    aw, ah = (abs(int(a)) << XY_SHIFT for a in axes)
    delta = (max(aw, ah) + (XY_ONE >> 1)) >> XY_SHIFT
    delta = 90 if delta < 3 else 30 if delta < 10 else 18 if delta < 15 \
        else 5
    ang = int(np.rint(angle))  # cvRound: half to even
    while ang < 0:
        ang += 360
    while ang > 360:
        ang -= 360
    alpha = float(_SIN_TABLE[450 - ang])
    beta = float(_SIN_TABLE[ang])
    pts: List[Tuple[int, int]] = []
    for i in range(0, 360 + delta, delta):
        a = min(i, 360)
        x = aw * float(_SIN_TABLE[450 - a])
        y = ah * float(_SIN_TABLE[a])
        px = cx + x * alpha - y * beta
        py = cy + x * beta + y * alpha
        qx = int(np.rint(px / XY_ONE)) << XY_SHIFT
        qy = int(np.rint(py / XY_ONE)) << XY_SHIFT
        qx += int(np.rint(px - qx))
        qy += int(np.rint(py - qy))
        if not pts or pts[-1] != (qx, qy):
            pts.append((qx, qy))
    if len(pts) == 1:
        pts = [(cx, cy)] * 2
    return pts


def ellipse(img: np.ndarray, center, axes, angle: float, color) -> None:
    """``cv2.ellipse(img, center, axes, angle, 0, 360, color, -1)`` in
    place: the filled ellipse, LINE_8."""
    _fill_convex_poly(img, _ellipse_poly(center, axes, angle), color)


def rectangle(img: np.ndarray, pt1, pt2, color) -> None:
    """``cv2.rectangle(img, pt1, pt2, color, 1)`` in place: the four sides
    of the box between the two corners, ends included, clipped."""
    (x1, y1), (x2, y2) = pt1, pt2
    x1, x2 = sorted((int(x1), int(x2)))
    y1, y2 = sorted((int(y1), int(y2)))
    h, w = img.shape[:2]
    xa, xb = max(x1, 0), min(x2, w - 1)
    ya, yb = max(y1, 0), min(y2, h - 1)
    for y in (y1, y2):
        if 0 <= y < h and xa <= xb:
            img[y, xa:xb + 1] = color
    for x in (x1, x2):
        if 0 <= x < w and ya <= yb:
            img[ya:yb + 1, x] = color


def _thick_segment(img: np.ndarray, p0, p1, color) -> None:
    """OpenCV's thickness-2 segment of a closed polyline, LINE_8, between
    integer points: the segment clipped to the image grown by the
    thickness, then the rectangle one pixel either side of it and the
    radius-1 disc at its (clipped) end ``p1``."""
    h, w = img.shape[:2]
    a = [int(p0[0]) + 2, int(p0[1]) + 2]
    b = [int(p1[0]) + 2, int(p1[1]) + 2]
    if not _clip_line(w + 4, h + 4, a, b):
        return
    x0, y0 = (a[0] - 2) << XY_SHIFT, (a[1] - 2) << XY_SHIFT
    x1, y1 = (b[0] - 2) << XY_SHIFT, (b[1] - 2) << XY_SHIFT
    dx = (x0 - x1) / XY_ONE
    dy = (y1 - y0) / XY_ONE
    r = dx * dx + dy * dy
    if abs(r) > np.finfo(np.float64).eps:
        r = (1 << XY_SHIFT) / math.sqrt(r)
        dpx, dpy = int(np.rint(dy * r)), int(np.rint(dx * r))
        _fill_convex_poly(img, [(x0 + dpx, y0 + dpy), (x0 - dpx, y0 - dpy),
                                (x1 - dpx, y1 - dpy), (x1 + dpx, y1 + dpy)],
                          color)
    cx, cy = b[0] - 2, b[1] - 2
    _put(img, [cx - 1, cx, cx + 1, cx, cx], [cy, cy, cy, cy - 1, cy + 1],
         color)


@functools.lru_cache(maxsize=None)
def _unit_stamp(dx: int, dy: int) -> Tuple[np.ndarray, np.ndarray]:
    """Pixel offsets (from the segment's start) that ``_thick_segment``
    paints for a step of (dx, dy) in -1..1 away from the image border."""
    canvas = np.zeros((9, 9), np.uint8)
    _thick_segment(canvas, (4, 4), (4 + dx, 4 + dy), 1)
    ys, xs = np.nonzero(canvas)
    return xs - 4, ys - 4


def draw_contours(img: np.ndarray, contours, color) -> None:
    """``cv2.drawContours(img, contours, -1, color, 2)`` in place: each
    contour closed, every segment a thickness-2 line.  Segments between
    neighbouring pixels inside the image (the contours of
    ``find_contours``) are stamped from ``_unit_stamp`` in bulk; the
    others are drawn one by one."""
    h, w = img.shape[:2]
    xs_all, ys_all = [], []
    for c in contours:
        pts = np.asarray(c, np.int64).reshape(-1, 2)
        if len(pts) == 0:
            continue
        prev = np.roll(pts, 1, axis=0)
        step = pts - prev
        inside = ((pts[:, 0] >= 0) & (pts[:, 0] < w) & (pts[:, 1] >= 0)
                  & (pts[:, 1] < h))
        unit = (np.abs(step).max(axis=1) <= 1) & inside & np.roll(inside, 1)
        for (ddx, ddy) in {tuple(s) for s in step[unit].tolist()}:
            sel = unit & (step[:, 0] == ddx) & (step[:, 1] == ddy)
            ox, oy = _unit_stamp(int(ddx), int(ddy))
            xs_all.append((prev[sel, 0, None] + ox[None]).ravel())
            ys_all.append((prev[sel, 1, None] + oy[None]).ravel())
        for i in np.flatnonzero(~unit):
            _thick_segment(img, prev[i], pts[i], color)
    if xs_all:
        _put(img, np.concatenate(xs_all), np.concatenate(ys_all), color)


def _line8(img: np.ndarray, p1, p2, color) -> None:
    """OpenCV's ``Line`` for LINE_8 between integer points: the line
    clipped to the image, then its ``LineIterator`` (left to right,
    Bresenham's error term)."""
    h, w = img.shape[:2]
    p1, p2 = [int(p1[0]), int(p1[1])], [int(p2[0]), int(p2[1])]
    if not (0 <= p1[0] < w and 0 <= p2[0] < w and 0 <= p1[1] < h
            and 0 <= p2[1] < h) and not _clip_line(w, h, p1, p2):
        return
    dx, dy = p2[0] - p1[0], p2[1] - p1[1]
    if dx < 0:
        dx, dy = -dx, -dy
        p1, p2 = p2, p1
    step_x, step_y = 1, 1
    if dy < 0:
        dy, step_y = -dy, -1
    vert = dy > dx
    if vert:
        dx, dy = dy, dx
        step_x, step_y = step_y, step_x
    # each step moves "minus" along the major axis and "plus" diagonally
    minus = (step_x, 0) if not vert else (0, step_x)
    plus = (0, step_y) if not vert else (step_y, 0)
    err, plus_delta, minus_delta = dx - 2 * dy, 2 * dx, -2 * dy
    x, y = p1
    xs, ys = [], []
    for _ in range(dx + 1):
        xs.append(x)
        ys.append(y)
        up = err < 0
        err += minus_delta + (plus_delta if up else 0)
        x += minus[0] + (plus[0] if up else 0)
        y += minus[1] + (plus[1] if up else 0)
    img[ys, xs] = color


def _poly_edges(img: np.ndarray, pts: np.ndarray, offset, color,
                edges: list) -> None:
    """OpenCV's ``CollectPolyEdges`` (LINE_8, shift 0) for one closed
    polygon: each edge drawn by ``_line8``, and each edge that is not
    horizontal kept as [y0, y1, x at y0, dx per row] in XY_SHIFT fixed
    point, running through its vertices, or through its clipped ends
    where it leaves the image."""
    h, w = img.shape[:2]
    ox, oy = int(offset[0]), int(offset[1])
    xs = [(int(x) + ox) << XY_SHIFT for x in pts[:, 0]]
    ys = [int(y) + oy for y in pts[:, 1]]
    # unit steps inside the image draw just their two ends
    inside = [0 <= x >> XY_SHIFT < w and 0 <= y < h for x, y in zip(xs, ys)]
    px, py = [], []
    x0, y0, in0 = xs[-1], ys[-1], inside[-1]
    for x1, y1, in1 in zip(xs, ys, inside):
        t0 = [(x0 + (XY_ONE >> 1)) >> XY_SHIFT, y0]
        t1 = [(x1 + (XY_ONE >> 1)) >> XY_SHIFT, y1]
        c0x, c0y, c1x, c1y = x0, y0, x1, y1
        if in0 and in1:
            if abs(t1[0] - t0[0]) <= 1 and abs(t1[1] - t0[1]) <= 1:
                px += (t0[0], t1[0])
                py += (t0[1], t1[1])
            else:
                _line8(img, t0, t1, color)
        else:
            _line8(img, t0, t1, color)
            _clip_line(w, h, t0, t1)
            if t0[1] != t1[1]:
                c0y, c1y = t0[1], t1[1]
            c0x, c1x = t0[0] << XY_SHIFT, t1[0] << XY_SHIFT
        if y0 != y1:
            dx = _tdiv(c1x - c0x, c1y - c0y)
            if y0 < y1:
                edges.append([y0, y1, c0x + (y0 - c0y) * dx, dx])
            else:
                edges.append([y1, y0, c1x + (y1 - c1y) * dx, dx])
        x0, y0, in0 = x1, y1, in1
    if px:
        img[py, px] = color


def _fill_edges(img: np.ndarray, edges: list, color) -> None:
    """OpenCV's ``FillEdgeCollection``: the edges sorted by (y0, x, dx);
    on each row the active edges in x order, paired, and the pixels whose
    centres lie between a pair filled (``ceil(x_left)`` to
    ``floor(x_right)``), then each paired edge stepped by its dx."""
    h, w = img.shape[:2]
    if len(edges) < 2:
        return
    y_min = min(e[0] for e in edges)
    y_max = max(e[1] for e in edges)
    ends = [e[2] for e in edges] + [e[2] + (e[1] - e[0]) * e[3]
                                    for e in edges]
    if y_max < 0 or y_min >= h or max(ends) < 0 or \
            min(ends) >= (w << XY_SHIFT):
        return
    edges = sorted(edges, key=lambda e: (e[0], e[2], e[3]))
    y_max = min(y_max, h)
    active, i, total = [], 0, len(edges)
    y = edges[0][0]
    while y < y_max:
        active = [e for e in active if e[1] != y]
        merged, j = [], 0
        while j < len(active) or (i < total and edges[i][0] == y):
            if j < len(active) and not (i < total and edges[i][0] == y
                                        and active[j][2] >= edges[i][2]):
                merged.append(active[j])
                j += 1
            else:
                merged.append(edges[i])
                i += 1
        for k in range(0, len(merged) - 1, 2):
            a, b = merged[k], merged[k + 1]
            if y >= 0:
                lo, hi = (b[2], a[2]) if a[2] > b[2] else (a[2], b[2])
                x1 = (lo + XY_ONE - 1) >> XY_SHIFT
                x2 = hi >> XY_SHIFT
                if x1 < w and x2 >= 0:
                    img[y, max(x1, 0):min(x2, w - 1) + 1] = color
            a[2] += a[3]
            b[2] += b[3]
        active = sorted(merged, key=lambda e: e[2])  # stable, as OpenCV's
        y += 1


def fill_contours(img: np.ndarray, contours, idx: int, color,
                  offset=(0, 0)) -> None:
    """``cv2.drawContours(img, contours, idx, color, thickness=-1,
    offset=offset)`` in place on a host array: contour ``idx`` (every
    contour when ``idx`` is negative) filled as one polygon set, even-odd,
    LINE_8."""
    chosen = range(len(contours)) if idx < 0 else [idx]
    edges: list = []
    for c in chosen:
        pts = np.asarray(contours[c]).reshape(-1, 2)
        if len(pts):
            _poly_edges(img, pts, offset, color, edges)
    _fill_edges(img, edges, color)
