"""Whole-slide attention heatmaps and ROI sampling (port of
multimodalfusion_tpu/interpret/heatmaps.py, a rewrite of the reference's
visHeatmap, WholeSlideImage.py:562-749, and wsi_utils.py:171-212).

The machine with the card has no OpenCV, PIL or matplotlib, so the
drawing runs on the port's stand-ins (``utils/image_ops.py``), each equal
to its library bit for bit: the tissue mask by ``fill_contours``
(``cv2.drawContours`` filled), the colormaps by ``colormap`` (matplotlib's
tables), the blur by ``gaussian_blur_u8`` (OpenCV's 8-bit path), the
blend by ``add_weighted`` and the final resizes by ``resize_bicubic_pil``
(PIL's default ``Image.resize``).  ``draw_heatmap`` sums each pixel's
scores in patch order on the host in float64, as JAX's loop does, then
averages, colours, blurs, blends and resizes on ``device`` in integer or
float64 arithmetic, so that the card and the CPU give the same bytes.

The fine pass (``compute_fine_scores``) re-grids the tissue at an
overlapping stride, reads its patches on a prefetch thread and embeds
them with ``Embedder.embed_images(resize=True)``, which resizes them on
the embedder's device as ``cv2.resize`` does on JAX's host.
"""
from __future__ import annotations

import time
from typing import Optional, Tuple

import numpy as np
import torch

from multimodalfusion_tpu_torch import resolve_device
from multimodalfusion_tpu_torch.utils import contours as cts
from multimodalfusion_tpu_torch.utils import image_ops


def to_percentiles(scores: np.ndarray) -> np.ndarray:
    """Rank-transform scores to [0, 100] (ref wsi_utils.py:171-176)."""
    from scipy.stats import rankdata
    return rankdata(scores, "average") / len(scores) * 100


def score_to_percentile(scores: np.ndarray, ref: np.ndarray) -> np.ndarray:
    """Percentile rank of each score against a reference distribution
    (``scipy.stats.percentileofscore(kind='rank')`` vectorised, ref
    heatmap_utils.py:32-34): the mean 1-based rank over ties where the
    score is present, else the count below it, over ``len(ref)``, times
    100."""
    ref = np.sort(np.asarray(ref).reshape(-1))
    s = np.asarray(scores).reshape(-1)
    n = len(ref)
    if n == 0:
        return np.zeros_like(s, dtype=np.float64)
    left = np.searchsorted(ref, s, side="left")
    right = np.searchsorted(ref, s, side="right")
    present = right > left
    rank = np.where(present, left + (right - left + 1) / 2.0,
                    right.astype(np.float64))
    return rank / n * 100.0


def screen_coords(scores: np.ndarray, coords: np.ndarray, top_left,
                  bot_right):
    """The (score, coord) pairs inside the level-0 box (ref
    wsi_utils.py:164-169)."""
    mask = np.logical_and(np.all(coords >= np.asarray(top_left), axis=1),
                          np.all(coords <= np.asarray(bot_right), axis=1))
    return scores[mask], coords[mask]


def get_seg_mask(region_size, scale, tissue, holes, use_holes: bool = True,
                 offset=(0, 0)) -> np.ndarray:
    """Boolean [h, w] foreground of the level-0 tissue contours at the vis
    scale (ref WholeSlideImage.get_seg_mask :794-811): each contour
    filled, largest area first, its holes carved out after it."""
    w, h = region_size
    mask = np.zeros((h, w), np.uint8)
    sx, sy = scale
    t_scaled = [np.array(c * np.array([sx, sy]), np.int32) for c in tissue]
    h_scaled = [[np.array(c * np.array([sx, sy]), np.int32) for c in hs]
                for hs in holes]
    off = (int(-offset[0] * sx), int(-offset[1] * sy))
    order = sorted(range(len(t_scaled)),
                   key=lambda i: cts.contour_area(t_scaled[i]), reverse=True)
    for i in order:
        image_ops.fill_contours(mask, t_scaled, i, 1, off)
        if use_holes and i < len(h_scaled):
            image_ops.fill_contours(mask, h_scaled[i], -1, 0, off)
    return mask.astype(bool)


def block_blend(slide, img: torch.Tensor, vis_level: int, top_left,
                bot_right, alpha: float, blank_canvas: bool = False,
                canvas_color=(255, 255, 255),
                block_size: int = 1024) -> torch.Tensor:
    """Alpha-blend the heatmap-written image [h, w, 3] (uint8, on any
    device) with the slide re-read in blocks of ``block_size`` (ref
    WholeSlideImage.block_blending :752-791), in place: the slide's
    canvas is never held whole."""
    ds = slide.level_downsamples[vis_level]
    h, w = img.shape[:2]
    bx, by = min(block_size, w), min(block_size, h)
    for x0 in range(int(top_left[0]), int(bot_right[0]), bx * int(ds[0])):
        for y0 in range(int(top_left[1]), int(bot_right[1]),
                        by * int(ds[1])):
            xi = int((x0 - top_left[0]) / int(ds[0]))
            yi = int((y0 - top_left[1]) / int(ds[1]))
            xe, ye = min(w, xi + bx), min(h, yi + by)
            if xe == xi or ye == yi:
                continue
            if blank_canvas:
                canvas = torch.tensor(canvas_color, dtype=torch.uint8,
                                      device=img.device).expand(
                    ye - yi, xe - xi, 3)
            else:
                canvas = torch.from_numpy(slide.read_region(
                    (x0, y0), vis_level, (xe - xi, ye - yi))).to(img.device)
            img[yi:ye, xi:xe] = image_ops.add_weighted(
                img[yi:ye, xi:xe], alpha, canvas, 1 - alpha)
    return img


class _Clock:
    """Seconds of each stage into ``timings`` (a dict, or None), the
    device synchronised at each stage's end."""

    def __init__(self, timings, device):
        self.timings, self.device = timings, device
        self.t = time.perf_counter()

    def lap(self, stage: str) -> None:
        if self.timings is None:
            return
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        now = time.perf_counter()
        self.timings[stage] = self.timings.get(stage, 0.0) + now - self.t
        self.t = now


def _accumulate(scores, coords, scale, ps_vis, thr, binarize, h, w):
    """The overlay's per-pixel score sums (float64, summed in patch
    order), the patches covering each pixel and those of them that pass
    the threshold (JAX heatmaps.py:163-176).  The counts are integers, so
    they are summed at once from a difference array."""
    cx = np.ceil(coords[:, 0] * scale[0]).astype(np.int64)
    cy = np.ceil(coords[:, 1] * scale[1]).astype(np.int64)
    passing = scores >= thr
    s = np.where(passing, 1.0 if binarize else scores, 0.0)
    overlay = np.zeros((h, w), np.float64)
    for si, x, y in zip(s.tolist(), cx.tolist(), cy.tolist()):
        overlay[y:y + ps_vis[1], x:x + ps_vis[0]] += si

    def count(sel):
        diff = np.zeros((h + 1, w + 1), np.int64)
        for x, y in zip(cx[sel].tolist(), cy[sel].tolist()):
            # numpy's slice bounds, as JAX's loop slices
            y0, y1, _ = slice(y, y + ps_vis[1]).indices(h)
            x0, x1, _ = slice(x, x + ps_vis[0]).indices(w)
            if x1 <= x0 or y1 <= y0:
                continue
            diff[y0, x0] += 1
            diff[y0, x1] -= 1
            diff[y1, x0] -= 1
            diff[y1, x1] += 1
        return np.cumsum(np.cumsum(diff, axis=0), axis=1)[:h, :w]
    return overlay, count(np.ones(len(s), bool)), count(passing)


def draw_heatmap(slide, scores: np.ndarray, coords: np.ndarray,
                 patch_size: int = 256, patch_level: int = 0,
                 vis_level: Optional[int] = None, alpha: float = 0.4,
                 blur: bool = False, overlap: float = 0.0,
                 use_percentiles: bool = True,
                 binarize: bool = False, threshold: float = 0.5,
                 cmap: str = "RdYlBu_r",
                 segment: bool = False, tissue=None, holes=None,
                 use_holes: bool = True,
                 blank_canvas: bool = False,
                 canvas_color=(255, 255, 255),
                 adjust: float = 0.0,
                 custom_downsample: int = 1,
                 max_size: Optional[int] = None,
                 top_left=None, bot_right=None,
                 block_size: int = 1024, device=None,
                 timings: Optional[dict] = None) -> np.ndarray:
    """The overlap-averaged attention overlay on the downscaled slide, as
    uint8 RGB [h, w, 3] (JAX draw_heatmap, ref visHeatmap
    WholeSlideImage.py:562-749): every option of JAX's, ``cmap`` checked
    before any work (``image_ops.colormap``).  The per-pixel work runs on
    ``device`` (cuda unless the caller names another); ``timings``
    collects the seconds of the overlay, the slide read, the
    segmentation mask, colormap, blur, blend and resize."""
    color_of = image_ops.colormap(cmap)
    dev = resolve_device(device)
    clock = _Clock(timings, dev)
    if vis_level is None:
        vis_level = slide.level_count - 1
    ds = slide.level_downsamples[vis_level]
    scale = (1.0 / ds[0], 1.0 / ds[1])
    scores = np.asarray(scores, np.float64).reshape(-1)
    coords = np.asarray(coords)

    if binarize:
        thr = 1.0 / len(scores) if threshold < 0 else threshold
    else:
        thr = 0.0

    if top_left is not None and bot_right is not None:
        scores, coords = screen_coords(scores, coords, top_left, bot_right)
        coords = coords - np.asarray(top_left)
        w = int(bot_right[0] * scale[0]) - int(top_left[0] * scale[0])
        h = int(bot_right[1] * scale[1]) - int(top_left[1] * scale[1])
    else:
        w, h = slide.level_dimensions[vis_level]
        top_left = (0, 0)
        bot_right = slide.level_dimensions[0]

    if use_percentiles:
        scores = to_percentiles(scores) / 100.0
    if adjust != 0.0:
        scores = np.clip(scores + adjust, 0.0, 1.0)

    pds = slide.level_downsamples[patch_level]
    ps_vis = (max(int(np.ceil(patch_size * pds[0] * scale[0])), 1),
              max(int(np.ceil(patch_size * pds[1] * scale[1])), 1))
    overlay, counter, pass_counter = _accumulate(
        scores, coords.reshape(-1, 2), scale, ps_vis, thr, binarize, h, w)
    overlay = torch.from_numpy(overlay).to(dev)
    counter = torch.from_numpy(counter).to(dev)
    seen = counter > 0
    overlay = torch.where(seen, overlay / counter.clamp(min=1).double(),
                          overlay)
    if binarize:
        overlay = torch.where(seen, torch.round(overlay), overlay)
    colored = torch.from_numpy(pass_counter > 0).to(dev)
    clock.lap("overlay")

    if blank_canvas:
        img = torch.tensor(canvas_color, dtype=torch.uint8,
                           device=dev).expand(h, w, 3).clone()
    else:
        img = torch.from_numpy(np.ascontiguousarray(slide.read_region(
            tuple(top_left), vis_level, (w, h)))).to(dev)
    clock.lap("read")
    if segment and tissue is not None:
        tissue_mask = get_seg_mask((w, h), scale, tissue, holes or [],
                                   use_holes=use_holes,
                                   offset=tuple(top_left))
        colored &= torch.from_numpy(tissue_mask).to(dev)
        clock.lap("seg_mask")
    heat = color_of(overlay.clamp(0, 1))
    img = torch.where(colored.unsqueeze(-1), heat, img)
    clock.lap("colormap")

    if blur:
        k = (int(ps_vis[0] * (1 - overlap)) * 2 + 1,
             int(ps_vis[1] * (1 - overlap)) * 2 + 1)
        img = image_ops.gaussian_blur_u8(img, k)
        clock.lap("blur")

    if alpha < 1.0:
        img = block_blend(slide, img, vis_level, top_left, bot_right,
                          alpha=alpha, blank_canvas=blank_canvas,
                          canvas_color=canvas_color, block_size=block_size)
        clock.lap("blend")

    # PIL's default bicubic, as JAX's Image.resize calls
    if custom_downsample > 1:
        img = image_ops.resize_bicubic_pil(
            img, (h // custom_downsample, w // custom_downsample))
    if max_size is not None and (img.shape[1] > max_size
                                 or img.shape[0] > max_size):
        f = max_size / max(img.shape[1], img.shape[0])
        img = image_ops.resize_bicubic_pil(
            img, (int(img.shape[0] * f), int(img.shape[1] * f)))
    out = img.cpu().numpy()
    clock.lap("resize")
    return out


def sample_rois(scores: np.ndarray, coords: np.ndarray, k: int = 5,
                mode: str = "topk", seed: int = 1,
                score_range: Tuple[float, float] = (0.45, 0.55)):
    """Patch coordinates chosen by attention score (ref
    wsi_utils.py:191-212): ``topk``, ``reverse_topk``, or ``range_sample``
    (a seeded numpy ``Generator``'s permutation of the patches whose
    percentile lies in ``score_range``).  Returns (scores, coords)."""
    scores = np.asarray(scores).reshape(-1)
    if len(scores) == 0:
        return scores, coords
    percentiles = to_percentiles(scores) / 100.0
    if mode == "topk":
        order = np.argsort(-scores)[:k]
    elif mode == "reverse_topk":
        order = np.argsort(scores)[:k]
    elif mode == "range_sample":
        lo, hi = score_range
        pool = np.flatnonzero((percentiles >= lo) & (percentiles <= hi))
        rng = np.random.default_rng(seed)
        order = rng.permutation(pool)[:k]
    else:
        raise NotImplementedError(mode)
    return scores[order], coords[order]


def dynamic_k(bag_size: int, frac: float = 0.005, floor: int = 200) -> int:
    """Sampling k = max(0.5% of the bag, ``floor``) (ref
    create_heatmaps.py:481-492)."""
    return max(int(bag_size * frac), floor)


def patch_mosaic(patches: np.ndarray, n_cols: int = 5, gap: int = 2,
                 downscale: int = 1) -> np.ndarray:
    """The sampled patches on a grid canvas (the reference's
    Mosaic_Canvas, util_classes.py:6-46), each resized by ``resize_u8``
    (``cv2.resize``) when ``downscale`` > 1."""
    if len(patches) == 0:
        return np.full((8, 8, 3), 245, np.uint8)
    ps = patches.shape[1] // downscale
    if downscale > 1:
        patches = image_ops.resize_u8(torch.from_numpy(np.ascontiguousarray(
            patches)), (ps, ps)).numpy()
    n = len(patches)
    n_rows = (n + n_cols - 1) // n_cols
    H = n_rows * ps + (n_rows + 1) * gap
    W = n_cols * ps + (n_cols + 1) * gap
    canvas = np.full((H, W, 3), 245, np.uint8)
    for i, p in enumerate(patches):
        r, c = divmod(i, n_cols)
        y = gap + r * (ps + gap)
        x = gap + c * (ps + gap)
        canvas[y:y + ps, x:x + ps] = p[..., :3]
    return canvas


def fine_pass_center_shift(overlap: float,
                           use_center_shift: bool = True) -> float:
    """The reference's overlap -> four_pt_hard probe shift of the fine
    grid (ref wsi_dataset.py:74-88 Wsi_Region)."""
    if not use_center_shift:
        return 0.0
    if overlap < 0.25:
        return 0.375
    if overlap < 0.95:
        return 0.5
    return 0.625


def compute_fine_scores(slide, tissue, holes, embedder, score_fn,
                        patch_size: int = 256, overlap: float = 0.75,
                        patch_level: int = 0, chunk: int = 512,
                        use_center_shift: bool = True,
                        timings: Optional[dict] = None):
    """The fine pass (ref heatmap_utils.compute_from_patches:111-150): the
    tissue re-gridded at stride ``patch_size * (1 - overlap)`` with the
    four_pt_hard check and its overlap-dependent probe shift, every patch
    read (``chunk`` at a time, on a prefetch thread) and embedded, resized
    on the embedder's device when its size is not the trunk's, and the
    whole bag scored by ``score_fn(features [N, D]) -> scores [N]``.
    Returns (scores, coords); ``timings`` collects the seconds of the
    grid, the reads and the embedding."""
    from multimodalfusion_tpu_torch.data.loaders import prefetch
    from multimodalfusion_tpu_torch.data.wsi import (process_contours,
                                                     read_patches)
    t0 = time.perf_counter()
    step = max(int(patch_size * (1 - overlap)), 1)
    coords, _ = process_contours(
        slide, tissue, holes, patch_level=patch_level,
        patch_size=patch_size, step_size=step,
        contour_fn="four_pt_hard",
        center_shift=fine_pass_center_shift(overlap, use_center_shift))
    wall = {} if timings is None else timings
    wall["fine_grid"] = wall.get("fine_grid", 0.0) + \
        time.perf_counter() - t0
    if len(coords) == 0:
        return np.zeros(0), coords

    def chunks():
        for start in range(0, len(coords), chunk):
            t = time.perf_counter()
            patches = read_patches(slide, coords[start:start + chunk],
                                   patch_level, patch_size)
            yield patches, time.perf_counter() - t

    feats = []
    for patches, read_s in prefetch(chunks(), depth=2):
        t = time.perf_counter()
        feats.append(embedder.embed_images(
            patches, resize=patches.shape[1] != embedder.image_size))
        wall["fine_embed"] = wall.get("fine_embed", 0.0) + \
            time.perf_counter() - t
        wall["fine_read"] = wall.get("fine_read", 0.0) + read_s
    scores = np.asarray(score_fn(np.concatenate(feats, axis=0))).reshape(-1)
    return scores, coords
