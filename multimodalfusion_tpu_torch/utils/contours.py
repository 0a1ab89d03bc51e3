"""Contours of binary masks and tests on them, as OpenCV computes them (the
machine with the card has no OpenCV): the port's stand-ins for the calls
of the JAX package's tissue segmentation and patch grid.

- ``find_contours(mask)`` is ``cv2.findContours(mask, RETR_CCOMP,
  CHAIN_APPROX_NONE)``: Suzuki and Abe's border following on the mask
  padded with a zero frame (so foreground on the image's edge is traced),
  every border pixel in OpenCV's order from OpenCV's start pixel, the
  contours in the reverse of their raster-scan discovery, each outer
  border followed by its holes, and the ``[next, prev, child, parent]``
  hierarchy of the two levels.  The start pixels are found by one
  vectorised pass over the row transitions; only the tracing is a loop.
- ``contour_area`` is ``cv2.contourArea`` (the shoelace formula,
  absolute), ``bounding_rect`` is ``cv2.boundingRect`` (``w = max - min
  + 1``) and ``point_polygon_test`` is ``cv2.pointPolygonTest`` with
  ``measureDist=False`` (+1 inside, 0 on an edge, -1 outside), its point
  rounded to float32 as OpenCV takes it.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

# chain code -> (dx, dy), OpenCV's order (counter-clockwise from east in
# image coordinates, y down)
_CODE_DELTAS = ((1, 0), (1, -1), (0, -1), (-1, -1), (-1, 0), (-1, 1),
                (0, 1), (1, 1))


def _trace(img, step: int, start: int, origin: Tuple[int, int],
           is_hole: bool, nbd: int) -> List[Tuple[int, int]]:
    """OpenCV's ``icvFetchContourEx`` on the flat padded image ``img`` (a
    memoryview of int32): follow the border from pixel ``start``, marking
    its pixels with ``nbd`` (``-nbd`` where the border leaves to the
    right), and return every point of it, starting at ``origin``."""
    deltas = [dx + dy * step for dx, dy in _CODE_DELTAS] * 2
    i0 = start
    s_end = s = 0 if is_hole else 4
    while True:
        s = (s - 1) & 7
        i1 = i0 + deltas[s]
        if img[i1] != 0 or s == s_end:
            break
    if img[i1] == 0:  # a single pixel
        img[i0] = -nbd
        return [origin]
    px, py = origin
    points = []
    i3 = i0
    while True:
        s_end = s
        while s < 15:
            s += 1
            i4 = i3 + deltas[s]
            if img[i4] != 0:
                break
        s &= 7
        if (s - 1) & 0xFFFFFFFF < s_end:
            img[i3] = -nbd
        elif img[i3] == 1:
            img[i3] = nbd
        points.append((px, py))
        px += _CODE_DELTAS[s][0]
        py += _CODE_DELTAS[s][1]
        if i4 == i0 and i3 == i1:
            return points
        i3 = i4
        s = (s + 4) & 7


def find_contours(mask: np.ndarray
                  ) -> Tuple[List[np.ndarray], Optional[np.ndarray]]:
    """``cv2.findContours(mask, cv2.RETR_CCOMP, cv2.CHAIN_APPROX_NONE)`` of
    a 2-D array (nonzero is foreground): (contours, each int32 [N, 1, 2]
    of (x, y), and the hierarchy int32 [1, n, 4], or None when there is no
    contour)."""
    m = np.asarray(mask)
    if m.ndim != 2:
        raise ValueError(f"find_contours takes a 2-D mask, got {m.shape}")
    h, w = m.shape
    step = w + 2
    padded = np.zeros((h + 2, step), np.int32)
    padded[1:-1, 1:-1] = m != 0
    flat = padded.reshape(-1)
    img = memoryview(flat).cast("B").cast("i")
    # every row transition of the mask, in raster order: the only places a
    # border can start (tracing marks foreground pixels only)
    left, right = padded[:, :-1], padded[:, 1:]
    ys, xs = np.nonzero(left != right)
    starts = (ys * step + xs + 1).tolist()
    # per contour: (points, is_hole, parent contour id or -1)
    contours: List[Tuple[List[Tuple[int, int]], bool, int]] = []
    label_of = {}  # nbd label -> contour id
    nbd = 1
    for x in starts:
        prev, p = img[x - 1], img[x]
        if prev == 0 and p == 1:
            is_hole, at = False, x
        elif p == 0 and prev >= 1:
            is_hole, at = True, x - 1
        else:
            continue
        parent = -1
        if is_hole:
            # the last border met on this row (Suzuki's LNBD): its contour
            # if it is an outer border, else that hole's own outer border
            row0 = x - x % step
            if img[x - 1] > 1:
                lab = img[x - 1]
            else:
                marked = np.flatnonzero(np.abs(flat[row0:x - 1]) > 1)
                lab = abs(int(flat[row0 + marked[-1]])) if len(marked) \
                    else 0
            if lab:
                owner = label_of[lab]
                parent = contours[owner][2] if contours[owner][1] else owner
        nbd += 1
        origin = (at % step - 1, at // step - 1)
        points = _trace(img, step, at, origin, is_hole, nbd)
        label_of[nbd] = len(contours)
        contours.append((points, is_hole, parent))
    if not contours:
        return [], None
    # children lists newest first; output in depth-first pre-order
    tops = [i for i in reversed(range(len(contours)))
            if contours[i][2] == -1]
    kids = {i: [] for i in range(len(contours))}
    for i in reversed(range(len(contours))):
        if contours[i][2] != -1:
            kids[contours[i][2]].append(i)
    order = []
    for t in tops:
        order.append(t)
        order += kids[t]
    index = {c: k for k, c in enumerate(order)}
    hier = np.full((1, len(order), 4), -1, np.int32)
    for level in [tops] + [kids[t] for t in tops]:
        for j, c in enumerate(level):
            row = hier[0, index[c]]
            row[0] = index[level[j + 1]] if j + 1 < len(level) else -1
            row[1] = index[level[j - 1]] if j > 0 else -1
            row[2] = index[kids[c][0]] if kids.get(c) and \
                contours[c][2] == -1 else -1
            row[3] = index[contours[c][2]] if contours[c][2] != -1 else -1
    out = [np.array(contours[c][0], np.int32).reshape(-1, 1, 2)
           for c in order]
    return out, hier


def contour_area(contour) -> float:
    """``cv2.contourArea(contour)``: the absolute shoelace area."""
    v = np.asarray(contour, np.float64).reshape(-1, 2)
    if len(v) < 3:
        return 0.0
    x, y = v[:, 0], v[:, 1]
    xp, yp = np.roll(x, 1), np.roll(y, 1)
    return float(abs(np.sum(xp * y - x * yp) * 0.5))


def bounding_rect(contour) -> Tuple[int, int, int, int]:
    """``cv2.boundingRect`` of integer points: (x, y, w, h), w = max - min
    + 1."""
    v = np.asarray(contour).reshape(-1, 2)
    if len(v) == 0:
        return 0, 0, 0, 0
    lo, hi = v.min(axis=0), v.max(axis=0)
    return int(lo[0]), int(lo[1]), int(hi[0] - lo[0] + 1), \
        int(hi[1] - lo[1] + 1)


def point_polygon_test(contour, pt) -> float:
    """``cv2.pointPolygonTest(contour, pt, False)``: 1.0 inside, 0.0 on an
    edge or vertex, -1.0 outside, by crossing parity over the edges.  The
    point is rounded to float32 first, as OpenCV takes a ``Point2f``."""
    v = np.asarray(contour, np.float64).reshape(-1, 2)
    if len(v) == 0:
        return -1.0
    px, py = (float(np.float32(c)) for c in pt)
    v0 = np.roll(v, 1, axis=0)
    x0, y0, x1, y1 = v0[:, 0], v0[:, 1], v[:, 0], v[:, 1]
    skip = (((y0 <= py) & (y1 <= py)) | ((y0 > py) & (y1 > py))
            | ((x0 < px) & (x1 < px)))
    on_vertex = skip & (py == y1) & ((px == x1) | (
        (py == y0) & (((x0 <= px) & (px <= x1)) | ((x1 <= px) & (px <= x0)))))
    dist = (py - y0) * (x1 - x0) - (px - x0) * (y1 - y0)
    if on_vertex.any() or (~skip & (dist == 0)).any():
        return 0.0
    dist = np.where(y1 < y0, -dist, dist)
    return 1.0 if int(np.sum(~skip & (dist > 0))) % 2 else -1.0
