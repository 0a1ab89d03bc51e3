"""Whole-slide images: slide readers, tissue segmentation, the patch grid,
patch reads, filters and stitching (port of multimodalfusion_tpu/data/
wsi.py, with its names).

The machine with the card has no OpenCV, PIL or openslide, so the port
runs on stand-ins of its own, each held to the library it replaces
(tests/test_torch_wsi_ops.py, tests/test_torch_wsi.py):
``utils/image_ops.py`` (HSV saturation, median blur, threshold and Otsu,
morphological close, the uint8 resize, rectangle, ellipse),
``utils/contours.py`` (``findContours`` with ``RETR_CCOMP``,
``contourArea``, ``boundingRect``, ``pointPolygonTest``),
``utils/tiff.py``, ``utils/png.py``, ``utils/jpeg.py`` and
``utils/j2k.py`` (the slide files, with their decoders in
``csrc/imgcodec.cpp`` and ``csrc/j2k.cpp``), ``utils/aperio.py``
(openslide's rules for Aperio slides) and ``data/hdf5.py`` (the
coordinates and their attributes).

Backends:
  * ``ArraySlide`` -- an in-memory numpy pyramid (tests, synthetic slides);
  * ``PILSlide`` -- the JAX name of the page-per-level reader, which
    picks its reader by the file's first bytes as PIL does
    (``slide_format``): multi-page TIFF or BigTIFF (``READS`` lists the
    layouts) through ``utils/tiff.py``, PNG through ``utils/png.py``,
    JPEG (Huffman or arithmetic coding, sequential, progressive or
    lossless) through ``utils/jpeg.py``, JPEG 2000 (a codestream or a JP2
    file) through ``utils/j2k.py``; every page is decoded into RAM, so
    the decode is budgeted from the headers first
    (``MMF_TPU_WSI_MAX_BYTES``);
  * ``OpenSlideBackend`` -- the JAX name of the openslide reader, for
    Aperio ``.svs`` slides: openslide's Aperio rules
    (``utils/aperio.py``), the tiles a read touches decoded on demand
    (``tiff.read_tiles``) into a cache bounded by bytes, no decode
    budget; the other openslide formats are refused by their extension.

The per-pixel filters of ``segment_tissue`` run as torch ops on the
device the caller names; contour tracing and the patch grid run on the
host in numpy.  The grid's scanline row test (``_polygon_row_test``) and
probe offsets are copies of the JAX package's.
"""
from __future__ import annotations

import collections
import math
import os
import time
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from multimodalfusion_tpu_torch import resolve_device
from multimodalfusion_tpu_torch.data.io import save_hdf5
from multimodalfusion_tpu_torch.utils import contours as cts
from multimodalfusion_tpu_torch.utils import (aperio, image_ops, j2k, jpeg,
                                             png, tiff)

# the formats of openslide (JAX open_slide, data/wsi.py:165); the port
# reads the first, Aperio's
OPENSLIDE_EXTS = (".svs", ".ndpi", ".mrxs", ".scn", ".vms", ".vmu", ".bif")
# the usual extensions of what PILSlide reads (for messages and
# cli.doctor; PILSlide itself goes by the file's first bytes)
SLIDE_EXTS = (".tif", ".tiff", ".btf", ".tf8", ".png", ".jpg", ".jpeg",
              ".jp2", ".j2k", ".jpc", ".jpf", ".jpx", ".j2c")
READS = ("multi-page TIFF or BigTIFF (stripped or tiled, chunky or planar; "
         "uncompressed, LZW, Deflate, PackBits, LZMA, ZSTD or JPEG; bilevel, "
         "gray, "
         "LA, RGB with or without alpha, 16-bit RGB, palette or CMYK), PNG, "
         "JPEG (Huffman or arithmetic coding; baseline, progressive or "
         "lossless; gray, YCbCr, RGB, CMYK or YCCK) and JPEG 2000")
# what PIL opens that the port does not read, by the first bytes its
# plugins' _accept functions test
_PIL_ONLY = (
    ("GIF", lambda h: h.startswith((b"GIF87a", b"GIF89a"))),
    ("BMP", lambda h: h.startswith(b"BM")),
    ("WebP", lambda h: h.startswith(b"RIFF") and h[8:12] == b"WEBP"),
    ("PBM/PGM/PPM", lambda h: len(h) > 1 and h[0] == ord("P")
     and h[1] in b"0123456fy"),
)
# patches resized at once by stitch_coords (256 of 256 px: 50 MB of int32)
STITCH_BATCH = 256


# ---------------------------------------------------------------------------
# slide backends
# ---------------------------------------------------------------------------

class ArraySlide:
    """In-memory pyramid: list of RGB uint8 arrays, level 0 largest."""

    def __init__(self, levels: Sequence[np.ndarray], name: str = "array"):
        self.levels = [np.asarray(l) for l in levels]
        self.name = name

    @property
    def level_count(self) -> int:
        return len(self.levels)

    @property
    def level_dimensions(self) -> List[Tuple[int, int]]:
        return [(l.shape[1], l.shape[0]) for l in self.levels]  # (w, h)

    @property
    def level_downsamples(self) -> List[Tuple[float, float]]:
        w0, h0 = self.level_dimensions[0]
        return [(w0 / w, h0 / h) for (w, h) in self.level_dimensions]

    def read_region(self, location_level0, level, size) -> np.ndarray:
        """(x, y) level-0 location, level, (w, h) size -> RGB uint8."""
        ds = self.level_downsamples[level]
        x = int(location_level0[0] / ds[0])
        y = int(location_level0[1] / ds[1])
        w, h = size
        arr = self.levels[level]
        out = np.full((h, w, 3), 255, np.uint8)
        src = arr[max(y, 0):y + h, max(x, 0):x + w, :3]
        out[:src.shape[0], :src.shape[1]] = src
        return out

    def thumbnail(self, level: int = -1) -> np.ndarray:
        return self.levels[level][..., :3]


def _png_header(path: str) -> Tuple[Tuple[int, int], str]:
    """((w, h), PIL's mode) of a PNG from its IHDR."""
    with open(path, "rb") as f:
        head = f.read(33)
    if head[:8] != png.SIGNATURE or head[12:16] != b"IHDR":
        raise ValueError(f"{path}: not a PNG file")
    w, h = int.from_bytes(head[16:20], "big"), int.from_bytes(head[20:24],
                                                              "big")
    return (w, h), png.mode(head[24], head[25])


def _jpeg_header(path: str) -> Tuple[Tuple[int, int], str]:
    """((w, h), PIL's mode) of a JPEG from its markers (its scans are not
    decoded): L, RGB or CMYK for 1, 3 or 4 components."""
    with open(path, "rb") as fh:
        data = fh.read()
    try:
        frame = jpeg.parse_jpeg(data)
    except NotImplementedError as e:
        raise NotImplementedError(f"{path}: {e}") from e
    return (frame.width, frame.height), {1: "L", 3: "RGB", 4: "CMYK"}[
        len(frame.h)]


# CMYK -> RGB as PIL's convert("RGB") (Convert.c's cmyk2rgb)
_cmyk_to_rgb = tiff.cmyk_to_rgb


def _j2k_header(path: str) -> Tuple[Tuple[int, int], str]:
    """((w, h), PIL's mode) of a JPEG 2000 file from its JP2 boxes and SIZ
    (no code-block is read)."""
    try:
        return j2k.read_header(path)
    except (ValueError, NotImplementedError) as e:
        raise type(e)(f"{path}: {e}") from e


def slide_format(path: str) -> str:
    """What the file at ``path`` is -- "TIFF", "PNG", "JPEG" or "JPEG2000"
    -- from its first 16 bytes, as PIL's ``Image.open`` tells (its plugins'
    ``_accept``: ``tiff.PREFIXES``, the PNG signature, ``\\xff\\xd8\\xff``,
    a JPEG 2000 codestream's SOC and SIZ or the JP2 signature box).  A
    format PIL opens and the port does not read raises
    ``NotImplementedError`` naming it; bytes that neither identifies, an
    ``OSError`` (PIL's ``UnidentifiedImageError`` is one)."""
    with open(path, "rb") as f:
        head = f.read(16)
    if head[:4] in tiff.PREFIXES:
        return "TIFF"
    if head.startswith(png.SIGNATURE):
        return "PNG"
    if head.startswith(b"\xff\xd8\xff"):
        return "JPEG"
    if head.startswith((b"\xff\x4f\xff\x51", j2k.JP2_SIGNATURE)):
        return "JPEG2000"
    for name, accept in _PIL_ONLY:
        if accept(head):
            raise NotImplementedError(
                f"{path}: a {name} slide (by its first bytes); PIL reads "
                f"it, the port reads {READS}")
    raise OSError(f"{path}: cannot identify the slide's format from its "
                  f"first bytes {head[:8]!r}; the port reads {READS} "
                  f"(usually named {', '.join(SLIDE_EXTS)})")


class PILSlide(ArraySlide):
    """Page-per-level slide (the JAX name; no PIL): the pages of a multi-
    page TIFF or little-endian BigTIFF -- strips or tiles, chunky or
    planar, uncompressed, LZW (predictor 1 or 2), Deflate, PackBits, LZMA,
    ZSTD (the port's own Zstandard decoder, ``utils/zstd.py``) or JPEG;
    bilevel, gray, LA, RGB with or without alpha, 16-bit RGB, palette or
    CMYK (``utils/tiff.py``) -- or one PNG of any colour type, depth and
    interlace (``utils/png.py``), or one JPEG -- Huffman or arithmetic
    coding, baseline, progressive or lossless, gray, YCbCr, RGB, CMYK or
    YCCK, decoded to PIL's pixels by ``utils/jpeg.py``, a CMYK page mapped
    to RGB as ``convert("RGB")`` maps it (``_cmyk_to_rgb``) -- or one JPEG
    2000 image (``utils/j2k.py``), are the pyramid's levels, each as PIL's
    ``convert("RGB")`` gives it.  The reader is chosen by the file's first
    bytes, as PIL chooses its plugin (``slide_format``), whatever the
    file's name; the levels' name is the file name's stem.  A format PIL
    reads and the port does not (GIF, BMP, WebP, PPM, ...) raises
    ``NotImplementedError`` naming it; bytes of no format, ``OSError``.

    Every page is decoded into RAM, so the decoded size is computed from
    the page headers FIRST: past ``max_decode_bytes`` (default 1 GiB,
    overridable via the MMF_TPU_WSI_MAX_BYTES env var) the constructor
    raises with the remedy instead of dying in the allocator.  The budget
    counts what PIL would hold (JAX data/wsi.py:85-122): every level as
    3 B/px RGB plus the largest page in its native mode (``MODE_BPP``,
    the JAX table's bytes: 4 B/px for RGB, RGBA, LA and CMYK, 1 for 8-bit
    gray, bilevel and palette, 2 for 16-bit grayscale), alive while it
    converts.
    """

    DEFAULT_MAX_BYTES = 1 << 30
    MODE_BPP = {"1": 1, "L": 1, "P": 1, "LA": 4, "I;16": 2, "RGB": 4,
                "RGBA": 4, "CMYK": 4}

    def __init__(self, path: str, max_decode_bytes: Optional[int] = None):
        if max_decode_bytes is None:
            max_decode_bytes = int(os.environ.get(
                "MMF_TPU_WSI_MAX_BYTES", self.DEFAULT_MAX_BYTES))
        kind = slide_format(path)
        if kind == "TIFF":
            pages = tiff.read_pages(path)
            heads = [((p.width, p.height), p.mode) for p in pages]
        else:
            heads = [{"PNG": _png_header, "JPEG": _jpeg_header,
                      "JPEG2000": _j2k_header}[kind](path)]
        sizes = [s for s, _ in heads]
        native_peak = max(self.MODE_BPP[m] * w * h for (w, h), m in heads)
        total = sum(3 * w * h for (w, h) in sizes) + native_peak
        if total > max_decode_bytes:
            raise ValueError(
                f"{path}: decoding {len(sizes)} page(s) "
                f"{sizes} needs ~{total / 2**20:.0f} MiB "
                f"(> {max_decode_bytes / 2**20:.0f} MiB budget). The "
                "port decodes whole pages, as PIL does; use smaller "
                "pages, or raise MMF_TPU_WSI_MAX_BYTES / max_decode_bytes "
                "if the host has the RAM.")
        if kind == "PNG":
            levels = [png.read_png(path, rgb=True)]
        elif kind == "JPEG":
            img = jpeg.read_jpeg(path)
            if img.ndim == 2:
                img = np.repeat(img[..., None], 3, axis=2)
            elif img.shape[2] == 4:
                img = _cmyk_to_rgb(img)
            levels = [img]
        elif kind == "JPEG2000":
            levels = [j2k.read_j2k(path, rgb=True)]
        else:
            levels = [tiff.read_page(path, p) for p in pages]
        order = np.argsort([-l.shape[0] for l in levels], kind="stable")
        super().__init__([levels[i] for i in order],
                         name=os.path.splitext(os.path.basename(path))[0])


class TileCache:
    """Decoded tiles by key, least recently used first out, holding at
    most ``max_bytes`` of them (openslide's tile cache is bounded by bytes
    too).  ``peak_bytes``: the most it has held."""

    def __init__(self, max_bytes: int):
        self.max_bytes = max_bytes
        self.bytes = self.peak_bytes = 0
        self._tiles: "collections.OrderedDict" = collections.OrderedDict()

    def get(self, key):
        tile = self._tiles.get(key)
        if tile is not None:
            self._tiles.move_to_end(key)
        return tile

    def put(self, key, tile: np.ndarray) -> None:
        if tile.nbytes > self.max_bytes:
            return
        self.bytes += tile.nbytes
        self._tiles[key] = tile
        while self.bytes > self.max_bytes:
            self.bytes -= self._tiles.popitem(last=False)[1].nbytes
        self.peak_bytes = max(self.peak_bytes, self.bytes)


class OpenSlideBackend:
    """The JAX package's openslide reader, for Aperio ``.svs`` slides (the
    machine with the card has no openslide): openslide's Aperio rules
    (``utils/aperio.py``) on the port's TIFF reader, the JAX class's
    interface (``name``, ``level_count``, ``level_dimensions``,
    ``level_downsamples`` as (d, d), ``read_region``, ``thumbnail``, and
    ``wsi.properties``, which ``fetch_mag_patching_params`` reads).

    ``read_region`` and ``read_regions`` decode only the tiles their
    regions touch (``tiff.read_tiles``: the C++ JPEG decoder over all host
    threads), each once a call, and keep them in a ``TileCache`` of
    ``CACHE_BYTES`` (openslide's default, 32 MiB).  Nothing
    decodes a whole level but a read of it, and no decode budget applies,
    as none applies in JAX's openslide route.  Pixels outside the level
    read (0, 0, 0), as openslide's transparent ones do after JAX's
    ``convert("RGB")``, and so do the tiles the file lacks (byte count 0).
    A level-0 location maps to ``floor(location / downsample)`` on the
    level: where that is not a whole number openslide reads at the
    fraction, which neither machine can check.  ``tiles_touched`` (each
    call's distinct tiles, summed over calls) and ``tiles_decoded`` count
    the work.  A file that is not an Aperio TIFF raises: bytes of no
    format ``OSError``, any other format or a TIFF without an Aperio
    description ``NotImplementedError`` (openslide reads those through its
    generic TIFF or PIL routes, which the port does not port)."""

    CACHE_BYTES = 32 << 20

    def __init__(self, path: str):
        kind = slide_format(path)
        pages = tiff.read_pages(path) if kind == "TIFF" else None
        if pages is None or not aperio.is_aperio(pages):
            raise NotImplementedError(
                f"{path}: {'a TIFF' if pages else f'a {kind} file'} without "
                f"an Aperio ImageDescription: openslide reads it through its "
                f"{'generic TIFF' if pages else 'PIL'} route, which is not "
                f"supported by the port; it reads Aperio .svs slides, and "
                f"{READS} by other names")
        self.path = path
        self.wsi = aperio.read_aperio(path, pages)
        self.name = os.path.splitext(os.path.basename(path))[0]
        self._pages = [pages[i] for i in self.wsi.levels]
        self.cache = TileCache(self.CACHE_BYTES)
        self.tiles_touched = self.tiles_decoded = 0

    @property
    def level_count(self) -> int:
        return len(self.wsi.levels)

    @property
    def level_dimensions(self) -> List[Tuple[int, int]]:
        return list(self.wsi.dimensions)

    @property
    def level_downsamples(self) -> List[Tuple[float, float]]:
        return [(d, d) for d in self.wsi.downsamples]

    def read_region(self, location_level0, level, size) -> np.ndarray:
        """(x, y) level-0 location, level, (w, h) size -> RGB uint8."""
        return self.read_regions([location_level0], level, size)[0]

    def read_regions(self, locations, level, size) -> np.ndarray:
        """[N, h, w, 3] uint8: ``read_region`` at each level-0 location of
        ``locations``, every tile they touch decoded at most once."""
        level, (w, h) = int(level), (int(size[0]), int(size[1]))
        page = self._pages[level]
        ds = self.wsi.downsamples[level]
        tw, th = page.tile
        across = tiff.tile_grid(page)[0]
        out = np.zeros((len(locations), h, w, 3), np.uint8)

        def span(a, n, t, end):
            """The tiles (of side ``t``) under [a, a + n) within [0, end)."""
            a, b = max(a, 0), min(a + n, end)
            return range(a // t, -(-b // t)) if b > a else range(0)
        spans = []
        for x0, y0 in locations:
            x = math.floor(int(x0) / ds)
            y = math.floor(int(y0) / ds)
            spans.append((x, y, span(x, w, tw, page.width),
                          span(y, h, th, page.height)))
        wanted = sorted({ty * across + tx for _, _, txs, tys in spans
                         for ty in tys for tx in txs})
        tiles = self._tiles(level, page, wanted)
        for i, (x, y, txs, tys) in enumerate(spans):
            for ty in tys:
                for tx in txs:
                    t = tiles[ty * across + tx]
                    # the tile's part inside the region
                    ax, ay = max(tx * tw, x), max(ty * th, y)
                    bx = min(tx * tw + t.shape[1], x + w)
                    by = min(ty * th + t.shape[0], y + h)
                    out[i, ay - y:by - y, ax - x:bx - x] = t[
                        ay - ty * th:by - ty * th, ax - tx * tw:bx - tx * tw]
        return out

    def _tiles(self, level: int, page, wanted) -> dict:
        """{tile index: RGB tile} of ``wanted``, the uncached ones decoded
        in one ``tiff.read_tiles`` call and then cached, the rightmost
        column last (patch batches run down columns, left to right)."""
        got, todo = {}, []
        for t in wanted:
            tile = self.cache.get((level, t))
            if tile is None:
                todo.append(t)
            else:
                got[t] = tile
        if todo:
            tw, th = page.tile
            across = tiff.tile_grid(page)[0]
            outs = [np.empty((min(th, page.height - t // across * th),
                              min(tw, page.width - t % across * tw), 3),
                             np.uint8) for t in todo]
            tiff.read_tiles(self.path, page, todo, outs)
            for t, o in sorted(zip(todo, outs),
                               key=lambda to: (to[0] % across, to[0])):
                got[t] = o
                self.cache.put((level, t), o)
        self.tiles_touched += len(wanted)
        self.tiles_decoded += len(todo)
        return got

    def thumbnail(self, level: int = -1) -> np.ndarray:
        lvl = self.level_count - 1 if level == -1 else level
        return self.read_region((0, 0), lvl, self.level_dimensions[lvl])


def open_slide(path: str):
    """The slide at ``path``: a ``.svs`` through ``OpenSlideBackend`` (an
    Aperio TIFF, else it raises), the other openslide formats refused by
    their extension, naming the file, as JAX routes them to openslide;
    anything else through ``PILSlide``, which reads the file's first
    bytes."""
    ext = os.path.splitext(path)[1].lower()
    if ext == ".svs":
        return OpenSlideBackend(path)
    if ext in OPENSLIDE_EXTS:
        raise NotImplementedError(
            f"{path}: an openslide format ({', '.join(OPENSLIDE_EXTS[1:])}) "
            f"is not supported by the port; it reads Aperio .svs slides, "
            f"and {READS} by other names")
    return PILSlide(path)


# ---------------------------------------------------------------------------
# tissue segmentation (ref segmentTissue, WholeSlideImage.py:112-200)
# ---------------------------------------------------------------------------

def segment_tissue(slide, seg_level: Optional[int] = None, sthresh: int = 20,
                   sthresh_up: int = 255, mthresh: int = 7, close: int = 4,
                   use_otsu: bool = False, a_t: float = 100.0,
                   a_h: float = 16.0, max_n_holes: int = 8,
                   ref_patch_size: int = 512, device=None, timings=None):
    """HSV saturation -> median blur -> (otsu) threshold -> morph close ->
    contour extraction with area filtering.  Returns (tissue_contours,
    hole_contours) in LEVEL-0 coordinates.  The filters run on
    ``device`` (cuda unless the caller names another); ``timings``, a
    dict, collects the host seconds of the filters and the tracing."""
    if seg_level is None:
        seg_level = slide.level_count - 1
    w, h = slide.level_dimensions[seg_level]
    t0 = time.perf_counter()
    img = slide.read_region((0, 0), seg_level, (w, h))
    x = torch.from_numpy(img).to(resolve_device(device))
    med = image_ops.median_blur(image_ops.hsv_saturation(x), mthresh)
    _, img_bin = image_ops.threshold(med, sthresh, sthresh_up, otsu=use_otsu)
    if close > 0:
        img_bin = image_ops.morph_close(img_bin, close)
    img_bin = img_bin.cpu().numpy()
    t1 = time.perf_counter()

    scale = slide.level_downsamples[seg_level]
    scaled_ref_area = int(ref_patch_size ** 2 / (scale[0] * scale[1]))
    a_t_abs = a_t * scaled_ref_area
    a_h_abs = a_h * scaled_ref_area

    contours, hierarchy = cts.find_contours(img_bin)
    t2 = time.perf_counter()
    if timings is not None:
        timings["filters"] = timings.get("filters", 0.0) + t1 - t0
        timings["contours"] = timings.get("contours", 0.0) + t2 - t1
    if hierarchy is None:
        return [], []
    hierarchy = np.squeeze(hierarchy, axis=0)[:, 2:]  # (child, parent)

    area = [cts.contour_area(c) for c in contours]
    fg, holes_per_fg = [], []
    for idx in np.flatnonzero(hierarchy[:, 1] == -1):
        hole_ids = np.flatnonzero(hierarchy[:, 1] == idx)
        a = area[idx] - sum(area[h] for h in hole_ids)
        if a <= a_t_abs or a == 0:
            continue
        fg.append(idx)
        # a stable sort by area, largest first, as Python's sorted(...,
        # reverse=True) orders them
        hs = sorted(hole_ids, key=lambda h: area[h], reverse=True)
        holes_per_fg.append([contours[hh] for hh in hs[:max_n_holes]
                             if area[hh] > a_h_abs])

    sx, sy = scale

    def _scale(cs):
        return [np.array(c * np.array([sx, sy]), dtype=np.int32)
                for c in cs]
    tissue = _scale([contours[i] for i in fg])
    holes = [_scale(hs) for hs in holes_per_fg]
    return tissue, holes


# ---------------------------------------------------------------------------
# contour checking (ref util_classes.py:48-116)
# ---------------------------------------------------------------------------

def _pt_in(cont, pt) -> bool:
    return cts.point_polygon_test(cont, (float(pt[0]), float(pt[1]))) >= 0


def make_contour_checker(contour, patch_size: int, mode: str = "four_pt",
                         center_shift: float = 0.5):
    """Returns pt(x, y)->bool for a patch anchored at its top-left."""
    half = patch_size // 2
    if mode == "basic":
        return lambda pt: _pt_in(contour, pt)
    if mode == "center":
        return lambda pt: _pt_in(contour, (pt[0] + half, pt[1] + half))
    if mode in ("four_pt", "four_pt_hard"):
        offs, require_all = _probe_offsets(patch_size, mode, center_shift)
        comb = all if require_all else any

        def check(pt):
            return comb(_pt_in(contour, (pt[0] + dx, pt[1] + dy))
                        for dx, dy in offs)
        return check
    raise NotImplementedError(mode)


def _in_holes(holes, pt, patch_size) -> bool:
    cx, cy = pt[0] + patch_size / 2, pt[1] + patch_size / 2
    return any(cts.point_polygon_test(h, (float(cx), float(cy))) > 0
               for h in holes)


def _polygon_row_test(contour, y: float, qx: np.ndarray) -> np.ndarray:
    """cv2.pointPolygonTest semantics for all points (qx[i], y) on one
    horizontal row in O(E + X log E): crossing parity against the
    sorted edge-intersection xs, with cv2's on-edge (0) cases
    (horizontal edges, vertex hits, exact edge crossings).

    Exactness: for integer contours the intersection xs are rationals
    with denominator <= the contour's y-extent, so distinct values
    differ by >= 1/extent while float64 rounding is ~1e-10 — the 1e-8
    equality window separates the two regimes for slides up to ~1e7 px.
    """
    v = np.asarray(contour, np.float64).reshape(-1, 2)
    v0 = np.roll(v, 1, axis=0)
    v0x, v0y = v0[:, 0], v0[:, 1]
    v1x, v1y = v[:, 0], v[:, 1]
    qx = np.asarray(qx, np.float64)

    contrib = ((v0y <= y) & (v1y > y)) | ((v0y > y) & (v1y <= y))
    xi = np.sort(v0x[contrib] + (y - v0y[contrib])
                 * (v1x[contrib] - v0x[contrib])
                 / (v1y[contrib] - v0y[contrib]))
    right = np.searchsorted(xi, qx + 1e-8)
    left = np.searchsorted(xi, qx - 1e-8)
    on_edge = right > left
    inside = ((len(xi) - right) % 2) == 1

    # cv2's skip-branch on-edge cases: a vertex exactly at (qx, y), or a
    # horizontal edge at y spanning qx
    skipped_vert = (v1y == y) & ~contrib
    if skipped_vert.any():
        vx = np.sort(v1x[skipped_vert])
        hit = np.searchsorted(vx, qx + 1e-8) > np.searchsorted(vx,
                                                               qx - 1e-8)
        on_edge |= hit
    horiz = (v0y == y) & (v1y == y)
    if horiz.any():
        for a, b in zip(np.minimum(v0x[horiz], v1x[horiz]),
                        np.maximum(v0x[horiz], v1x[horiz])):
            on_edge |= (qx >= a) & (qx <= b)
    return np.where(on_edge, np.int8(0),
                    np.where(inside, np.int8(1), np.int8(-1)))


def _probe_offsets(patch_size: int, mode: str,
                   center_shift: float = 0.5):
    """(offsets [P, 2] relative to the patch top-left, require_all) for
    each contour-check strategy (ref util_classes.py:48-116)."""
    half = patch_size // 2
    if mode == "basic":
        return np.array([[0, 0]]), False
    if mode == "center":
        return np.array([[half, half]]), False
    if mode == "four_pt":
        s1, s2 = int(half * 0.25), int(half * 0.5)
        offs = [(-s1, -s1), (s1, s1), (s1, -s1), (-s1, s1),
                (-s2, -s2), (s2, s2), (s2, -s2), (-s2, s2)]
        return np.array(offs) + half, False
    if mode == "four_pt_hard":
        s = int(half * center_shift)
        offs = ([(-s, -s), (s, s), (s, -s), (-s, s)] if s > 0
                else [(0, 0)])
        return np.array(offs) + half, True
    raise NotImplementedError(mode)


# ---------------------------------------------------------------------------
# patch coordinate generation (ref process_contour(s) :432-549)
# ---------------------------------------------------------------------------

def contour_patch_coords(slide, contour, holes, patch_level: int = 0,
                         patch_size: int = 256, step_size: int = 256,
                         contour_fn: str = "four_pt",
                         use_padding: bool = True,
                         center_shift: float = 0.5) -> np.ndarray:
    """Grid candidates over the contour's bounding box filtered by the
    in-contour check and hole exclusion.  Level-0 coords, [N, 2], in the
    per-point oracle's x-major order.  All probe points of all candidates
    are tested by per-row scanline sweeps (``_polygon_row_test``)."""
    if contour is not None:
        start_x, start_y, w, h = cts.bounding_rect(contour)
    else:
        w, h = slide.level_dimensions[patch_level]
        start_x = start_y = 0
    ds = slide.level_downsamples[patch_level]
    ref_patch = (int(patch_size * ds[0]), int(patch_size * ds[1]))
    img_w, img_h = slide.level_dimensions[0]
    if use_padding:
        stop_x, stop_y = start_x + w, start_y + h
    else:
        stop_x = min(start_x + w, img_w - ref_patch[0] + 1)
        stop_y = min(start_y + h, img_h - ref_patch[1] + 1)
    xs = np.arange(start_x, stop_x, step_size * int(ds[0]))
    ys = np.arange(start_y, stop_y, step_size * int(ds[1]))
    if len(xs) == 0 or len(ys) == 0:
        return np.zeros((0, 2), np.int64)

    # keep[i, j] for candidate (xs[i], ys[j]); each probe row is one
    # scanline test over all candidate xs at once
    keep = np.ones((len(xs), len(ys)), bool)
    if contour is not None:
        offs, require_all = _probe_offsets(ref_patch[0], contour_fn,
                                           center_shift)
        comb = np.all if require_all else np.any
        for j, y0 in enumerate(ys):
            rows = []
            for dy in np.unique(offs[:, 1]):
                dxs = offs[offs[:, 1] == dy, 0]
                rows.extend(_polygon_row_test(contour, float(y0 + dy),
                                              xs + dx) >= 0 for dx in dxs)
            keep[:, j] = comb(np.stack(rows), axis=0)
    half = ref_patch[0] / 2.0
    for hole in holes or []:
        for j, y0 in enumerate(ys):
            if not keep[:, j].any():
                continue
            keep[:, j] &= ~(_polygon_row_test(hole, float(y0 + half),
                                              xs + half) > 0)
    gi, gj = np.nonzero(keep)
    if len(gi) == 0:
        return np.zeros((0, 2), np.int64)
    coords = np.stack([xs[gi], ys[gj]], axis=1).astype(np.int64)
    order = np.lexsort((coords[:, 1], coords[:, 0]))
    return coords[order]


def process_contours(slide, tissue, holes, save_path: Optional[str] = None,
                     patch_level: int = 0, patch_size: int = 256,
                     step_size: int = 256, contour_fn: str = "four_pt",
                     use_padding: bool = True,
                     center_shift: float = 0.5):
    """All-contour coordinate generation; writes the reference's
    {name}_patches.h5 coords schema + attrs when save_path is given
    (ref WholeSlideImage.py:432-549)."""
    all_coords = []
    for cont, hs in zip(tissue, holes):
        coords = contour_patch_coords(slide, cont, hs, patch_level,
                                      patch_size, step_size, contour_fn,
                                      use_padding, center_shift)
        if len(coords):
            all_coords.append(coords)
    coords = (np.concatenate(all_coords, axis=0) if all_coords
              else np.zeros((0, 2), np.int64))
    if save_path is not None:
        return coords, save_coords(slide, coords, save_path, patch_level,
                                   patch_size)
    return coords, None


def save_coords(slide, coords: np.ndarray, save_path: str,
                patch_level: int = 0, patch_size: int = 256) -> str:
    """Write ``{save_path}/{name}_patches.h5``: ``coords`` with the
    reference's attributes."""
    attrs = {"coords": {
        "patch_size": patch_size,
        "patch_level": patch_level,
        "downsample": np.asarray(slide.level_downsamples[patch_level]),
        "downsampled_level_dim":
            np.asarray(slide.level_dimensions[patch_level]),
        "level_dim": np.asarray(slide.level_dimensions[patch_level]),
        "name": slide.name,
    }}
    h5_path = os.path.join(save_path, f"{slide.name}_patches.h5")
    save_hdf5(h5_path, {"coords": coords}, attrs, mode="w")
    return h5_path


def read_patches(slide, coords: np.ndarray, patch_level: int = 0,
                 patch_size: int = 256) -> np.ndarray:
    """Fetch patches [N, ps, ps, 3] uint8 for level-0 anchored coords
    (an ``OpenSlideBackend`` decodes each tile they touch once)."""
    if isinstance(slide, OpenSlideBackend):
        return slide.read_regions(coords, patch_level,
                                  (patch_size, patch_size))
    out = np.empty((len(coords), patch_size, patch_size, 3), np.uint8)
    for i, (x, y) in enumerate(coords):
        out[i] = slide.read_region((int(x), int(y)), patch_level,
                                   (patch_size, patch_size))
    return out


# ---------------------------------------------------------------------------
# patch filters + stitching (ref wsi_utils.py:21-52, 269-336)
# ---------------------------------------------------------------------------

def is_white_patch(patch: np.ndarray, sat_thresh: int = 5) -> bool:
    sat = image_ops.hsv_saturation(torch.from_numpy(
        np.ascontiguousarray(patch)))
    return bool(int(sat.sum(dtype=torch.int64)) / sat.numel() < sat_thresh)


def is_black_patch(patch: np.ndarray, rgb_thresh: int = 40) -> bool:
    return bool(np.all(np.mean(patch, axis=(0, 1)) < rgb_thresh))


def stitch_coords(slide, coords: np.ndarray, patch_level: int = 0,
                  patch_size: int = 256, downscale: int = 16,
                  draw_grid: bool = True) -> np.ndarray:
    """Downscaled mosaic of the selected patches over a white canvas —
    the reference's StitchCoords visual QC (ref wsi_utils.py:269-336).
    Patches are read and resized ``STITCH_BATCH`` at a time, then pasted
    and framed in the coordinates' order."""
    w0, h0 = slide.level_dimensions[0]
    W, H = max(w0 // downscale, 1), max(h0 // downscale, 1)
    canvas = np.full((H, W, 3), 245, np.uint8)
    ds = slide.level_downsamples[patch_level]
    ps_l0 = int(patch_size * ds[0])
    ps_c = max(ps_l0 // downscale, 1)
    for b0 in range(0, len(coords), STITCH_BATCH):
        chunk = coords[b0:b0 + STITCH_BATCH]
        small = image_ops.resize_u8(torch.from_numpy(read_patches(
            slide, chunk, patch_level, patch_size)), (ps_c, ps_c)).numpy()
        for (x, y), s in zip(chunk, small):
            cx, cy = int(x) // downscale, int(y) // downscale
            hh = min(ps_c, H - cy)
            ww = min(ps_c, W - cx)
            if hh <= 0 or ww <= 0:
                continue
            canvas[cy:cy + hh, cx:cx + ww] = s[:hh, :ww]
            if draw_grid:
                image_ops.rectangle(canvas, (cx, cy), (cx + ww, cy + hh),
                                    (0, 0, 0))
    return canvas


def fetch_mag_patching_params(slide, mag_level: int = 40,
                              patch_size: int = 256, step_size: int = 256,
                              mpp: Optional[float] = None, dec_prec: int = 1):
    """Magnification-aware patch parameters (ref
    WholeSlideImage.fetch_mag_patching_params :813-852): infer the
    level-0 magnification from microns-per-pixel, then either find the
    pyramid level whose downsample matches the requested magnification or
    fall back to level 0 with an enlarged patch (custom downsample).

    Returns (level0_mag, patch_level, patch_size, step_size,
    custom_downsample) with custom_downsample None when a native level
    matches.
    """
    if mpp is None:
        props = getattr(getattr(slide, "wsi", None), "properties", {}) or {}
        try:
            mpp = float(props.get("openslide.mpp-x", -1))
        except (TypeError, ValueError):
            mpp = -1.0
    level0_mag = -1
    if 0 <= mpp < 0.3:
        level0_mag = 40
    elif 0 <= mpp < 0.6:
        level0_mag = 20
    if level0_mag <= 0:
        level0_mag = 40  # sensible default when properties are absent
    all_ds = [round(xy[0], dec_prec) if dec_prec >= 0 else xy[0]
              for xy in slide.level_downsamples]
    # requesting a magnification above level 0 is impossible; read level 0
    custom = max(int(level0_mag / mag_level), 1)
    if custom in all_ds:
        return (level0_mag, all_ds.index(custom), patch_size, step_size,
                None)
    return (level0_mag, 0, int(patch_size * custom),
            int(step_size * custom), custom)


def synthetic_slide(width: int = 2048, height: int = 1536, n_blobs: int = 3,
                    seed: int = 0, n_levels: int = 3,
                    rows: int = 256) -> ArraySlide:
    """Synthetic H&E-like slide: white background + pink/purple tissue
    blobs (for tests and demos; stands in for TCGA .svs files).  The same
    draws as the JAX package's; the noise is drawn and added ``rows`` rows
    at a time, which keeps numpy's stream and bounds the int64 draws."""
    rng = np.random.default_rng(seed)
    img = np.full((height, width, 3), 245, np.uint8)
    for _ in range(n_blobs):
        cx = rng.integers(width // 6, 5 * width // 6)
        cy = rng.integers(height // 6, 5 * height // 6)
        ax = rng.integers(width // 10, width // 4)
        ay = rng.integers(height // 10, height // 4)
        color = (int(rng.integers(150, 220)), int(rng.integers(60, 120)),
                 int(rng.integers(140, 200)))
        image_ops.ellipse(img, (int(cx), int(cy)), (int(ax), int(ay)),
                          float(rng.uniform(0, 180)), color)
    for r0 in range(0, height, rows):
        band = img[r0:r0 + rows]
        noise = rng.integers(-12, 12, size=band.shape)
        band[...] = np.clip(band.astype(np.int16) + noise, 0, 255)
    levels = [img]
    for _ in range(n_levels - 1):
        prev = levels[-1]
        levels.append(image_ops.resize_u8(
            torch.from_numpy(prev), (prev.shape[0] // 2,
                                     prev.shape[1] // 2)).numpy())
    return ArraySlide(levels, name=f"synthetic_{seed}")
