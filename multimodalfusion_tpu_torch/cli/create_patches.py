"""WSI segmentation and patch-coordinate CLI, stage 0 (port of
multimodalfusion_tpu/cli/create_patches.py, the in-repo form of CLAM's
create_patches_fp.py that the reference defers to, ref README.md:42-50).

Per slide of ``--source`` (or of ``--process_list``): tissue segmentation,
the patch grid, and ``patches/{slide}_patches.h5`` (``coords`` with the
reference's attributes), ``masks/{slide}_mask.jpg`` (the segmentation
level with tissue contours in green and holes in red) and, with
``--stitch``, ``stitches/{slide}_stitch.jpg``; then
``process_list_autogen.csv`` with the parameters each slide used, in the
JAX CLI's columns and rows (ref batch_process_utils.py:17-92).

The JAX CLI's flags, plus ``--device``: where the per-pixel filters of the
segmentation run (``cuda`` unless ``--device cpu`` is given); the
contours, the grid and the files are host work.  ``--preset`` and
``--process_list`` are read with ``utils/table.read_csv`` and typed as
pandas types them (empty cells NaN).  The images are written by the
port's JPEG encoder (``utils/jpeg.py``, OpenCV's defaults) and the slides
read by ``data/wsi.open_slide`` (Aperio ``.svs`` tile by tile, as
JAX's openslide route reads it, the segmentation on the smallest level
by default; multi-page TIFF, stripped or tiled, uncompressed or LZW,
Deflate, PackBits, LZMA, ZSTD or JPEG; PNG; JPEG; JPEG 2000; the other
openslide formats are refused and recorded as failed).

    python -m multimodalfusion_tpu_torch.cli.create_patches \\
        --source SLIDES --save_dir OUT --patch_size 256 --step_size 256 \\
        [--stitch] [--preset P.csv] [--process_list L.csv] [--device cpu]
"""
from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

from multimodalfusion_tpu_torch import resolve_device
from multimodalfusion_tpu_torch.data import wsi as wsi_mod
from multimodalfusion_tpu_torch.data.io import ensure_dir
from multimodalfusion_tpu_torch.utils import image_ops, table
from multimodalfusion_tpu_torch.utils.jpeg import write_jpeg

DEFAULT_SEG_PARAMS = {"seg_level": -1, "sthresh": 8, "mthresh": 7,
                      "close": 4, "use_otsu": False}
DEFAULT_FILTER_PARAMS = {"a_t": 100.0, "a_h": 16.0, "max_n_holes": 8}
DEFAULT_PATCH_PARAMS = {"use_padding": True, "contour_fn": "four_pt"}


def build_parser():
    p = argparse.ArgumentParser(description="WSI patching")
    p.add_argument("--source", type=str, required=True,
                   help="directory of slides")
    p.add_argument("--save_dir", type=str, required=True)
    p.add_argument("--patch_size", type=int, default=256)
    p.add_argument("--step_size", type=int, default=256)
    p.add_argument("--patch_level", type=int, default=0)
    p.add_argument("--seg", action="store_true", default=True)
    p.add_argument("--patch", action="store_true", default=True)
    p.add_argument("--stitch", action="store_true", default=False)
    p.add_argument("--no_auto_skip", action="store_true", default=False)
    p.add_argument("--preset", type=str, default=None,
                   help="CSV with one row of segmentation/filter defaults "
                        "applied to every slide (ref presets/tcga.csv); "
                        "per-slide process_list values still win")
    p.add_argument("--process_list", type=str, default=None,
                   help="CSV of slides + per-slide params")
    p.add_argument("--seg_level", type=int, default=-1)
    p.add_argument("--sthresh", type=int, default=8)
    p.add_argument("--mthresh", type=int, default=7)
    p.add_argument("--close", type=int, default=4)
    p.add_argument("--use_otsu", action="store_true", default=False)
    p.add_argument("--a_t", type=float, default=100.0)
    p.add_argument("--a_h", type=float, default=16.0)
    p.add_argument("--max_n_holes", type=int, default=8)
    p.add_argument("--contour_fn", type=str, default="four_pt")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device of the segmentation's pixel filters "
                        "(cuda, cuda:1, cpu)")
    return p


def _isna(v) -> bool:
    return v is None or (isinstance(v, (float, np.floating)) and v != v)


def _first_row(cols: dict) -> dict:
    """``pd.read_csv(path).iloc[0].to_dict()``: a frame whose columns are
    all numbers gives one row upcast to their common type (ints stay ints
    only when every column is int); any other frame keeps each cell's
    own type."""
    row = {k: v[0] for k, v in cols.items() if len(v)}
    kinds = {np.asarray(v).dtype.kind for v in cols.values()}
    if kinds <= {"i", "f"} and "f" in kinds:
        return {k: np.float64(v) for k, v in row.items()}
    return row


def _records(cols: dict) -> list:
    """``DataFrame.to_dict("records")``."""
    n = len(next(iter(cols.values()))) if cols else 0
    return [{k: v[i] for k, v in cols.items()} for i in range(n)]


def draw_mask(slide, tissue, holes, seg_level: int) -> np.ndarray:
    ds = slide.level_downsamples[seg_level]
    w, h = slide.level_dimensions[seg_level]
    img = slide.read_region((0, 0), seg_level, (w, h)).copy()
    scale = np.array([1.0 / ds[0], 1.0 / ds[1]])
    image_ops.draw_contours(img, [np.array(c * scale, np.int32)
                                  for c in tissue], (0, 255, 0))
    for hs in holes:
        image_ops.draw_contours(img, [np.array(c * scale, np.int32)
                                      for c in hs], (255, 0, 0))
    return img


def process_one(slide, args, patch_dir, mask_dir, stitch_dir,
                params=None, timings=None):
    """Segment, patch, draw and write one slide; (patches, the parameters
    used).  ``timings`` collects host seconds by step."""
    params = params or {}
    timings = {} if timings is None else timings
    seg_kwargs = {**DEFAULT_SEG_PARAMS, **DEFAULT_FILTER_PARAMS}
    # CLI-level overrides, then per-slide process-list overrides
    for k in seg_kwargs:
        if hasattr(args, k):
            seg_kwargs[k] = getattr(args, k)
    seg_kwargs.update({k: params[k] for k in params
                       if k in seg_kwargs and not _isna(params[k])})
    used_params = dict(seg_kwargs)
    used_params["contour_fn"] = params.get(
        "contour_fn", getattr(args, "contour_fn",
                              DEFAULT_PATCH_PARAMS["contour_fn"]))
    seg_kwargs = dict(seg_kwargs)
    seg_level = seg_kwargs.pop("seg_level")
    if seg_level in (-1, None):
        seg_level = slide.level_count - 1
    seg_level = int(seg_level)
    for k in ("mthresh", "close", "max_n_holes"):
        seg_kwargs[k] = int(seg_kwargs[k])
    seg_kwargs["use_otsu"] = bool(seg_kwargs["use_otsu"])
    tissue, holes = wsi_mod.segment_tissue(slide, seg_level=seg_level,
                                           device=args.device,
                                           timings=timings, **seg_kwargs)
    t0 = time.perf_counter()
    mask = draw_mask(slide, tissue, holes, seg_level)
    t1 = time.perf_counter()
    write_jpeg(os.path.join(mask_dir, f"{slide.name}_mask.jpg"), mask)
    t2 = time.perf_counter()
    coords = wsi_mod.process_contours(
        slide, tissue, holes, patch_level=args.patch_level,
        patch_size=args.patch_size, step_size=args.step_size,
        contour_fn=used_params["contour_fn"])[0]
    t3 = time.perf_counter()
    wsi_mod.save_coords(slide, coords, patch_dir, args.patch_level,
                        args.patch_size)
    t4 = time.perf_counter()
    timings["draw"] = timings.get("draw", 0.0) + t1 - t0
    timings["encode"] = timings.get("encode", 0.0) + t2 - t1
    timings["grid"] = timings.get("grid", 0.0) + t3 - t2
    timings["h5"] = timings.get("h5", 0.0) + t4 - t3
    if args.stitch and len(coords):
        t0 = time.perf_counter()
        canvas = wsi_mod.stitch_coords(slide, coords, args.patch_level,
                                       args.patch_size)
        t1 = time.perf_counter()
        write_jpeg(os.path.join(stitch_dir, f"{slide.name}_stitch.jpg"),
                   canvas)
        timings["stitch"] = timings.get("stitch", 0.0) + t1 - t0
        timings["encode"] += time.perf_counter() - t1
    return len(coords), used_params


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    args.device = str(resolve_device(args.device))
    patch_dir = ensure_dir(os.path.join(args.save_dir, "patches"))
    mask_dir = ensure_dir(os.path.join(args.save_dir, "masks"))
    stitch_dir = ensure_dir(os.path.join(args.save_dir, "stitches"))

    preset = {}
    if args.preset:
        preset = _first_row(table.read_csv(args.preset))
    if args.process_list:
        cols = table.read_csv(args.process_list)
        slide_names = [str(s) for s in cols["slide_id"]]
        param_rows = [{**preset, **r} for r in _records(cols)]
    else:
        slide_names = sorted(os.listdir(args.source))
        param_rows = [dict(preset) for _ in slide_names]

    rows, timings = [], {}
    t_start = time.perf_counter()
    for name, params in zip(slide_names, param_rows):
        path = os.path.join(args.source, name)
        if not os.path.isfile(path):
            continue
        stem = os.path.splitext(name)[0]
        h5_out = os.path.join(patch_dir, f"{stem}_patches.h5")
        if os.path.exists(h5_out) and not args.no_auto_skip:
            print(f"skip {name} (exists)")
            continue
        t0 = time.perf_counter()
        try:
            slide = wsi_mod.open_slide(path)
            timings["read"] = timings.get("read", 0.0) + \
                time.perf_counter() - t0
            n, used = process_one(slide, args, patch_dir, mask_dir,
                                  stitch_dir, params, timings)
            status = "processed"
            print(f"{name}: {n} patches in {time.perf_counter() - t0:.1f}s")
        except Exception as e:  # a bad slide is recorded, the rest go on
            n, status, used = 0, f"failed: {e}", {}
            print(f"FAILED {name}: {e}")
        # record the parameters that were ACTUALLY used for this slide so
        # a rerun from the autogen list reproduces the same segmentation
        rows.append({"slide_id": name, "status": status, "n_patches": n,
                     **{**DEFAULT_SEG_PARAMS, **DEFAULT_FILTER_PARAMS,
                        **DEFAULT_PATCH_PARAMS, **used}})
    table.write_csv(os.path.join(args.save_dir, "process_list_autogen.csv"),
                    table.from_records(rows))
    print(f"stage 0 wall s: {len(rows)} slides; " + ", ".join(
        f"{k} {v:.3f}" for k, v in timings.items())
        + f", total {time.perf_counter() - t_start:.3f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
