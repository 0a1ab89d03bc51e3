"""WSI patch feature-extraction CLI, stage 1 for slides (port of
multimodalfusion_tpu/cli/extract_features_fp.py, the in-repo form of
CLAM's extract_features_fp.py, ref README.md:52-54).

Reads each slide's ``patches/{slide}_patches.h5`` (``coords`` and its
``patch_level`` / ``patch_size`` attributes, through ``data/hdf5.py``),
reads its patches on a prefetch thread while the previous chunk is
embedded, resizes them to ``--target_patch_size`` on the device as
``cv2.resize`` does (``utils/image_ops.resize_u8``, exact on uint8) and
embeds them with the truncated ResNet50 (``extract/features.Embedder``);
writes ``path_pt_files/{slide}.pt`` and ``h5_files/{slide}.h5``
(``features``, ``coords``): the bags stage 2 reads.

The JAX CLI's flags, plus ``--device`` (``cuda`` unless ``--device cpu``
is given).  ``--no_s2d_stem`` is accepted and changes nothing (the port's
stem is the plain one, whose outputs the JAX space-to-depth stem equals).
``--data_parallel`` under torchrun gives rank r of K every K-th slide:
each slide's features depend only on that slide, so the files are those
of one process.  Aperio ``.svs`` slides (the default ``--slide_ext``)
are read tile by tile, each chunk's touched tiles decoded once
(``data/wsi.read_patches``); the other openslide formats are refused,
naming the file.

    python -m multimodalfusion_tpu_torch.cli.extract_features_fp \\
        --data_h5_dir PATCHED --data_slide_dir SLIDES --feat_dir OUT \\
        --slide_ext .tiff --weights resnet50.pt [--device cpu]
"""
from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

from multimodalfusion_tpu_torch.data import hdf5
from multimodalfusion_tpu_torch.data import wsi as wsi_mod
from multimodalfusion_tpu_torch.data.io import ensure_dir, save_hdf5, save_pt
from multimodalfusion_tpu_torch.data.loaders import prefetch
from multimodalfusion_tpu_torch.extract.features import Embedder
from multimodalfusion_tpu_torch.models.resnet import FEATURE_DIM
from multimodalfusion_tpu_torch.parallel import mesh as par
from multimodalfusion_tpu_torch.utils import table


def build_parser():
    p = argparse.ArgumentParser(description="WSI patch feature extraction")
    p.add_argument("--data_h5_dir", type=str, required=True,
                   help="dir containing patches/{slide}_patches.h5")
    p.add_argument("--data_slide_dir", type=str, required=True)
    p.add_argument("--csv_path", type=str, default=None,
                   help="optional process list (slide_id column)")
    p.add_argument("--feat_dir", type=str, required=True)
    p.add_argument("--batch_size", type=int, default=128)
    p.add_argument("--data_parallel", action="store_true", default=False,
                   help="under torchrun, rank r of K extracts every K-th "
                        "slide")
    p.add_argument("--slide_ext", type=str, default=".svs")
    p.add_argument("--target_patch_size", type=int, default=224)
    p.add_argument("--weights", type=str, default=None,
                   help="torch-format ResNet50 state_dict")
    p.add_argument("--allow_random_weights", action="store_true",
                   default=False,
                   help="proceed with a randomly initialized ResNet50 "
                        "(test/debug only — embeddings are meaningless)")
    p.add_argument("--no_s2d_stem", action="store_true",
                   default=False,
                   help="accepted for the JAX CLI's sake and changes "
                        "nothing: this package runs only the canonical "
                        "7x7/s2 stem, whose outputs the JAX "
                        "space-to-depth stem equals")
    p.add_argument("--dtype", type=str, default="bfloat16",
                   choices=["bfloat16", "float32"],
                   help="conv compute dtype: bfloat16 (autocast, the "
                        "default) or float32 (TF32 off) for reference "
                        "parity")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device to run on (cuda, cuda:1, cpu)")
    return p


def read_coords(coords_h5: str):
    """(coords [N, 2], patch_level, patch_size) of a patch-coordinates h5,
    as the JAX CLI reads them with h5py: an attribute that cannot be
    opened gives its default (0, 256)."""
    with hdf5.File(coords_h5) as f:
        return (f["coords"], int(f.attr_get("coords", "patch_level", 0)),
                int(f.attr_get("coords", "patch_size", 256)))


def extract_slide(slide, coords_h5: str, embedder: Embedder,
                  target_patch_size: int, wall=None):
    """(features [N, 1024] float32, coords [N, 2]) of one slide: chunks of
    ``embedder.batch_size`` patches read on a prefetch thread, resized on
    the device and embedded.  ``wall`` collects the host seconds of the
    reads and of the embedding."""
    coords, patch_level, patch_size = read_coords(coords_h5)
    feats = np.zeros((len(coords), FEATURE_DIM), np.float32)
    B = embedder.batch_size
    wall = {} if wall is None else wall

    def chunks():
        for start in range(0, len(coords), B):
            t0 = time.perf_counter()
            chunk = coords[start:start + B]
            patches = wsi_mod.read_patches(slide, chunk, patch_level,
                                           patch_size)
            yield start, len(chunk), patches, time.perf_counter() - t0

    for start, n, patches, read_s in prefetch(chunks(), depth=2):
        t0 = time.perf_counter()
        feats[start:start + n] = embedder.embed_images(
            patches, resize=patch_size != target_patch_size)
        wall["embed"] = wall.get("embed", 0.0) + time.perf_counter() - t0
        wall["read"] = wall.get("read", 0.0) + read_s
    return feats, coords


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    with par.distributed(args.device, args.data_parallel) as device:
        args.device = device
        with par.quiet_unless_rank0():
            return _run(args)


def _run(args) -> int:
    shard = (0, 1)
    if args.data_parallel:
        if par.world_size() < 2:
            print("--data_parallel: only one device visible, running "
                  "unsharded")
        else:
            shard = (par.rank(), par.world_size())
            print(f"--data_parallel: slides split over {shard[1]} ranks")
    pt_dir = ensure_dir(os.path.join(args.feat_dir, "path_pt_files"))
    h5_dir = ensure_dir(os.path.join(args.feat_dir, "h5_files"))
    embedder = Embedder(weights_path=args.weights,
                        batch_size=args.batch_size,
                        image_size=args.target_patch_size,
                        allow_random=args.allow_random_weights,
                        dtype=args.dtype, device=args.device)

    patches_dir = os.path.join(args.data_h5_dir, "patches")
    if args.csv_path:
        slide_ids = [str(s) for s in
                     table.read_csv(args.csv_path)["slide_id"]]
    else:
        slide_ids = [n.replace("_patches.h5", args.slide_ext)
                     for n in sorted(os.listdir(patches_dir))
                     if n.endswith("_patches.h5")]

    wall = {"open": 0.0, "write": 0.0}
    n_patches = n_slides = 0
    t_start = time.perf_counter()
    for i, slide_file in enumerate(slide_ids):
        if i % shard[1] != shard[0]:
            continue
        stem = os.path.splitext(os.path.basename(slide_file))[0]
        coords_h5 = os.path.join(patches_dir, f"{stem}_patches.h5")
        pt_out = os.path.join(pt_dir, f"{stem}.pt")
        if os.path.exists(pt_out):
            print(f"skip {stem} (exists)")
            continue
        if not os.path.exists(coords_h5):
            print(f"no coords for {stem}")
            continue
        t0 = time.perf_counter()
        slide = wsi_mod.open_slide(
            os.path.join(args.data_slide_dir, slide_file))
        t1 = time.perf_counter()
        feats, coords = extract_slide(slide, coords_h5, embedder,
                                      args.target_patch_size, wall)
        t2 = time.perf_counter()
        save_pt(pt_out, feats)
        save_hdf5(os.path.join(h5_dir, f"{stem}.h5"),
                  {"features": feats, "coords": coords}, mode="w")
        t3 = time.perf_counter()
        wall["open"] += t1 - t0
        wall["write"] += t3 - t2
        n_patches += len(coords)
        n_slides += 1
        dt = t3 - t0
        print(f"{stem}: {len(coords)} patches in {dt:.1f}s "
              f"({len(coords) / max(dt, 1e-9):.0f} patches/s)")
    total = time.perf_counter() - t_start
    print(f"stage 1 wall s: {n_slides} slides, {n_patches} patches; "
          + ", ".join(f"{k} {v:.3f}" for k, v in wall.items())
          + f" (read: the prefetch thread), total {total:.3f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
