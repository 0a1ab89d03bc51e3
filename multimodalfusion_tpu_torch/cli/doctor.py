"""Environment doctor: one command that tells a new deployment what works
and what is missing (port of multimodalfusion_tpu/cli/doctor.py).  Each
check prints one line:

    [ok]   platform: torch 2.x CUDA 12.x device NVIDIA H100 80GB HBM3
    [ok]   native: csrc/bagio.cpp built with g++ (threaded bag collation)
    [ok]   kernels: nvcc built mil_pool_fwd, mil_pool_bwd for sm_90a
    [ok]   optional: tensorboardX not needed -> utils/tb_writer.py
    ...

Exit code 0 when nothing failed (warnings are fine), 1 otherwise.  It
runs on ``cuda`` unless ``--device cpu`` is given; without a card and
without that request the platform check fails.  ``--full`` also holds
both CUDA kernels against their plain versions on the card (the forward
at JAX's shape, B=2, N=200, D=64, Da=32).  On the CPU it runs every
check it can and says that the kernels were not checked.

Run:  python -m multimodalfusion_tpu_torch.cli.doctor [--full] [--device cpu]
"""
from __future__ import annotations

import argparse
import os
import sys
import tempfile

import numpy as np
import torch

from multimodalfusion_tpu_torch.data.wsi import SLIDE_EXTS


class Doctor:
    """The checks' lines and whether one failed."""

    def __init__(self):
        self.failed = False

    def line(self, status: str, msg: str) -> None:
        if status == "fail":
            self.failed = True
        print(f"[{status}]".ljust(7) + msg, flush=True)

    def platform(self, device: str) -> bool:
        """Whether the device is usable."""
        cuda = torch.version.cuda or "none"
        if device.startswith("cuda"):
            if not torch.cuda.is_available():
                self.line("fail", f"platform: torch {torch.__version__} "
                          f"(CUDA {cuda}) sees no CUDA device; pass --device "
                          f"cpu to check the CPU path")
                return False
            self.line("ok", f"platform: torch {torch.__version__} CUDA "
                      f"{cuda} device {torch.cuda.get_device_name(device)}")
            return True
        self.line("ok", f"platform: torch {torch.__version__} (CUDA {cuda}) "
                  f"device {device}")
        self.line("warn", "platform: on the CPU the pooling runs its plain "
                  "version; the CUDA kernels run only on a card")
        return True

    def native(self) -> None:
        from multimodalfusion_tpu_torch import native
        try:
            native.lib()
        except RuntimeError as e:
            self.line("fail", f"native: csrc/bagio.cpp could not be built "
                      f"({e})")
            return
        self.line("ok", "native: csrc/bagio.cpp built with g++ (threaded "
                  "bag collation)")
        try:
            native.codec_lib()
        except RuntimeError as e:
            self.line("fail", f"native: csrc/imgcodec.cpp could not be "
                      f"built ({e})")
            return
        self.line("ok", "native: csrc/imgcodec.cpp built with g++ (TIFF "
                  "LZW, PackBits and ZSTD (the port's own Zstandard "
                  "decoder), PNG filters, JPEG in Huffman and "
                  "arithmetic coding, sequential, progressive and "
                  "lossless, lossless-JPEG DICOM frames)")

    def kernels(self, device: str) -> bool:
        """Whether both kernels were built."""
        if not device.startswith("cuda"):
            self.line("warn", "kernels: not checked (--device cpu): nvcc "
                      "builds them for sm_90a on a card")
            return False
        from multimodalfusion_tpu_torch.ops import cuda_build
        try:
            for name in ("mil_pool_fwd", "mil_pool_bwd"):
                cuda_build.load(name)
        except (RuntimeError, OSError) as e:
            self.line("fail", f"kernels: {e}")
            return False
        self.line("ok", "kernels: nvcc built mil_pool_fwd and mil_pool_bwd "
                  "for sm_90a")
        return True

    # what the JAX package imports and the port replaces with its own code
    STAND_INS = (
        ("tensorboardX", "--tb event files: utils/tb_writer.py"),
        ("orbax", "--ckpt_format orbax: the .pt resume bundle "
                  "(engine/train.save_resume)"),
        ("scikit-learn", "--split: data/stratified.py"),
        ("pandas", "CSV files: the csv module, utils/table.py"),
        ("h5py", "feature h5 files: data/hdf5.py (h5py's default format "
                 "and libver v108 to latest, track_order, dense groups "
                 "and attributes; deflate, shuffle, fletcher32 and lzf "
                 "filters, lzf in csrc/imgcodec.cpp)"),
        ("flax / msgpack", "checkpoints: .pt files, utils/msgpack_io.py"),
        ("PyYAML", "heatmap configs: utils/yaml_subset.py"),
        ("pydicom", "DICOM: data/dicom.py (JPEG Lossless and the JPEG "
                    "frames of …1.2.4.50 -- baseline, progressive, "
                    "arithmetic or lossless -- in csrc/imgcodec.cpp, JPEG "
                    "2000 in csrc/j2k.cpp)"),
        ("OpenCV / matplotlib / PIL", "images: utils/image_ops.py, "
                                      "utils/contours.py, utils/png.py "
                                      "(every PNG PIL reads), utils/jpeg.py "
                                      "(Huffman or arithmetic JPEG: "
                                      "sequential, progressive, lossless), "
                                      "utils/j2k.py (JPEG 2000), "
                                      "utils/tiff.py (TIFF and BigTIFF; "
                                      "tiled or stripped, "
                                      "chunky or planar; LZW, Deflate, "
                                      "PackBits, LZMA, ZSTD, JPEG; bilevel, "
                                      "gray, "
                                      "LA, RGB(A), 16-bit RGB, palette, "
                                      "CMYK)"),
        ("PIL's bicubic Image.resize", "heatmap resizes: "
                                       "image_ops.resize_bicubic_pil"),
        ("matplotlib's colormaps", "heatmap colours: image_ops.colormap "
                                   "(jet, coolwarm, RdYlBu, their _r)"),
        ("OpenCV's uint8 GaussianBlur and filled drawContours",
         "heatmap blur and tissue mask: image_ops.gaussian_blur_u8, "
         "image_ops.fill_contours"),
        ("openslide", "slides: data/wsi.py reads Aperio .svs tile by tile "
                      "(utils/aperio.py: openslide's Aperio rules; JPEG "
                      "tiles, a bounded tile cache), TIFF and BigTIFF (LZW, "
                      "Deflate, PackBits, LZMA, ZSTD, JPEG; tiled or "
                      "stripped, chunky or planar), PNG, JPEG (Huffman or "
                      "arithmetic; sequential, progressive or lossless) and "
                      "JPEG 2000, known by their first bytes (usually "
                      + " ".join(SLIDE_EXTS) + "); the other openslide "
                      "formats are refused"),
        ("lungmask", "lung masks: the classical estimator in "
                     "data/ct_preprocess.py"),
    )

    def optional(self) -> None:
        for lib, what in self.STAND_INS:
            self.line("ok", f"optional: {lib} not needed -> {what}")

    def io(self) -> None:
        from multimodalfusion_tpu_torch.data.dicom import (read_file,
                                                           write_ct_slice)
        from multimodalfusion_tpu_torch.data.nifti import (read_nifti,
                                                           write_nifti)
        with tempfile.TemporaryDirectory() as d:
            vol = np.arange(24, dtype=np.float32).reshape(2, 3, 4)
            p = os.path.join(d, "t.nii.gz")
            write_nifti(p, vol)
            if np.array_equal(read_nifti(p).data, vol):
                self.line("ok", "io: NIfTI write/read round-trip")
            else:
                self.line("fail", "io: NIfTI round-trip mismatch")
            px = np.arange(64, dtype=np.int16).reshape(8, 8)
            p = os.path.join(d, "t.dcm")
            write_ct_slice(p, px, z=1.0)
            if np.array_equal(read_file(p).pixel_array, px):
                self.line("ok", "io: DICOM write/read round-trip (native "
                          "reader)")
            else:
                self.line("fail", "io: DICOM round-trip mismatch")

    def numerics(self, device: str, full: bool) -> None:
        """The plain pooling against the reference on ``device`` and, with
        ``full`` on a card, both kernels against their plain versions."""
        from multimodalfusion_tpu_torch.ops import mil_attention as mil
        g = torch.Generator().manual_seed(0)
        B, N, D, Da = 2, 200, 64, 32
        h = torch.randn(B, N, D, generator=g)
        mask = (torch.arange(N)[None, :]
                < torch.tensor([[150], [200]])).float()
        params = mil.AttnParams(*(torch.randn(*s, generator=g) * 0.1
                                  for s in ((D, Da), (Da,), (D, Da), (Da,),
                                            (Da, 1), (1,))))
        h, mask = h.to(device), mask.to(device)
        params = mil.AttnParams(*(p.to(device) for p in params))
        ref = mil._pool_reference(h, mask, params, True)
        plain, ml = mil._pool_plain(h, mask, params, True)
        err = float((plain - ref).abs().max())
        self.line("ok" if err < 1e-5 else "fail",
                  f"numerics: fused pooling's plain version matches the "
                  f"reference on {device} (max |d| {err:.1e})")
        if device.startswith("cuda") and full:
            self._kernels_vs_plain(mil, h, mask, params, plain, ml)
        elif device.startswith("cuda"):
            self.line("warn", "numerics: kernels not run (add --full)")
        else:
            self.line("warn", "numerics: the CUDA kernels were not checked "
                      "(--device cpu)")
        if torch.isfinite(ref).all():
            self.line("ok", "numerics: forward pass finite")
        else:
            self.line("fail", "numerics: non-finite forward output")

    def _kernels_vs_plain(self, mil, h, mask, params, plain, ml) -> None:
        """Both kernels against their plain versions at rel 1e-4 (f32, the
        sums in another order)."""
        def rel(got, want):
            return float((got - want).abs().max()
                         / want.abs().max().clamp_min(1e-30))
        try:
            out, ml_k = mil._fused_pool_cuda(h, mask, params, True)
            g = torch.ones_like(out)
            dh, grads = mil._fused_pool_bwd_cuda(h, mask, params, out, ml_k,
                                                 g, True)
            torch.cuda.synchronize()
        except (RuntimeError, ValueError) as e:
            self.line("fail", f"numerics: a CUDA kernel failed ({e})")
            return
        dh_p, grads_p = mil._pool_bwd_plain(h, mask, params, plain, ml, g,
                                            True)
        fwd = max(rel(out, plain), rel(ml_k, ml))
        bwd = max([rel(dh, dh_p)] + [rel(a, b) for a, b in
                                      zip(grads[:5], grads_p[:5])])
        for name, err in (("mil_pool_fwd", fwd), ("mil_pool_bwd", bwd)):
            self.line("ok" if err < 1e-4 else "fail",
                      f"numerics: {name} matches its plain version on the "
                      f"card (max rel err {err:.1e}, tol 1e-4)")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="environment doctor")
    p.add_argument("--full", action="store_true", default=False,
                   help="also hold both CUDA kernels against their plain "
                        "versions on the card")
    p.add_argument("--device", type=str, default="cuda",
                   help="device to check (cuda, cuda:1, cpu)")
    args = p.parse_args(argv)
    doc = Doctor()
    if doc.platform(args.device):
        doc.native()
        built = doc.kernels(args.device)
        doc.optional()
        doc.io()
        doc.numerics(args.device, args.full and built)
    print("doctor:", "FAIL" if doc.failed else "ok")
    return 1 if doc.failed else 0


if __name__ == "__main__":
    sys.exit(main())
