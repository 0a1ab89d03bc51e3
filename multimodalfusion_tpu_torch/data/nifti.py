"""Minimal NIfTI-1 reader and writer (.nii / .nii.gz): the port's own
copy of multimodalfusion_tpu/data/nifti.py, same behaviour.

The glioma path needs only the volume, its origin (for the
flip-to-standard-origin step, ref datasets/dataset_raw.py:31-38) and a
[z, y, x] array; this implements the NIfTI-1 header for the common scalar
dtypes with gzip, struct and numpy.
"""
from __future__ import annotations

import gzip
import struct
from dataclasses import dataclass
from typing import Tuple

import numpy as np

_DTYPES = {2: np.uint8, 4: np.int16, 8: np.int32, 16: np.float32,
           64: np.float64, 256: np.int8, 512: np.uint16, 768: np.uint32}
_CODES = {np.dtype(v): k for k, v in _DTYPES.items()}


@dataclass
class NiftiImage:
    data: np.ndarray          # [z, y, x]
    pixdim: Tuple[float, float, float]   # (x, y, z) voxel size
    origin_lps: Tuple[float, float, float]  # ITK-convention origin
    affine: np.ndarray        # 4x4 RAS affine (srow or pixdim-scaled eye)

    @property
    def spacing_zyx(self):
        return (self.pixdim[2], self.pixdim[1], self.pixdim[0])


def _open(path: str, mode="rb"):
    if str(path).endswith(".gz"):
        return gzip.open(path, mode)
    return open(path, mode)


def read_nifti(path: str) -> NiftiImage:
    with _open(path) as f:
        raw = f.read()
    hdr = raw[:348]
    (sizeof_hdr,) = struct.unpack_from("<i", hdr, 0)
    endian = "<"
    if sizeof_hdr != 348:
        (sizeof_hdr,) = struct.unpack_from(">i", hdr, 0)
        if sizeof_hdr != 348:
            raise ValueError(f"{path}: not a NIfTI-1 file")
        endian = ">"
    dim = struct.unpack_from(endian + "8h", hdr, 40)
    ndim = dim[0]
    shape_xyz = dim[1:1 + max(ndim, 3)]
    (datatype,) = struct.unpack_from(endian + "h", hdr, 70)
    pixdim = struct.unpack_from(endian + "8f", hdr, 76)
    (vox_offset,) = struct.unpack_from(endian + "f", hdr, 108)
    scl_slope, scl_inter = struct.unpack_from(endian + "2f", hdr, 112)
    srow = np.array([struct.unpack_from(endian + "4f", hdr, off)
                     for off in (280, 296, 312)] + [[0, 0, 0, 1]],
                    dtype=np.float64)
    (sform_code,) = struct.unpack_from(endian + "h", hdr, 254)
    if sform_code <= 0:
        srow = np.diag([pixdim[1], pixdim[2], pixdim[3], 1.0])

    if datatype not in _DTYPES:
        raise ValueError(f"{path}: unsupported NIfTI datatype {datatype}")
    dt = np.dtype(_DTYPES[datatype]).newbyteorder(endian)
    nx, ny, nz = shape_xyz[0], shape_xyz[1], (shape_xyz[2]
                                              if len(shape_xyz) > 2 else 1)
    count = nx * ny * nz
    data = np.frombuffer(raw, dtype=dt, count=count,
                         offset=int(vox_offset)).copy()
    # NIfTI stores Fortran order (x fastest) -> [z, y, x] array
    data = data.reshape((nz, ny, nx))
    if scl_slope not in (0.0, 1.0) or scl_inter != 0.0:
        slope = scl_slope if scl_slope != 0 else 1.0
        data = data.astype(np.float32) * slope + scl_inter
    # ITK/LPS origin from the RAS affine translation (sign-flip x, y)
    t = srow[:3, 3]
    origin_lps = (-float(t[0]), -float(t[1]), float(t[2]))
    return NiftiImage(data=np.asarray(data),
                      pixdim=(float(pixdim[1]), float(pixdim[2]),
                              float(pixdim[3])),
                      origin_lps=origin_lps, affine=srow)


def write_nifti(path: str, data_zyx: np.ndarray,
                pixdim=(1.0, 1.0, 1.0), origin_lps=(0.0, 0.0, 0.0)) -> str:
    """Write a [z, y, x] volume as NIfTI-1 (sform identity scaled by
    pixdim, translation from the LPS origin)."""
    data_zyx = np.asarray(data_zyx)
    if data_zyx.dtype not in _CODES:
        data_zyx = data_zyx.astype(np.float32)
    code = _CODES[np.dtype(data_zyx.dtype)]
    nz, ny, nx = data_zyx.shape
    hdr = bytearray(348)
    struct.pack_into("<i", hdr, 0, 348)
    struct.pack_into("<8h", hdr, 40, 3, nx, ny, nz, 1, 1, 1, 1)
    struct.pack_into("<h", hdr, 70, code)
    struct.pack_into("<h", hdr, 72, data_zyx.dtype.itemsize * 8)
    struct.pack_into("<8f", hdr, 76, 1.0, pixdim[0], pixdim[1], pixdim[2],
                     0, 0, 0, 0)
    struct.pack_into("<f", hdr, 108, 352.0)
    struct.pack_into("<2f", hdr, 112, 1.0, 0.0)
    struct.pack_into("<h", hdr, 252, 1)  # qform_code (unused by reader)
    struct.pack_into("<h", hdr, 254, 1)  # sform_code
    struct.pack_into("<4f", hdr, 280, pixdim[0], 0, 0, -origin_lps[0])
    struct.pack_into("<4f", hdr, 296, 0, pixdim[1], 0, -origin_lps[1])
    struct.pack_into("<4f", hdr, 312, 0, 0, pixdim[2], origin_lps[2])
    hdr[344:348] = b"n+1\x00"
    body = bytes(hdr) + b"\x00" * 4 + data_zyx.tobytes(order="C")
    with _open(path, "wb") as f:
        f.write(body)
    return path
