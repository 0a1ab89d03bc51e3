"""CT/MRI preprocessing (port of multimodalfusion_tpu/data/ct_preprocess.py,
itself a rewrite of ref utils/ct_preprocess_utils.py and the scan paths
of datasets/dataset_raw.py), in numpy and scipy.

DICOM series are read by the port's own reader (``data/dicom.py``).
Lung segmentation is the classical threshold / connected-components
estimator (ref segment_lung_mask, ct_preprocess_utils.py:90-129); the
reference's ``lungmask`` U-Net needs downloaded weights and is not
offered.  Lung bounding boxes are the bounding box of the mask's nonzero
pixels, which is the union of the bounding rectangles of its
``cv2.findContours`` contours that the JAX package takes.
"""
from __future__ import annotations

import os
from typing import Optional, Sequence, Tuple

import numpy as np
import scipy.ndimage

from multimodalfusion_tpu_torch.data import dicom


# ---------------------------------------------------------------------------
# DICOM
# ---------------------------------------------------------------------------

def load_scan(path: str):
    """Read and z-sort a DICOM series (ref load_scan :14-34), setting
    every slice's ``SliceThickness`` to the spacing of the first two
    distinct z positions; None when the directory holds no .dcm file."""
    names = [n for n in os.listdir(path) if ".dcm" in n.lower()]
    if not names:
        return None
    slices = dicom.read_series(path)
    slices.sort(key=lambda s: float(s.ImagePositionPatient[2]))
    thickness = abs(slices[0].ImagePositionPatient[2]
                    - slices[1].ImagePositionPatient[2])
    if thickness == 0:
        thickness = abs(slices[1].ImagePositionPatient[2]
                        - slices[2].ImagePositionPatient[2])
        if thickness == 0:
            raise NotImplementedError("zero slice thickness")
    for s in slices:
        s.SliceThickness = thickness
    return slices


def get_pixels_hu(slices) -> np.ndarray:
    """DICOM pixel arrays -> Hounsfield units (ref get_pixels_hu :37-60)."""
    image = np.stack([s.pixel_array for s in slices]).astype(np.int16)
    image[image == -2000] = 0
    for i, s in enumerate(slices):
        intercept, slope = s.RescaleIntercept, s.RescaleSlope
        if slope != 1:
            image[i] = (slope * image[i].astype(np.float64)).astype(np.int16)
        image[i] += np.int16(intercept)
    return image


def apply_orientation_fixes(img_hu: np.ndarray, orientations) -> np.ndarray:
    """Per-slice ImageOrientationPatient fix-ups (ref
    dataset_raw.py:59-75)."""
    img_hu = img_hu.copy()
    for i, ori in enumerate(orientations):
        x = np.round(np.asarray(ori[0:3]))
        y = np.round(np.asarray(ori[3:6]))
        if all(x == [-1, 0, 0]):
            img_hu[i] = np.flip(img_hu[i], 0)
        if all(y == [0, -1, 0]):
            img_hu[i] = np.flip(img_hu[i], 1)
        if all(x == [0, -1, 0]) and all(y == [1, 0, 0]):
            img_hu[i] = np.rot90(img_hu[i])
        if all(x == [0, -1, 0]) and all(y == [-1, 0, 0]):
            img_hu[i] = np.flip(np.rot90(img_hu[i]), 1)
        if all(x == [0, 1, 0]) and all(y == [1, 0, 0]):
            img_hu[i] = np.flip(np.rot90(img_hu[i]), 0)
        if all(x == [0, 1, 0]) and all(y == [-1, 0, 0]):
            img_hu[i] = np.rot90(img_hu[i], 3)
    return img_hu


# ---------------------------------------------------------------------------
# resampling / cropping / normalization
# ---------------------------------------------------------------------------

def resample(image: np.ndarray, spacing_zyx: Sequence[float],
             new_spacing=(1.0, 1.5, 1.5)) -> Tuple[np.ndarray, np.ndarray]:
    """Resample by cubic spline zoom (ref resample :63-88: rounds the
    zoomed shape and recomputes the real factor)."""
    spacing = np.array(spacing_zyx, np.float32)
    resize_factor = spacing / np.asarray(new_spacing, np.float32)
    new_shape = np.round(np.asarray(image.shape) * resize_factor)
    real_factor = new_shape / np.asarray(image.shape)
    new_spacing_real = spacing / real_factor
    out = scipy.ndimage.zoom(image, real_factor, mode="nearest")
    return out, new_spacing_real


def _linear_weight_mat(n_in: int, n_out: int) -> np.ndarray:
    """float32 [n_in, n_out] weights of ``jax.image.resize``'s "linear"
    kernel along one axis (``jax._src.image.scale.compute_weight_mat``):
    the triangle kernel at the sample centres, widened by the downscale
    factor (antialiasing), each column normalised to sum 1, and columns
    whose centre falls outside the input zeroed."""
    f32 = np.float32
    inv_scale = f32(1.0 / (n_out / n_in))
    kernel_scale = max(inv_scale, f32(1.0))
    sample = (np.arange(n_out, dtype=f32) + f32(0.5)) * inv_scale \
        - f32(0.0) - f32(0.5)
    x = np.abs(sample[None, :] - np.arange(n_in, dtype=f32)[:, None]) \
        / kernel_scale
    w = np.maximum(f32(0.0), f32(1.0) - np.abs(x))
    total = np.sum(w, axis=0, keepdims=True, dtype=f32)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, f32(1.0)), f32(0.0))
    inside = (sample >= -0.5) & (sample <= f32(n_in) - f32(0.5))
    return np.where(inside[None, :], w, f32(0.0)).astype(f32)


def resample_xla(image, spacing_zyx, new_spacing=(1.0, 1.5, 1.5),
                 device=None):
    """Trilinear resample on the device, the port of the JAX package's
    ``jax.image.resize(method="trilinear")`` path (same target-shape rule
    as ``resample``): separable, each axis whose size changes contracted
    with ``_linear_weight_mat`` in float32, TF32 off.  Like JAX, and
    unlike ``F.interpolate``, it antialiases when it downsamples.
    Returns (float32 tensor on ``device``, the real new spacing)."""
    import torch

    from multimodalfusion_tpu_torch import resolve_device
    dev = resolve_device(device)
    spacing = np.array(spacing_zyx, np.float32)
    factor = spacing / np.asarray(new_spacing, np.float32)
    new_shape = tuple(int(x) for x in
                      np.round(np.asarray(np.shape(image)) * factor))
    x = torch.as_tensor(np.asarray(image, np.float32), device=dev)
    matmul = torch.backends.cuda.matmul
    tf32 = matmul.allow_tf32
    matmul.allow_tf32 = False
    try:
        for axis, (n_in, n_out) in enumerate(zip(x.shape, new_shape)):
            if n_in == n_out:
                continue
            w = torch.from_numpy(_linear_weight_mat(n_in, n_out)).to(dev)
            x = torch.movedim(torch.movedim(x, axis, -1) @ w, -1, axis)
    finally:
        matmul.allow_tf32 = tf32
    real = spacing / (np.asarray(new_shape) / np.asarray(np.shape(image)))
    return x.contiguous(), real


def normalize(image: np.ndarray, min_bound: float,
              max_bound: float) -> np.ndarray:
    """Window + scale to [0, 1] (ref normalize :240-244)."""
    out = (image.astype(np.float32) - min_bound) / (max_bound - min_bound)
    return np.clip(out, 0.0, 1.0)


def crop_image(img: np.ndarray, tol: float = 0, return_index: bool = False):
    """Crop the spatial dims to the bounding box of voxels > tol across the
    whole stack (ref crop_image :131-134).  With ``return_index`` also
    return the boolean (rows, cols) selectors, so that a companion volume
    (a segmentation mask) can be cropped identically."""
    mask = img > tol
    rows = mask.any(0).any(1)
    cols = mask.any(0).any(0)
    if not rows.any() or not cols.any():
        rows = np.ones(img.shape[1], bool)
        cols = np.ones(img.shape[2], bool)
    out = img[:, rows][:, :, cols]
    if return_index:
        return out, rows, cols
    return out


# ---------------------------------------------------------------------------
# lung segmentation (classical; ref segment_lung_mask :90-129)
# ---------------------------------------------------------------------------

def _largest_label_volume(labels: np.ndarray, bg: int = 0) -> Optional[int]:
    vals, counts = np.unique(labels[labels != bg], return_counts=True)
    if len(counts) == 0:
        return None
    return int(vals[np.argmax(counts)])


def segment_lung_mask(image: np.ndarray,
                      fill_lung_structures: bool = True) -> np.ndarray:
    """Threshold at -320 HU, remove the surrounding-air component,
    optionally fill per-slice structures, keep the largest air region.

    scipy.ndimage.label is binary (unlike the reference's value-aware
    skimage.measure.label), so each step labels an explicit boolean mask.
    """
    binary = np.array(image > -320, dtype=np.int8) + 1  # 1 = air, 2 = tissue
    air = binary == 1
    air_labels = scipy.ndimage.label(air)[0]
    corner = air_labels[0, 0, 0]
    if corner != 0:  # scan corner is outside air -> mark it as tissue
        binary[air_labels == corner] = 2
    if fill_lung_structures:
        for i in range(binary.shape[0]):
            tissue = binary[i] == 2
            lab = scipy.ndimage.label(tissue)[0]
            l_max = _largest_label_volume(lab, bg=0)
            if l_max is not None:
                # everything outside the dominant tissue region -> air
                binary[i][lab != l_max] = 1
    lungs = (binary == 1).astype(np.int8)
    labels = scipy.ndimage.label(lungs, structure=np.ones((3, 3, 3)))[0]
    l_max = _largest_label_volume(labels, bg=0)
    if l_max is not None:
        lungs[labels != l_max] = 0
    return lungs.astype(np.uint8)


def lung_mask(volume: np.ndarray) -> np.ndarray:
    """The lung segmentation of a resampled HU volume: the classical
    estimator (the JAX package first tries the ``lungmask`` U-Net, whose
    weights are downloaded; the port does not)."""
    return segment_lung_mask(volume)


def lung_box(original: np.ndarray, seg: np.ndarray,
             return_coord: bool = False):
    """Bounding box of one slice's segmentation (ref lung_box :136-171):
    rows y..yh-1 and columns x..xw-1 hold every nonzero pixel of ``seg``.
    With ``return_coord`` the box (Nones for an empty mask); else the
    slice with everything outside the box widened by 5 pixels set to
    -1000 HU, and that widened mask."""
    seg_temp = np.ascontiguousarray(seg.astype(np.uint8))
    rows = np.flatnonzero(seg_temp.any(1))
    if rows.size == 0:
        lung_bb = original.copy()
        lung_bb[seg == 0] = -1000
        return (None, None, None, None) if return_coord else (lung_bb,
                                                              seg_temp)
    cols = np.flatnonzero(seg_temp.any(0))
    y, yh = int(rows[0]), int(rows[-1]) + 1
    x, xw = int(cols[0]), int(cols[-1]) + 1
    if return_coord:
        return y, yh, x, xw
    seg_temp[max(y - 5, 0):yh + 5, max(x - 5, 0):xw + 5] = 1
    lung_bb = original.copy()
    lung_bb[seg_temp == 0] = -1000
    return lung_bb, seg_temp


def largest_lung_box(volume: np.ndarray, segmentation: np.ndarray,
                     return_box: bool = False):
    """Crop the stack to the union bounding box over all slices (ref
    largest_lung_box :173-192).  With ``return_box`` also return the
    (y0, y1, x0, x1) slice bounds so that companion volumes can be cropped
    identically."""
    b_y, b_yh = np.inf, -np.inf
    b_x, b_xw = np.inf, -np.inf
    for i in range(len(volume)):
        y, yh, x, xw = lung_box(volume[i], segmentation[i], True)
        if y is None:
            continue
        b_y, b_x = min(b_y, y), min(b_x, x)
        b_yh, b_xw = max(b_yh, yh), max(b_xw, xw)
    if not np.isfinite(b_y):
        box = (0, volume.shape[1], 0, volume.shape[2])
    else:
        box = (max(int(b_y) - 1, 0), int(b_yh) + 1,
               max(int(b_x) - 1, 0), int(b_xw) + 1)
    out = volume[:, box[0]:box[1], box[2]:box[3]]
    if return_box:
        return out, box
    return out
