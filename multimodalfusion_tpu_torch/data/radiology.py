"""Per-scan radiology preprocessing (port of
multimodalfusion_tpu/data/radiology.py, a rewrite of ref
datasets/dataset_raw.py PreprocessDataset as pure functions): NIfTI MRI
(glioma) or DICOM / NIfTI CT (lung) -> slice stacks in [0, 1] and their
slice ids, ready for the embedder."""
from __future__ import annotations

from typing import Tuple

import numpy as np

from multimodalfusion_tpu_torch.data import ct_preprocess as ct
from multimodalfusion_tpu_torch.data.nifti import read_nifti

GLIOMA_STANDARD_ORIGIN = (0.0, -239.0, 0.0)


def preprocess_glioma_scan(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """NIfTI MRI -> (slices [N, H, W] in [0, 1], slice ids).

    Mirrors ref dataset_raw.py:31-49: flip axes whose origin component
    differs from the standard (0, -239, 0), drop all-black axial slices,
    min-max normalize over the kept stack, crop to the nonzero bounding
    box.
    """
    img = read_nifti(path)
    arr = img.data
    flip = [img.origin_lps[i] != GLIOMA_STANDARD_ORIGIN[i] for i in range(3)]
    # origin axis order is (x, y, z) -> array axes (2, 1, 0)
    for axis_xyz, do_flip in enumerate(flip):
        if do_flip:
            arr = np.flip(arr, axis=2 - axis_xyz)
    slice_ids = np.array([i for i in range(arr.shape[0])
                          if np.count_nonzero(arr[i]) > 0], dtype=np.int64)
    selected = arr[slice_ids]
    if selected.size == 0:
        return np.zeros((0, 1, 1), np.float32), slice_ids
    final = ct.normalize(selected, selected.min(), selected.max())
    final = ct.crop_image(final)
    return final.astype(np.float32), slice_ids


def preprocess_lung_volume(img_hu: np.ndarray, spacing_zyx,
                           segment_each_slice: bool = False,
                           return_mask: bool = False):
    """HU volume [Z, Y, X] + spacing -> (slices [N, H, W] in [0, 1],
    slice ids).  The DICOM-independent core of the lung pipeline (ref
    dataset_raw.py:76-93): resample to [1, 1.5, 1.5] mm, lung
    segmentation + bounding-box crop, window-normalize (-1000, 400),
    drop black slices.

    ``return_mask`` additionally returns the lung segmentation cropped
    identically to the output slices (ref PreprocessDatasetMask
    dataset_raw.py:122-257, consumed by the GradCAM CLI to zero CAMs
    outside the lungs).  Not supported with ``segment_each_slice``
    (the per-slice boxes destroy cross-slice alignment).
    """
    if return_mask and segment_each_slice:
        raise ValueError("return_mask requires segment_each_slice=False")
    img_hu = np.asarray(img_hu).copy()
    img_hu[img_hu < -1000] = -1000
    resampled, _ = ct.resample(img_hu, spacing_zyx, (1.0, 1.5, 1.5))
    segmentation = ct.lung_mask(resampled)
    if segment_each_slice:
        segmented = np.array([ct.lung_box(resampled[i], segmentation[i])[0]
                              for i in range(len(resampled))])
        cropped = ct.crop_image(np.asarray(segmented))
    else:
        segmented, box = ct.largest_lung_box(resampled, segmentation,
                                             return_box=True)
        cropped, rows, cols = ct.crop_image(np.asarray(segmented),
                                            return_index=True)
    normalized = ct.normalize(cropped, -1000, 400)
    slice_ids = np.array([i for i in range(normalized.shape[0])
                          if np.count_nonzero(normalized[i]) > 0],
                         dtype=np.int64)
    slices = normalized[slice_ids].astype(np.float32)
    if not return_mask:
        return slices, slice_ids
    seg_box = segmentation[:, box[0]:box[1], box[2]:box[3]]
    seg_aligned = seg_box[:, rows][:, :, cols]
    return slices, slice_ids, (seg_aligned[slice_ids] > 0)


def preprocess_lung_scan(path: str, segment_each_slice: bool = False,
                         return_mask: bool = False):
    """DICOM series dir -> (slices [N, H, W] in [0, 1], slice ids).

    Mirrors ref dataset_raw.py:51-93: HU conversion, orientation fix-ups,
    then the DICOM-independent ``preprocess_lung_volume`` core.
    NIfTI lung scans are also accepted (path ending .nii/.nii.gz).
    ``return_mask`` adds the aligned lung mask (see
    ``preprocess_lung_volume``).
    """
    if str(path).endswith((".nii", ".nii.gz")):
        img = read_nifti(path)
        return preprocess_lung_volume(img.data, img.spacing_zyx,
                                      segment_each_slice, return_mask)
    slices = ct.load_scan(path)
    if slices is None:
        empty = (np.zeros((0, 1, 1), np.float32), np.zeros(0, np.int64))
        return empty + (np.zeros((0, 1, 1), bool),) if return_mask else empty
    img_hu = ct.get_pixels_hu(slices)
    img_hu = ct.apply_orientation_fixes(
        img_hu, [s.ImageOrientationPatient for s in slices])
    spacing = (float(slices[0].SliceThickness),
               float(slices[0].PixelSpacing[0]),
               float(slices[0].PixelSpacing[1]))
    return preprocess_lung_volume(img_hu, spacing, segment_each_slice,
                                  return_mask)


def preprocess_scan(path: str, lung: bool):
    """(slices [N, H, W] in [0, 1], slice ids, lung mask [N, H, W] or
    None) of a lung CT (``preprocess_lung_scan``, with its mask) or a
    glioma MRI (``preprocess_glioma_scan``, no mask)."""
    if lung:
        return preprocess_lung_scan(path, return_mask=True)
    slices, slice_ids = preprocess_glioma_scan(path)
    return slices, slice_ids, None


def slices_to_rgb(slices: np.ndarray) -> np.ndarray:
    """[N, H, W] grayscale -> [N, H, W, 3] (ref dataset_raw.py:103-116
    repeats the channel)."""
    return np.repeat(slices[..., None], 3, axis=-1)
