"""GradCAM++ on the ResNet trunk's layer3 map with torch autograd (port of
multimodalfusion_tpu/interpret/gradcam.py, which replaces the reference's
pytorch-grad-cam: GradCAMPlusPlus on resnet50.layer3[-1], ref
gradcam.py:64,101-105), and the overlays of a CAM on its slice.

The layer3 map is NCHW here, [B, 1024, h, w], where the JAX package's is
NHWC: the spatial sums run over dims (2, 3) and the augmentation's flip
over the image's dim 3 (the CAM's dim 2).  The image steps use the
port's stand-ins for OpenCV and matplotlib (``utils/image_ops.py``)."""
from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import torch
from torch.nn import functional as F

from multimodalfusion_tpu_torch.utils.image_ops import (add_weighted,
                                                        colormap,
                                                        gaussian_blur,
                                                        repeat_rgb,
                                                        resize_bilinear,
                                                        to_uint8_gray)

# pytorch-grad-cam's aug_smooth: horizontal flip x brightness multiply
AUG_FLIPS = (False, True)
AUG_FACTORS = (0.9, 1.0, 1.1)


def gradcam_pp(act: torch.Tensor, grads: torch.Tensor) -> torch.Tensor:
    """GradCAM++ CAMs [B, h, w] in [0, 1] from the layer activations
    ``act`` [B, C, h, w] and the target's gradients with respect to them.

    As pytorch-grad-cam's ``GradCAMPlusPlus`` (ref gradcam.py:101-105):
    alpha = g^2 / (2 g^2 + (sum_hw A) g^3 + 1e-6), 0 where g == 0; channel
    weight = sum_hw alpha relu(g); CAM = relu(sum_c weight A), min-max
    scaled per image."""
    g2 = grads ** 2
    g3 = g2 * grads
    sum_act = act.sum(dim=(2, 3), keepdim=True)            # [B, C, 1, 1]
    denom = 2.0 * g2 + sum_act * g3 + 1e-6
    alpha = torch.where(grads != 0.0, g2 / denom, torch.zeros_like(g2))
    weights = (alpha * F.relu(grads)).sum(dim=(2, 3))      # [B, C]
    cam = F.relu(torch.einsum("bc,bchw->bhw", weights, act))
    lo = cam.amin(dim=(1, 2), keepdim=True)
    hi = cam.amax(dim=(1, 2), keepdim=True)
    return (cam - lo) / (1e-7 + hi - lo)


def _cam(spatial_fn: Callable, head_fn: Callable, x: torch.Tensor
         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(CAMs, the layer3 map) of one input: the trunk without autograd,
    then the map as the leaf of the head's gradient."""
    with torch.no_grad():
        act = spatial_fn(x)
    act = act.detach().requires_grad_(True)
    with torch.enable_grad():
        (grads,) = torch.autograd.grad(head_fn(act).sum(), act)
    act = act.detach()
    with torch.no_grad():
        return gradcam_pp(act, grads), act


def gradcam_for(spatial_fn: Callable, head_fn: Callable,
                images: torch.Tensor, aug_smooth: bool = False
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """CAMs [B, h, w] of normalised images [B, 3, H, W]: layer3 maps from
    ``spatial_fn``, the gradient of the summed target ``head_fn(map)``.
    Also returns the layer3 map of ``images`` as they are, for a read-out
    of the same pass.

    ``aug_smooth`` replicates pytorch-grad-cam's test-time augmentation
    (ref gradcam.py:105): the mean of the per-variant, min-max-scaled CAMs
    over the horizontal flip x the brightness factors 0.9, 1.0, 1.1
    (multiplying the already normalised input), each flipped CAM flipped
    back.  The trunk runs once per variant."""
    if not aug_smooth:
        return _cam(spatial_fn, head_fn, images)
    cams, plain_act = [], None
    for flip in AUG_FLIPS:
        x = images.flip(3) if flip else images
        for factor in AUG_FACTORS:
            cam, act = _cam(spatial_fn, head_fn, x * factor)
            if flip:
                cam = cam.flip(2)
            elif factor == 1.0:
                plain_act = act
            cams.append(cam)
    return torch.stack(cams).mean(dim=0), plain_act


def upsample_cams(cams: torch.Tensor, size: Sequence[int]) -> torch.Tensor:
    """CAMs [N, h, w] bilinearly resized to the slices' size (H, W)."""
    return resize_bilinear(cams.float(), size)


def cam_overlay(image_gray: torch.Tensor, cam: torch.Tensor,
                mask: Optional[torch.Tensor] = None, blur: int = 11,
                alpha: float = 0.5) -> torch.Tensor:
    """uint8 RGB [H, W, 3]: a CAM [H, W] blended over its grayscale slice
    (ref gradcam.py:124-189): zeroed outside ``mask``, blurred by a
    ``blur`` x ``blur`` Gaussian and divided by its maximum (at least
    1e-12), coloured by jet, and blended as ``add_weighted(slice, 1 -
    alpha, heat, alpha)`` over the slice in [0, 1] made uint8."""
    cam = cam.float()
    if mask is not None:
        cam = cam * (mask > 0)
    if blur:
        cam = gaussian_blur(cam, blur)
        cam = cam / cam.max().clamp_min(1e-12)
    base = repeat_rgb(to_uint8_gray(image_gray))
    return add_weighted(base, 1 - alpha, colormap("jet")(cam), alpha)
