"""Truncated ResNet50 feature extractor (port of
multimodalfusion_tpu/models/resnet.py).

torchvision's ResNet50 cut after layer3, followed by a mean over the
spatial dims: images [B, 3, H, W] -> embeddings [B, 1024], the features
of WSI patches and radiology slices (ref models/resnet_custom.py:57-119).
The modules carry torchvision's attribute names (``conv1``, ``bn1``,
``layer1..3`` of ``Bottleneck`` blocks with ``conv1..3``, ``bn1..3`` and
``downsample.0/1``), so a torchvision ResNet50 ``state_dict`` loads as it
is (``load_trunk_state_dict``): strict on every key of the trunk, with
``layer4.*``, ``fc.*`` and ``num_batches_tracked`` ignored, as the JAX
``port_torch_state_dict`` ignores them.  No weights are downloaded.

The JAX package's space-to-depth stem (``_Stem(s2d=True)``) is not
ported: it is a rearrangement for the TPU's matrix unit that gives the
plain 7x7 stride-2 stem's outputs.
"""
from __future__ import annotations

from typing import Mapping, Optional

import torch
import torch.nn as nn

STAGE_SIZES = (3, 4, 6)          # layer1..layer3 (layer4 dropped)
STAGE_WIDTHS = (64, 128, 256)    # bottleneck 3x3 widths
EXPANSION = 4
FEATURE_DIM = STAGE_WIDTHS[-1] * EXPANSION  # 1024
BN_EPS = 1e-5

# ImageNet normalisation (ref feature_extraction.py:103-108)
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)

# keys of a torchvision ResNet50 state_dict that the trunk does not use
IGNORED_PREFIXES = ("layer4.", "fc.")


class Bottleneck(nn.Module):
    """1x1 -> 3x3 (stride here) -> 1x1 x4, with a 1x1 strided projection
    on the first block of each stage (JAX models/resnet.py:33-57)."""

    def __init__(self, inplanes: int, width: int, stride: int = 1,
                 downsample: bool = False):
        super().__init__()
        out = width * EXPANSION
        self.conv1 = nn.Conv2d(inplanes, width, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(width, eps=BN_EPS)
        self.conv2 = nn.Conv2d(width, width, 3, stride=stride, padding=1,
                               bias=False)
        self.bn2 = nn.BatchNorm2d(width, eps=BN_EPS)
        self.conv3 = nn.Conv2d(width, out, 1, bias=False)
        self.bn3 = nn.BatchNorm2d(out, eps=BN_EPS)
        self.relu = nn.ReLU(inplace=True)
        self.downsample = (nn.Sequential(
            nn.Conv2d(inplanes, out, 1, stride=stride, bias=False),
            nn.BatchNorm2d(out, eps=BN_EPS)) if downsample else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.relu(self.bn1(self.conv1(x)))
        y = self.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        residual = x if self.downsample is None else self.downsample(x)
        return self.relu(y + residual)


class ResNet50Trunc(nn.Module):
    """images NCHW float [B, 3, H, W] -> embeddings [B, 1024] float32, or
    with ``return_spatial`` the layer3 map [B, 1024, h, w] float32 (the
    GradCAM target layer, ref gradcam.py:64).

    Without a ``generator`` the weights are torch's default draw; with one
    (a CPU ``torch.Generator``) the convolutions are He-normal (fan out)
    from it, as torchvision initialises them; BatchNorm starts at the
    identity either way."""

    def __init__(self, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = nn.BatchNorm2d(64, eps=BN_EPS)
        self.relu = nn.ReLU(inplace=True)
        self.maxpool = nn.MaxPool2d(3, stride=2, padding=1)
        inplanes = 64
        for stage, (n_blocks, width) in enumerate(
                zip(STAGE_SIZES, STAGE_WIDTHS), start=1):
            blocks = []
            for i in range(n_blocks):
                stride = 2 if (i == 0 and stage > 1) else 1
                blocks.append(Bottleneck(inplanes, width, stride,
                                         downsample=(i == 0)))
                inplanes = width * EXPANSION
            setattr(self, f"layer{stage}", nn.Sequential(*blocks))
        if generator is not None:
            with torch.no_grad():
                for m in self.modules():
                    if isinstance(m, nn.Conv2d):
                        nn.init.kaiming_normal_(m.weight, mode="fan_out",
                                                nonlinearity="relu",
                                                generator=generator)

    def forward(self, x: torch.Tensor,
                return_spatial: bool = False) -> torch.Tensor:
        x = self.maxpool(self.relu(self.bn1(self.conv1(x))))
        x = self.layer3(self.layer2(self.layer1(x)))
        if return_spatial:
            return x.float()
        # adaptive average pool to 1x1 (ref resnet_custom.py:100-106)
        return x.float().mean(dim=(2, 3))


def _trunk_keys(model: nn.Module):
    return [k for k in model.state_dict()
            if not k.endswith("num_batches_tracked")]


def load_trunk_state_dict(model: ResNet50Trunc,
                          state_dict: Mapping[str, torch.Tensor]
                          ) -> ResNet50Trunc:
    """Load a torchvision ResNet50 ``state_dict`` into the trunk.  Every
    key of the trunk must be there and no other key besides ``layer4.*``,
    ``fc.*`` and ``num_batches_tracked``; a missing or an unknown key
    raises ``KeyError``, a wrong shape ``RuntimeError``."""
    kept = {k: v for k, v in state_dict.items()
            if not k.startswith(IGNORED_PREFIXES)
            and not k.endswith("num_batches_tracked")}
    want = _trunk_keys(model)
    missing = sorted(set(want) - set(kept))
    unknown = sorted(set(kept) - set(want))
    if missing or unknown:
        raise KeyError(f"ResNet50 trunk state_dict: missing keys {missing}, "
                       f"unknown keys {unknown}")
    model.load_state_dict(kept, strict=False)
    return model


def load_torch_checkpoint(path: str) -> dict:
    """The state_dict of a torch-serialized ResNet50 file (a state_dict,
    or an object with ``.state_dict()``), read with
    ``torch.load(weights_only=True)`` on the CPU."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    return sd


def normalize_nchw(x: torch.Tensor) -> torch.Tensor:
    """ImageNet normalisation of float NCHW images in [0, 1]."""
    mean = torch.tensor(IMAGENET_MEAN, dtype=torch.float32,
                        device=x.device).view(1, 3, 1, 1)
    std = torch.tensor(IMAGENET_STD, dtype=torch.float32,
                       device=x.device).view(1, 3, 1, 1)
    return (x - mean) / std


def preprocess_images(images: torch.Tensor,
                      center_crop: int = 224) -> torch.Tensor:
    """uint8 or float NHWC [B, H, W, 3] -> normalised float32 NCHW,
    centre-cropped to ``center_crop`` (JAX models/resnet.py:199-212):
    uint8 / 255, the crop at JAX's floor offsets ((H - size) // 2, where
    torchvision rounds), then the ImageNet normalisation.  A side shorter
    than the crop is kept whole."""
    x = images
    x = x.float() / 255.0 if x.dtype == torch.uint8 else x.float()
    H, W = x.shape[1], x.shape[2]
    if center_crop and (H != center_crop or W != center_crop):
        top = max((H - center_crop) // 2, 0)
        left = max((W - center_crop) // 2, 0)
        x = x[:, top:top + center_crop, left:left + center_crop]
    return normalize_nchw(x.permute(0, 3, 1, 2))


def conv_flops(model: nn.Module, height: int = 224,
               width: int = 224) -> float:
    """Operations of the trunk's convolutions on one image:
    sum of 2 * Ho * Wo * Cin * Cout * kh * kw / groups over every conv."""
    total = 0.0

    def hook(m, _inp, out):
        nonlocal total
        kh, kw = m.kernel_size
        total += (2.0 * out.shape[2] * out.shape[3] * m.in_channels
                  * m.out_channels * kh * kw / m.groups)

    hooks = [m.register_forward_hook(hook) for m in model.modules()
             if isinstance(m, nn.Conv2d)]
    try:
        with torch.no_grad():
            dev = next(model.parameters()).device
            model(torch.zeros(1, 3, height, width, device=dev))
    finally:
        for h in hooks:
            h.remove()
    return total

