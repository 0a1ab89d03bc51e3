"""Batched embedding of WSI patches and radiology slices (port of
multimodalfusion_tpu/extract/features.py).  WSI patches are resized to
the trunk's input on the device, bit for bit as ``cv2.resize`` does on
the JAX host path.

The truncated ResNet50 (``models/resnet.py``) runs in inference mode on
fixed-size chunks of ``batch_size`` images.  ``bfloat16`` (the JAX
default) runs the convolutions under ``torch.autocast`` with
channels-last tensors; ``float32`` turns cuDNN's TF32 off for its
convolutions, so that it is f32.  On the card the chunks are
double-buffered through page-locked staging buffers: chunk k+1 is
copied and dispatched before the features of chunk k are read back, so
the copies and the host's work overlap the convolutions.  Radiology
slices travel as one grayscale channel and are repeated to three and
normalised on the device, which gives the inputs of the JAX host path
(``slices_to_rgb`` + ``_fit_spatial`` + ``preprocess_images``) bit for bit.
"""
from __future__ import annotations

import contextlib
import warnings
from typing import Callable, Optional, Union

import numpy as np
import torch

from multimodalfusion_tpu_torch import resolve_device
from multimodalfusion_tpu_torch.models.resnet import (FEATURE_DIM,
                                                      ResNet50Trunc,
                                                      load_torch_checkpoint,
                                                      load_trunk_state_dict,
                                                      normalize_nchw,
                                                      preprocess_images)
from multimodalfusion_tpu_torch.utils.image_ops import resize_u8

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


class Embedder:
    """images (uint8/float NHWC) or grayscale slices -> 1024-d features.

    Weights: ``state_dict`` (torchvision layout), else ``weights_path``
    (a file of one), else with ``allow_random`` a random trunk drawn from
    a CPU ``torch.Generator`` seeded with 0 (with a warning); with none
    of them it raises.  A short last chunk runs at its own size: JAX pads
    it to ``batch_size`` so that XLA compiles one shape, which on the
    card only computes the padding for nothing (PERF.md §6)."""

    def __init__(self, weights_path: Optional[str] = None,
                 state_dict=None, batch_size: int = 128,
                 dtype: Union[str, torch.dtype] = "bfloat16",
                 image_size: int = 224, allow_random: bool = False,
                 device=None):
        if batch_size < 1:
            raise ValueError(f"batch_size must be >= 1, got {batch_size}")
        self.dtype = DTYPES[dtype] if isinstance(dtype, str) else dtype
        if self.dtype not in DTYPES.values():
            raise ValueError(f"dtype must be bfloat16 or float32, got "
                             f"{dtype}")
        self.device = resolve_device(device)
        self.batch_size = batch_size
        self.image_size = image_size
        generator = None
        if state_dict is None and weights_path is not None:
            state_dict = load_torch_checkpoint(weights_path)
        elif state_dict is None and allow_random:
            warnings.warn(
                "Embedder: no weights given — using a RANDOMLY initialized "
                "ResNet50. Embeddings are meaningless outside tests; pass a "
                "torchvision resnet50 state_dict (torch.save(torchvision."
                "models.resnet50(weights='IMAGENET1K_V1').state_dict(), "
                "'resnet50.pt')).", stacklevel=2)
            generator = torch.Generator().manual_seed(0)
        elif state_dict is None:
            raise ValueError(
                "Embedder needs ResNet50 weights (weights_path= or "
                "state_dict=). Export them once with torch: "
                "torch.save(torchvision.models.resnet50("
                "weights='IMAGENET1K_V1').state_dict(), 'resnet50.pt'). "
                "Pass allow_random=True only for tests.")
        model = ResNet50Trunc(generator=generator)
        if state_dict is not None:
            load_trunk_state_dict(model, state_dict)
        self.memory_format = (torch.channels_last
                              if self.dtype == torch.bfloat16
                              else torch.contiguous_format)
        self.model = model.to(self.device,
                              memory_format=self.memory_format).eval()

    @contextlib.contextmanager
    def _compute(self):
        """The context of a forward: cuDNN on the card with TF32 off for
        float32 (its other flags as the caller set them), and autocast
        for bfloat16."""
        with contextlib.ExitStack() as stack:
            if self.device.type == "cuda":
                cudnn = torch.backends.cudnn
                stack.enter_context(cudnn.flags(
                    enabled=True, benchmark=cudnn.benchmark,
                    deterministic=cudnn.deterministic,
                    allow_tf32=self.dtype != torch.float32))
            if self.dtype == torch.bfloat16:
                stack.enter_context(torch.autocast(self.device.type,
                                                   dtype=torch.bfloat16))
            yield

    def _layout(self, x: torch.Tensor) -> torch.Tensor:
        return x.contiguous(memory_format=self.memory_format)

    def _prepare_images(self, x: torch.Tensor) -> torch.Tensor:
        return self._layout(preprocess_images(x, self.image_size))

    def _prepare_slices(self, gray: torch.Tensor) -> torch.Tensor:
        """[n, S, S] float32 slices in [0, 1] -> normalised [n, 3, S, S]:
        the grayscale channel repeated, then the ImageNet normalisation."""
        return self._layout(normalize_nchw(gray.unsqueeze(1).expand(
            -1, 3, -1, -1)))

    def _embed(self, host: np.ndarray,
               prepare: Callable[[torch.Tensor], torch.Tensor]
               ) -> np.ndarray:
        """Features [N, 1024] float32 of the rows of ``host``, chunk by
        chunk; ``prepare`` turns a chunk on the device into the trunk's
        input."""
        n_total, bs = host.shape[0], self.batch_size
        out = np.empty((n_total, FEATURE_DIM), np.float32)
        if n_total == 0:
            return out
        cuda = self.device.type == "cuda"
        src_dtype = torch.from_numpy(host[:1]).dtype
        shape = (min(bs, n_total),) + host.shape[1:]
        if cuda:
            # two page-locked slots each way: slot k % 2 is refilled only
            # after the readback of chunk k - 2, which follows its copy
            staging = [torch.empty(shape, dtype=src_dtype, pin_memory=True)
                       for _ in range(2)]
            results = [torch.empty((shape[0], FEATURE_DIM), pin_memory=True)
                       for _ in range(2)]
            done = [torch.cuda.Event() for _ in range(2)]
        pending = None  # (slot, first row, rows) of the chunk in flight
        with torch.inference_mode(), self._compute():
            for k, start in enumerate(range(0, n_total, bs)):
                chunk = host[start:start + bs]
                n, slot = chunk.shape[0], k % 2
                if cuda:
                    buf = staging[slot][:n]
                    np.copyto(buf.numpy(), chunk)
                    x = buf.to(self.device, non_blocking=True)
                else:
                    x = torch.from_numpy(np.ascontiguousarray(chunk))
                feats = self.model(prepare(x))
                if not cuda:
                    out[start:start + n] = feats.numpy()
                    continue
                results[slot][:n].copy_(feats, non_blocking=True)
                done[slot].record()
                if pending is not None:
                    self._collect(out, results, done, *pending)
                pending = (slot, start, n)
            if pending is not None:
                self._collect(out, results, done, *pending)
        return out

    @staticmethod
    def _collect(out, results, done, slot, start, n):
        done[slot].synchronize()
        out[start:start + n] = results[slot][:n].numpy()

    def embed_images(self, images: np.ndarray, resize: bool = False
                     ) -> np.ndarray:
        """Any number of NHWC images (uint8 or float) -> [N, 1024] float32
        features; each is centre-cropped to ``image_size`` and normalised
        on the device.  With ``resize`` (uint8 images), each is first
        resized to ``image_size`` on the device as ``cv2.resize`` does
        (``utils/image_ops.resize_u8``): the WSI patches' path."""
        prepare = self._prepare_images
        if resize:
            size = (self.image_size, self.image_size)

            def prepare(x):
                return self._prepare_images(resize_u8(x, size))
        return self._embed(np.asarray(images), prepare)

    def embed_slices(self, slices: np.ndarray) -> np.ndarray:
        """[N, H, W] grayscale in [0, 1] -> [N, 1024]; the slices are
        centre-cropped or zero-padded to ``image_size`` on the host
        (``_fit_spatial``), then embedded as three equal channels."""
        return self._embed(self.fit_slices(slices), self._prepare_slices)

    def fit_slices(self, slices: np.ndarray) -> np.ndarray:
        """[N, H, W] -> float32 [N, image_size, image_size]."""
        s = np.asarray(slices, np.float32)
        n = s.shape[0]
        return _fit_spatial(s[..., None], self.image_size).reshape(
            n, self.image_size, self.image_size)

    def spatial_maps(self, x: torch.Tensor) -> torch.Tensor:
        """The trunk's layer3 maps [N, 1024, h, w] float32 of normalised
        NCHW inputs on the device, ``batch_size`` at a time, without
        autograd (the GradCAM target layer)."""
        with torch.no_grad(), self._compute():
            return torch.cat([
                self.model(self._layout(x[i:i + self.batch_size]),
                           return_spatial=True)
                for i in range(0, x.shape[0], self.batch_size)])

    def slice_inputs(self, slices: np.ndarray) -> torch.Tensor:
        """The trunk's inputs for ``slices`` as ``embed_slices`` makes them
        on the device (float32 NCHW)."""
        gray = torch.from_numpy(self.fit_slices(slices)).to(self.device)
        return self._prepare_slices(gray)


def _fit_spatial(images: np.ndarray, size: int) -> np.ndarray:
    """Centre-crop-or-pad NHWC images to (size, size) (JAX
    extract/features.py:122-137): the crop at floor offsets, then
    centred zero padding, as torchvision's CenterCrop(224) pads a smaller
    image (ref feature_extraction.py:103-108)."""
    n, h, w, c = images.shape
    out = np.zeros((n, size, size, c), images.dtype)
    top = max((h - size) // 2, 0)
    left = max((w - size) // 2, 0)
    crop = images[:, top:top + size, left:left + size, :]
    ch, cw = crop.shape[1], crop.shape[2]
    pt = (size - ch) // 2
    pl = (size - cw) // 2
    out[:, pt:pt + ch, pl:pl + cw, :] = crop
    return out
