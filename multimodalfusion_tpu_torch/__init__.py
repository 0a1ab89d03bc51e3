"""PyTorch + CUDA port of multimodalfusion_tpu for NVIDIA Hopper GPUs.

The port keeps the JAX package's module names so each counterpart is easy
to find, imports nothing of the JAX package, and runs on ``cuda`` unless
the caller asks for the CPU (``device="cpu"``, ``--device cpu``).  It
extracts the ResNet50 features of radiology scans (stage 1,
``cli/feature_extraction.py``), trains the stage-2 models over
radiology, pathology and genomics
(``cli/main.py``), serves them without labels (``cli/infer.py``),
extracts their embeddings (stage 3) and trains, scores and serves the
stage-4 heads over them.  Operations: folds resume from their last
epoch, write TensorBoard event files and profiler traces, cohorts are
split, a fold is exported for serving (``cli/export_model.py``) and
``cli/doctor.py`` checks a deployment; ROADMAP.md lists what comes next.
"""
from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller names
    another.  Never falls back to the CPU on its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' (--device cpu) to run "
            "the plain PyTorch path on the CPU")
    return dev
