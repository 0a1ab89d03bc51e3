"""Model factory, batch adapter and checkpoint loading (the serving part of
multimodalfusion_tpu/engine/train.py).  The training loop comes with the
training slice (ROADMAP.md, port queue item 2)."""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from multimodalfusion_tpu_torch.models.amil import PathAMIL

_NOT_YET = {
    "radio_attention_mil": "radio AMIL is ROADMAP.md port queue item 3",
    "max_net": "omic models are ROADMAP.md port queue item 4",
    "mm_attention_mil": "multimodal models are ROADMAP.md port queue item 4",
}


@dataclasses.dataclass
class TrainConfig:
    """The knobs of the JAX package's TrainConfig that serving reads
    (ref main.py:96-144), with the same names and defaults.  The
    training slice adds the rest."""
    model_type: str = "max_net"
    mode: str = "omic"
    n_classes: int = 4
    batch_size: int = 1
    drop_out: bool = False           # attention-branch dropout
    gate_path: bool = False
    model_size_wsi: str = "small"
    pretrained: bool = False
    bag_dtype: str = "float32"


def _unsupported(cfg: TrainConfig) -> NotImplementedError:
    if cfg.pretrained:
        why = "stage-4 pretrained heads are ROADMAP.md port queue item 4"
    else:
        why = _NOT_YET.get(cfg.model_type, "not a model of this repo")
    return NotImplementedError(f"{cfg.model_type} (mode {cfg.mode}): {why}")


def build_model(cfg: TrainConfig,
                generator: Optional[torch.Generator] = None):
    """Model dispatch (ref core_utils.py:76-98); only the path branch is
    ported so far."""
    if cfg.pretrained or cfg.model_type != "path_attention_mil":
        raise _unsupported(cfg)
    return PathAMIL(model_size=cfg.model_size_wsi, gate=cfg.gate_path,
                    attn_dropout=cfg.drop_out, n_classes=cfg.n_classes,
                    compute_dtype=cfg.bag_dtype, generator=generator)


def model_inputs(cfg: TrainConfig, batch: Dict[str, np.ndarray],
                 device: torch.device) -> dict:
    """Map a loader batch onto the model's call signature, on ``device``."""
    if cfg.pretrained or cfg.model_type != "path_attention_mil":
        raise _unsupported(cfg)
    return dict(bags=torch.from_numpy(batch["path_bags"]).to(device),
                mask=torch.from_numpy(batch["path_mask"]).to(device))


def load_checkpoint(model: torch.nn.Module, path: str) -> torch.nn.Module:
    """Load a reference-layout ``.pt`` state_dict (the JAX package writes
    one beside every checkpoint) into ``model``, strictly, on the device
    the model is on."""
    device = next(model.parameters()).device
    sd = torch.load(path, map_location=device, weights_only=True)
    model.load_state_dict(sd, strict=True)
    return model
