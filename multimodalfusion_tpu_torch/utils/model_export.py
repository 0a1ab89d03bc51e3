"""Single-file model export for serving with ``torch.export`` (port of
multimodalfusion_tpu/utils/model_export.py, which writes a jax.export
StableHLO artifact).

The scoring call ``model(**inputs)`` in eval mode, its weights included,
is traced into one ``ExportedProgram`` and saved with
``torch.export.save`` (a ``.pt2`` file):

    sidecar = save_scorer(path, model, cfg, platforms=["cuda"])  # train side
    scorer = load_scorer(path)                                    # serving
    out = scorer(batch)      # {"risk": ..., "hazards": ..., "S": ...}

Shapes are fixed at export time (batch_size, bag_len); the serving side
pads as training did (masks make the padding exact).  ``platforms``
picks the pooling and the device: exactly ``["cuda"]`` keeps the
hand-written forward kernel as the custom op ``mmf::fused_pool``, with
the weights on the card, so loading that artifact imports the port's
``ops.mil_attention`` module (the sidecar's ``requires``); any other list
is traced on the CPU, through the plain PyTorch pooling, as JAX traces
its unfused pooling for any platform but the TPU, and loads with torch
alone.
"""
from __future__ import annotations

import json
from typing import Optional, Sequence

import numpy as np
import torch

from multimodalfusion_tpu_torch import resolve_device
from multimodalfusion_tpu_torch.data.loaders import \
    FEAT_DIM as PATH_FEAT_DIM  # single point of truth for bag shapes
from multimodalfusion_tpu_torch.engine.train import model_inputs
from multimodalfusion_tpu_torch.ops import mil_attention as mil

PRETRAINED_DIM = 256      # stage-3 embedding width
KERNEL_MODULE = "multimodalfusion_tpu_torch.ops.mil_attention"


def example_batch(cfg, batch_size: int = 8, bag_len: int = 512):
    """Loader-style batch of zeros with the shapes and dtypes that
    ``engine.train.model_inputs(cfg, ...)`` takes: shapes are all that
    tracing needs."""
    B, N = batch_size, bag_len
    batch = {}
    if cfg.pretrained:
        for k in ("h_radio", "h_path", "h_omic"):
            batch[k] = np.zeros((B, PRETRAINED_DIM), np.float32)
        batch["valid"] = np.ones((B,), np.float32)
        return batch
    if "radio" in cfg.mode:
        n_mod = max(len(cfg.modalities), 1)
        batch["radio_bags"] = np.zeros((B, N, n_mod * PATH_FEAT_DIM),
                                       np.float32)
        batch["radio_mask"] = np.ones((B, N), np.float32)
    if "path" in cfg.mode:
        batch["path_bags"] = np.zeros((B, N, PATH_FEAT_DIM), np.float32)
        batch["path_mask"] = np.ones((B, N), np.float32)
    if "omic" in cfg.mode:
        if cfg.omic_input_dim <= 0:
            raise ValueError("cfg.omic_input_dim must be set to export "
                             "an omic model")
        batch["genomic"] = np.zeros((B, cfg.omic_input_dim), np.float32)
    if not batch:
        raise NotImplementedError(cfg.mode)
    return batch


def keeps_kernel(platforms: Optional[Sequence[str]]) -> bool:
    """Whether an export for ``platforms`` keeps the forward kernel:
    exactly ``["cuda"]`` (also the default)."""
    return list(platforms or ["cuda"]) == ["cuda"]


def check_platforms(platforms: Optional[Sequence[str]]) -> list:
    """``platforms`` (default ``["cuda"]``) as a list; a TPU platform, or
    any other than cuda and cpu, raises."""
    plist = list(platforms or ["cuda"])
    other = sorted(set(plist) - {"cuda", "cpu"})
    if other:
        raise ValueError(f"--platforms {plist}: the port exports for cuda "
                         f"and cpu, not {other}")
    return plist


def export_device(platforms: Optional[Sequence[str]]) -> torch.device:
    """The device an export for ``platforms`` traces and keeps its weights
    on: the card for exactly ``["cuda"]``, else the CPU (so the plain
    pooling never runs on card tensors)."""
    check_platforms(platforms)
    return resolve_device("cuda" if keeps_kernel(platforms) else "cpu")


class _Scorer(torch.nn.Module):
    """``model(**inputs)`` reduced to the serving outputs: ``A_raw`` and
    the features are interpretability escapes with model-internal
    structure."""

    def __init__(self, model: torch.nn.Module):
        super().__init__()
        self.model = model

    def forward(self, inputs: dict) -> dict:
        out = self.model(**inputs)
        return {k: out[k] for k in ("risk", "hazards", "S")
                if out.get(k) is not None}


def example_inputs(cfg, batch_size: int, bag_len: int, device) -> dict:
    """``example_batch`` as the model's keyword inputs on ``device``."""
    return model_inputs(cfg, example_batch(cfg, batch_size, bag_len),
                        torch.device(device))


def export_scorer(model: torch.nn.Module, cfg, batch_size: int = 8,
                  bag_len: int = 512,
                  platforms: Optional[Sequence[str]] = None):
    """The ``ExportedProgram`` of ``model`` (in eval mode, on the device it
    is on) for ``platforms`` (default ``["cuda"]``), which choose the
    pooling (``keeps_kernel``): the kernel's custom op, or the plain
    pooling of a model on the CPU."""
    check_platforms(platforms)
    model.eval()
    device = next(model.parameters()).device
    kernel = keeps_kernel(platforms)
    if not kernel and device.type != "cpu":
        raise ValueError(f"--platforms {list(platforms)} traces the plain "
                         f"pooling on the CPU: move the model there, not "
                         f"{device}")
    inputs = example_inputs(cfg, batch_size, bag_len, device)
    with mil.pooling_route("op" if kernel else "kernel"):
        return torch.export.export(_Scorer(model), (inputs,))


def _outputs(ep) -> dict:
    """{name: (shape, dtype)} of the program's outputs, from its graph."""
    node = next(n for n in ep.graph.nodes if n.op == "output")
    vals = [a.meta["val"] for a in node.args[0]]
    tree = torch.utils._pytree.tree_unflatten(vals, ep.call_spec.out_spec)
    return {k: {"shape": list(v.shape), "dtype": str(v.dtype).split(".")[-1]}
            for k, v in tree.items()}


def save_scorer(path: str, model: torch.nn.Module, cfg, batch_size: int = 8,
                bag_len: int = 512,
                platforms: Optional[Sequence[str]] = None) -> dict:
    """``export_scorer``, written to ``path`` with ``torch.export.save``,
    and a ``<path>.json`` sidecar with the input and output signatures
    (the JAX sidecar's keys, ``format`` "torch.export", plus ``requires``:
    the modules that loading imports).  Returns the sidecar."""
    ep = export_scorer(model, cfg, batch_size, bag_len, platforms)
    ep.example_inputs = None  # the zeros it was traced on: 16 MB at B=8
    torch.export.save(ep, path)
    names = example_inputs(cfg, batch_size, bag_len, "cpu")
    sidecar = {
        "format": "torch.export",
        "model_type": cfg.model_type,
        "mode": cfg.mode,
        "batch_size": batch_size,
        "bag_len": bag_len,
        "platforms": check_platforms(platforms),
        "inputs": {k: {"shape": list(v.shape),
                       "dtype": str(v.dtype).split(".")[-1]}
                   for k, v in names.items()},
        "outputs": _outputs(ep),
        "requires": [KERNEL_MODULE] if keeps_kernel(platforms) else [],
    }
    with open(path + ".json", "w") as f:
        json.dump(sidecar, f, indent=2)
        f.write("\n")
    return sidecar


def load_scorer(path: str):
    """A saved artifact as ``scorer(inputs)``: the model-input dict (the
    keys and shapes baked at export; see the sidecar) of numpy arrays or
    tensors, to the output dict of tensors.  No model object is built: the
    program holds the graph and the weights, on their export device; a
    kernel artifact calls the custom op that ``ops.mil_attention``
    (imported here) registers."""
    ep = torch.export.load(path)
    module = ep.module()
    dev = next(iter(module.state_dict().values())).device

    def scorer(inputs: dict) -> dict:
        with torch.inference_mode():
            return module({k: torch.as_tensor(v, device=dev)
                           for k, v in inputs.items()})

    scorer.exported = ep
    return scorer
