"""Per-fold training engine for the stage-2 models (pathology and
radiology attention-MIL, the genomic SNN and their fusion) and the
stage-4 heads over pretrained embeddings (port of
multimodalfusion_tpu/engine/train.py).

The epoch loop feeds fixed-shape bucketed batches through one train step
(forward, survival loss, autograd backward through the fused pooling
kernels, optimizer) and aggregates metrics on the host.  Every random
draw comes from an explicit ``torch.Generator`` seeded from ``cfg.seed``:
the weights from a CPU generator, the dropout masks from one on the
training device, the batch order from numpy as in the JAX package.

Checkpoints are the reference-layout ``.pt`` state_dicts
(``s_{k}_checkpoint.pt``, ``s_{k}_minloss_checkpoint.pt``,
``s_{k}_mid_checkpoint.pt``) that the JAX package writes beside its
msgpack files, with the same placeholders of the branches the mode does
not build (``utils/params.py``); the port writes no msgpack.

On a CUDA device the loader collates the bags into the page-locked
buffers of a ``PinnedPool``, and ``model_inputs`` copies them to the card
with ``non_blocking`` and hands them back to the pool.

Multi-GPU (``--data_parallel``, ``--bag_shard``, ``--bag_shard_devices``;
one process per GPU under torchrun, ``parallel/mesh.py``): each rank's
loader yields its rows of the global batch.  Under data parallelism the
heads' outputs and the labels are gathered over the data group and every
rank computes the JAX package's loss of the global, padded batch (a Cox
risk set spans the ranks); each rank backpropagates it through its own
rows, so the gradients are summed over the data group once, after the
backward.  Under bag sharding the attention pool merges the instance
blocks with collectives (``ops/sharded_pool.py``), which also sum the
attention parameters' gradients; the per-instance layers before it
(``instance_parameters``) see only the block's rows and are summed over
the bag group; the classifier sees the same pooled features on every rank
and is not.  The L1 term's gradient is added after the sums, once.
Dropout bits are the global batch's (``mesh.draw``), so a sharded step
equals the step at world size 1.  Only rank 0 writes files.

Operations (JAX engine/train.py:673-858): after every epoch the fold's
resume bundle is written (``resume_state``: the model, the optimizer, the
``MultiSteps`` accumulator and count, the fold generator's state, the
epoch and the early-stopping fields), as ``s_{k}_resume.pt`` in either
``--ckpt_format`` (every layout of the port replicates what the bundle
holds, so rank 0 writes it alone); ``--resume`` continues from it, so a
resumed fold equals the straight one.  A JAX bundle (``.msgpack`` or
``.orbax``) is refused: its ``rbg`` key cannot continue a
``torch.Generator``.
``--tb`` writes the scalars of ``metrics.jsonl`` as TensorBoard event
files with the port's own writer (``utils/tb_writer.py``).

A stage-4 head trains in train mode, so its ``MaskedBatchNorm``s use the
batch statistics of the valid rows and move their running ones.  With
``multimodal-dropout`` a branch whose modality the whole batch lacks
(all-zero embeddings) is frozen for the step (JAX engine/train.py:
306-360): its parameters and optimizer moments stay where they were,
while its tensors' step counts advance, as JAX's one global count does.
"""
from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from multimodalfusion_tpu_torch import losses as losses_mod
from multimodalfusion_tpu_torch import metrics as metrics_mod
from multimodalfusion_tpu_torch import resolve_device
from multimodalfusion_tpu_torch.data.bags import PinnedPool
from multimodalfusion_tpu_torch.data.loaders import (iter_batches, prefetch,
                                                     usable_indices)
from multimodalfusion_tpu_torch.data.survival_dataset import MODALITIES
from multimodalfusion_tpu_torch.models.amil import PathAMIL, RadioAMIL
from multimodalfusion_tpu_torch.models.genomic import MaxNet
from multimodalfusion_tpu_torch.models.mm_amil import MMAttentionMIL
from multimodalfusion_tpu_torch.models.pretrained_heads import (
    MULTIMODAL_TYPES, UNIMODAL_TYPES, MultimodalPretrained,
    UnimodalPretrained)
from multimodalfusion_tpu_torch.parallel import mesh as par
from multimodalfusion_tpu_torch.parallel.mesh import BAG_AXIS, DATA_AXIS
from multimodalfusion_tpu_torch.utils import tb_writer
from multimodalfusion_tpu_torch.utils import params as params_mod

# the modes each stage-2 model trains and serves in (the JAX CLI's)
_MODES = {"path_attention_mil": ("path",), "radio_attention_mil": ("radio",),
          "max_net": ("omic",),
          "mm_attention_mil": ("radio", "path", "omic", "radio_path",
                               "radio_omic", "path_omic",
                               "radio_path_omic")}


@dataclasses.dataclass
class TrainConfig:
    """The reference CLI knobs that reach the port's engine (ref
    main.py:96-144), with the JAX package's names and defaults, plus
    ``device``.  The knobs of models not ported yet come with them."""
    model_type: str = "max_net"
    mode: str = "omic"
    n_classes: int = 4
    bag_loss: str = "nll_surv"
    alpha_surv: float = 0.0
    nll_ratio: float = 0.2
    reg_type: str = "None"           # None | all | omic_mm
    lambda_reg: float = 1e-4
    lr: float = 2e-4
    reg: float = 1e-5                # weight decay
    opt: str = "adam"
    max_epochs: int = 20
    batch_size: int = 1
    gc: int = 1                      # gradient accumulation steps
    early_stopping: bool = False
    weighted_sample: bool = False
    drop_out: bool = False           # attention-branch dropout
    gate_path: bool = False
    gate_radio: bool = False
    gate: bool = False               # fusion gating (--gate_omic)
    fusion: Optional[str] = None
    radio_fusion: Optional[str] = None
    modalities: Tuple[str, ...] = MODALITIES
    model_size_wsi: str = "small"
    model_size_radio: str = "small"
    model_size_omic: str = "small"
    omic_input_dim: int = 0          # the cohort's genomic columns
    seed: int = 1
    results_dir: str = "./results"
    split_mode: str = "train_val"
    # stage 4 (ref main_pretrained.py:95-135)
    train_type: Optional[str] = None
    n_layers: int = 1
    pretrained: bool = False
    # freeze a branch for a step whose batch lacks its modality; the
    # multimodal-dropout train type implies it
    multimodal_dropout: bool = False
    # engine knobs (no reference equivalent)
    bag_dtype: str = "float32"
    resume: bool = False
    data_parallel: bool = False
    bag_shard: bool = False
    bag_shard_devices: int = 0
    tb: bool = False
    ckpt_format: str = "msgpack"
    device: str = "cuda"             # the port's: where the fold runs


# ---------------------------------------------------------------------------
# model factory + batch adapter
# ---------------------------------------------------------------------------

def _unsupported(cfg: TrainConfig) -> Exception:
    """The error for a model and mode that no CLI of the repo runs."""
    where = f"{cfg.model_type} (mode {cfg.mode})"
    if cfg.model_type not in _MODES:
        return NotImplementedError(f"{where}: not a model of this repo")
    return ValueError(f"{where}: {cfg.model_type} runs in mode "
                      f"{' or '.join(_MODES[cfg.model_type])}")


def _check_head(cfg: TrainConfig) -> None:
    """A stage-4 head: multimodal for mm_attention_mil, unimodal (on the
    one embedding its mode names) for any other model type."""
    if cfg.model_type == "mm_attention_mil":
        if cfg.train_type not in MULTIMODAL_TYPES:
            raise ValueError(f"--train_type {cfg.train_type!r}: the "
                             f"multimodal heads are {MULTIMODAL_TYPES}")
    elif cfg.train_type not in UNIMODAL_TYPES:
        raise ValueError(f"--train_type {cfg.train_type!r}: the unimodal "
                         f"heads are {UNIMODAL_TYPES}")
    elif cfg.mode not in ("radio", "path", "omic"):
        raise ValueError(f"a unimodal head reads one embedding: --mode "
                         f"radio, path or omic, not {cfg.mode!r}")


def _check_model(cfg: TrainConfig) -> None:
    if cfg.pretrained:
        _check_head(cfg)
    elif cfg.mode not in _MODES.get(cfg.model_type, ()):
        raise _unsupported(cfg)


_AMIL = ("path_attention_mil", "radio_attention_mil")


def check_layout(cfg: TrainConfig, world: int) -> None:
    """The JAX package's errors for the multi-device layouts (JAX
    engine/train.py:609-632) at world size ``world``."""
    if not cfg.bag_shard:
        return
    if cfg.model_type not in _AMIL:
        raise ValueError("bag_shard applies to AMIL models only")
    if cfg.data_parallel and not cfg.bag_shard_devices:
        raise ValueError("bag_shard + data_parallel needs "
                         "--bag_shard_devices (bag-axis size of the "
                         "2-D mesh)")
    if world < 2 or not cfg.data_parallel:
        return
    if world % cfg.bag_shard_devices:
        raise ValueError(f"{world} devices not divisible by bag_devices="
                         f"{cfg.bag_shard_devices}")
    n_data = world // cfg.bag_shard_devices
    if cfg.batch_size % n_data:
        raise ValueError(
            f"--batch_size {cfg.batch_size} must be divisible by the "
            f"data-axis size {n_data} of the 2-D mesh (= devices / "
            f"--bag_shard_devices {cfg.bag_shard_devices})")


def check_supported(cfg: TrainConfig) -> None:
    """Raise for a model or mode that no CLI of the repo runs, for a
    checkpoint format that is not one, and for a layout that the launch's
    world size cannot take; nothing is silently ignored."""
    _check_model(cfg)
    if cfg.ckpt_format not in ("msgpack", "orbax"):
        raise ValueError(f"--ckpt_format {cfg.ckpt_format!r}: msgpack or "
                         f"orbax")
    check_layout(cfg, par.launch_world_size())


def build_model(cfg: TrainConfig,
                generator: Optional[torch.Generator] = None,
                bag_mesh: Optional[par.Mesh] = None):
    """Model dispatch (ref core_utils.py:76-98,
    core_utils_pretrained.py:74-87).  The models with a genomic branch
    take its input width from ``cfg.omic_input_dim``; a radiology bag has
    ``len(cfg.modalities)`` sequences.  ``bag_mesh``: a mesh with a "bag"
    axis routes the AMIL attention pooling through the sharded op."""
    _check_model(cfg)
    bag_group = bag_mesh.group(BAG_AXIS) if bag_mesh is not None else None
    if cfg.pretrained:
        head = (MultimodalPretrained if cfg.model_type == "mm_attention_mil"
                else UnimodalPretrained)
        return head(mode=cfg.mode, train_type=cfg.train_type,
                    bag_loss=cfg.bag_loss, n_classes=cfg.n_classes,
                    n_layers=cfg.n_layers, generator=generator)
    if cfg.model_type == "path_attention_mil":
        return PathAMIL(model_size=cfg.model_size_wsi, gate=cfg.gate_path,
                        attn_dropout=cfg.drop_out, n_classes=cfg.n_classes,
                        compute_dtype=cfg.bag_dtype, generator=generator,
                        bag_group=bag_group)
    if cfg.model_type == "radio_attention_mil":
        return RadioAMIL(n_modalities=len(cfg.modalities),
                         radio_fusion=cfg.radio_fusion or "concat",
                         model_size=cfg.model_size_radio,
                         gate=cfg.gate_radio, attn_dropout=cfg.drop_out,
                         n_classes=cfg.n_classes,
                         compute_dtype=cfg.bag_dtype, generator=generator,
                         bag_group=bag_group)
    if "omic" in cfg.mode and cfg.omic_input_dim <= 0:
        raise ValueError(f"{cfg.model_type}: omic_input_dim must be the "
                         f"cohort's number of genomic columns, got "
                         f"{cfg.omic_input_dim}")
    if cfg.model_type == "max_net":
        return MaxNet(cfg.omic_input_dim, model_size=cfg.model_size_omic,
                      bag_loss=cfg.bag_loss, n_classes=cfg.n_classes,
                      generator=generator)
    return MMAttentionMIL(mode=cfg.mode, omic_input_dim=cfg.omic_input_dim,
                          fusion=cfg.fusion or "tensor", gate=cfg.gate,
                          gate_path=cfg.gate_path,
                          attn_dropout=cfg.drop_out,
                          model_size_wsi=cfg.model_size_wsi,
                          model_size_omic=cfg.model_size_omic,
                          n_classes=cfg.n_classes,
                          n_modalities=len(cfg.modalities),
                          radio_fusion=cfg.radio_fusion or "concat",
                          gate_radio=cfg.gate_radio,
                          model_size_radio=cfg.model_size_radio,
                          generator=generator)


def _to(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array on ``device``: an asynchronous copy when the array is
    page-locked, a staged one when it is not, none on the CPU."""
    return torch.from_numpy(arr).to(device, non_blocking=True)


def model_inputs(cfg: TrainConfig, batch: Dict[str, np.ndarray],
                 device: torch.device,
                 pool: Optional[PinnedPool] = None) -> dict:
    """Map a loader batch onto the model's call signature, on ``device``.
    The bag copies are enqueued on the device's current stream; ``pool``,
    which the batch was collated into, gets its buffers back behind
    them."""
    _check_model(cfg)
    if cfg.pretrained:
        # `valid` keeps the padding rows out of the BatchNorm statistics
        return {k: _to(batch[k], device)
                for k in ("h_radio", "h_path", "h_omic", "valid")}
    bags = tuple(f"{m}_{k}" for m in ("radio", "path") if m in cfg.mode
                 for k in ("bags", "mask"))
    if cfg.model_type in ("path_attention_mil", "radio_attention_mil"):
        kw = dict(bags=_to(batch[bags[0]], device),
                  mask=_to(batch[bags[1]], device))
    elif cfg.model_type == "max_net":
        kw = dict(genomic_features=_to(batch["genomic"], device))
    else:
        kw = {k: _to(batch[k], device)
              for k in bags + (("genomic",) if "omic" in cfg.mode else ())}
    if pool is not None and bags:
        pool.release([batch[k] for k in bags],
                     torch.cuda.current_stream(device)
                     if device.type == "cuda" else None)
    return kw


def label_inputs(batch: Dict[str, np.ndarray], device: torch.device
                 ) -> dict:
    """The batch's labels (Y, t, c, valid) as tensors on ``device``."""
    return {k: _to(batch[k], device) for k in ("Y", "t", "c", "valid")}


def load_checkpoint(model: torch.nn.Module, path: str,
                    spec=None) -> torch.nn.Module:
    """Load a reference-layout ``.pt`` state_dict (the JAX package writes
    one beside every checkpoint) into ``model`` on the device the model is
    on: the placeholders that ``spec`` names are dropped, and any other
    missing or unexpected key fails the strict load.  A JAX export of a 2-
    or 3-sequence tensor-fusion radiology model takes its trained fusion
    from the flax checkpoint beside it
    (``params_mod.with_trained_radio_fusion``)."""
    device = next(model.parameters()).device
    sd = torch.load(path, map_location=device, weights_only=True)
    if spec is not None:
        sd = params_mod.without_fillers(sd, spec)
        sd = params_mod.with_trained_radio_fusion(sd, spec, path)
    model.load_state_dict(sd, strict=True)
    return model


def save_checkpoint(path: str, model: torch.nn.Module, spec=None) -> None:
    """Write the model's reference-layout state_dict (CPU tensors), with
    the placeholders that ``spec`` names, to ``path`` atomically (tmp file
    + os.replace), so a kill mid-write leaves no truncated checkpoint."""
    sd = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    if spec is not None:
        sd = params_mod.reference_state_dict(sd, spec)
    tmp = path + ".tmp"
    torch.save(sd, tmp)
    os.replace(tmp, path)


# ---------------------------------------------------------------------------
# resume bundles (JAX engine/train.py:673-695, :846-858)
# ---------------------------------------------------------------------------

_ES_FIELDS = ("es_best", "es_counter", "es_val_loss_min", "es_has_best",
              "stopped")


def resume_state(model: torch.nn.Module, opt, generator: torch.Generator,
                 epoch: int, stopper=None, stopped: bool = False
                 ) -> Dict[str, torch.Tensor]:
    """The fold's resume bundle after ``epoch`` as a flat dict of tensors:
    ``model.*`` (the state_dict), ``optim.{i}.*`` (the optimizer's
    per-parameter state), ``multisteps.*`` (a ``MultiSteps``' running
    mean and count, which carry across epochs), ``generator`` (the fold
    generator's state: a CUDA generator's is its Philox seed and offset),
    ``epoch`` and the early-stopping fields that JAX keeps."""
    inner = opt.opt if isinstance(opt, MultiSteps) else opt
    out = {f"model.{k}": v.detach() for k, v in model.state_dict().items()}
    for i, state in inner.state_dict()["state"].items():
        out.update({f"optim.{i}.{k}": v for k, v in state.items()})
    if isinstance(opt, MultiSteps):
        out["multisteps.count"] = torch.tensor(opt.mini_step)
        out.update({f"multisteps.acc.{i}": a for i, a in enumerate(opt.acc)})
    has_best = stopper is not None and stopper.best_score is not None
    f64 = torch.float64
    out.update(
        generator=generator.get_state(), epoch=torch.tensor(epoch),
        es_best=torch.tensor(stopper.best_score if has_best else 0.0,
                             dtype=f64),
        es_counter=torch.tensor(stopper.counter if stopper else 0),
        es_val_loss_min=torch.tensor(stopper.val_loss_min if stopper
                                     else np.inf, dtype=f64),
        es_has_best=torch.tensor(int(has_best)),
        stopped=torch.tensor(int(stopped)))
    return out


def restore_resume(bundle: Dict[str, torch.Tensor], model: torch.nn.Module,
                   opt, generator: torch.Generator) -> dict:
    """Put a ``resume_state`` bundle (host tensors) back into ``model``,
    ``opt`` and ``generator``; returns the epoch and the early-stopping
    fields as Python numbers."""
    model.load_state_dict({k[len("model."):]: v for k, v in bundle.items()
                           if k.startswith("model.")}, strict=True)
    inner = opt.opt if isinstance(opt, MultiSteps) else opt
    state: Dict[int, dict] = {}
    for k, v in bundle.items():
        if k.startswith("optim."):
            i, name = k[len("optim."):].split(".", 1)
            state.setdefault(int(i), {})[name] = v
    inner.load_state_dict({"state": state,
                           "param_groups": inner.state_dict()["param_groups"]})
    if isinstance(opt, MultiSteps):
        opt.mini_step = int(bundle["multisteps.count"])
        with torch.no_grad():
            for i, a in enumerate(opt.acc):
                a.copy_(bundle[f"multisteps.acc.{i}"])
    generator.set_state(bundle["generator"])
    return {k: bundle[k].item() for k in ("epoch",) + _ES_FIELDS}


def save_resume(path: str, bundle: Dict[str, torch.Tensor]) -> None:
    """Write ``bundle`` by rank 0 alone as one ``torch.save`` file,
    atomically (tmp file + os.replace); every rank calls it."""
    if par.rank() == 0:
        tmp = path + ".tmp"
        torch.save({k: v.cpu() for k, v in bundle.items()}, tmp)
        os.replace(tmp, path)


def load_resume(path: str) -> Dict[str, torch.Tensor]:
    """A bundle written by ``save_resume``, on the host."""
    return torch.load(path, map_location="cpu", weights_only=True)


def _prune_log(log_path: str, start_epoch: int) -> None:
    """Keep the parseable records of ``metrics.jsonl`` below the resume
    point (a SIGKILL can truncate the last line or leave an epoch newer
    than the bundle)."""
    kept = []
    if os.path.exists(log_path):
        for line in open(log_path).read().splitlines():
            try:
                if json.loads(line)["epoch"] < start_epoch:
                    kept.append(line)
            except (json.JSONDecodeError, KeyError):
                pass
        tmp = log_path + ".tmp"
        with open(tmp, "w") as f:
            f.write("".join(line + "\n" for line in kept))
        os.replace(tmp, log_path)


def _tb_scalars(writer, rec: dict) -> None:
    """One epoch's scalars with the reference's exact tags, including its
    'c_index' vs 'c-index' inconsistency (core_utils.py:262-264,338-340)."""
    e = rec["epoch"]
    writer.add_scalar("train/loss_surv", rec["train_loss"], e)
    writer.add_scalar("train/loss", rec.get("train_total", rec["train_loss"]),
                      e)
    writer.add_scalar("train/c_index", rec["train_c_index"], e)
    writer.add_scalar("val/loss_surv", rec["val_loss"], e)
    writer.add_scalar("val/loss", rec.get("val_total", rec["val_loss"]), e)
    writer.add_scalar("val/c-index", rec["val_c_index"], e)


# ---------------------------------------------------------------------------
# optimizer
# ---------------------------------------------------------------------------

class MultiSteps:
    """``optax.MultiSteps(tx, every_k_schedule=k)`` around a torch
    optimizer: every call adds the step's gradients into a running mean
    (``acc + (g - acc) / (n + 1)``, optax's own formula); every k-th call
    hands the mean to the inner optimizer and resets.  Other calls leave
    the parameters and the inner state alone.  The count carries across
    epoch boundaries."""

    def __init__(self, opt: torch.optim.Optimizer, k: int):
        self.opt, self.k = opt, k
        self.mini_step = 0
        self.params = [p for g in opt.param_groups for p in g["params"]]
        self.acc = [torch.zeros_like(p) for p in self.params]

    def zero_grad(self, set_to_none: bool = True) -> None:
        self.opt.zero_grad(set_to_none=set_to_none)

    @torch.no_grad()
    def step(self) -> None:
        n = self.mini_step
        for a, p in zip(self.acc, self.params):
            g = p.grad if p.grad is not None else torch.zeros_like(p)
            a.add_((g - a) / (n + 1))
        if n == self.k - 1:
            for a, p in zip(self.acc, self.params):
                p.grad = a.clone()
            self.opt.step()
            for a in self.acc:
                a.zero_()
            self.mini_step = 0
        else:
            self.mini_step = n + 1


def make_optimizer(cfg: TrainConfig, params):
    """torch.optim.Adam/SGD with L2 weight decay added to the gradient
    before the moment update (ref utils/utils.py:144-151; the JAX
    package's add_decayed_weights -> scale_by_adam, not AdamW).  SGD is
    momentum 0.9 without dampening.  ``gc > 1`` averages gc gradients per
    update (``MultiSteps``)."""
    params = list(params)
    if cfg.opt == "adam":
        opt = torch.optim.Adam(params, lr=cfg.lr, weight_decay=cfg.reg)
    elif cfg.opt == "sgd":
        opt = torch.optim.SGD(params, lr=cfg.lr, momentum=0.9, dampening=0,
                              weight_decay=cfg.reg)
    else:
        raise NotImplementedError(cfg.opt)
    return MultiSteps(opt, cfg.gc) if cfg.gc > 1 else opt


def make_loss_spec(cfg: TrainConfig) -> losses_mod.LossSpec:
    return losses_mod.LossSpec(cfg.bag_loss, alpha=cfg.alpha_surv,
                               nll_ratio=cfg.nll_ratio)


def _reg_fn(cfg: TrainConfig):
    if cfg.reg_type == "all":
        return losses_mod.l1_reg
    if cfg.reg_type == "omic_mm":
        return lambda m: losses_mod.l1_reg_subtree(m, ("fc_omic", "mm"))
    return None


# ---------------------------------------------------------------------------
# multimodal-dropout: the branches a batch freezes
# ---------------------------------------------------------------------------

# the name markers of each modality's branch (JAX engine/train.py:306-310);
# the first modality whose marker a parameter's name holds owns it
_MODALITY_MARKERS = {"radio": ("MRI", "radio"), "path": ("WSI", "path"),
                     "omic": ("omic",)}


def frozen_parameters(model: torch.nn.Module, batch: Dict[str, np.ndarray],
                      group=None) -> List[torch.Tensor]:
    """The parameters of the branches whose modality has all-zero
    embeddings in the whole batch (JAX ``_modality_scale_tree``): with a
    data ``group``, the whole global batch."""
    kinds = [m for m in _MODALITY_MARKERS if f"h_{m}" in batch]
    present = [bool(np.any(np.abs(batch[f"h_{m}"]) > 0)) for m in kinds]
    if group is not None and kinds:
        device = next(model.parameters()).device
        present = par.all_reduce_max(present, group, device)
    absent = {m for m, here in zip(kinds, present) if not here}
    frozen = []
    for name, p in model.named_parameters():
        owner = next((m for m, marks in _MODALITY_MARKERS.items()
                      if any(mk in name for mk in marks)), None)
        if owner in absent:
            frozen.append(p)
    return frozen


@torch.no_grad()
def step_with_frozen(opt: torch.optim.Optimizer,
                     frozen: List[torch.Tensor]) -> None:
    """``opt.step()`` with ``frozen`` held still, as the JAX package's step
    holds a frozen branch: its tensors take a zero gradient, so their
    step counts advance with every other tensor's (JAX keeps one global
    Adam count), and after the step their values and optimizer moments
    are put back (moments a first step creates are zeros, as optax's
    initial moments are), so neither the gradient nor the weight decay
    moves them."""
    saved = []
    for p in frozen:
        p.grad = torch.zeros_like(p)
        saved.append((p.detach().clone(),
                      {k: v.clone() for k, v in opt.state[p].items()
                       if k != "step" and torch.is_tensor(v)}))
    opt.step()
    for p, (value, moments) in zip(frozen, saved):
        p.copy_(value)
        for k, v in opt.state[p].items():
            if k == "step" or not torch.is_tensor(v):
                continue
            if k in moments:
                v.copy_(moments[k])
            else:
                v.zero_()


# ---------------------------------------------------------------------------
# steps
# ---------------------------------------------------------------------------

def _shard_eval_batch(batch: Dict[str, np.ndarray], mesh, device
                      ) -> Optional[par.Shard]:
    """Where this rank's rows of the batch sit in the global batch
    (``mesh.Shard``), or None without a mesh.  The JAX package's
    ``_shard_eval_batch`` places a host batch on the mesh; here the loader
    has already cut this rank's rows (``rows``, ``{kind}_rows``), and
    under data parallelism each rank bucketed its own bags, so the global
    batch's bag length is the longest over the data group."""
    if mesh is None:
        return None
    B = batch["valid"].shape[0]
    rows = tuple(int(v) for v in batch.get("rows", (0, B, B)))
    bags = {k[:-len("_rows")]: tuple(int(v) for v in batch[k])
            for k in batch if k.endswith("_rows")}
    data_group = mesh.group(DATA_AXIS)
    if data_group is not None and bags:
        kinds = sorted(bags)
        lengths = par.all_reduce_max([bags[k][2] for k in kinds], data_group,
                                     device)
        bags = {k: bags[k][:2] + (n,) for k, n in zip(kinds, lengths)}
    return par.Shard(rows, bags, data_group)


def _gather_global(out: dict, lab: dict, group) -> Tuple[dict, dict]:
    """The heads' outputs (differentiable) and the labels of every rank's
    rows, in the global batch's order."""
    keys = [k for k in ("hazards", "S", "risk") if out.get(k) is not None]
    parts = [out[k].reshape(out[k].shape[0], -1) for k in keys]
    got = par.gather_rows(torch.cat(parts, dim=1), group).split(
        [t.shape[1] for t in parts], dim=1)
    out = dict(out)
    for k, t in zip(keys, got):
        out[k] = t.reshape((t.shape[0],) + out[k].shape[1:])
    names = ("Y", "t", "c", "valid")
    lab_all = par.gather_rows(torch.stack(
        [lab[k].to(torch.float32) for k in names], dim=1), group)
    lab = {k: lab_all[:, i].to(lab[k].dtype) for i, k in enumerate(names)}
    return out, lab


def make_steps(cfg: TrainConfig, model: torch.nn.Module, opt,
               device: torch.device, pool: Optional[PinnedPool] = None,
               mesh: Optional[par.Mesh] = None):
    """(train_step(batch, generator), eval_step(batch)) over host batches
    (collated into ``pool``, when given).  Each returns the survival loss
    ``loss``, ``total`` = loss + the L1 term, the batch's ``risk`` and
    ``S`` (None for a scalar-risk head), as tensors, and ``labels``: the
    batch's Y, t, c and valid in numpy.  On a ``mesh`` with a data axis
    these are the global batch's (see the module's docstring)."""
    if cfg.bag_loss in ("ranking_surv", "ranking_nll_surv") \
            and cfg.batch_size < 2:
        # the ranking term has no comparable pairs at B=1 (the reference
        # raises the same way, loss_utils.py:60-61)
        raise ValueError(
            f"{cfg.bag_loss} requires batch_size >= 2 "
            f"(got {cfg.batch_size}); the pairwise ranking term is "
            "identically zero for single-sample batches")
    mm_dropout = (cfg.multimodal_dropout
                  or cfg.train_type == "multimodal-dropout")
    if mm_dropout and cfg.gc > 1:
        raise ValueError(
            "multimodal-dropout freeze masking is incompatible with "
            "gradient accumulation (gc > 1): the aggregated update would "
            "be masked by only the final microbatch's modality presence")
    loss_spec = make_loss_spec(cfg)
    reg_fn = _reg_fn(cfg)
    data_group = mesh.group(DATA_AXIS) if mesh is not None else None
    bag_group = mesh.group(BAG_AXIS) if mesh is not None else None
    instance_params = (model.instance_parameters() if bag_group is not None
                       else [])
    params = list(model.parameters())

    def _forward(batch, **kw):
        with par.local_rows(_shard_eval_batch(batch, mesh, device)):
            out = model(**model_inputs(cfg, batch, device, pool), **kw)
        lab = label_inputs(batch, device)
        if data_group is not None:
            out, lab = _gather_global(out, lab, data_group)
        loss = loss_spec.apply(hazards=out["hazards"], S=out["S"],
                               risks=out["risk"], Y=lab["Y"],
                               times=lab["t"], c=lab["c"],
                               valid=lab["valid"])
        labels = ({k: v.cpu().numpy() for k, v in lab.items()}
                  if data_group is not None else
                  {k: batch[k] for k in ("Y", "t", "c", "valid")})
        return out, loss, labels

    def _reg():
        return cfg.lambda_reg * reg_fn(model)

    def train_step(batch, generator: Optional[torch.Generator]):
        model.train()
        opt.zero_grad(set_to_none=True)
        out, loss, labels = _forward(batch, generator=generator)
        loss.backward()
        if bag_group is not None:
            par.sum_gradients(instance_params, bag_group)
        if data_group is not None:
            par.sum_gradients(params, data_group)
        total = loss
        if reg_fn is not None:
            # after the sums: every rank adds the same L1 gradient once
            reg = _reg()
            reg.backward()
            total = loss + reg
        if mm_dropout:
            step_with_frozen(opt, frozen_parameters(model, batch, data_group))
        else:
            opt.step()
        S = out["S"]
        return {"loss": loss.detach(), "total": total.detach(),
                "risk": out["risk"].detach(),
                "S": None if S is None else S.detach(), "labels": labels}

    @torch.no_grad()
    def eval_step(batch):
        model.eval()
        out, loss, labels = _forward(batch)
        # the reference's val/loss also carries the L1 term
        # (core_utils.py:305-312,337-340)
        total = loss + _reg() if reg_fn is not None else loss
        return {"loss": loss, "total": total, "risk": out["risk"],
                "S": out["S"], "hazards": out["hazards"], "labels": labels}

    return train_step, eval_step


# ---------------------------------------------------------------------------
# early stopping (ref utils/utils.py:167-214)
# ---------------------------------------------------------------------------

class EarlyStopping:
    def __init__(self, warmup=0, patience=20, stop_epoch=100, verbose=False,
                 spec=None):
        self.spec = spec  # the checkpoint's placeholders (utils/params.py)
        self.warmup = warmup
        self.patience = patience
        self.stop_epoch = stop_epoch
        self.verbose = verbose
        self.counter = 0
        self.best_score = None
        self.early_stop = False
        self.val_loss_min = np.inf

    def __call__(self, epoch, val_loss, model, ckpt_name=None):
        score = -val_loss
        if epoch < self.warmup:
            return
        if np.isnan(val_loss):
            # deliberate deviation from ref utils.py:188-197 (as in the JAX
            # package): a NaN val_loss would fall through every comparison
            # into the save branch, overwriting the best checkpoint with
            # diverged weights.  It counts against patience instead.
            self.counter += 1
            if self.verbose:
                print(f"EarlyStopping counter (NaN val loss): "
                      f"{self.counter} / {self.patience}")
            if self.counter >= self.patience and epoch > self.stop_epoch:
                self.early_stop = True
            return
        if self.best_score is None:
            self.best_score = score
            self._save(val_loss, model, ckpt_name)
        elif score < self.best_score:
            self.counter += 1
            if self.verbose:
                print(f"EarlyStopping counter: {self.counter} / "
                      f"{self.patience}")
            if self.counter >= self.patience and epoch > self.stop_epoch:
                self.early_stop = True
        else:
            self.best_score = score
            self._save(val_loss, model, ckpt_name)
            self.counter = 0

    def _save(self, val_loss, model, ckpt_name):
        if ckpt_name is not None:
            save_checkpoint(ckpt_name, model, self.spec)
        self.val_loss_min = val_loss


# ---------------------------------------------------------------------------
# epoch loops
# ---------------------------------------------------------------------------

def _cindex(c, t, risk) -> float:
    try:
        return metrics_mod.concordance_index_censored(
            (1 - c).astype(bool), t, risk)[0]
    except ValueError:
        return float("nan")


def _run_epoch(cfg, split, indices, train_step, eval_step, generator,
               training: bool, seed: int, pool=None, mesh=None) -> dict:
    all_risk, all_c, all_t, losses, totals = [], [], [], [], []
    for batch in prefetch(iter_batches(split, batch_size=cfg.batch_size,
                                       shuffle=training,
                                       weighted=training
                                       and cfg.weighted_sample,
                                       seed=seed, indices=indices,
                                       pool=pool, mesh=mesh)):
        batch.pop("subject_ids")
        out = (train_step(batch, generator) if training
               else eval_step(batch))
        lab = out["labels"]
        valid = lab["valid"] > 0
        all_risk.append(out["risk"].float().cpu().numpy().reshape(-1)[valid])
        all_c.append(lab["c"][valid])
        all_t.append(lab["t"][valid])
        losses.append(float(out["loss"]))
        totals.append(float(out["total"]))
    all_risk = np.concatenate(all_risk) if all_risk else np.zeros(0)
    all_c = np.concatenate(all_c) if all_c else np.zeros(0)
    all_t = np.concatenate(all_t) if all_t else np.zeros(0)
    return {"loss": float(np.mean(losses)) if losses else float("nan"),
            "total": float(np.mean(totals)) if totals else float("nan"),
            "c_index": _cindex(all_c, all_t, all_risk), "risk": all_risk,
            "c": all_c, "t": all_t}


def summary_survival(cfg, split, eval_step, indices=None, pool=None,
                     mesh=None) -> Tuple[dict, float]:
    """Sequential pass collecting per-patient risks (ref
    core_utils.py:358-429): a dict of numpy arrays with the JAX package's
    keys (no ``prob`` for a scalar-risk head), and the c-index.  On a
    data-parallel ``mesh`` every rank returns the global batches'."""
    if indices is None:
        indices = usable_indices(split)
    data_group = mesh.group(DATA_AXIS) if mesh is not None else None
    ids, risk, c, t, label, S = [], [], [], [], [], []
    for batch in prefetch(iter_batches(split, batch_size=cfg.batch_size,
                                       shuffle=False, indices=indices,
                                       pool=pool, mesh=mesh)):
        subject_ids = list(batch.pop("subject_ids"))
        out = eval_step(batch)
        if data_group is not None:
            parts = [None] * dist.get_world_size(data_group)
            dist.all_gather_object(parts, subject_ids, group=data_group)
            subject_ids = [s for part in parts for s in part]
        lab = out["labels"]
        valid = lab["valid"] > 0
        ids.append(np.asarray(subject_ids, dtype=object)[valid])
        risk.append(out["risk"].float().cpu().numpy().reshape(-1)[valid])
        c.append(lab["c"][valid])
        t.append(lab["t"][valid])
        label.append(lab["Y"][valid])
        if out["S"] is not None:
            S.append(out["S"].float().cpu().numpy()[valid])

    def cat(parts):
        return np.concatenate(parts) if parts else np.zeros(0)
    results = {"subject_id": cat(ids), "risk": cat(risk),
               "disc_label": cat(label), "survival": cat(t),
               "censorship": cat(c)}
    if S:
        results["prob"] = np.concatenate(S, axis=0)
    return results, _cindex(results["censorship"], results["survival"],
                            results["risk"])


def _bag_mesh(cfg: TrainConfig) -> Optional[par.Mesh]:
    """The fold's bag or 2-D mesh (JAX engine/train.py:609-640; its
    errors are ``check_layout``'s, raised by ``check_supported`` before
    anything is written)."""
    if not cfg.bag_shard:
        return None
    if par.world_size() < 2:
        print("bag_shard: only one device visible, running unsharded")
        return None
    if cfg.data_parallel:
        mesh = par.make_dp_bag_mesh(cfg.bag_shard_devices)
        print(f"bag_shard x data_parallel: 2-D mesh {mesh.shape}")
        return mesh
    mesh = par.make_bag_mesh()
    print(f"bag_shard: instance axis sharded over {mesh.size} devices")
    return mesh


def _activate_mesh(cfg: TrainConfig, bag_mesh) -> Optional[par.Mesh]:
    """The active mesh: the bag or 2-D mesh of build time, or a fresh
    data-parallel one.  JAX replicates the trees onto it; here every rank
    already holds the same parameters, built from ``cfg.seed`` or loaded
    from one checkpoint."""
    mesh = None
    if cfg.data_parallel and bag_mesh is None:
        if par.world_size() < 2:
            print("data_parallel: only one device visible, "
                  "running unsharded")
        else:
            mesh = par.make_mesh()
            print(f"data_parallel: batch axis sharded over "
                  f"{mesh.size} devices")
    elif bag_mesh is not None:
        mesh = bag_mesh
    return mesh


def _resume(cfg: TrainConfig, cur: int, path: str, model, opt, generator,
            stopper, log_path: Optional[str]) -> int:
    """With ``--resume``: restore the bundle at ``path`` (every rank, after
    a barrier) and the stopper, and return the epoch after it; a fold that
    already stopped early skips to its summary.  Without a bundle, 0; a
    JAX bundle in its place raises.  Either way ``log_path`` (rank 0's) is
    pruned to the epochs before the returned one, so that a kill before
    the first bundle leaves no stale record."""
    if not cfg.resume:
        return 0
    par.barrier()
    if not os.path.exists(path):
        jax_bundle = os.path.join(
            cfg.results_dir, f"s_{cur}_resume."
            + ("orbax" if cfg.ckpt_format == "orbax" else "msgpack"))
        if os.path.exists(jax_bundle):
            raise RuntimeError(
                f"{jax_bundle} is a resume bundle of the JAX package: its "
                f"rbg key cannot continue a torch.Generator, so the port "
                f"cannot resume it.  Resume the fold with the JAX package, "
                f"or remove the file to train the fold from epoch 0")
        if log_path is not None:
            _prune_log(log_path, 0)
        return 0
    state = restore_resume(load_resume(path), model, opt, generator)
    start_epoch = int(state["epoch"]) + 1
    if state["stopped"]:
        # the fold finished by early stopping: training it further would
        # overwrite its checkpoints and metrics with longer-trained ones
        start_epoch = cfg.max_epochs
        print(f"fold {cur} already early-stopped; skipping to summary")
    elif start_epoch < cfg.max_epochs:
        print(f"resuming fold {cur} from epoch {start_epoch}")
    if stopper is not None and state["es_has_best"]:
        # so that the resumed fold cannot clobber the saved best
        # checkpoint with worse weights
        stopper.best_score = state["es_best"]
        stopper.counter = int(state["es_counter"])
        stopper.val_loss_min = state["es_val_loss_min"]
    if log_path is not None:
        _prune_log(log_path, start_epoch)
    return start_epoch


def train_fold(datasets, cur: int, cfg: TrainConfig,
               eval_only: bool = False):
    """Train (or evaluate) one fold; returns the reference's result tuple
    (ref core_utils.py train :21-171): (results_val, val_c) or, with
    split_mode train_val_test, (results_val, val_c, results_test,
    test_c).  Under torch.distributed every rank of the group calls it;
    only rank 0 writes."""
    check_supported(cfg)
    device = resolve_device(cfg.device)
    writer = par.rank() == 0
    fold_dir = os.path.join(cfg.results_dir, str(cur))
    if writer:
        os.makedirs(fold_dir, exist_ok=True)
    log_path = os.path.join(fold_dir, "metrics.jsonl")

    if cfg.split_mode == "train_val_test":
        train_split, val_split, test_split = datasets
    else:
        train_split, val_split = datasets
        test_split = None
    for name, split in (("train", train_split), ("val", val_split),
                        ("test", test_split)):
        if split is None and not (name == "test"
                                  and cfg.split_mode != "train_val_test"):
            raise ValueError(
                f"fold {cur}: the '{name}' split is empty — check the "
                f"'{name}' column of the fold's splits csv (split_mode="
                f"{cfg.split_mode})")

    bag_mesh = _bag_mesh(cfg)
    model = build_model(cfg, torch.Generator().manual_seed(cfg.seed),
                        bag_mesh)
    model = model.to(device)
    spec = params_mod.spec_from_config(cfg)
    opt = make_optimizer(cfg, model.parameters())
    pool = (PinnedPool() if device.type == "cuda" and not cfg.pretrained
            else None)
    generator = torch.Generator(device=device).manual_seed(cfg.seed)

    train_idx = usable_indices(train_split)
    if not train_idx:
        bad = getattr(train_split, "all_nan_genomic_cols", [])
        hint = (f" (genomic columns {bad} are entirely NaN — if they are "
                f"scan-path columns, exclude them via --modality)"
                if bad else "")
        raise ValueError(f"no usable samples in the train split for mode "
                         f"'{cfg.mode}'{hint}")
    val_idx = usable_indices(val_split)
    test_idx = usable_indices(test_split) if test_split is not None else None

    ckpt, minloss_ckpt, mid_ckpt = (
        os.path.join(cfg.results_dir, f"s_{cur}_{name}checkpoint.pt")
        for name in ("", "minloss_", "mid_"))

    def summaries():
        results_val, val_c = summary_survival(cfg, val_split, eval_step,
                                              val_idx, pool, mesh)
        if cfg.split_mode != "train_val_test":
            return results_val, val_c
        results_test, test_c = summary_survival(cfg, test_split, eval_step,
                                                test_idx, pool, mesh)
        return results_val, val_c, results_test, test_c

    if eval_only:
        load_checkpoint(model, minloss_ckpt, spec)
        mesh = _activate_mesh(cfg, bag_mesh)
        train_step, eval_step = make_steps(cfg, model, opt, device, pool,
                                           mesh)
        return summaries()

    mesh = _activate_mesh(cfg, bag_mesh)
    train_step, eval_step = make_steps(cfg, model, opt, device, pool, mesh)
    stopper = (EarlyStopping(warmup=0, patience=20,
                             stop_epoch=100 if not cfg.pretrained else 50,
                             verbose=True, spec=spec)
               if cfg.early_stopping else None)
    resume_path = os.path.join(cfg.results_dir, f"s_{cur}_resume.pt")
    start_epoch = _resume(cfg, cur, resume_path, model, opt, generator,
                          stopper, log_path if writer else None)
    tb = None
    if cfg.tb and writer:
        if cfg.resume:
            # an old event file may hold scalars past the resume point
            # (metrics.jsonl was pruned): drop it and replay the log
            for name in os.listdir(fold_dir):
                if name.startswith("events.out.tfevents"):
                    os.remove(os.path.join(fold_dir, name))
        tb = tb_writer.EventWriter(fold_dir)
        if cfg.resume and os.path.exists(log_path):
            for line in open(log_path).read().splitlines():
                _tb_scalars(tb, json.loads(line))
            tb.flush()
    stop = False
    for epoch in range(start_epoch, cfg.max_epochs):
        t0 = time.time()
        tr = _run_epoch(cfg, train_split, train_idx, train_step, eval_step,
                        generator, True, seed=cfg.seed * 100003 + epoch,
                        pool=pool, mesh=mesh)
        va = _run_epoch(cfg, val_split, val_idx, train_step, eval_step,
                        generator, False, seed=0, pool=pool, mesh=mesh)
        rec = {"epoch": epoch, "train_loss": tr["loss"],
               "train_c_index": tr["c_index"], "val_loss": va["loss"],
               "val_c_index": va["c_index"],
               "train_total": tr["total"], "val_total": va["total"],
               "sec": time.time() - t0}
        print(f"fold {cur} epoch {epoch}: "
              f"train_loss {tr['loss']:.4f} c {tr['c_index']:.4f} | "
              f"val_loss {va['loss']:.4f} c {va['c_index']:.4f} "
              f"({rec['sec']:.1f}s)")
        if writer:
            with open(log_path, "a") as f:
                f.write(json.dumps(rec) + "\n")
            if tb is not None:
                _tb_scalars(tb, rec)
                tb.flush()
            if epoch == 10:
                save_checkpoint(mid_ckpt, model, spec)  # ref core_utils:342
        if stopper is not None:
            # every rank sees the same val loss and decides alike
            stopper(epoch, va["loss"], model,
                    minloss_ckpt if writer else None)
            if stopper.early_stop:
                print("Early stopping")
                stop = True
        save_resume(resume_path, resume_state(model, opt, generator, epoch,
                                               stopper, stop))
        if stop:
            break

    if tb is not None:
        tb.close()
    if writer:
        save_checkpoint(ckpt, model, spec)
    _, final_val_c = summary_survival(cfg, val_split, eval_step, val_idx,
                                      pool, mesh)
    if cfg.early_stopping:
        par.barrier()  # rank 0 has written its checkpoints
    if cfg.early_stopping and os.path.exists(minloss_ckpt):
        load_checkpoint(model, minloss_ckpt, spec)
    elif writer:
        # no early stopping: minloss == final (keep downstream contracts)
        save_checkpoint(minloss_ckpt, model, spec)
    out = summaries()
    print(f"Final Val c-Index: {final_val_c:.4f}")
    print(f"EarlyStopping Val c-Index: {out[1]:.4f}")
    if cfg.split_mode == "train_val_test":
        print(f"EarlyStopping Test c-Index: {out[3]:.4f}")
    return out
