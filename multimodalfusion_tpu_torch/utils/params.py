"""JAX-layout parameters -> the port's state_dict, and the reference's
placeholders of unbuilt branches.

The port's own copy of the mapping that the JAX package keeps in
utils/torch_interop.py (``build_spec`` / ``variables_to_torch``): flax
Dense kernels are [in, out], torch Linear weights [out, in].  The keys are
the reference's (ref model_attention_mil_{path,radio}.py, model_genomic.py,
model_mm_attention_mil.py, model_modules.py, nll_models_pretrained.py,
coxranking_models_pretrained.py), the same the JAX package's ``.pt`` side
export writes, BatchNorm running statistics included.

A spec is a list of entries:
  ("linear", torch_prefix, jax_path)
  ("bn", torch_prefix, jax_path)     BatchNorm: params scale/bias and the
                                     batch_stats mean/var
  ("attn", torch_prefix, jax_path, gated, attn_dropout)
  ("fill_linear", torch_prefix, (in, out))
  ("fill_attn", torch_prefix, (L, D), gated, attn_dropout)
  ("fill_xfusion", torch_prefix, (dim, scale_dim, mmhid1, mmhid2, n_mod,
                                  gate, skip))
The ``fill_*`` entries are branches the reference builds whatever the mode
and the port (like the JAX package) does not: a checkpoint carries them as
deterministic placeholders, so it loads strictly in the reference, and a
load drops exactly their keys.
"""
from __future__ import annotations

import os
import zlib
from collections import OrderedDict
from typing import Dict, Iterator, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from multimodalfusion_tpu_torch.models.pretrained_heads import (
    LATE_NAMES, is_nll, present_modalities)
from multimodalfusion_tpu_torch.models.resnet import STAGE_SIZES
from multimodalfusion_tpu_torch.utils import msgpack_io

Entry = Tuple


def _tensor(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32, order="C",
                                     copy=True))


def _attn_pairs(prefix: str, gated: bool, attn_dropout: bool
                ) -> List[Tuple[str, str, str]]:
    """(torch module prefix, weight name, bias name) of an attention net."""
    if gated:
        return [(f"{prefix}.attention_a.0", "Wa", "ba"),
                (f"{prefix}.attention_b.0", "Wb", "bb"),
                (f"{prefix}.attention_c", "wc", "cc")]
    last = f"{prefix}.module.3" if attn_dropout else f"{prefix}.module.2"
    return [(f"{prefix}.module.0", "Wa", "ba"), (last, "wc", "cc")]


def _snn_entries(prefix: str, n_blocks: int = 2) -> List[Entry]:
    """MaxNet-style SNN stack (ref model_genomic.py:21-25): the SNN_Block
    Sequential nests the Linear at .0 (JAX torch_interop.py:119-123)."""
    return [("linear", f"{prefix}.{i}.0", [f"fc_omic_{i}", "Dense_0"])
            for i in range(n_blocks)]


def _xfusion_entries(prefix: str, path: List[str], n_mod: int,
                     gate: bool = True) -> List[Entry]:
    """XlinearFusion (ref model_modules.py:113-178; JAX
    torch_interop.py:60-77): per-modality reduce Linears + two encoders."""
    es: List[Entry] = []
    for i in range(n_mod):
        es.append(("linear", f"{prefix}.reduce.{i}.0.0",
                   path + [f"reduce_{i}_h"]))
        if gate:
            es.append(("linear", f"{prefix}.reduce.{i}.1.0",
                       path + [f"reduce_{i}_z"]))
        es.append(("linear", f"{prefix}.reduce.{i}.{2 if gate else 1}.0",
                   path + [f"reduce_{i}_o"]))
    es.append(("linear", f"{prefix}.encoder1.0", path + ["encoder1"]))
    es.append(("linear", f"{prefix}.encoder2.0", path + ["encoder2"]))
    return es


def _highway_entries(prefix: str, path: List[str], n_layers: int
                     ) -> List[Entry]:
    """Highway (ref model_modules.py:5-26; JAX torch_interop.py:88-96)."""
    es: List[Entry] = [("bn", f"{prefix}.bn1", path + ["bn1"]),
                       ("bn", f"{prefix}.bn2", path + ["bn2"])]
    for i in range(n_layers):
        es += [("linear", f"{prefix}.{name}.{i}", path + [f"{name}_{i}"])
               for name in ("nonlinear", "linear", "gate")]
    return es


def _residual_entries(prefix: str, path: List[str], n_layers: int
                      ) -> List[Entry]:
    """Residual stack (ref model_modules.py:28-59; JAX
    torch_interop.py:99-108)."""
    es: List[Entry] = []
    for i in range(n_layers):
        base, sub = f"{prefix}.blocks.{i}", path + [f"ResidualBlock_{i}"]
        es += [("linear", f"{base}.fc1", sub + ["Dense_0"]),
               ("bn", f"{base}.bn1", sub + ["BatchNorm_0"]),
               ("linear", f"{base}.fc2", sub + ["Dense_1"]),
               ("bn", f"{base}.bn2", sub + ["BatchNorm_1"])]
    return es


def _unimodal_pretrained_spec(train_type: str, bag_loss: str,
                              n_layers: int) -> List[Entry]:
    """UnimodalPretrained (ref nll_models_pretrained.py:14-62,
    coxranking_models_pretrained.py:14-58; JAX torch_interop.py:248-266)."""
    if train_type == "fcnn":
        if is_nll(bag_loss):
            return [("linear", "classifier.0", ["classifier"])]
        return [("linear", "classifier.0", ["classifier_0"]),
                ("bn", "classifier.1", ["classifier_bn"]),
                ("linear", "classifier.4", ["classifier_1"])]
    if train_type == "highway":
        es = _highway_entries("highway", ["highway"], n_layers)
    elif train_type == "residual":
        es = _residual_entries("residual", ["residual"], n_layers)
    else:
        raise ValueError(f"train_type {train_type!r} of a unimodal head")
    return es + [("linear", "classifier", ["classifier"])]


def _multimodal_pretrained_spec(mode: str, train_type: str, bag_loss: str,
                                n_layers: int) -> List[Entry]:
    """MultimodalPretrained (ref nll_models_pretrained.py:66-197,
    coxranking_models_pretrained.py:62-183; JAX
    torch_interop.py:269-305).  multimodal-dropout builds late-fcnn."""
    if train_type == "multimodal-dropout":
        train_type = "late-fcnn"
    present = present_modalities(mode)
    es: List[Entry] = []
    if train_type == "late-fcnn":
        for m in present:
            t = f"layer_{LATE_NAMES[m]}"
            es += [("linear", f"{t}.0", [f"{t}_0"]),
                   ("bn", f"{t}.1", [f"{t}_bn"])]
            if not is_nll(bag_loss):
                es.append(("linear", f"{t}.4", [f"{t}_1"]))
        es.append(("linear", "classifier.0", ["classifier"]))
    elif train_type == "early-fcnn":
        es += [("linear", "classifier.0", ["classifier_0"]),
               ("bn", "classifier.1", ["classifier_bn"]),
               ("linear", "classifier.4", ["classifier_1"])]
    elif train_type == "early-highway":
        es += _highway_entries("highway", ["highway"], n_layers)
        es.append(("linear", "classifier", ["classifier"]))
    elif train_type == "late-highway":
        for m in present:
            es += _highway_entries(f"highway_{m}", [f"highway_{m}"],
                                   n_layers)
        es.append(("linear", "classifier", ["classifier"]))
    elif train_type == "kronecker":
        es += _xfusion_entries("xfusion", ["xfusion"], len(present))
        es.append(("linear", "classifier", ["classifier"]))
    else:
        raise ValueError(f"train_type {train_type!r} of a multimodal head")
    return es


# the reference's radiology fusion, built for 4 sequences whatever their
# number (model_mm_attention_mil.py:57, model_attention_mil_radio.py:29)
RADIO_XFUSION_PLACEHOLDER = ("fill_xfusion", "radio_xfusion",
                             (1024, 64, 1024, 1024, 4, True, False))


def _radio_fusion_entries(radio_fusion: str, built: bool,
                          n_modalities: int) -> List[Entry]:
    """The radiology sequences' fusion: ``radio_xfusion`` (tensor) or
    ``reduce_dim`` (concat).  The reference builds it from
    ``radio_fusion`` alone, whatever the mode and the number of
    sequences, and ``radio_xfusion`` always for 4 sequences
    (model_mm_attention_mil.py:56-61, model_attention_mil_radio.py:
    28-32): a model that does not build it (no radiology branch, or one
    sequence) carries a placeholder of the reference's shapes.  A model
    that builds it carries its own parameters, at its own number of
    sequences.  (For 2 or 3 sequences with tensor fusion the JAX export
    writes the 4-sequence placeholder there instead, JAX
    torch_interop.py:80-92: ``with_trained_radio_fusion`` takes the
    trained fusion from the flax checkpoint beside such a ``.pt``.)"""
    if radio_fusion == "tensor":
        if built:
            return _xfusion_entries("radio_xfusion", ["radio_xfusion"],
                                    n_modalities)
        return [RADIO_XFUSION_PLACEHOLDER]
    if built:
        return [("linear", "reduce_dim", ["reduce_dim"])]
    return [("fill_linear", "reduce_dim", (1024 * n_modalities, 1024))]


def _mm_attention_mil_spec(mode: str, fusion: str, radio_fusion: str,
                           gate: bool, gate_path: bool, gate_radio: bool,
                           attn_dropout: bool, n_modalities: int,
                           omic_input_dim: int = 0) -> List[Entry]:
    """MM_MIL_Attention_fc_surv (ref model_mm_attention_mil.py:34-200;
    JAX torch_interop.py:177-245).  The reference builds the radiology
    branch, its sequences' fusion, the pathology branch and the genomic
    SNN whatever the mode: the ones the mode lacks are placeholders (the
    SNN's only with the cohort's genomic width, ``omic_input_dim``)."""
    if "radio" in mode:
        es: List[Entry] = [
            ("linear", "attention_net_radio.0", ["fc_radio"]),
            ("attn", "attention_net_radio.3", ["attention_net_radio"],
             gate_radio, attn_dropout)]
    else:
        es = [("fill_linear", "attention_net_radio.0", (1024, 256)),
              ("fill_attn", "attention_net_radio.3", (256, 256), gate_radio,
               attn_dropout)]
    es += _radio_fusion_entries(radio_fusion,
                                "radio" in mode and n_modalities > 1,
                                n_modalities)
    if "path" in mode:
        es += [("linear", "attention_net_WSI.0", ["fc_WSI"]),
               ("attn", "attention_net_WSI.3", ["attention_net_WSI"],
                gate_path, attn_dropout)]
    else:
        es += [("fill_linear", "attention_net_WSI.0", (1024, 256)),
               ("fill_attn", "attention_net_WSI.3", (256, 256), gate_path,
                attn_dropout)]
    if "omic" in mode:
        es += _snn_entries("fc_omic")
    elif omic_input_dim > 0:
        es += [("fill_linear", "fc_omic.0.0", (omic_input_dim, 256)),
               ("fill_linear", "fc_omic.1.0", (256, 256))]
    n_branches = sum(m in mode for m in ("radio", "path", "omic"))
    if fusion == "tensor":
        es += _xfusion_entries("mm", ["mm"], n_branches, gate=gate)
        # classifier = Sequential(Linear(512, 256), ReLU, Dropout, Linear)
        es += [("linear", "classifier.0", ["classifier_0"]),
               ("linear", "classifier.3", ["classifier_1"])]
    else:
        es.append(("linear", "classifier", ["classifier"]))
    return es


def build_spec(model_type: str, *, mode: str = "path", gated: bool = True,
               attn_dropout: bool = False, fusion: str = "tensor",
               radio_fusion: str = "concat", gate: bool = True,
               gate_radio: bool = True, n_modalities: int = 4,
               omic_input_dim: int = 0, pretrained: bool = False,
               train_type: Optional[str] = None, bag_loss: str = "nll_surv",
               n_layers: int = 1) -> List[Entry]:
    """The spec of a model the port builds (``engine/train.build_model``).
    ``gated`` is the gate of a path or radio AMIL's attention net, and of
    mm_attention_mil's pathology one (``gate_radio`` its radiology one).
    With ``pretrained``, the stage-4 head of ``train_type``: multimodal
    for ``mm_attention_mil``, unimodal otherwise."""
    if pretrained:
        if model_type == "mm_attention_mil":
            return _multimodal_pretrained_spec(mode, train_type, bag_loss,
                                               n_layers)
        return _unimodal_pretrained_spec(train_type, bag_loss, n_layers)
    if model_type in ("path_attention_mil", "radio_attention_mil"):
        net = ("attention_net_WSI" if model_type == "path_attention_mil"
               else "attention_net_radio")
        es = [("linear", f"{net}.0", ["fc"]),
              ("attn", f"{net}.3", ["attention_net"], gated, attn_dropout),
              ("linear", "classifier", ["classifier"])]
        if model_type == "radio_attention_mil":
            es += _radio_fusion_entries(radio_fusion, n_modalities > 1,
                                        n_modalities)
        return es
    if model_type == "max_net":
        return _snn_entries("fc_omic") + [("linear", "classifier",
                                           ["classifier"])]
    if model_type == "mm_attention_mil":
        return _mm_attention_mil_spec(mode, fusion, radio_fusion, gate,
                                      gated, gate_radio, attn_dropout,
                                      n_modalities, omic_input_dim)
    raise NotImplementedError(f"{model_type}: not a model of this repo")


def spec_from_config(cfg) -> List[Entry]:
    """The spec of ``build_model(cfg)`` (JAX torch_interop.spec_from_config
    for the port's models)."""
    gated = (cfg.gate_radio if cfg.model_type == "radio_attention_mil"
             else cfg.gate_path)
    return build_spec(cfg.model_type, mode=cfg.mode, gated=gated,
                      attn_dropout=cfg.drop_out, fusion=cfg.fusion or "tensor",
                      radio_fusion=cfg.radio_fusion or "concat",
                      gate=cfg.gate, gate_radio=cfg.gate_radio,
                      n_modalities=len(cfg.modalities),
                      omic_input_dim=cfg.omic_input_dim,
                      pretrained=cfg.pretrained, train_type=cfg.train_type,
                      bag_loss=cfg.bag_loss, n_layers=cfg.n_layers)


def _at(tree: Mapping, path: Sequence[str]):
    for p in path:
        tree = tree[p]
    return tree


def state_dict_from_jax(model_type, params: Mapping, gated: bool = True,
                        attn_dropout: bool = False,
                        batch_stats: Optional[Mapping] = None, **spec_kw
                        ) -> Dict[str, torch.Tensor]:
    """The port's state_dict for the JAX package's params (a nested dict
    of arrays: ``fc/kernel``, ``attention_net/Wa`` ... ``cc``, ...) and,
    for a model with BatchNorm, its ``batch_stats`` (the running mean and
    var; without them a BatchNorm gets zeros and ones and
    ``num_batches_tracked`` is 0, as the JAX export writes).
    ``model_type``: a model type (its spec is built from the keyword
    arguments) or a spec.  Placeholders are not included."""
    spec = (build_spec(model_type, gated=gated, attn_dropout=attn_dropout,
                       **spec_kw)
            if isinstance(model_type, str) else model_type)
    sd: Dict[str, torch.Tensor] = OrderedDict()
    for entry in spec:
        kind, prefix = entry[0], entry[1]
        if kind not in ("linear", "attn", "bn"):
            continue
        at = _at(params, entry[2])
        if kind == "linear":
            sd[f"{prefix}.weight"] = _tensor(np.asarray(at["kernel"]).T)
            sd[f"{prefix}.bias"] = _tensor(at["bias"])
        elif kind == "bn":
            stats = (None if batch_stats is None
                     else _at(batch_stats, entry[2]))
            n = np.asarray(at["scale"]).shape[0]
            sd[f"{prefix}.weight"] = _tensor(at["scale"])
            sd[f"{prefix}.bias"] = _tensor(at["bias"])
            sd[f"{prefix}.running_mean"] = _tensor(
                np.zeros(n) if stats is None else stats["mean"])
            sd[f"{prefix}.running_var"] = _tensor(
                np.ones(n) if stats is None else stats["var"])
            sd[f"{prefix}.num_batches_tracked"] = torch.tensor(
                0, dtype=torch.long)
        else:
            for tp, w, b in _attn_pairs(prefix, entry[3], entry[4]):
                sd[f"{tp}.weight"] = _tensor(np.asarray(at[w]).T)
                sd[f"{tp}.bias"] = _tensor(at[b])
    return sd


# ---------------------------------------------------------------------------
# placeholders of the branches the port does not build
# ---------------------------------------------------------------------------

def _fill_layers(entry: Entry) -> Iterator[Tuple[str, int, int]]:
    """(torch prefix, in, out) of each Linear of a ``fill_*`` entry, in the
    JAX export's order (JAX torch_interop.py:381-410)."""
    kind, prefix = entry[0], entry[1]
    if kind == "fill_linear":
        yield (prefix, *entry[2])
    elif kind == "fill_attn":
        (L, D), gated, dropout = entry[2], entry[3], entry[4]
        dims = {"Wa": (L, D), "Wb": (L, D), "wc": (D, 1)}
        for tp, w, _ in _attn_pairs(prefix, gated, dropout):
            yield (tp, *dims[w])
    elif kind == "fill_xfusion":
        dim_og, scale_dim, mmhid1, mmhid2, n_mod, gate, skip = entry[2]
        d = dim_og // scale_dim
        for i in range(n_mod):
            yield (f"{prefix}.reduce.{i}.0.0", dim_og, d)
            if gate:
                yield (f"{prefix}.reduce.{i}.1.0", dim_og * n_mod, d)
                yield (f"{prefix}.reduce.{i}.2.0", d, d)
            else:
                yield (f"{prefix}.reduce.{i}.1.0", d, d)
        yield (f"{prefix}.encoder1.0", (d + 1) ** n_mod, mmhid1)
        yield (f"{prefix}.encoder2.0",
               mmhid1 + (dim_og * n_mod if skip else 0), mmhid2)


_BN_KEYS = ("weight", "bias", "running_mean", "running_var",
            "num_batches_tracked")


def _entry_keys(entry: Entry) -> List[str]:
    kind, prefix = entry[0], entry[1]
    if kind == "bn":
        return [f"{prefix}.{k}" for k in _BN_KEYS]
    if kind == "linear":
        prefixes = [prefix]
    elif kind == "attn":
        prefixes = [tp for tp, _, _ in _attn_pairs(prefix, *entry[3:5])]
    else:
        prefixes = [tp for tp, _, _ in _fill_layers(entry)]
    return [f"{p}.{k}" for p in prefixes for k in ("weight", "bias")]


def filler_keys(spec: Sequence[Entry]) -> List[str]:
    """The state_dict keys of the spec's placeholders."""
    return [k for entry in spec if entry[0].startswith("fill_")
            for k in _entry_keys(entry)]


def without_fillers(sd: Mapping, spec: Sequence[Entry]) -> Dict:
    """A reference-layout state_dict without exactly the spec's
    placeholder keys (whatever else it holds stays, for a strict load to
    judge)."""
    fill = set(filler_keys(spec))
    return OrderedDict((k, v) for k, v in sd.items() if k not in fill)


def reference_state_dict(model_sd: Mapping, spec: Sequence[Entry]) -> Dict:
    """The model's state_dict plus the spec's placeholders, in the JAX
    export's key order: the key set the reference loads strictly."""
    keys = [k for entry in spec for k in _entry_keys(entry)]
    if sorted(set(keys) - set(filler_keys(spec))) != sorted(model_sd):
        raise ValueError(f"the model's keys differ from its spec: "
                         f"{sorted(set(model_sd) ^ set(keys))}")
    src = dict(model_sd)
    src.update(filler_state_dict(spec))
    return OrderedDict((k, src[k]) for k in keys)


def filler_state_dict(spec: Sequence[Entry]) -> Dict[str, torch.Tensor]:
    """The spec's placeholders as the JAX export writes them: Xavier-normal
    weights from a numpy generator seeded with the CRC-32 of the prefix
    and zero biases; weights of more than 4M entries are zeros."""
    sd: Dict[str, torch.Tensor] = OrderedDict()
    for entry in spec:
        if not entry[0].startswith("fill_"):
            continue
        for prefix, n_in, n_out in _fill_layers(entry):
            if n_in * n_out > 4_000_000:
                w = np.zeros((n_out, n_in), np.float32)
            else:
                std = float(np.sqrt(2.0 / (n_in + n_out)))
                rng = np.random.default_rng(zlib.crc32(prefix.encode()))
                w = rng.normal(0.0, std, size=(n_out, n_in)).astype(
                    np.float32)
            sd[f"{prefix}.weight"] = torch.from_numpy(w)
            sd[f"{prefix}.bias"] = torch.zeros(n_out)
    return sd


def with_trained_radio_fusion(sd: Mapping, spec: Sequence[Entry],
                              path: str) -> Mapping:
    """``sd`` (loaded from ``path``) with the trained radiology fusion of a
    2- or 3-sequence tensor model in place of the 4-sequence placeholder
    that the JAX export writes there (JAX torch_interop.py:80-92): the
    fusion comes from the flax checkpoint that JAX training writes beside
    every ``.pt`` (``s_{k}_*_checkpoint.msgpack``, JAX
    engine/train.py:420-440), ``params/radio_xfusion``, mapped by
    ``state_dict_from_jax``.  Any other ``sd`` is returned as it is.
    Without that file it raises ``RuntimeError``, naming it."""
    built = [e for e in spec
             if e[0] == "linear" and e[1].startswith("radio_xfusion.")]
    placeholder = set(_entry_keys(RADIO_XFUSION_PLACEHOLDER))
    have = {k for k in sd if k.startswith("radio_xfusion.")}
    if (not built or have != placeholder
            or {k for e in built for k in _entry_keys(e)} == placeholder):
        return sd
    n_seq = sum(e[2][-1].startswith("reduce_") and e[2][-1].endswith("_h")
                for e in built)
    flax_path = os.path.splitext(path)[0] + ".msgpack"
    if not os.path.exists(flax_path):
        raise RuntimeError(
            f"{path} holds the reference's 4-sequence radio_xfusion "
            f"placeholder where this {n_seq}-sequence tensor-fusion model's "
            f"trained fusion should be (the JAX export writes it so); the "
            f"trained fusion is read from the flax checkpoint beside it, "
            f"{flax_path}, which does not exist")
    fusion = state_dict_from_jax(built, msgpack_io.read(flax_path)["params"])
    device = next(iter(sd.values())).device
    out = OrderedDict((k, v) for k, v in sd.items() if k not in placeholder)
    out.update((k, v.to(device)) for k, v in fusion.items())
    return out


# ---------------------------------------------------------------------------
# the truncated ResNet50 of stage 1
# ---------------------------------------------------------------------------

def resnet_state_dict_from_flax(variables: Mapping
                                ) -> Dict[str, torch.Tensor]:
    """The torchvision-layout state_dict of the JAX package's
    ``ResNet50Trunc`` variables ({'params', 'batch_stats'}): the inverse
    of JAX ``port_torch_state_dict`` (models/resnet.py:139-182).  Conv
    kernels HWIO -> OIHW; BatchNorm ``scale``/``bias`` -> ``weight``/
    ``bias`` and ``mean``/``var`` -> ``running_mean``/``running_var``.
    The stem kernel has its canonical [7, 7, 3, 64] shape whether or not
    the JAX model ran the space-to-depth stem."""
    params, stats = variables["params"], variables["batch_stats"]
    sd: Dict[str, torch.Tensor] = OrderedDict()

    def conv(torch_key, node):
        sd[torch_key] = _tensor(np.transpose(np.asarray(node["kernel"]),
                                             (3, 2, 0, 1)))

    def bn(torch_prefix, path):
        p, s = _at(params, path), _at(stats, path)
        sd[f"{torch_prefix}.weight"] = _tensor(p["scale"])
        sd[f"{torch_prefix}.bias"] = _tensor(p["bias"])
        sd[f"{torch_prefix}.running_mean"] = _tensor(s["mean"])
        sd[f"{torch_prefix}.running_var"] = _tensor(s["var"])

    conv("conv1.weight", params["conv1"])
    bn("bn1", ["bn1"])
    for stage, n_blocks in enumerate(STAGE_SIZES, start=1):
        for i in range(n_blocks):
            t, f = f"layer{stage}.{i}", f"layer{stage}_{i}"
            for c in (1, 2, 3):
                conv(f"{t}.conv{c}.weight", params[f][f"conv{c}"])
                bn(f"{t}.bn{c}", [f, f"bn{c}"])
            if "downsample_conv" in params[f]:
                conv(f"{t}.downsample.0.weight", params[f]["downsample_conv"])
                bn(f"{t}.downsample.1", [f, "downsample_bn"])
    return sd
