"""JAX-layout parameters -> the port's state_dict, and the reference's
placeholders of unbuilt branches.

The port's own copy of the mapping that the JAX package keeps in
utils/torch_interop.py (``build_spec`` / ``variables_to_torch``): flax
Dense kernels are [in, out], torch Linear weights [out, in].  The keys are
the reference's (ref model_attention_mil_path.py, model_genomic.py,
model_mm_attention_mil.py, model_modules.py), the same the JAX package's
``.pt`` side export writes.

A spec is a list of entries:
  ("linear", torch_prefix, jax_path)
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

import zlib
from collections import OrderedDict
from typing import Dict, Iterator, List, Mapping, Sequence, Tuple

import numpy as np
import torch

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


def _mm_attention_mil_spec(mode: str, fusion: str, radio_fusion: str,
                           gate: bool, gate_path: bool, gate_radio: bool,
                           attn_dropout: bool, n_modalities: int
                           ) -> List[Entry]:
    """MM_MIL_Attention_fc_surv (ref model_mm_attention_mil.py:34-200;
    JAX torch_interop.py:177-245) for the port's modes (path_omic, omic).
    The reference builds the radiology branch, its radio_fusion module
    (from ``radio_fusion`` alone, always for 4 modalities) and the
    pathology branch whatever the mode: the ones the mode lacks are
    placeholders."""
    es: List[Entry] = [
        ("fill_linear", "attention_net_radio.0", (1024, 256)),
        ("fill_attn", "attention_net_radio.3", (256, 256), gate_radio,
         attn_dropout)]
    if radio_fusion == "tensor":
        es.append(("fill_xfusion", "radio_xfusion",
                   (1024, 64, 1024, 1024, 4, True, False)))
    else:
        es.append(("fill_linear", "reduce_dim",
                   (1024 * n_modalities, 1024)))
    if "path" in mode:
        es += [("linear", "attention_net_WSI.0", ["fc_WSI"]),
               ("attn", "attention_net_WSI.3", ["attention_net_WSI"],
                gate_path, attn_dropout)]
    else:
        es += [("fill_linear", "attention_net_WSI.0", (1024, 256)),
               ("fill_attn", "attention_net_WSI.3", (256, 256), gate_path,
                attn_dropout)]
    es += _snn_entries("fc_omic")
    n_branches = ("path" in mode) + ("omic" in mode)
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
               gate_radio: bool = True, n_modalities: int = 4
               ) -> List[Entry]:
    """The spec of a model the port builds (``engine/train.build_model``).
    ``gated`` is the pathology attention net's gate (``gate_path``)."""
    if model_type == "path_attention_mil":
        return [("linear", "attention_net_WSI.0", ["fc"]),
                ("attn", "attention_net_WSI.3", ["attention_net"], gated,
                 attn_dropout),
                ("linear", "classifier", ["classifier"])]
    if model_type == "max_net":
        return _snn_entries("fc_omic") + [("linear", "classifier",
                                           ["classifier"])]
    if model_type == "mm_attention_mil" and "radio" not in mode:
        return _mm_attention_mil_spec(mode, fusion, radio_fusion, gate,
                                      gated, gate_radio, attn_dropout,
                                      n_modalities)
    raise NotImplementedError(
        f"{model_type} (mode {mode}): not ported yet (ROADMAP.md, port "
        "queue: radio AMIL and the radiology branch are item 4, stage-4 "
        "heads item 3)")


def spec_from_config(cfg) -> List[Entry]:
    """The spec of ``build_model(cfg)`` (JAX torch_interop.spec_from_config
    for the port's models)."""
    return build_spec(cfg.model_type, mode=cfg.mode, gated=cfg.gate_path,
                      attn_dropout=cfg.drop_out, fusion=cfg.fusion or "tensor",
                      radio_fusion=cfg.radio_fusion or "concat",
                      gate=cfg.gate, gate_radio=cfg.gate_radio,
                      n_modalities=len(cfg.modalities))


def state_dict_from_jax(model_type, params: Mapping, gated: bool = True,
                        attn_dropout: bool = False, **spec_kw
                        ) -> Dict[str, torch.Tensor]:
    """The port's state_dict for the JAX package's params (a nested dict
    of arrays: ``fc/kernel``, ``attention_net/Wa`` ... ``cc``, ...).
    ``model_type``: a model type (its spec is built from the keyword
    arguments) or a spec.  Placeholders are not included."""
    spec = (build_spec(model_type, gated=gated, attn_dropout=attn_dropout,
                       **spec_kw)
            if isinstance(model_type, str) else model_type)
    sd: Dict[str, torch.Tensor] = OrderedDict()
    for entry in spec:
        kind, prefix = entry[0], entry[1]
        if kind not in ("linear", "attn"):
            continue
        at = params
        for p in entry[2]:
            at = at[p]
        if kind == "linear":
            sd[f"{prefix}.weight"] = _tensor(np.asarray(at["kernel"]).T)
            sd[f"{prefix}.bias"] = _tensor(at["bias"])
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


def _entry_keys(entry: Entry) -> List[str]:
    kind, prefix = entry[0], entry[1]
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
