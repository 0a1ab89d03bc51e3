"""JAX-layout parameters -> the port's state_dict.

The port's own copy of the mapping that the JAX package keeps in
utils/torch_interop.py (``build_spec`` / ``variables_to_torch``): flax
Dense kernels are [in, out], torch Linear weights [out, in].  The keys are
the reference's (ref model_attention_mil_path.py, model_modules.py:70-110),
the same the JAX package's ``.pt`` side export writes.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Dict, List, Mapping, Tuple

import numpy as np
import torch


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


def state_dict_from_jax(model_type: str, params: Mapping, gated: bool = True,
                        attn_dropout: bool = False
                        ) -> Dict[str, torch.Tensor]:
    """The port's state_dict for the JAX package's params of
    ``model_type`` (a nested dict of arrays: ``fc/kernel``,
    ``attention_net/Wa`` ... ``cc``, ``classifier/*``)."""
    if model_type != "path_attention_mil":
        raise NotImplementedError(
            f"{model_type}: the port serves path_attention_mil only so far "
            "(ROADMAP.md, port queue: radio AMIL is item 3, omic and "
            "stage-4 heads item 4)")
    sd: Dict[str, torch.Tensor] = OrderedDict()

    def linear(prefix, node, w="kernel", b="bias"):
        sd[f"{prefix}.weight"] = _tensor(np.asarray(node[w]).T)
        sd[f"{prefix}.bias"] = _tensor(node[b])

    linear("attention_net_WSI.0", params["fc"])
    for prefix, w, b in _attn_pairs("attention_net_WSI.3", gated,
                                    attn_dropout):
        linear(prefix, params["attention_net"], w, b)
    linear("classifier", params["classifier"])
    return sd
