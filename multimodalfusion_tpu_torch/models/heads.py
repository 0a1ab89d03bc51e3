"""Shared survival-head helpers: logits -> (hazards, S, risk)
(port of multimodalfusion_tpu/models/heads.py)."""
from __future__ import annotations

import torch


def survival_outputs(logits):
    """hazards = sigmoid(logits); S = cumprod(1-hazards); risk = -sum(S)
    (ref model_attention_mil_path.py:59-61, nll_models_pretrained.py:59-61).
    """
    hazards = torch.sigmoid(logits)
    S = torch.cumprod(1.0 - hazards, dim=-1)
    risk = -torch.sum(S, dim=-1)
    Y_hat = torch.argmax(logits, dim=-1)
    return {"logits": logits, "hazards": hazards, "S": S, "risk": risk,
            "Y_hat": Y_hat}


def scalar_risk_outputs(risk):
    """Cox/ranking heads emit a single scalar risk (ref
    coxranking_models_pretrained.py:51-58, model_genomic.py:70-72)."""
    risk = risk.reshape(risk.shape[0]) if risk.dim() > 1 else risk
    return {"logits": None, "hazards": None, "S": None, "risk": risk,
            "Y_hat": None}
