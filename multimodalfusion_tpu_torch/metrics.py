"""Survival metrics on host arrays (port of the concordance index of
multimodalfusion_tpu/metrics.py; the other metrics come with later
slices)."""
from __future__ import annotations

import numpy as np


def concordance_index_censored(event_indicator, event_time, estimate,
                               tied_tol: float = 1e-8):
    """Harrell's censoring-aware concordance index, with the semantics of
    ``sksurv.metrics.concordance_index_censored``:
      * pair (i, j) is comparable iff event_i and (t_j > t_i, or
        t_j == t_i and j is censored);
      * concordant when estimate_i > estimate_j (shorter survival, higher
        risk); |estimate_i - estimate_j| <= tied_tol counts 0.5.

    Returns (cindex, concordant, discordant, tied_risk, tied_time).
    """
    event = np.asarray(event_indicator, dtype=bool)
    time = np.asarray(event_time, dtype=np.float64)
    est = np.asarray(estimate, dtype=np.float64)
    if not event.any():
        raise ValueError("All samples are censored")

    later = time[None, :] > time[:, None]
    tied_at = (time[None, :] == time[:, None]) & (~event)[None, :]
    comp = event[:, None] & (later | tied_at)
    np.fill_diagonal(comp, False)

    diff = est[:, None] - est[None, :]
    tied_risk_mat = np.abs(diff) <= tied_tol
    concordant = int(np.sum(comp & (diff > 0) & ~tied_risk_mat))
    discordant = int(np.sum(comp & (diff < 0) & ~tied_risk_mat))
    tied_risk = int(np.sum(comp & tied_risk_mat))
    tied_time = int(np.sum(event[:, None] & tied_at))

    denom = concordant + discordant + tied_risk
    if denom == 0:
        raise ValueError("No comparable pairs")
    cindex = (concordant + 0.5 * tied_risk) / denom
    return cindex, concordant, discordant, tied_risk, tied_time
