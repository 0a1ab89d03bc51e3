"""Survival metrics on host arrays (port of the concordance index and the
integrated Brier score of multimodalfusion_tpu/metrics.py:1-156), with
the semantics of ``sksurv.metrics`` that the reference calls (ref
utils/core_utils.py:258,426, utils/core_utils_pretrained.py:537-556)."""
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


def kaplan_meier(event, time):
    """Kaplan-Meier estimate of S(t) = P(T > t): (unique times, survival
    probability), a right-continuous step function."""
    event = np.asarray(event, dtype=bool)
    time = np.asarray(time, dtype=np.float64)
    order = np.argsort(time, kind="stable")
    time, event = time[order], event[order]
    uniq, first_idx = np.unique(time, return_index=True)
    n_at_risk = len(time) - first_idx
    d = np.array([np.sum(event[time == t]) for t in uniq], np.float64)
    frac = np.where(n_at_risk > 0, 1.0 - d / n_at_risk, 1.0)
    return uniq, np.cumprod(frac)


def censoring_survival(event, time):
    """Reverse Kaplan-Meier: G(t) = P(C > t), the censoring distribution.
    At a tied time deaths come before censorings (sksurv's convention):
    the risk set of a censoring at t leaves out the deaths at t."""
    event = np.asarray(event, dtype=bool)
    time = np.asarray(time, dtype=np.float64)
    uniq = np.unique(time)
    G = np.ones(len(uniq))
    g = 1.0
    for k, t in enumerate(uniq):
        at_risk = np.sum(time >= t)
        deaths = np.sum((time == t) & event)
        cens = np.sum((time == t) & ~event)
        denom = at_risk - deaths
        if denom > 0:
            g *= 1.0 - cens / denom
        elif cens > 0:
            g = 0.0
        G[k] = g
    return uniq, G


def _step_lookup(step_times, step_vals, query, before_value=1.0):
    """A right-continuous step function at the query points
    (``before_value`` before its first step)."""
    idx = np.searchsorted(step_times, query, side="right") - 1
    return np.where(idx >= 0, step_vals[np.clip(idx, 0, len(step_vals) - 1)],
                    before_value)


def brier_score(train_event, train_time, test_event, test_time, estimate,
                times):
    """IPCW Brier score at each of ``times`` (sksurv's ``brier_score``).
    ``estimate``: [n_test, n_times], the predicted S(t | x_i) at each
    time.  The censoring distribution G is the training data's reverse
    Kaplan-Meier; a death is weighted by 1 / G(t_i), a survivor past t by
    1 / G(t), and a weight whose G is 0 is 0.  Returns (times, scores)."""
    test_event = np.asarray(test_event, dtype=bool)
    test_time = np.asarray(test_time, dtype=np.float64)
    times = np.asarray(times, dtype=np.float64)
    estimate = np.asarray(estimate, dtype=np.float64)
    if estimate.shape != (len(test_time), len(times)):
        raise ValueError(f"estimate shape {estimate.shape} != "
                         f"({len(test_time)}, {len(times)})")
    g_t, g_v = censoring_survival(train_event, train_time)
    G_ti = _step_lookup(g_t, g_v, test_time)
    w_died = np.where(G_ti > 0, 1.0 / np.where(G_ti > 0, G_ti, 1.0), 0.0)
    scores = np.empty(len(times))
    for k, t in enumerate(times):
        G_t = _step_lookup(g_t, g_v, np.array([t]))[0]
        s = estimate[:, k]
        died = (test_time <= t) & test_event
        alive = test_time > t
        w_alive = (1.0 / G_t) if G_t > 0 else 0.0
        scores[k] = np.mean(died * (s ** 2) * w_died
                            + alive * ((1.0 - s) ** 2) * w_alive)
    return times, scores


def integrated_brier_score(train_event, train_time, test_event, test_time,
                           estimate, times):
    """The trapezoid integral of the Brier score over [times[0],
    times[-1]], divided by that span (sksurv's
    ``integrated_brier_score``)."""
    times, scores = brier_score(train_event, train_time, test_event,
                                test_time, estimate, times)
    if len(times) < 2:
        raise ValueError("need at least two time points")
    area = (np.diff(times) * (scores[1:] + scores[:-1]) / 2.0).sum()
    return area / (times[-1] - times[0])
