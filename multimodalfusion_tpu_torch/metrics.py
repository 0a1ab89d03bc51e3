"""Survival metrics on host arrays (port of multimodalfusion_tpu/
metrics.py: the concordance index, the integrated Brier score, the IPCW
c-index and time-dependent AUC of the reporting stage, and per-bin
survival stepped onto query times), with the
semantics of ``sksurv.metrics`` that the reference calls (ref
utils/core_utils.py:258,426, utils/core_utils_pretrained.py:537-556,
utils_analysis/evaluation.py:577-578)."""
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

    comp, tied_at = _comparable(event, time)
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
    return _trapezoid(scores, times) / (times[-1] - times[0])


def _trapezoid(y, x):
    """``np.trapezoid(y, x)`` of 1-D arrays, in its order of operations
    (numpy before 2.0 has no ``trapezoid``)."""
    return (np.diff(x) * (y[1:] + y[:-1]) / 2.0).sum()


def _ipcw_weights(train_event, train_time, test_event, test_time):
    """1 / G(t_i) for the test events (0 for the censored), G the training
    cohort's censoring survival (reverse Kaplan-Meier), as sksurv's
    ``CensoringDistributionEstimator.predict_ipcw``; a time past the last
    training time takes G's last value.  A zero G at an event raises."""
    g_t, g_v = censoring_survival(train_event, train_time)
    test_event = np.asarray(test_event, dtype=bool)
    test_time = np.asarray(test_time, dtype=np.float64)
    G = _step_lookup(g_t, g_v, test_time)
    if np.any((G <= 0) & test_event):
        raise ValueError("censoring survival function is zero at one or "
                         "more event times")
    w = np.zeros(len(test_time))
    w[test_event] = 1.0 / G[test_event]
    return w


def _comparable(event, time):
    """Harrell's comparable pairs (event i; j outlived i or was censored at
    i's time) and the pairs tied in time."""
    later = time[None, :] > time[:, None]
    tied_at = (time[None, :] == time[:, None]) & (~event)[None, :]
    comp = event[:, None] & (later | tied_at)
    np.fill_diagonal(comp, False)
    return comp, tied_at


def concordance_index_ipcw(train_event, train_time, test_event, test_time,
                           estimate, tau=None, tied_tol: float = 1e-8):
    """Uno's IPCW concordance index (sksurv's ``concordance_index_ipcw``,
    which the reference calls in utils_analysis/evaluation.py:578).
    Harrell's pairs, row i weighted by 1 / G(t_i)^2 with G the training
    cohort's censoring survival; with ``tau``, rows with t_i >= tau weigh
    0, and they are cut before the weights are taken, so a zero G at such
    an event does not raise (as in sksurv).

    Returns (cindex, concordant, discordant, tied_risk, tied_time), the
    counts unweighted as sksurv's."""
    event = np.asarray(test_event, dtype=bool)
    time = np.asarray(test_time, dtype=np.float64)
    est = np.asarray(estimate, dtype=np.float64)
    if not event.any():
        raise ValueError("All samples are censored")
    if tau is not None:
        in_tau = time < tau
        ipcw = np.zeros(len(time))
        ipcw[in_tau] = _ipcw_weights(train_event, train_time, event[in_tau],
                                     time[in_tau])
    else:
        ipcw = _ipcw_weights(train_event, train_time, event, time)
    w = np.square(ipcw)

    comp, tied_at = _comparable(event, time)
    diff = est[:, None] - est[None, :]
    tied_risk_mat = np.abs(diff) <= tied_tol
    concordant_mat = (diff > 0) & ~tied_risk_mat
    numerator = np.sum(w[:, None] * comp * (concordant_mat
                                            + 0.5 * tied_risk_mat))
    denominator = np.sum(w[:, None] * comp)
    if denominator == 0:
        raise ValueError("No comparable pairs")
    concordant = int(np.sum(comp & concordant_mat))
    tied_risk = int(np.sum(comp & tied_risk_mat))
    discordant = int(np.sum(comp)) - concordant - tied_risk
    tied_time = int(np.sum(event[:, None] & tied_at))
    return (numerator / denominator, concordant, discordant, tied_risk,
            tied_time)


def cumulative_dynamic_auc(train_event, train_time, test_event, test_time,
                           estimate, times):
    """Time-dependent cumulative/dynamic AUC (sksurv's
    ``cumulative_dynamic_auc``, reference utils_analysis/evaluation.py:
    577).  At each time t the cases are the events by t, weighted by
    1 / G(t_i), and the controls the subjects still at risk after t;
    AUC(t) is the area under the weighted ROC whose thresholds pool tied
    estimates (the last of each run of equal ones).  ``mean_auc`` weighs
    AUC(t_k) by the test cohort's Kaplan-Meier mass d_k = S(t_{k-1}) -
    S(t_k) over the times where AUC(t) is defined: an undefined AUC(t)
    (no case or no control) leaves both the sum and the mass, where
    sksurv refuses such a grid.

    Returns (auc per time [len(times)], mean_auc)."""
    event = np.asarray(test_event, dtype=bool)
    time = np.asarray(test_time, dtype=np.float64)
    est = np.asarray(estimate, dtype=np.float64)
    times = np.atleast_1d(np.asarray(times, dtype=np.float64))
    ipcw = _ipcw_weights(train_event, train_time, event, time)

    order = np.argsort(-est, kind="stable")
    time_ord, event_ord, ipcw_ord = time[order], event[order], ipcw[order]
    keep = np.concatenate([np.diff(est[order]) != 0, [True]])
    scores = np.empty(len(times))
    for k, t in enumerate(times):
        is_case = (time_ord <= t) & event_ord
        is_control = time_ord > t
        n_controls = int(is_control.sum())
        cum_tp = np.cumsum(is_case * ipcw_ord)
        cum_fp = np.cumsum(is_control)
        if cum_tp[-1] == 0 or n_controls == 0:
            scores[k] = np.nan
            continue
        tpr = cum_tp[keep] / cum_tp[-1]
        fpr = cum_fp[keep] / n_controls
        scores[k] = _trapezoid(np.concatenate([[0.0], tpr]),
                               np.concatenate([[0.0], fpr]))
    if len(times) == 1:
        return scores, float(scores[0])
    s_t, s_v = kaplan_meier(event, time)
    d = -np.diff(np.concatenate([[1.0], _step_lookup(s_t, s_v, times)]))
    valid = ~np.isnan(scores)
    denom = float(np.sum(d[valid]))
    mean_auc = (float(np.sum(scores[valid] * d[valid]) / denom)
                if denom > 0 else float("nan"))
    return scores, mean_auc


def survival_probs_at_times(S_bins, bin_edges, times):
    """Per-bin survival S[B, K] (survival through bin k) stepped onto query
    times, float64 (JAX metrics.py:296): column k holds for t in
    [edges[k + 1], edges[k + 2]), the last column past the last bin, and 1
    before edges[1].  At the bin edges (``times = edges[1:]``, as the
    reference's IBS uses them) it returns S itself."""
    S_bins = np.asarray(S_bins, dtype=np.float64)
    edges = np.asarray(bin_edges, dtype=np.float64)
    times = np.asarray(times, dtype=np.float64)
    k = np.minimum(np.searchsorted(edges[1:], times, side="right") - 1,
                   S_bins.shape[1] - 1)
    out = np.ones((S_bins.shape[0], len(times)))
    out[:, k >= 0] = S_bins[:, k[k >= 0]]
    return out
