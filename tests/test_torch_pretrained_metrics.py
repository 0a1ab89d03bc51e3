"""The port's stage-4 metrics (multimodalfusion_tpu_torch.metrics and
engine/evaluate.compute_ibs) against the JAX package's on seeded numpy
data: tied times (deaths and censorings at one time), a censored last
time, test times past the training maximum and grids that the edge clamps
move.  Both sides compute in float64 on the host; they agree to 1e-12."""
import numpy as np
import pytest

from multimodalfusion_tpu import metrics as jmetrics
from multimodalfusion_tpu.engine import evaluate as jevaluate
from multimodalfusion_tpu_torch import metrics as tmetrics
from multimodalfusion_tpu_torch.engine import evaluate as tevaluate

TOL = 1e-12


def survival_data(seed, n, n_times=6, censored_last=True):
    """Integer-valued times (so ties are common), about a third censored,
    the largest time censored when ``censored_last``."""
    rng = np.random.default_rng(seed)
    time = rng.integers(1, 12, size=n).astype(np.float64)
    event = rng.uniform(size=n) > 0.35
    last = np.argmax(time)
    event[last] = not censored_last
    est = np.sort(rng.uniform(0.05, 1.0, size=(n, n_times)), axis=1)[:, ::-1]
    return event, time, est


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("censored_last", [True, False])
def test_kaplan_meier_and_censoring_survival_match_jax(seed, censored_last):
    event, time, _ = survival_data(seed, 40, censored_last=censored_last)
    assert len(np.unique(time)) < len(time)  # ties
    for name in ("kaplan_meier", "censoring_survival"):
        got = getattr(tmetrics, name)(event, time)
        want = getattr(jmetrics, name)(event, time)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, w, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_brier_and_integrated_brier_score_match_jax(seed):
    tr_event, tr_time, _ = survival_data(seed, 50)
    te_event, te_time, est = survival_data(seed + 100, 20)
    times = np.array([1.5, 3.0, 4.0, 6.5, 9.0, 11.0])
    got_t, got = tmetrics.brier_score(tr_event, tr_time, te_event, te_time,
                                      est, times)
    want_t, want = jmetrics.brier_score(tr_event, tr_time, te_event,
                                        te_time, est, times)
    np.testing.assert_array_equal(got_t, want_t)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    assert tmetrics.integrated_brier_score(
        tr_event, tr_time, te_event, te_time, est, times) == pytest.approx(
        jmetrics.integrated_brier_score(tr_event, tr_time, te_event,
                                        te_time, est, times), rel=TOL)
    with pytest.raises(ValueError):
        tmetrics.brier_score(tr_event, tr_time, te_event, te_time,
                             est[:, :3], times)


def test_brier_score_weights_a_zero_censoring_survival_as_zero():
    """G falls to 0 after the last training time when it is censored: a
    death or a survivor weighted by 1/0 counts 0 on both sides."""
    tr_event = np.array([True, True, False])
    tr_time = np.array([1.0, 2.0, 3.0])
    te_event = np.array([True, False, True])
    te_time = np.array([3.0, 3.5, 2.0])
    est = np.array([[0.9, 0.5], [0.8, 0.4], [0.7, 0.2]])
    times = np.array([2.5, 3.2])
    np.testing.assert_allclose(
        tmetrics.brier_score(tr_event, tr_time, te_event, te_time, est,
                             times)[1],
        jmetrics.brier_score(tr_event, tr_time, te_event, te_time, est,
                             times)[1], rtol=TOL, atol=TOL)


@pytest.mark.parametrize("case", ["inside", "clamp_first", "clamp_last",
                                  "clamp_both", "past_train_max"])
def test_compute_ibs_matches_jax(case):
    """compute_ibs with the reference's clamps: the grid's first and last
    points move just inside the test range; test times past the training
    maximum are clamped to it; the survival columns keep their
    positions."""
    tr_event, tr_time, _ = survival_data(7, 60, n_times=4)
    te_event, te_time, S = survival_data(8, 25, n_times=4)
    bins = {"inside": [0.0, 3.0, 5.0, 7.0, 9.0],
            "clamp_first": [0.0, 0.5, 5.0, 7.0, 9.0],
            "clamp_last": [0.0, 3.0, 5.0, 7.0, 50.0],
            "clamp_both": [0.0, 0.5, 5.0, 7.0, 50.0],
            "past_train_max": [0.0, 3.0, 5.0, 7.0, 9.0]}[case]
    if case == "past_train_max":
        te_time = te_time.copy()
        te_time[:3] = tr_time.max() + np.array([1.0, 5.0, 0.5])
    got = tevaluate.compute_ibs(tr_event, tr_time, te_event, te_time, S,
                                np.asarray(bins))
    want = jevaluate.compute_ibs(tr_event, tr_time, te_event, te_time, S,
                                 np.asarray(bins))
    assert np.isfinite(got)
    assert got == pytest.approx(want, rel=TOL)
