"""The port's IPCW metrics (multimodalfusion_tpu_torch.metrics:
_ipcw_weights, concordance_index_ipcw, cumulative_dynamic_auc) against the
JAX package's on the same seeded numpy inputs: values at rtol 1e-12,
integer counts equal.  Cases: with and without tau, the zero-G raise and
its suppression past tau, tied estimates and tied times, and a time grid
with undefined AUCs."""
import numpy as np
import pytest

from multimodalfusion_tpu import metrics as jm
from multimodalfusion_tpu_torch import metrics as tm

RTOL = 1e-12


def cohort(seed, n_train=40, n_test=30, ties=False):
    """Train and test survival data in months; with ``ties``, times and
    estimates drawn from a few values so that both tie."""
    rng = np.random.default_rng(seed)
    tr_t = rng.uniform(1, 100, n_train).round(1)
    tr_e = rng.uniform(size=n_train) < 0.7
    te_t = rng.uniform(1, 90, n_test).round(1)
    te_e = rng.uniform(size=n_test) < 0.7
    est = rng.normal(size=n_test)
    if ties:
        te_t = rng.choice([10.0, 20.0, 30.0, 40.0, 50.0], n_test)
        tr_t[:5] = [10.0, 20.0, 30.0, 40.0, 50.0]
        est = rng.choice([-1.0, 0.0, 0.5, 2.0], n_test)
    return tr_e, tr_t, te_e, te_t, est


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("ties", [False, True])
def test_ipcw_weights(seed, ties):
    tr_e, tr_t, te_e, te_t, _ = cohort(seed, ties=ties)
    np.testing.assert_allclose(tm._ipcw_weights(tr_e, tr_t, te_e, te_t),
                               jm._ipcw_weights(tr_e, tr_t, te_e, te_t),
                               rtol=RTOL, atol=0)


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("tau", [None, 30.0, 60.0])
def test_concordance_index_ipcw(seed, ties, tau):
    args = cohort(seed, ties=ties)
    got = tm.concordance_index_ipcw(*args, tau=tau)
    want = jm.concordance_index_ipcw(*args, tau=tau)
    np.testing.assert_allclose(got[0], want[0], rtol=RTOL)
    assert got[1:] == want[1:]
    assert all(isinstance(c, int) for c in got[1:])
    if ties:
        assert got[3] > 0 and got[4] > 0  # tied risks and tied times


@pytest.mark.parametrize("tied_tol", [1e-8, 0.6])
def test_concordance_index_ipcw_tied_tol(tied_tol):
    args = cohort(7)
    got = tm.concordance_index_ipcw(*args, tied_tol=tied_tol)
    want = jm.concordance_index_ipcw(*args, tied_tol=tied_tol)
    np.testing.assert_allclose(got[0], want[0], rtol=RTOL)
    assert got[1:] == want[1:]


def _zero_g_cohort():
    """The training cohort's last subject is censored at 80: G(t) = 0 from
    80 on, so a test event at 85 has no weight."""
    tr_t = np.array([10.0, 20.0, 30.0, 40.0, 50.0, 80.0])
    tr_e = np.array([1, 1, 0, 1, 1, 0], bool)
    te_t = np.array([5.0, 15.0, 25.0, 35.0, 85.0])
    te_e = np.array([1, 1, 0, 1, 1], bool)
    est = np.array([2.0, 1.0, 0.3, 0.5, -1.0])
    return tr_e, tr_t, te_e, te_t, est


def test_zero_g_raises_without_tau_and_not_past_tau():
    args = _zero_g_cohort()
    for mod in (tm, jm):
        with pytest.raises(ValueError, match="censoring survival"):
            mod.concordance_index_ipcw(*args)
        with pytest.raises(ValueError, match="censoring survival"):
            mod._ipcw_weights(*args[:4])
        with pytest.raises(ValueError, match="censoring survival"):
            mod.cumulative_dynamic_auc(*args, [20.0, 30.0])
    # truncated at tau=60 before the weights: the event at 85 weighs 0
    got = tm.concordance_index_ipcw(*args, tau=60.0)
    want = jm.concordance_index_ipcw(*args, tau=60.0)
    np.testing.assert_allclose(got[0], want[0], rtol=RTOL)
    assert got[1:] == want[1:]


def test_all_censored_and_no_pairs_raise():
    tr_e, tr_t, te_e, te_t, est = cohort(3)
    for mod in (tm, jm):
        with pytest.raises(ValueError, match="All samples are censored"):
            mod.concordance_index_ipcw(tr_e, tr_t, np.zeros_like(te_e),
                                       te_t, est)
        # the only event is the latest time: no comparable pair
        e = np.zeros_like(te_e)
        e[np.argmax(te_t)] = True
        with pytest.raises(ValueError, match="No comparable pairs"):
            mod.concordance_index_ipcw(tr_e, tr_t, e, te_t, est)


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("ties", [False, True])
def test_cumulative_dynamic_auc(seed, ties):
    args = cohort(seed, ties=ties)
    times = np.percentile(args[3], np.linspace(5, 81, 15))
    got, got_mean = tm.cumulative_dynamic_auc(*args, times)
    want, want_mean = jm.cumulative_dynamic_auc(*args, times)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=0)
    np.testing.assert_allclose(got_mean, want_mean, rtol=RTOL)
    assert np.isfinite(got_mean)


def test_cumulative_dynamic_auc_tied_estimates_pool():
    """Runs of equal estimates are pooled into one threshold (the last of
    each run): with every estimate equal the AUC is exactly 0.5."""
    tr_e, tr_t, te_e, te_t, _ = cohort(11)
    est = np.full(len(te_t), 0.25)
    got, _ = tm.cumulative_dynamic_auc(tr_e, tr_t, te_e, te_t, est, [40.0])
    want, _ = jm.cumulative_dynamic_auc(tr_e, tr_t, te_e, te_t, est, [40.0])
    assert got[0] == want[0] == 0.5


def test_cumulative_dynamic_auc_nan_times():
    """A grid whose first time precedes every event (no case) and whose
    last follows every subject (no control): those AUCs are NaN and leave
    both the sum and the KM mass; a single time returns its AUC."""
    args = cohort(5)
    t_min, t_max = args[3].min(), args[3].max()
    times = np.array([t_min - 0.5, 30.0, 50.0, t_max + 1.0])
    got, got_mean = tm.cumulative_dynamic_auc(*args, times)
    want, want_mean = jm.cumulative_dynamic_auc(*args, times)
    assert np.isnan(got[[0, 3]]).all() and np.isnan(want[[0, 3]]).all()
    np.testing.assert_allclose(got[1:3], want[1:3], rtol=RTOL)
    np.testing.assert_allclose(got_mean, want_mean, rtol=RTOL)
    one, one_mean = tm.cumulative_dynamic_auc(*args, [30.0])
    assert one_mean == float(one[0]) == jm.cumulative_dynamic_auc(
        *args, [30.0])[1]
    nan, nan_mean = tm.cumulative_dynamic_auc(*args, [t_max + 1.0,
                                                      t_max + 2.0])
    assert np.isnan(nan).all() and np.isnan(nan_mean)
    assert np.isnan(jm.cumulative_dynamic_auc(*args, [t_max + 1.0,
                                                      t_max + 2.0])[1])


def test_trapezoid_matches_numpy():
    rng = np.random.default_rng(0)
    x = np.sort(rng.uniform(size=50))
    y = rng.normal(size=50)
    assert tm._trapezoid(y, x) == np.trapezoid(y, x)
