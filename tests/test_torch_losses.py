"""The port's survival losses, label binning and concordance index
(multimodalfusion_tpu_torch.{losses,data.labels,metrics}) against the JAX
package's on the same seeded numpy inputs."""
import numpy as np
import pandas as pd
import pytest
import torch

import jax.numpy as jnp

from multimodalfusion_tpu import losses as jlosses
from multimodalfusion_tpu import metrics as jmetrics
from multimodalfusion_tpu.data import labels as jlabels
from multimodalfusion_tpu_torch import losses as tlosses
from multimodalfusion_tpu_torch import metrics as tmetrics
from multimodalfusion_tpu_torch.data import labels as tlabels

# f32 on both sides, the same formulas: the sums differ in order only
RTOL = 1e-5


def survival_batch(seed, B=8, K=4):
    rng = np.random.default_rng(seed)
    logits = rng.normal(size=(B, K)).astype(np.float32)
    hazards = 1.0 / (1.0 + np.exp(-logits))
    S = np.cumprod(1.0 - hazards, axis=1).astype(np.float32)
    Y = rng.integers(0, K, size=B).astype(np.int32)
    c = (rng.uniform(size=B) < 0.4).astype(np.float32)
    t = rng.uniform(1, 50, size=B).astype(np.float32)
    risks = rng.normal(size=B).astype(np.float32)
    valid = np.ones(B, np.float32)
    valid[-2:] = 0.0  # a partial batch
    return dict(hazards=hazards.astype(np.float32), S=S, Y=Y, c=c, t=t,
                risks=risks, valid=valid)


@pytest.mark.parametrize("use_valid", [False, True])
@pytest.mark.parametrize("name", ["nll", "ce", "cox", "ranking",
                                  "ranking_nll"])
def test_losses_match_jax(name, use_valid):
    d = survival_batch(0)
    v = d["valid"] if use_valid else None
    if name == "nll":
        args, fj, ft = ((d["hazards"], d["S"], d["Y"], d["c"]),
                        jlosses.nll_loss, tlosses.nll_loss)
        kw = {"alpha": 0.15}
    elif name == "ce":
        args, fj, ft = ((d["hazards"], d["S"], d["Y"], d["c"]),
                        jlosses.ce_loss, tlosses.ce_loss)
        kw = {"alpha": 0.4}
    elif name == "cox":
        args, fj, ft = ((d["risks"], d["t"], d["c"]), jlosses.cox_loss,
                        tlosses.cox_loss)
        kw = {}
    elif name == "ranking":
        args, fj, ft = ((d["risks"], d["t"], d["c"]), jlosses.ranking_loss,
                        tlosses.ranking_loss)
        kw = {}
    else:
        args, fj, ft = ((d["hazards"], d["risks"], d["S"], d["Y"], d["c"]),
                        jlosses.ranking_nll_loss, tlosses.ranking_nll_loss)
        kw = {"nll_ratio": 0.3}
    jv = {} if v is None else {"valid": jnp.asarray(v)}
    tv = {} if v is None else {"valid": torch.from_numpy(v)}
    want = float(fj(*[jnp.asarray(a) for a in args], **jv, **kw))
    got = float(ft(*[torch.from_numpy(a) for a in args], **tv, **kw))
    assert np.isfinite(got)
    assert got == pytest.approx(want, rel=RTOL, abs=1e-7)


def test_nll_recomputes_S_when_absent():
    d = survival_batch(1)
    got = tlosses.nll_loss(torch.from_numpy(d["hazards"]), None,
                           torch.from_numpy(d["Y"]), torch.from_numpy(d["c"]))
    want = jlosses.nll_loss(jnp.asarray(d["hazards"]), None,
                            jnp.asarray(d["Y"]), jnp.asarray(d["c"]))
    assert float(got) == pytest.approx(float(want), rel=RTOL)


def test_cox_extreme_padded_risk_and_ranking_without_pairs():
    """A padded row with an extreme risk neither underflows the valid terms
    nor makes NaN; a ranking batch with no comparable pair gives 0."""
    d = survival_batch(2)
    risks = d["risks"].copy()
    risks[-1] = 1e4  # a padded row (valid = 0)
    j = jlosses.cox_loss(jnp.asarray(risks), jnp.asarray(d["t"]),
                         jnp.asarray(d["c"]), valid=jnp.asarray(d["valid"]))
    t = tlosses.cox_loss(torch.from_numpy(risks), torch.from_numpy(d["t"]),
                         torch.from_numpy(d["c"]),
                         valid=torch.from_numpy(d["valid"]))
    assert np.isfinite(float(t))
    assert float(t) == pytest.approx(float(j), rel=RTOL)
    c = np.ones_like(d["c"])  # all censored: no comparable pair
    for reduction in ("mean", "sum"):
        t = tlosses.ranking_loss(torch.from_numpy(d["risks"]),
                                 torch.from_numpy(d["t"]),
                                 torch.from_numpy(c), reduction=reduction)
        j = jlosses.ranking_loss(jnp.asarray(d["risks"]),
                                 jnp.asarray(d["t"]), jnp.asarray(c),
                                 reduction=reduction)
        assert float(t) == float(j) == 0.0


@pytest.mark.parametrize("name", ["nll_surv", "ce_surv", "cox_surv",
                                  "ranking_surv", "ranking_nll_surv"])
def test_loss_spec_dispatch(name):
    d = survival_batch(3)
    kw = dict(hazards=d["hazards"], S=d["S"], risks=d["risks"], Y=d["Y"],
              times=d["t"], c=d["c"], valid=d["valid"])
    j = jlosses.LossSpec(name, alpha=0.1, nll_ratio=0.3).apply(
        **{k: jnp.asarray(v) for k, v in kw.items()})
    t = tlosses.LossSpec(name, alpha=0.1, nll_ratio=0.3).apply(
        **{k: torch.from_numpy(v) for k, v in kw.items()})
    assert float(t) == pytest.approx(float(j), rel=RTOL, abs=1e-7)
    with pytest.raises(NotImplementedError):
        tlosses.LossSpec("nope")


def test_l1_reg_value_and_gradient_match_jax():
    """The L1 terms and their gradients, with the JAX package's +1
    derivative at an exact 0 (zero-initialized biases)."""
    import jax
    rng = np.random.default_rng(4)
    tree = {"fc_omic": {"w": rng.normal(size=(3, 2)).astype(np.float32),
                        "b": np.zeros(2, np.float32)},
            "classifier": {"w": rng.normal(size=(2, 2)).astype(np.float32)}}
    jtree = jax.tree.map(jnp.asarray, tree)
    named = [(f"{a}.{b}", torch.from_numpy(v.copy()).requires_grad_())
             for a, sub in tree.items() for b, v in sub.items()]
    want = jlosses.l1_reg(jtree)
    got = tlosses.l1_reg([p for _, p in named])
    assert float(got.detach()) == pytest.approx(float(want), rel=RTOL)
    got.backward()
    jgrad = jax.grad(jlosses.l1_reg)(jtree)
    for name, p in named:
        a, b = name.split(".")
        np.testing.assert_array_equal(p.grad.numpy(),
                                      np.asarray(jgrad[a][b]))
    sub_t = tlosses.l1_reg_subtree(named, ("fc_omic", "mm"))
    sub_j = jlosses.l1_reg_subtree(jtree, ("fc_omic", "mm"))
    assert float(sub_t.detach()) == pytest.approx(float(sub_j), rel=RTOL)


def cohort_frame(times, cens, train):
    return pd.DataFrame({"survival_months": times, "censorship": cens,
                         "train": train})


@pytest.mark.parametrize("n_bins", [2, 4, 5])
@pytest.mark.parametrize("tied", [False, True])
def test_discretize_matches_jax(n_bins, tied):
    """Random and heavily tied survival times: the same edges (pandas'
    qcut quantiles, exactly), disc_label, label and label dict."""
    rng = np.random.default_rng(10 + n_bins)
    n = 60
    if tied:
        times = rng.choice([1.0, 2.0, 3.0, 5.0, 8.0, 13.0, 21.0], size=n)
    else:
        times = np.round(rng.exponential(20.0, size=n), 1)
    cens = (rng.uniform(size=n) < 0.3).astype(float)
    train = (rng.uniform(size=n) < 0.8).astype(int)
    try:
        want = jlabels.discretize(cohort_frame(times, cens, train),
                                  n_bins=n_bins)
    except ValueError as e:
        with pytest.raises(ValueError, match=str(e)[:40]):
            tlabels.discretize(times, cens, train, n_bins=n_bins)
        return
    got = tlabels.discretize(times, cens, train, n_bins=n_bins)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[2], want[2])
    assert got[3] == want[3]


@pytest.mark.parametrize("case", ["no_uncensored", "few_distinct",
                                  "collapsed"])
def test_discretize_refusals_match_jax(case):
    """The three refusals, each with the JAX package's cause."""
    n = 20
    times = np.linspace(1, 40, n)
    cens = np.zeros(n)
    train = np.ones(n, int)
    if case == "no_uncensored":
        cens[:] = 1.0
        cause = "no uncensored"
    elif case == "few_distinct":
        times = np.where(np.arange(n) < 10, 3.0, 7.0)
        cause = "only 2 distinct"
    else:
        times = np.array([5.0] * 16 + [6.0, 7.0, 8.0, 9.0])
        cause = "collapse"
    with pytest.raises(ValueError, match=cause):
        jlabels.discretize(cohort_frame(times, cens, train), n_bins=4)
    with pytest.raises(ValueError, match=cause):
        tlabels.discretize(times, cens, train, n_bins=4)


def test_assign_bins_edges_match_pandas_cut():
    q = np.array([0.5, 2.0, 4.0, 9.0])
    vals = np.array([0.5, 1.9, 2.0, 3.99, 4.0, 8.99])
    np.testing.assert_array_equal(tlabels.assign_bins(vals, q),
                                  jlabels.assign_bins(vals, q))
    with pytest.raises(ValueError, match="outside"):
        tlabels.assign_bins(np.array([9.0]), q)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_concordance_index_matches_jax(seed):
    """Ties in time and in risk included."""
    rng = np.random.default_rng(seed)
    n = 40
    t = rng.integers(1, 12, size=n).astype(float)    # tied times
    event = rng.uniform(size=n) < 0.6
    est = np.round(rng.normal(size=n), 1)            # tied risks
    assert tmetrics.concordance_index_censored(event, t, est) == \
        jmetrics.concordance_index_censored(event, t, est)
    with pytest.raises(ValueError, match="censored"):
        tmetrics.concordance_index_censored(np.zeros(n, bool), t, est)
