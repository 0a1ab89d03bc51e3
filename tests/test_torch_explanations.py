"""multimodalfusion_tpu_torch.interpret.explanations against the JAX
package's on the CPU: _robust_range, beeswarm_offsets, _symmetric_xlim and
global_beeswarm_data equal exactly, including NaN feature values, constant
columns (the 1-99 and min-max fallbacks), near-zero attributions and all
equal attributions; the three plot functions draw and write nothing and
return what JAX draws from."""
import numpy as np
import pytest

from multimodalfusion_tpu.interpret import explanations as je
from multimodalfusion_tpu_torch.interpret import explanations as te


def _columns(rng):
    base = rng.normal(size=50)
    spiky = np.zeros(50)
    spiky[:2] = [5.0, -3.0]           # 5-95 collapses, 1-99 does not
    spikier = np.zeros(50)
    spikier[0] = 7.0                  # 1-99 collapses too: min-max
    with_nan = base.copy()
    with_nan[[3, 9]] = np.nan
    return [base, np.ones(50), spiky, spikier, with_nan,
            np.full(50, np.nan)]


def test_robust_range_equals_jax():
    import warnings
    for col in _columns(np.random.default_rng(0)):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            want = je._robust_range(col)
            got = te._robust_range(col)
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


@pytest.mark.parametrize("scale", [1.0, 1e-13, 0.0, 37.5])
def test_offsets_and_xlim_equal_jax(scale):
    rng = np.random.default_rng(1)
    for n in (1, 2, 30, 301):
        shaps = rng.normal(size=n) * scale
        for seed in (0, 3):
            for nbins in (100, 7):
                np.testing.assert_array_equal(
                    te.beeswarm_offsets(shaps, 0.4, nbins, seed),
                    je.beeswarm_offsets(shaps, 0.4, nbins, seed))
        m = float(np.abs(shaps).max())
        assert te._symmetric_xlim(m) == je._symmetric_xlim(m)


def _same_data(got, want):
    assert set(got) >= set(want)
    np.testing.assert_array_equal(got["feature_order"],
                                  want["feature_order"])
    assert got["xlim"] == want["xlim"]
    assert got["xtick_stride"] == want["xtick_stride"]
    assert len(got["rows"]) == len(want["rows"])
    for g, w in zip(got["rows"], want["rows"]):
        assert sorted(g) == sorted(w)
        for k in w:
            np.testing.assert_array_equal(np.asarray(g[k]),
                                          np.asarray(w[k]), err_msg=k)


@pytest.mark.parametrize("case", ["plain", "nan_and_constant", "no_ref",
                                  "tiny_attr"])
def test_global_beeswarm_data_equals_jax(case):
    rng = np.random.default_rng(4)
    n, m, g = 30, 50, 12
    attr = rng.normal(size=(n, g)) * np.linspace(0.1, 2.0, g)
    feats = rng.normal(size=(n, g))
    ref = rng.normal(size=(m, g)) * 3.0
    if case == "nan_and_constant":
        feats[0, 5] = np.nan
        ref[:, 2] = 1.0
        ref[:, 3] = 0.0
        ref[0, 3] = 9.0
    if case == "no_ref":
        ref = None
    if case == "tiny_attr":
        attr *= 1e-13
    for md in (8, 20, 1):
        _same_data(te.global_beeswarm_data(attr, feats, ref, max_display=md,
                                           seed=2),
                   je.global_beeswarm_data(attr, feats, ref, max_display=md,
                                           seed=2))


def test_plots_draw_nothing_and_return_their_data(tmp_path):
    rng = np.random.default_rng(0)
    attr = rng.normal(size=(6, 10))
    feats = rng.normal(size=(6, 10))
    genes = [f"g{i}_cnv" for i in range(10)]
    data = te.global_beeswarm_plot(attr, feats, genes,
                                   str(tmp_path / "bees.png"), max_display=6)
    _same_data(data, je.global_beeswarm_data(attr, feats, max_display=6))
    assert data["labels"] == [genes[i] for i in data["feature_order"]]
    bars = te.local_attr_plot(attr[0], feats[0], feats, genes,
                              str(tmp_path / "one.png"), max_display=5)
    assert bars["path"] == str(tmp_path / "one.png")
    np.testing.assert_array_equal(bars["order"],
                                  np.argsort(np.abs(attr[0]))[-5:])
    assert bars["labels"] == [genes[i] for i in bars["order"]]
    assert np.all((bars["color_frac"] >= 0) & (bars["color_frac"] <= 1))
    feats_const = np.ones_like(feats)  # every colour range collapses: 0.5
    const = te.local_attr_plot(attr[1], feats_const[1], feats_const, genes,
                               str(tmp_path / "const.png"))
    assert np.all(const["color_frac"] == 0.5)
    plots = te.local_attr_plots(attr, feats, [f"P{i}" for i in range(6)],
                                genes, str(tmp_path / "local"), n_patients=2)
    order = np.argsort(-np.abs(attr).sum(axis=1))[:2]
    assert [p["path"] for p in plots] == [
        str(tmp_path / "local" / f"P{i}_local_attr.png") for i in order]
    assert not list(tmp_path.rglob("*.png"))
