"""The port's stand-ins for what pandas and PyYAML do in the reporting
stage, held to pandas and PyYAML on the CPU: ``utils/table.read_csv``
(the header, the unnamed index column, empty cells, inf, per-column int /
float / text), ``from_records`` + ``write_csv`` against
``pd.DataFrame(rows).to_csv`` byte for byte, ``pivot_mean`` against
``pivot_table(...).round(4)`` (all-NaN rows and columns dropped, half to
even), ``kahan_group_reduce`` against groupby mean / median / max bit for
bit, and ``yaml_subset.dump`` read back by PyYAML and by the port's own
reader as the object it was given, quoting what YAML would read as
another type."""
import io

import numpy as np
import pandas as pd
import pytest
import yaml

from multimodalfusion_tpu_torch.data.io import load_pkl, save_pkl
from multimodalfusion_tpu_torch.utils import table, yaml_subset

CSV_CASES = {
    "summary": ",folds,val_cindex\n0,0,0.61\n1,1,\n2,2,inf\n",
    "summary_test": ",folds,val_cindex,test_cindex\n0,0,0.5,0.25\n"
                    "1,1,0.75,-inf\n",
    "cohort": "subject_id,slide_id,survival_months,censorship,age,G0\n"
              "007,007-A.svs,12.5,0.0,61,-1.25e-3\n"
              "10,10-A.svs,3,1.0,,2.5\n",
    "text": "subject_id,note\nSUBJ001,a b\nSUBJ002,\n",
    "blank_lines": "a,b\n1,2\n\n3,4\n",
    "empty_body": "a,b\n",
    "signs": "x,y\n+1,.5\n-2,-.5e2\n",
}


@pytest.mark.parametrize("name", sorted(CSV_CASES))
def test_read_csv_matches_pandas(tmp_path, name):
    path = tmp_path / "t.csv"
    path.write_text(CSV_CASES[name])
    got = table.read_csv(str(path))
    want = pd.read_csv(path)
    assert list(got) == list(want.columns)
    for col in want.columns:
        w = want[col]
        g = got[col]
        if w.dtype.kind in "iuf":
            assert g.dtype == w.dtype, (col, g.dtype, w.dtype)
            np.testing.assert_array_equal(g, w.to_numpy())
        elif name == "cohort" and col == "subject_id":
            # ids stay text in the port (pandas reads 7 and 10)
            assert list(g) == ["007", "10"]
        else:
            assert [v if isinstance(v, str) else None for v in g] == \
                [v if isinstance(v, str) else None for v in w]


def test_read_csv_rejects_what_it_cannot_type(tmp_path):
    path = tmp_path / "t.csv"
    path.write_text("a,a\n1,2\n")
    with pytest.raises(ValueError, match="repeated"):
        table.read_csv(str(path))
    path.write_text("a\n1,2\n")
    with pytest.raises(ValueError, match="cells"):
        table.read_csv(str(path))
    path.write_text("")
    assert table.read_csv(str(path)) == {}


@pytest.mark.parametrize("seed", range(3))
def test_records_write_as_pandas_writes_them(tmp_path, seed):
    """Rows of dicts with keys missing in some rows (NaN, an int column
    then float), ints, floats of every size, inf and NaN, text."""
    rng = np.random.default_rng(seed)
    rows = []
    for i in range(6):
        row = {"experiment": f"c__s__EXP{rng.integers(0, 100)}",
               "n": int(rng.integers(4, 400)),
               "pooled_cindex": float(rng.uniform()),
               "logrank_p": float(10.0 ** rng.uniform(-12, 0))}
        if i % 2:
            row["iauc"] = float(rng.normal() * 10.0 ** rng.integers(-6, 6))
        if i == 3:
            row["cindex_lo"] = float("nan")
            row["ipcw_cindex"] = float("inf")
        if i == 4:
            row["k"] = 7
        rows.append(row)
    table.write_csv(str(tmp_path / "got.csv"), table.from_records(rows))
    pd.DataFrame(rows).to_csv(tmp_path / "want.csv", index=False)
    assert (tmp_path / "got.csv").read_text() == \
        (tmp_path / "want.csv").read_text()


def test_empty_table_writes_one_empty_line(tmp_path):
    table.write_csv(str(tmp_path / "got.csv"), table.from_records([]))
    pd.DataFrame().to_csv(tmp_path / "want.csv", index=False)
    assert (tmp_path / "got.csv").read_text() == \
        (tmp_path / "want.csv").read_text() == "\n"


def _pivot_frame(seed, n=30, nan_frac=0.3):
    rng = np.random.default_rng(seed)
    models = [f"M{rng.integers(0, 5)}" for _ in range(n)]
    cohorts = [["(root)", "a", "b", "brain"][rng.integers(0, 4)]
               for _ in range(n)]
    v = rng.uniform(size=n)
    v[rng.uniform(size=n) < nan_frac] = np.nan
    return models, cohorts, v


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("nan_frac", [0.0, 0.4, 0.9])
def test_pivot_mean_matches_pandas(seed, nan_frac):
    models, cohorts, v = _pivot_frame(seed, nan_frac=nan_frac)
    rows, cols, grid = table.pivot_mean(models, cohorts, v)
    want = pd.DataFrame({"model": models, "cohort": cohorts, "v": v}
                        ).pivot_table(index="model", columns="cohort",
                                      values="v", aggfunc="mean").round(4)
    assert rows == list(want.index) and cols == list(want.columns)
    np.testing.assert_array_equal(grid, want.to_numpy())


def test_pivot_drops_all_nan_and_rounds_half_even(tmp_path):
    """pandas 3's pivot: the all-NaN cohort b and model M3 leave; the CSV
    is the one that pandas writes."""
    models = ["M1", "M2", "M1", "M3", "M4"]
    cohorts = ["a", "(root)", "b", "(root)", "a"]
    v = np.array([0.61234, 0.5, np.nan, np.nan, 0.12345])
    rows, cols, grid = table.pivot_mean(models, cohorts, v)
    assert rows == ["M1", "M2", "M4"] and cols == ["(root)", "a"]
    assert grid[2, 1] == np.round(0.12345, 4)
    table.write_csv(str(tmp_path / "got.csv"),
                    {"model": rows, **{c: grid[:, j]
                                       for j, c in enumerate(cols)}})
    want = pd.DataFrame({"model": models, "cohort": cohorts, "v": v}
                        ).pivot_table(index="model", columns="cohort",
                                      values="v", aggfunc="mean").round(4)
    want.to_csv(tmp_path / "want.csv")
    assert (tmp_path / "got.csv").read_text() == \
        (tmp_path / "want.csv").read_text() == \
        "model,(root),a\nM1,,0.6123\nM2,0.5,\nM4,,0.1234\n"


@pytest.mark.parametrize("how", ["mean", "median", "max"])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_group_reduce_matches_pandas(how, dtype):
    rng = np.random.default_rng(1)
    labels = rng.integers(0, 7, 200)
    values = (rng.normal(size=200) * 10.0 ** rng.integers(-3, 4, 200)
              ).astype(dtype)
    values[rng.uniform(size=200) < 0.1] = np.nan
    values[labels == 6] = np.nan  # a group with no number
    got = table.kahan_group_reduce(labels, 7, values, how)
    want = getattr(pd.DataFrame({"k": labels, "v": values}).groupby("k")[
        "v"], how)()
    assert got.dtype == want.dtype == dtype
    np.testing.assert_array_equal(got, want.to_numpy())
    with pytest.raises(ValueError, match="mean, median or max"):
        table.kahan_group_reduce(labels, 7, values, "sum")


def test_load_pkl_reads_both_packages_results(tmp_path):
    """A fold's results pkl of either package: numpy arrays, the ids
    numbers (JAX, numeric cohort) or text (the port)."""
    for ids in (np.array([7, 10, 100]), np.array(["007", "10", "100"],
                                                 object)):
        res = {"subject_id": ids, "risk": np.ones(3, np.float32)}
        save_pkl(str(tmp_path / "r.pkl"), res)
        got = load_pkl(str(tmp_path / "r.pkl"))
        assert list(got) == list(res)
        np.testing.assert_array_equal(got["subject_id"], ids)
        assert got["subject_id"].dtype == ids.dtype


TRICKY = ["007", "yes", "No", "on", "null", "~", "", "1e3", "1.5", ".5",
          "-3", "+2", "0x1F", "1_000", "12:30", "2020-01-02", "true",
          "a: b", "path/with: colon", "x #y", "#c", "-", "- a", "?", "a:",
          " pad", "pad ", "[x]", "{x}", "!tag", "&a", "*a", "|", ">",
          "'q'", '"q"', "%d", "@x", "`x`", "multi\nline", "tab\tx", "é",
          "plain", "/abs/path/RADIO_a0.0_s1", "heatmap_results/x_val_0",
          "1e-3", ".inf", ".nan", "=", "<<"]


@pytest.mark.parametrize("text", TRICKY)
def test_dump_quotes_what_would_read_as_another_type(text):
    doc = {"k": text, text or "empty": [text]}
    out = yaml_subset.dump(doc)
    assert yaml.safe_load(out) == doc
    assert yaml_subset.load(out) == doc


def test_dump_reads_back_as_pyyaml_dump_does():
    """A heatmap config with every type dump takes, nested mappings and
    lists, empty ones, and floats that need YAML 1.1's dot: PyYAML and
    the port read the port's text as PyYAML's own dump of it."""
    cfg = {"exp_arguments": {"branch": "omic", "save_dir": "/r/x_val_0",
                             "overwrite": True, "seed": None},
           "data_arguments": {"modalities": ["FLAIR", "T1"], "ids": [],
                              "extra": {}, "nested": [{"a": 1, "b": [1,
                                                                     2]},
                                                      [3, [4]]]},
           "model_arguments": {"ckpt_path": "/abs/exp", "which_k": 10,
                               "lr": 1e-05, "big": 1e20, "neg": -0.0,
                               "inf": float("-inf"), "np": np.float32(0.5),
                               "npi": np.int64(3), "npb": np.bool_(False)},
           "heatmap_arguments": {"local_n": 8, "max_display": 20},
           "sample_arguments": {"samples": [{"name": "topk", "k": 15}]}}
    out = yaml_subset.dump(cfg)
    plain = yaml.safe_load(yaml.dump(_plain(cfg), default_flow_style=False,
                                     sort_keys=False))
    assert yaml.safe_load(out) == plain == yaml_subset.load(out)
    assert out.splitlines()[:3] == ["exp_arguments:", "  branch: omic",
                                    "  save_dir: /r/x_val_0"]


def _plain(v):
    """numpy scalars as Python ones (PyYAML's safe dump takes no
    numpy)."""
    if isinstance(v, dict):
        return {k: _plain(x) for k, x in v.items()}
    if isinstance(v, list):
        return [_plain(x) for x in v]
    return v.item() if isinstance(v, np.generic) else v


def test_dump_refuses_what_is_outside_the_subset():
    with pytest.raises(TypeError):
        yaml_subset.dump({"k": object()})
    with pytest.raises(TypeError):
        yaml_subset.dump({("a",): 1})
    assert yaml_subset.dump([]) == "[]\n"
    assert yaml_subset.dump("007") == '"007"\n'
    assert yaml.safe_load(io.StringIO(yaml_subset.dump([1, "x"]))) == [1,
                                                                       "x"]
