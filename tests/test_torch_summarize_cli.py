"""The port's reporting CLI (multimodalfusion_tpu_torch.cli.summarize)
against the JAX package's on the CPU, on two results trees trained on the
synthetic cohorts of tests/fixtures.py: one by the JAX package's cli.main,
one by the port's (--device cpu).  Each tree holds a path AMIL and a
max_net experiment of two folds under a cohort of text ids ("brain") and a
max_net under a cohort of numeric ids of 1 to 3 digits whose two
validation splits overlap ("lung": a subject validated in both folds), so
the pivot has two columns, the pooled order is numeric on one side and
text on the other, and a subject's risk is pooled over two folds.
cv_summary.csv, cv_pivot.csv and risk_group_stats.csv agree cell by cell
(text equal, numbers at rtol 1e-12, NaN for NaN), the bootstrap CI bounds
among them; the emitted YAMLs parse to equal dicts under PyYAML and the
port's yaml_subset; an emitted OMICS YAML runs through the port's
create_heatmaps."""
import csv
import os
import pickle
import shutil

import numpy as np
import pytest
import yaml

from fixtures import make_cohort_csv, make_feature_store, make_splits

from multimodalfusion_tpu.cli.main import main as jax_train
from multimodalfusion_tpu.cli.summarize import main as jax_summarize
from multimodalfusion_tpu_torch.cli.create_heatmaps import \
    main as port_heatmaps
from multimodalfusion_tpu_torch.cli.main import main as port_train
from multimodalfusion_tpu_torch.cli.summarize import main as port_summarize
from multimodalfusion_tpu_torch.utils import yaml_subset

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL = 1e-12
ARMS = {
    "path": ["--model_type", "path_attention_mil", "--mode", "path",
             "--gate_path", "--bag_loss", "nll_surv", "--batch_size", "4"],
    "omic": ["--model_type", "max_net", "--mode", "omic", "--bag_loss",
             "cox_surv", "--batch_size", "8"],
}


def read_rows(path):
    with open(path, newline="") as f:
        return list(csv.reader(f))


def _number(cell):
    try:
        return float(cell)
    except ValueError:
        return None


def same_cells(got_path, want_path):
    """The same header and rows; a cell that reads as a number on both
    sides within RTOL (NaN, an empty cell, only for NaN), any other cell
    equal as text."""
    got, want = read_rows(got_path), read_rows(want_path)
    assert len(got) == len(want), (got, want)
    assert got[0] == want[0]
    n_numbers = 0
    for g_row, w_row in zip(got[1:], want[1:]):
        assert len(g_row) == len(w_row)
        for name, g, w in zip(want[0], g_row, w_row):
            gv, wv = _number(g), _number(w)
            if g == w == "":
                continue
            if gv is None or wv is None:
                assert g == w, (name, g, w)
                continue
            n_numbers += 1
            if np.isnan(wv) or np.isinf(wv):
                assert g == w, (name, g, w)
            else:
                assert abs(gv - wv) <= RTOL * abs(wv), (name, g, w)
    return n_numbers


def _write_cohorts(b):
    """brain: text ids SUBJ000.., disjoint 2-fold splits; lung: numeric
    ids of 1-3 digits, splits whose validation sets share 8 subjects."""
    _, df, latent = make_cohort_csv(str(b / "dataset_csv" / "brain"), n=16,
                                    seed=31, modalities=["T1"], n_genes=8)
    make_feature_store(str(b / "features" / "brain"), df, latent, seed=31,
                       modalities=["T1"], bag_range=(6, 30))
    make_splits(str(b / "splits" / "brain" / "2foldcv"), df, k=2,
                val_frac=0.3, seed=31)
    _, df, latent = make_cohort_csv(str(b / "dataset_csv" / "lung"), n=16,
                                    seed=32, modalities=["T1"], n_genes=8)
    ids = [str(5 + 13 * i) for i in range(16)]
    df["subject_id"] = ids
    df["slide_id"] = [f"{s}-SLIDE.svs" for s in ids]
    df.to_csv(b / "dataset_csv" / "lung" / "survival.csv", index=False)
    os.makedirs(b / "features" / "lung")
    make_splits(str(b / "splits" / "lung" / "2foldcv"), df, k=2,
                val_frac=0.6, seed=32)


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    b = tmp_path_factory.mktemp("torch_summarize")
    _write_cohorts(b)
    out = {}
    for name, train, extra in (("jax", jax_train, []),
                               ("port", port_train, ["--device", "cpu"])):
        results = b / f"results_{name}"
        for cancer, arm in (("brain", "path"), ("brain", "omic"),
                            ("lung", "omic")):
            assert train([
                "--cancer_type", cancer, "--which_splits", "2foldcv",
                "--k", "2", "--max_epochs", "2", "--lr", "1e-3",
                "--data_root_dir", str(b / "features"),
                "--dataset_root", str(b / "dataset_csv"),
                "--splits_root", str(b / "splits"),
                "--results_dir", str(results)] + ARMS[arm] + extra) == 0
        out[name] = results
    out["base"] = b
    # the port's tree with each pkl's ids held as the JAX package holds
    # them (numbers for a numeric cohort): what the JAX CLI would pool
    out["port_as_jax"] = b / "results_port_as_jax"
    shutil.copytree(out["port"], out["port_as_jax"])
    for pkl in out["port_as_jax"].glob("*/*/*/split_train_val_*.pkl"):
        with open(pkl, "rb") as f:
            res = pickle.load(f)
        ids = [str(s) for s in res["subject_id"]]
        if all(s.isdigit() for s in ids):
            res["subject_id"] = np.array([int(s) for s in ids])
        with open(pkl, "wb") as f:
            pickle.dump(res, f)
    return out


# each case is one command line of flags, run by both CLIs on both trees
FLAG_SETS = {
    "all_folds": ["--km", "--km_thresh", "1.0", "--percentiles", "25,50,75",
                  "--hazard_hist", "--bootstrap", "200", "--pivot",
                  "--all_folds"],
    "best_fold_median": ["--km", "--topk", "1", "--percentiles", "50",
                         "--overall_func", "median", "--bootstrap", "50",
                         "--pivot", "--pivot_col", "val_cindex_std",
                         "--heatmap_branch", "auto"],
    "max_omic_branch": ["--km", "--km_thresh", "0.5", "--topk", "3",
                        "--overall_func", "max", "--hazard_hist",
                        "--heatmap_branch", "omic", "--heatmap_save_root",
                        "SAVE_ROOT"],
}


def _run_both(trees, tree, flags, tmp_path, jax_tree=None):
    """Both CLIs with one set of flags, the port's on ``tree`` and JAX's on
    ``jax_tree`` (by default the same); the lung cohort's CSV as
    --cohort_csv and examples/heatmap_omic.yaml as the template."""
    out = {}
    for name, cli in (("jax", jax_summarize), ("port", port_summarize)):
        d = tmp_path / name
        root = trees[jax_tree or tree] if name == "jax" else trees[tree]
        argv = ["--results_root", str(root), "--save_dir",
                str(d / "report"), "--cohort_csv",
                str(trees["base"] / "dataset_csv" / "lung" / "survival.csv"),
                "--emit_heatmap_yamls", str(d / "yamls"),
                "--heatmap_template",
                os.path.join(REPO, "examples", "heatmap_omic.yaml")]
        argv += [str(d / "save_root") if f == "SAVE_ROOT" else f
                 for f in flags]
        assert cli(argv) == 0
        out[name] = d
    return out


@pytest.mark.parametrize("tree", ["jax", "port"])
@pytest.mark.parametrize("flags", sorted(FLAG_SETS))
def test_reports_agree(trees, tmp_path, tree, flags):
    """cv_summary.csv, cv_pivot.csv and risk_group_stats.csv of both CLIs
    on a tree trained by either package, cell by cell.  On the port's
    tree the JAX CLI reads the pkls with the ids held as it holds them
    (numbers for the numeric cohort); the port pools text ids that all
    read as ints in that numeric order (test_pooled_order_and_overlap)."""
    out = _run_both(trees, tree, FLAG_SETS[flags], tmp_path,
                    jax_tree="port_as_jax" if tree == "port" else None)
    names = ["cv_summary.csv", "risk_group_stats.csv"]
    if "--pivot" in FLAG_SETS[flags]:
        names.append("cv_pivot.csv")
    for name in names:
        n = same_cells(out["port"] / "report" / name,
                       out["jax"] / "report" / name)
        assert n > 0, name
    summary = read_rows(out["port"] / "report" / "cv_summary.csv")
    assert len(summary) == 4  # header and three experiments
    stats = read_rows(out["port"] / "report" / "risk_group_stats.csv")
    assert len(stats) == 4
    if "--bootstrap" in FLAG_SETS[flags]:
        lo, hi = stats[0].index("cindex_lo"), stats[0].index("cindex_hi")
        for row in stats[1:]:
            assert float(row[lo]) <= float(row[hi])
    if "--pivot" in FLAG_SETS[flags]:
        pivot = read_rows(out["port"] / "report" / "cv_pivot.csv")
        assert pivot[0] == ["model", "brain", "lung"]


def test_pooled_order_and_overlap(trees, tmp_path):
    """The lung experiment pools 10 subjects validated 9 times per fold
    (8 in both folds): the JAX tree's pkls hold its ids as numbers, the
    port's as text.  The port pools text ids that all read as ints in
    numeric order, as the JAX CLI pools the numbers, so its bootstrap CI
    is the JAX CLI's on the same pkls with numeric ids, bit for bit; the
    JAX CLI given the text ids pools them in text order, which changes
    only the CI draws (and the IPCW c-index's sum order)."""
    for tree in ("jax", "port"):
        exp = next((trees[tree] / "lung" / "2foldcv").iterdir())
        ids = []
        for k in range(2):
            with open(exp / f"split_train_val_{k}_results.pkl", "rb") as f:
                ids.append(list(pickle.load(f)["subject_id"]))
        assert len(set(ids[0]) & set(ids[1])) == 8
        kind = np.asarray(ids[0]).dtype.kind
        assert kind in ("iu" if tree == "jax" else "OU"), kind
    flags = ["--bootstrap", "300"]
    got = _run_both(trees, "port", flags, tmp_path / "a",
                    jax_tree="port_as_jax")
    text_order = _run_both(trees, "port", flags, tmp_path / "b")
    rows = {r[0]: r for r in read_rows(got["port"] / "report"
                                       / "risk_group_stats.csv")}
    want = {r[0]: r for r in read_rows(got["jax"] / "report"
                                       / "risk_group_stats.csv")}
    other = {r[0]: r for r in read_rows(text_order["jax"] / "report"
                                        / "risk_group_stats.csv")}
    head = read_rows(got["port"] / "report" / "risk_group_stats.csv")[0]
    lung = [k for k in rows if k.startswith("lung")][0]
    assert int(rows[lung][1]) == 10
    ci = [head.index("cindex_lo"), head.index("cindex_hi")]
    assert [rows[lung][j] for j in ci] == [want[lung][j] for j in ci]
    assert [rows[lung][j] for j in ci] != [other[lung][j] for j in ci]
    for j, name in enumerate(head[:head.index("iauc")]):
        assert rows[lung][j] == other[lung][j], name


@pytest.mark.parametrize("all_folds", [True, False])
def test_emitted_yamls_parse_equal(trees, tmp_path, all_folds):
    """On the JAX-trained tree both CLIs emit the same configs (one per
    fold, or one per PATH and OMICS experiment), equal under PyYAML and
    under the port's reader; on the port's tree, which has no .msgpack,
    only the port emits (it tests for the .pt that both trainers
    write)."""
    flags = ["--all_folds"] if all_folds else []
    out = _run_both(trees, "jax", flags, tmp_path / "jax_tree")
    got = sorted(os.listdir(out["port"] / "yamls"))
    want = sorted(f for f in os.listdir(out["jax"] / "yamls")
                  if f.endswith(".yaml"))
    assert got == want and len(got) == (6 if all_folds else 3)
    for name in got:
        with open(out["jax"] / "yamls" / name) as f:
            jax_text = f.read()
        with open(out["port"] / "yamls" / name) as f:
            port_text = f.read()
        want_cfg = yaml.safe_load(jax_text)
        # the save_dir is under each CLI's own output directory
        want_cfg["exp_arguments"]["save_dir"] = want_cfg["exp_arguments"][
            "save_dir"].replace(str(out["jax"]), str(out["port"]))
        assert yaml.safe_load(port_text) == want_cfg
        assert yaml_subset.load(port_text) == want_cfg
        assert yaml_subset.load(jax_text)["model_arguments"] == \
            want_cfg["model_arguments"]
    out = _run_both(trees, "port", flags, tmp_path / "port_tree")
    assert len(os.listdir(out["port"] / "yamls")) == (6 if all_folds else 3)
    assert not [f for f in os.listdir(out["jax"] / "yamls")
                if f.endswith(".yaml")]


def test_emitted_omic_yaml_runs_create_heatmaps(trees, tmp_path):
    """An OMICS config emitted by the port, unmodified, through the port's
    create_heatmaps on the CPU: the omic branch writes its CSVs."""
    out = _run_both(trees, "port", [], tmp_path)
    cfgs = sorted((out["port"] / "yamls").glob("*OMICS*.yaml"))
    assert len(cfgs) == 2
    assert port_heatmaps(["--config", str(cfgs[0]), "--device", "cpu"]) == 0
    save_dir = yaml_subset.load_file(str(cfgs[0]))["exp_arguments"][
        "save_dir"]
    rows = read_rows(os.path.join(save_dir, "omic_attr_global.csv"))
    assert len(rows) == 1 + 8  # one row per gene


def test_figures_are_named_not_drawn(trees, tmp_path, capsys):
    """Where the JAX CLI draws cv_compare.png, {exp}_hist.png and
    {exp}_km.png, the port writes no PNG and prints one line naming each."""
    flags = ["--km", "--hazard_hist", "--pivot"]
    out = _run_both(trees, "port", flags, tmp_path)
    text = capsys.readouterr().out
    drawn = sorted(f for f in os.listdir(out["jax"] / "report")
                   if f.endswith(".png"))
    assert len(drawn) == 1 + 3 + 3
    assert not [f for f in os.listdir(out["port"] / "report")
                if f.endswith(".png")]
    named = sorted(w for line in text.splitlines() if " not drawn " in line
                   for w in line.replace(";", " ").split()
                   if w.endswith(".png"))
    assert named == drawn


def test_no_results_and_bad_pivot_col(tmp_path, capsys):
    """An empty tree: both CLIs write the same empty cv_summary.csv and no
    risk_group_stats.csv; an unknown --pivot_col is reported, not
    raised."""
    (tmp_path / "empty").mkdir()
    for name, cli in (("jax", jax_summarize), ("port", port_summarize)):
        assert cli(["--results_root", str(tmp_path / "empty"), "--save_dir",
                    str(tmp_path / name), "--pivot"]) == 0
    for name in ("jax", "port"):
        assert (tmp_path / name / "cv_summary.csv").read_text() == "\n"
        assert not (tmp_path / name / "risk_group_stats.csv").exists()
    res = tmp_path / "one" / "c" / "s" / "OMICS_x"
    res.mkdir(parents=True)
    (res / "summary.csv").write_text(",folds,val_cindex\n0,0,0.5\n")
    capsys.readouterr()
    assert port_summarize(["--results_root", str(tmp_path / "one"),
                           "--save_dir", str(tmp_path / "p2"), "--pivot",
                           "--pivot_col", "nope"]) == 0
    assert "--pivot_col 'nope' not in cv_summary columns" in \
        capsys.readouterr().out
    assert not (tmp_path / "p2" / "cv_pivot.csv").exists()
    shutil.rmtree(tmp_path / "one")
