"""The port's interpretability CLIs (multimodalfusion_tpu_torch.cli.
{create_attributions,create_heatmaps}) against the JAX package's on the
CPU, on experiments the JAX CLIs trained on the synthetic cohort of
tests/fixtures.py, built as tests/test_interpret_clis.py builds them: a
stage-4 trimodal early-fcnn head (two folds), a max_net, and a 2-sequence
tensor-fusion radio AMIL, which the port serves from the JAX export and
the flax checkpoint beside it.  attr.csv, attr_orig.csv, scores.csv and
both omic CSVs agree at rel 1e-4 with identical ids, groups, columns and
order.  Also: its YAML reader against PyYAML; its CSV writer and group means
against pandas."""
import csv
import os

import numpy as np
import pandas as pd
import pytest
import torch
import yaml
from hypothesis import given, settings, strategies as st

import jax

from fixtures import (make_cohort_csv, make_feature_store,
                      make_pretrained_store, make_splits)

from multimodalfusion_tpu.cli.create_attributions import main as jax_attr
from multimodalfusion_tpu.cli.create_heatmaps import main as jax_heatmaps
from multimodalfusion_tpu.cli.infer import main as jax_infer
from multimodalfusion_tpu.cli.main import main as jax_stage2
from multimodalfusion_tpu.cli.main_pretrained import main as jax_stage4
from multimodalfusion_tpu_torch.cli import create_heatmaps as port_hm_mod
from multimodalfusion_tpu_torch.cli.create_attributions import \
    main as port_attr
from multimodalfusion_tpu_torch.cli.infer import main as port_infer
from multimodalfusion_tpu_torch.utils import table, yaml_subset

port_heatmaps = port_hm_mod.main


def read(path):
    with open(path, newline="") as f:
        rows = list(csv.reader(f))
    return rows[0], rows[1:]


def same_csv(got_path, want_path, text_cols, rtol=1e-4):
    """The same header and rows in the same order; the text columns
    equal, every other column within rtol of its largest |value|."""
    gh, got = read(got_path)
    wh, want = read(want_path)
    assert gh == wh
    assert len(got) == len(want) > 0
    for j, name in enumerate(wh):
        g = [r[j] for r in got]
        w = [r[j] for r in want]
        if name in text_cols:
            assert g == w, name
        else:
            g, w = np.array(g, float), np.array(w, float)
            assert np.abs(g - w).max() <= rtol * np.abs(w).max(), name


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    b = tmp_path_factory.mktemp("torch_interp")
    _, df, latent = make_cohort_csv(str(b / "dataset_csv" / "brain"), n=20,
                                    seed=21, modalities=["T1", "T2"])
    make_feature_store(str(b / "features" / "brain"), df, latent, seed=21,
                       modalities=["T1", "T2"], bag_range=(5, 15))
    make_pretrained_store(str(b / "features" / "brain"), df, latent,
                          seed=21)
    make_splits(str(b / "splits" / "brain" / "2foldcv"), df, k=2, seed=21)
    common = ["--cancer_type", "brain", "--which_splits", "2foldcv",
              "--k", "2", "--data_root_dir", str(b / "features"),
              "--dataset_root", str(b / "dataset_csv"),
              "--splits_root", str(b / "splits"), "--overwrite",
              "--lr", "1e-3"]
    assert jax_stage4(common + [
        "--results_dir", str(b / "s4"), "--model_type", "mm_attention_mil",
        "--mode", "radio_path_omic", "--train_type", "early-fcnn",
        "--bag_loss", "nll_surv", "--batch_size", "8",
        "--max_epochs", "2"]) == 0
    assert jax_stage2(common + [
        "--k_end", "1", "--results_dir", str(b / "s2o"),
        "--model_type", "max_net", "--mode", "omic", "--bag_loss",
        "nll_surv", "--batch_size", "8", "--max_epochs", "1"]) == 0
    assert jax_stage2(common + [
        "--k_end", "1", "--results_dir", str(b / "s2r"),
        "--model_type", "radio_attention_mil", "--mode", "radio",
        "--modality", "T1,T2", "--radio_fusion", "tensor", "--gate_radio",
        "--bag_loss", "nll_surv", "--batch_size", "4",
        "--max_epochs", "1"]) == 0
    exps = {name: next((b / name / "brain" / "2foldcv").iterdir())
            for name in ("s4", "s2o", "s2r")}
    return b, df, exps


def test_create_attributions_matches_jax(trained, tmp_path):
    """Two folds of IG over the validation splits: attr.csv and
    attr_orig.csv, subjects sorted, averaged across folds."""
    _, _, exps = trained
    exp = exps["s4"]
    args = ["--model_path", str(exp), "--batch_size", "8"]
    assert jax_attr(args + ["--save_dir", str(tmp_path / "jax")]) == 0
    assert port_attr(args + ["--save_dir", str(tmp_path / "port"),
                             "--device", "cpu"]) == 0
    sub = os.path.join("brain", "2foldcv", exp.name)
    for name in ("attr.csv", "attr_orig.csv"):
        same_csv(tmp_path / "port" / sub / name, tmp_path / "jax" / sub / name,
                 {"subject_id"})
    header, rows = read(tmp_path / "port" / sub / "attr.csv")
    assert header == ["subject_id", "radio_attr", "path_attr", "omic_attr"]
    assert len(rows) > 10


def _config(path, cfg):
    path.write_text(yaml.safe_dump(cfg))
    assert yaml_subset.load_file(str(path)) == yaml.safe_load(
        path.read_text())
    return str(path)


def test_radio_tensor_experiment_is_served_like_jax(trained, tmp_path):
    """The JAX-trained 2-sequence tensor-fusion radio experiment: its .pt
    holds the 4-sequence placeholder, the port takes the trained fusion
    from the msgpack beside it and serves JAX's risks at rel 1e-5."""
    _, _, exps = trained
    common = ["--model_path", str(exps["s2r"]), "--which_k", "0",
              "--batch_size", "4"]
    assert jax_infer(common + ["--out", str(tmp_path / "jax.csv")]) == 0
    assert port_infer(common + ["--out", str(tmp_path / "port.csv"),
                                "--device", "cpu"]) == 0
    same_csv(tmp_path / "port.csv", tmp_path / "jax.csv", {"subject_id"},
             rtol=1e-5)


def test_heatmap_radio_branch_matches_jax(trained, tmp_path):
    """scores.csv of three subjects through the 2-sequence tensor-fusion
    experiment's attention read-out: the same slices, groups and order,
    attention at rel 1e-4."""
    b, df, exps = trained
    plist = tmp_path / "subjects.csv"
    pd.DataFrame({"subject_id": df["subject_id"].iloc[:3]}).to_csv(
        plist, index=False)
    for side, main, extra in (("jax", jax_heatmaps, []),
                              ("port", port_heatmaps, ["--device", "cpu"])):
        cfg = _config(tmp_path / f"{side}.yaml", {
            "exp_arguments": {"branch": "radio",
                              "save_dir": str(tmp_path / side)},
            "data_arguments": {"process_list": str(plist),
                               "feat_dir": str(b / "features" / "brain"),
                               "modalities": ["T1", "T2"]},
            "model_arguments": {"ckpt_path": str(exps["s2r"]),
                                "which_k": 0}})
        assert main(["--config", cfg] + extra) == 0
    same_csv(tmp_path / "port" / "scores.csv", tmp_path / "jax" / "scores.csv",
             {"subject_id", "slice_index", "group"})
    _, rows = read(tmp_path / "port" / "scores.csv")
    assert {r[3] for r in rows} == {"top", "mid", "low"}


def _jax_draws(seed, n_samples, B, M):
    """The draws of the JAX package's expected_gradients (JAX
    interpret/ig.py:86-90)."""
    key = jax.random.PRNGKey(seed)
    bidx = jax.random.randint(key, (n_samples, B), 0, M)
    alphas = jax.random.uniform(jax.random.fold_in(key, 1), (n_samples, B))
    return (torch.from_numpy(np.asarray(bidx).astype(np.int64)),
            torch.from_numpy(np.asarray(alphas)))


@pytest.mark.parametrize("method", ["ig", "expected_gradients"])
def test_heatmap_omic_branch_matches_jax(trained, tmp_path, monkeypatch,
                                         method):
    """Per-patient and global gene attributions of the max_net: the same
    subjects, genes, columns and order at rel 1e-4; expected gradients
    over JAX's own draws (the port's own draws differ by design)."""
    _, _, exps = trained
    monkeypatch.setattr(
        port_hm_mod, "expected_gradient_draws",
        lambda n, B, M, generator: _jax_draws(generator.initial_seed(), n,
                                              B, M))
    for side, main, extra in (("jax", jax_heatmaps, []),
                              ("port", port_heatmaps, ["--device", "cpu"])):
        cfg = _config(tmp_path / f"{side}.yaml", {
            "exp_arguments": {"branch": "omic",
                              "save_dir": str(tmp_path / side)},
            "data_arguments": {},
            "model_arguments": {"ckpt_path": str(exps["s2o"]),
                                "which_k": 0},
            "heatmap_arguments": {"method": method, "shap_samples": 48,
                                  "local_n": 1, "max_display": 4}})
        assert main(["--config", cfg] + extra) == 0
    same_csv(tmp_path / "port" / "omic_attr_per_patient.csv",
             tmp_path / "jax" / "omic_attr_per_patient.csv", {"subject_id"})
    same_csv(tmp_path / "port" / "omic_attr_global.csv",
             tmp_path / "jax" / "omic_attr_global.csv", {"gene"})
    assert not list((tmp_path / "port").glob("*.png"))


def test_new_clis_need_cuda_unless_cpu_is_asked(trained, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    _, _, exps = trained
    with pytest.raises(RuntimeError, match="--device cpu"):
        port_attr(["--model_path", str(exps["s4"]),
                   "--save_dir", str(tmp_path)])
    cfg = _config(tmp_path / "omic.yaml", {
        "exp_arguments": {"branch": "omic", "save_dir": str(tmp_path)},
        "model_arguments": {"ckpt_path": str(exps["s2o"])}})
    with pytest.raises(RuntimeError, match="--device cpu"):
        port_heatmaps(["--config", cfg])


# ---------------------------------------------------------------------------
# the YAML reader and the CSV writer
# ---------------------------------------------------------------------------

EXAMPLES = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "examples")


@pytest.mark.parametrize("name", ["path", "radio", "omic"])
def test_yaml_reader_reads_the_example_configs(name):
    path = os.path.join(EXAMPLES, f"heatmap_{name}.yaml")
    with open(path) as f:
        want = yaml.safe_load(f)
    assert yaml_subset.load_file(path) == want


def test_yaml_reader_reads_the_jax_tests_configs():
    """yaml.safe_dump of the configs tests/test_interpret_clis.py writes
    (the path one with its list-form samples)."""
    configs = [
        {"exp_arguments": {"branch": "path", "save_dir": "/t/hm_path",
                           "raw_save_dir": "/t/raw"},
         "data_arguments": {"process_list": "/t/slides.csv",
                            "data_dir": "/t/slides",
                            "feat_dir": "/t/wsifeat"},
         "patching_arguments": {"patch_size": 256, "a_t": 0.5,
                                "a_h": 0.05, "batch_size": 16,
                                "target_patch_size": 128},
         "model_arguments": {"ckpt_path": "/t/s2p/brain/PATH_a0.0_s1",
                             "which_k": 0, "allow_random_weights": True},
         "heatmap_arguments": {"alpha": 0.4, "cmap": "coolwarm",
                               "overlap": 0.5, "save_orig": True},
         "sample_arguments": {"samples": [
             {"name": "topk_high_attention", "sample": True, "k": 3,
              "mode": "topk"},
             {"name": "mid_band", "sample": True, "seed": 1, "k": 2,
              "mode": "range_sample", "score_start": 0.2,
              "score_end": 0.8},
             {"name": "skipped", "sample": False, "k": 5, "mode": "topk"}]}},
        {"exp_arguments": {"branch": "radio", "save_dir": "/t/hm_radio"},
         "data_arguments": {"process_list": "/t/subjects.csv",
                            "feat_dir": "/t/features/brain",
                            "modalities": ["T1", "T2", "T1Gd", "FLAIR"],
                            "scan_list": "/t/scan_list.csv",
                            "display_modality": ["T1", "FLAIR"],
                            "cancer_type": "lung"},
         "model_arguments": {"ckpt_path": "/t/s2r", "which_k": 0}},
        {"exp_arguments": {"branch": "omic", "save_dir": "/t/hm_omic_eg"},
         "data_arguments": {},
         "model_arguments": {"ckpt_path": "/t/s2o", "which_k": 0},
         "heatmap_arguments": {"local_n": 2, "method": "expected_gradients",
                               "shap_samples": 64}}]
    for cfg in configs:
        # as those tests write them, and in mixed style on unbounded lines
        for text in (yaml.safe_dump(cfg),
                     yaml.safe_dump(cfg, default_flow_style=None,
                                    width=10 ** 6)):
            assert yaml_subset.load(text) == yaml.safe_load(text) == cfg


@pytest.mark.parametrize("text", [
    "a: &x 1\nb: *x\n", "a: !!str 1\n", "a: |\n  block\n", "a: >\n  fold\n",
    "--- \na: 1\n", "%YAML 1.1\n---\na: 1\n", "? a\n: b\n", "a: b\n  c\n",
    "a: [1,\n  2]\n", "a: 'x\n  y'\n", "a: 0x10\n", "a: 1_000\n",
    "a: 2001-12-14\n", "<<: {b: 1}\n", "a: b: c\n", "- a\nb: 1\n"])
def test_yaml_reader_refuses_what_is_outside_its_subset(text):
    with pytest.raises(ValueError, match="outside the subset"):
        yaml_subset.load(text)


_ascii = st.text(st.characters(min_codepoint=32, max_codepoint=126),
                 max_size=24)
_scalar = st.one_of(st.none(), st.booleans(),
                    st.integers(-10 ** 12, 10 ** 12),
                    st.floats(allow_nan=False, width=64), _ascii)
_key = st.text(st.characters(min_codepoint=33, max_codepoint=126),
               min_size=1, max_size=12)
_config_tree = st.recursive(
    _scalar, lambda kids: st.one_of(
        st.lists(kids, max_size=4),
        st.dictionaries(_key, kids, max_size=4)),
    max_leaves=20)


@settings(max_examples=150, deadline=None)
@given(st.dictionaries(_key, _config_tree, max_size=5))
def test_yaml_reader_equals_pyyaml_on_generated_configs(cfg):
    """Nested configs of the subset, dumped by PyYAML in block and mixed
    style on unbounded lines (a folded line is outside the subset)."""
    for flow in (False, None):
        text = yaml.safe_dump(cfg, default_flow_style=flow, width=10 ** 6)
        assert yaml_subset.load(text) == yaml.safe_load(text)


def test_csv_writer_and_group_means_match_pandas(tmp_path):
    """write_csv is DataFrame.to_csv (floats of either width, NaN, text);
    group_mean is groupby().mean() with pandas' key order: text ids sort
    as text; ids that are all numbers sort as numbers, as pandas reads
    such a column, but stay text ('007' stays '007' where pandas writes
    7)."""
    rng = np.random.default_rng(0)
    x32 = rng.normal(size=7).astype(np.float32)
    x64 = rng.normal(size=7)
    x64[3] = np.nan
    cols = {"subject_id": [f"S{i % 3}" for i in range(7)], "a": x32,
            "b": x64}
    table.write_csv(str(tmp_path / "mine.csv"), cols)
    pd.DataFrame(cols).to_csv(tmp_path / "pandas.csv", index=False)
    assert (tmp_path / "mine.csv").read_text() == \
        (tmp_path / "pandas.csv").read_text()
    table.write_csv(str(tmp_path / "mine_i.csv"), cols, index=True)
    pd.DataFrame(cols).to_csv(tmp_path / "pandas_i.csv")
    assert (tmp_path / "mine_i.csv").read_text() == \
        (tmp_path / "pandas_i.csv").read_text()

    for ids, numeric in ((["b", "a10", "a9", "b", "a10"], False),
                         (["10", "9", "007", "10", "9"], True)):
        v = rng.normal(size=5).astype(np.float32)
        keys, means = table.group_mean(ids, {"v": v})
        frame = pd.DataFrame({"subject_id": [int(s) for s in ids]
                              if numeric else ids, "v": v})
        want = frame.groupby("subject_id").mean()
        assert keys == ([s for s in ("007", "9", "10")] if numeric
                        else [str(k) for k in want.index])
        assert [int(k) for k in keys] == list(want.index) if numeric \
            else True
        assert means["v"].dtype == want["v"].dtype == np.float32
        np.testing.assert_allclose(means["v"], want["v"].to_numpy(),
                                   rtol=1e-6)


def test_create_attributions_with_numeric_ids_matches_jax(tmp_path):
    """A cohort whose subject ids are all numbers, of 1 to 3 digits (text
    order differs from numeric order): both CLIs write the same rows of
    attr.csv and attr_orig.csv in the same (numeric) order, at rel 1e-4."""
    _, df, latent = make_cohort_csv(str(tmp_path / "dataset_csv" / "brain"),
                                    n=20, seed=21, modalities=["T1", "T2"])
    ids = [str(5 + 13 * i) for i in range(20)]
    df["subject_id"] = ids
    df["slide_id"] = [f"{s}-SLIDE.svs" for s in ids]
    df.to_csv(tmp_path / "dataset_csv" / "brain" / "survival.csv",
              index=False)
    make_pretrained_store(str(tmp_path / "features" / "brain"), df, latent,
                          seed=21)
    make_splits(str(tmp_path / "splits" / "brain" / "2foldcv"), df, k=2,
                seed=21)
    assert jax_stage4([
        "--cancer_type", "brain", "--which_splits", "2foldcv", "--k", "2",
        "--data_root_dir", str(tmp_path / "features"),
        "--dataset_root", str(tmp_path / "dataset_csv"),
        "--splits_root", str(tmp_path / "splits"), "--overwrite",
        "--lr", "1e-3", "--results_dir", str(tmp_path / "s4"),
        "--model_type", "mm_attention_mil", "--mode", "radio_path_omic",
        "--train_type", "early-fcnn", "--bag_loss", "nll_surv",
        "--batch_size", "8", "--max_epochs", "1"]) == 0
    exp = next((tmp_path / "s4" / "brain" / "2foldcv").iterdir())
    args = ["--model_path", str(exp), "--batch_size", "8"]
    assert jax_attr(args + ["--save_dir", str(tmp_path / "jax")]) == 0
    assert port_attr(args + ["--save_dir", str(tmp_path / "port"),
                             "--device", "cpu"]) == 0
    sub = os.path.join("brain", "2foldcv", exp.name)
    for name in ("attr.csv", "attr_orig.csv"):
        same_csv(tmp_path / "port" / sub / name, tmp_path / "jax" / sub / name,
                 {"subject_id"})
    _, rows = read(tmp_path / "port" / sub / "attr.csv")
    got = [int(r[0]) for r in rows]
    assert got == sorted(got) and [str(i) for i in got] != sorted(
        str(i) for i in got)
