"""The radiology experiments of the port's CLIs (multimodalfusion_tpu_torch.
cli.{main,infer,pre_trained_feature,main_pretrained}) against the JAX
package's, end to end on the CPU on tests/fixtures.py's cohort (16
subjects, four MRI sequences of 6-20 slices as feature h5 files, one
slide each, 12 genomic columns): the port trains radio AMIL and
radio+path+omic fusion folds; on a JAX-trained radio experiment its
--eval_only c-index, its served risks (rel 1e-4) and its stage-3
embeddings (1e-5) are JAX's; and a stage-4 head trains on the radio
embeddings the port extracted itself."""
import csv
import json
import math
import os
import pickle
import shutil

import numpy as np
import pytest
import torch

from fixtures import (make_cohort_csv, make_feature_store,
                      make_pretrained_store, make_splits)

from multimodalfusion_tpu.cli.infer import main as jax_infer
from multimodalfusion_tpu.cli.main import main as jax_main
from multimodalfusion_tpu.cli.pre_trained_feature import main as jax_stage3
from multimodalfusion_tpu_torch.cli.infer import main as port_infer
from multimodalfusion_tpu_torch.cli.main import main as port_main
from multimodalfusion_tpu_torch.cli.main_pretrained import \
    main as port_stage4
from multimodalfusion_tpu_torch.cli.pre_trained_feature import \
    main as port_stage3

N_SUBJECTS = 16
MODELS = {
    "radio": ["--model_type", "radio_attention_mil", "--mode", "radio",
              "--gate_radio", "--drop_out", "--bag_loss", "nll_surv"],
    "radio_path_omic": ["--model_type", "mm_attention_mil", "--mode",
                        "radio_path_omic", "--fusion", "tensor",
                        "--gate_path", "--gate_radio", "--drop_out",
                        "--bag_loss", "nll_surv"],
}


@pytest.fixture(scope="module")
def cohort(tmp_path_factory):
    base = tmp_path_factory.mktemp("torch_radio_cli")
    _, df, latent = make_cohort_csv(str(base / "dataset_csv" / "brain"),
                                    n=N_SUBJECTS, seed=4)
    make_feature_store(str(base / "features" / "brain"), df, latent, seed=4,
                       bag_range=(6, 20))
    make_splits(str(base / "splits" / "brain" / "2foldcv"), df, k=2,
                val_frac=0.5, seed=4)
    return base


def cli_args(base, results_dir, model, *extra):
    return ["--cancer_type", "brain", "--which_splits", "2foldcv",
            "--k", "2", "--k_end", "1", "--max_epochs", "2",
            "--batch_size", "4", "--lr", "1e-3", *MODELS[model],
            "--data_root_dir", str(base / "features"),
            "--dataset_root", str(base / "dataset_csv"),
            "--splits_root", str(base / "splits"),
            "--results_dir", str(results_dir), *extra]


def exp_dir(results_dir):
    return next((results_dir / "brain" / "2foldcv").iterdir())


def read_risks(path):
    with open(path) as f:
        return {r["subject_id"]: r for r in csv.DictReader(f)}


@pytest.fixture(scope="module")
def port_runs(cohort):
    """One fold, two epochs of the port's CLI per model, on the CPU."""
    for model in MODELS:
        assert port_main(cli_args(cohort, cohort / "port" / model, model,
                                  "--device", "cpu")) == 0
    return {m: exp_dir(cohort / "port" / m) for m in MODELS}


@pytest.fixture(scope="module")
def jax_radio(cohort):
    """One fold, two epochs of the JAX CLI's radio AMIL; msgpack
    checkpoints and their .pt exports."""
    assert jax_main(cli_args(cohort, cohort / "jax", "radio")) == 0
    return cohort / "jax"


@pytest.mark.parametrize("model", list(MODELS))
def test_port_trains_radio_folds(cohort, port_runs, model, tmp_path):
    """Two epochs of finite losses, the fold's files, and cli.infer on the
    trained checkpoint gives the fold's own validation risks."""
    exp = port_runs[model]
    recs = [json.loads(x) for x in open(exp / "0" / "metrics.jsonl")]
    assert len(recs) == 2
    assert all(math.isfinite(r[k]) for r in recs
               for k in ("train_loss", "val_loss"))
    for name in ("s_0_checkpoint.pt", "s_0_minloss_checkpoint.pt",
                 "summary_partial_0_1.csv", "split_train_val_0_results.pkl"):
        assert (exp / name).exists(), name
    settings = (exp / f"experiment_{exp.name}.txt").read_text()
    assert "'radio_modality': ['T1', 'T2', 'T1Gd', 'FLAIR']" in settings
    out = tmp_path / "risks.csv"
    assert port_infer(["--model_path", str(exp), "--which_k", "0", "--out",
                       str(out), "--device", "cpu"]) == 0
    served = read_risks(out)
    assert len(served) == N_SUBJECTS
    with open(exp / "split_train_val_0_results.pkl", "rb") as f:
        res = pickle.load(f)
    got = np.array([float(served[s]["risk"]) for s in res["subject_id"]])
    np.testing.assert_allclose(got, res["risk"], rtol=1e-5)


def test_port_radio_file_set_is_the_jax_clis(port_runs, jax_radio):
    jexp, texp = exp_dir(jax_radio), port_runs["radio"]
    assert jexp.name == texp.name
    # .pt checkpoints only; JAX's resume bundle is the port's .pt one
    jfiles = {p.relative_to(jexp).as_posix().replace(
        "_resume.msgpack", "_resume.pt") for p in jexp.rglob("*")
        if p.is_file() and (not p.name.endswith(".msgpack")
                            or p.name.endswith("_resume.msgpack"))}
    tfiles = {p.relative_to(texp).as_posix() for p in texp.rglob("*")
              if p.is_file()}
    assert tfiles == jfiles
    jsd = torch.load(jexp / "s_0_minloss_checkpoint.pt", weights_only=True)
    tsd = torch.load(texp / "s_0_minloss_checkpoint.pt", weights_only=True)
    assert list(tsd) == list(jsd)
    assert all(tsd[k].shape == jsd[k].shape for k in jsd)


def test_eval_only_matches_jax(cohort, jax_radio, tmp_path):
    """--eval_only of the port on the JAX-trained radio experiment (its .pt
    export) gives the JAX CLI's validation c-index and risks at rel
    1e-4."""
    runs = {}
    for name, main, extra in (("jax", jax_main, ()),
                              ("port", port_main, ("--device", "cpu"))):
        root = tmp_path / name
        shutil.copytree(jax_radio, root)
        assert main(cli_args(cohort, root, "radio", "--eval_only",
                             *extra)) == 0
        exp = exp_dir(root)
        with open(exp / "split_train_val_0_results.pkl", "rb") as f:
            res = pickle.load(f)
        with open(exp / "eval_summary_partial_0_1.csv") as f:
            rows = list(csv.reader(f))
        runs[name] = (res, rows)
    (jres, jrows), (tres, trows) = runs["jax"], runs["port"]
    assert trows[0] == jrows[0]
    assert float(trows[1][2]) == pytest.approx(float(jrows[1][2]),
                                               rel=1e-4)
    np.testing.assert_array_equal(tres["subject_id"], jres["subject_id"])
    np.testing.assert_allclose(tres["risk"], jres["risk"], rtol=1e-4)
    np.testing.assert_allclose(tres["prob"], jres["prob"], rtol=1e-4,
                               atol=1e-6)


def test_infer_matches_jax(jax_radio, tmp_path):
    """cli.infer of both packages on the JAX-trained radio experiment:
    the same subjects, risks, hazards and survival at rel 1e-4."""
    exp = exp_dir(jax_radio)
    outs = {}
    for name, main, extra in (("jax", jax_infer, []),
                              ("port", port_infer, ["--device", "cpu"])):
        outs[name] = tmp_path / f"{name}.csv"
        assert main(["--model_path", str(exp), "--which_k", "0", "--out",
                     str(outs[name]), "--batch_size", "5"] + extra) == 0
    want, got = read_risks(outs["jax"]), read_risks(outs["port"])
    assert sorted(got) == sorted(want) and len(got) == N_SUBJECTS
    cols = [c for c in next(iter(want.values())) if c != "subject_id"]
    assert list(next(iter(got.values())))[1:] == cols
    for c in cols:
        w = np.array([float(want[s][c]) for s in sorted(want)])
        g = np.array([float(got[s][c]) for s in sorted(want)])
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-7, err_msg=c)


def test_stage3_radio_embeddings_match_jax(jax_radio, tmp_path):
    """Stage 3 of both packages on the JAX-trained radio experiment:
    radio_pt_files/{subject}.pt, [1, 256] float32, at 1e-5 of the largest
    entry."""
    exp = exp_dir(jax_radio)
    roots = {}
    for name, main, extra in (("jax", jax_stage3, []),
                              ("port", port_stage3, ["--device", "cpu"])):
        roots[name] = tmp_path / name
        assert main(["--checkpoint_path", str(exp), "--which_k", "0",
                     "--output_dir", str(roots[name]), "--batch_size", "3"]
                    + extra) == 0
    jdir, tdir = (roots[n] / "brain" / "radio_pt_files"
                  for n in ("jax", "port"))
    names = sorted(os.listdir(jdir))
    assert sorted(os.listdir(tdir)) == names and len(names) == N_SUBJECTS
    for n in names:
        got = torch.load(tdir / n, weights_only=True).numpy()
        want = torch.load(jdir / n, weights_only=True).numpy()
        assert got.shape == want.shape == (1, 256)
        assert got.dtype == np.float32
        assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max(), n


def test_stage4_trains_on_the_ports_radio_embeddings(cohort, port_runs,
                                                     tmp_path):
    """The paper's trimodal stage 4 (README: main_pretrained --mode
    radio_path_omic --train_type early-fcnn) on the radio embeddings that
    the port's stage 3 extracted from its own radio experiment, beside
    path and omic embeddings from tests/fixtures.py."""
    out = tmp_path / "pre"
    assert port_stage3(["--checkpoint_path", str(port_runs["radio"]),
                        "--which_k", "0", "--output_dir", str(out),
                        "--device", "cpu"]) == 0
    import pandas as pd
    df = pd.read_csv(cohort / "dataset_csv" / "brain" / "survival.csv")
    store = tmp_path / "store"
    make_pretrained_store(str(store), df, np.zeros(len(df)), seed=1)
    for m in ("path", "omic"):
        shutil.copytree(store / f"{m}_pt_files",
                        out / "brain" / f"{m}_pt_files")
    radio = sorted(os.listdir(out / "brain" / "radio_pt_files"))
    assert len(radio) == N_SUBJECTS
    results = tmp_path / "s4"
    assert port_stage4([
        "--cancer_type", "brain", "--which_splits", "2foldcv",
        "--data_root_dir", str(out),
        "--dataset_root", str(cohort / "dataset_csv"),
        "--splits_root", str(cohort / "splits"),
        "--model_type", "mm_attention_mil", "--mode", "radio_path_omic",
        "--train_type", "early-fcnn", "--bag_loss", "nll_surv",
        "--k", "2", "--k_end", "1", "--max_epochs", "2", "--batch_size",
        "8", "--results_dir", str(results), "--device", "cpu"]) == 0
    exp = exp_dir(results)
    recs = [json.loads(x) for x in open(exp / "0" / "metrics.jsonl")]
    assert len(recs) == 2
    assert all(math.isfinite(r[k]) for r in recs
               for k in ("train_loss", "val_loss"))
    assert (exp / "s_0_minloss_checkpoint.pt").exists()
