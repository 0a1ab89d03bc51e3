"""Stages 3 and 4 of the port (multimodalfusion_tpu_torch.cli.
{pre_trained_feature,main_pretrained,eval_pretrained,infer}) against the
JAX package's CLIs, end to end on the CPU on the synthetic cohort of
tests/fixtures.py: JAX-trained stage-2 path and omic experiments, the
embeddings both packages extract from them (at 1e-5), a JAX-trained
stage-4 experiment evaluated by both (c-index and IBS to 1e-6, risks at
rel 1e-5) and served by both, and the port's own stage-4 training
writing the JAX CLI's files."""
import csv
import json
import math
import os
import pickle
import shutil

import numpy as np
import pytest
import torch

from fixtures import make_cohort_csv, make_feature_store, make_splits

from multimodalfusion_tpu.cli.eval_pretrained import main as jax_eval
from multimodalfusion_tpu.cli.infer import main as jax_infer
from multimodalfusion_tpu.cli.main import main as jax_stage2
from multimodalfusion_tpu.cli.main_pretrained import main as jax_stage4
from multimodalfusion_tpu.cli.pre_trained_feature import main as jax_stage3
from multimodalfusion_tpu_torch.cli.eval_pretrained import main as port_eval
from multimodalfusion_tpu_torch.cli.infer import main as port_infer
from multimodalfusion_tpu_torch.cli.main_pretrained import \
    main as port_stage4
from multimodalfusion_tpu_torch.cli.pre_trained_feature import \
    main as port_stage3

N_SUBJECTS = 20
STAGE2 = {"path": ["--model_type", "path_attention_mil", "--mode", "path",
                   "--gate_path", "--bag_loss", "nll_surv"],
          "omic": ["--model_type", "max_net", "--mode", "omic",
                   "--bag_loss", "cox_surv"]}
STAGE4 = {"kronecker_nll": ["--train_type", "kronecker", "--bag_loss",
                            "nll_surv"],
          "mm_dropout_cox": ["--train_type", "multimodal-dropout",
                             "--bag_loss", "cox_surv"]}


def data_args(base, features, splits="2foldcv"):
    return ["--cancer_type", "brain", "--which_splits", splits,
            "--data_root_dir", str(features),
            "--dataset_root", str(base / "dataset_csv"),
            "--splits_root", str(base / "splits")]


def exp_dir(results, splits="2foldcv"):
    return next((results / "brain" / splits).iterdir())


def stage4_args(base, features, results, case, *extra):
    return (data_args(base, features) + STAGE4[case]
            + ["--model_type", "mm_attention_mil", "--mode", "path_omic",
               "--k", "2", "--k_end", "1", "--max_epochs", "2",
               "--batch_size", "8", "--lr", "1e-3",
               "--results_dir", str(results), *extra])


@pytest.fixture(scope="module")
def stage2(tmp_path_factory):
    """The cohort (20 subjects, bags of 6-20 instances, a 2-fold split set
    and a 2-fold one with a test column) and one JAX-trained fold per
    stage-2 model (one epoch)."""
    base = tmp_path_factory.mktemp("torch_pretrained")
    _, df, latent = make_cohort_csv(str(base / "dataset_csv" / "brain"),
                                    n=N_SUBJECTS, seed=9)
    make_feature_store(str(base / "features" / "brain"), df, latent, seed=9,
                       modalities=["T1"], bag_range=(6, 20))
    make_splits(str(base / "splits" / "brain" / "2foldcv"), df, k=2,
                val_frac=0.3, seed=9)
    make_splits(str(base / "splits" / "brain" / "2foldtest"), df, k=2,
                val_frac=0.3, seed=9, test_frac=0.2)
    exps = {}
    for mode, flags in STAGE2.items():
        results = base / f"s2_{mode}"
        assert jax_stage2(data_args(base, base / "features") + flags + [
            "--k", "2", "--k_end", "1", "--max_epochs", "1",
            "--batch_size", "4", "--lr", "1e-3",
            "--results_dir", str(results)]) == 0
        exps[mode] = exp_dir(results)
    # stage 3 writes path embeddings for the first 15 subjects only
    keep = base / "keep.csv"
    keep.write_text("subject_id\n" + "".join(
        f"{s}\n" for s in df["subject_id"][:15]))
    return base, exps, keep, list(df["subject_id"])


def stage3_argv(exp, out, keep=None, batch_size=8):
    argv = ["--checkpoint_path", str(exp), "--which_k", "0",
            "--output_dir", str(out), "--batch_size", str(batch_size)]
    return argv + (["--extraction_csv_path", str(keep)] if keep else [])


@pytest.fixture(scope="module")
def embeddings(stage2):
    """Stage 3 of both packages (port with --device cpu) on both
    experiments, the path one limited by --extraction_csv_path."""
    base, exps, keep, _ = stage2
    for name, main, extra in (("jax", jax_stage3, []),
                              ("port", port_stage3, ["--device", "cpu"])):
        for mode, exp in exps.items():
            assert main(stage3_argv(exp, base / f"pre_{name}",
                                    keep if mode == "path" else None)
                        + extra) == 0
    return base / "pre_jax", base / "pre_port"


def load(path):
    return torch.load(path, map_location="cpu", weights_only=True).numpy()


@pytest.mark.parametrize("mode", ["path", "omic"])
def test_stage3_writes_the_jax_embeddings(stage2, embeddings, tmp_path,
                                          mode):
    """Same files (the path ones limited to the extraction CSV), [1, 256]
    float32, equal to JAX's at 1e-5 of the largest entry; a rerun keeps
    the files it finds."""
    base, exps, _, subjects = stage2
    jroot, troot = (r / "brain" / f"{mode}_pt_files" for r in embeddings)
    names = sorted(os.listdir(jroot))
    assert sorted(os.listdir(troot)) == names
    assert len(names) == (15 if mode == "path" else N_SUBJECTS)
    for name in names:
        got, want = load(troot / name), load(jroot / name)
        assert got.shape == want.shape == (1, 256)
        assert got.dtype == np.float32
        assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max(), name
    rerun = tmp_path / "rerun"
    shutil.copytree(embeddings[1], rerun)
    again = rerun / "brain" / f"{mode}_pt_files"
    stamp = os.stat(again / names[0]).st_mtime_ns
    assert port_stage3(stage3_argv(exps[mode], rerun)
                       + ["--device", "cpu"]) == 0
    assert os.stat(again / names[0]).st_mtime_ns == stamp
    # without the extraction CSV the other subjects are added
    assert sorted(os.listdir(again)) == sorted(f"{s}.pt" for s in subjects)


@pytest.fixture(scope="module")
def jax_stage4_runs(stage2, embeddings):
    """Two epochs of JAX stage-4 training per head, on JAX's embeddings
    (five subjects lack a path embedding)."""
    base = stage2[0]
    runs = {}
    for case in STAGE4:
        results = base / f"s4_jax_{case}"
        assert jax_stage4(stage4_args(base, embeddings[0], results,
                                      case)) == 0
        runs[case] = exp_dir(results)
    return runs


def eval_outputs(out_dir):
    with open(out_dir / "eval_summary.csv", newline="") as f:
        rows = list(csv.reader(f))
    res = {}
    for name in sorted(os.listdir(out_dir)):
        if name.startswith("eval_") and name.endswith("_results.pkl"):
            with open(out_dir / name, "rb") as f:
                res[name] = pickle.load(f)
    return rows, res


@pytest.mark.parametrize("case,splits", [
    ("kronecker_nll", None), ("kronecker_nll", "2foldtest"),
    ("mm_dropout_cox", None)])
def test_eval_pretrained_matches_jax(jax_stage4_runs, tmp_path, case,
                                     splits):
    """The port's eval_pretrained --device cpu on a JAX-trained stage-4
    experiment: JAX's eval_summary.csv columns, c-index and IBS to 1e-6
    (NaN IBS for cox on both), and the eval_*_results.pkl files with the
    same keys, subjects and labels and risks at rel 1e-5.  With
    --which_splits and --split_mode train_val_test, the test split too."""
    exp = jax_stage4_runs[case]
    extra = ["--k_end", "1"]
    if splits:
        extra += ["--which_splits", splits, "--split_mode", "train_val_test"]
    outs = {}
    for name, main, dev in (("jax", jax_eval, []),
                            ("port", port_eval, ["--device", "cpu"])):
        out = tmp_path / name
        assert main(["--model_path", str(exp), "--results_dir", str(out)]
                    + extra + dev) == 0
        outs[name] = eval_outputs(out)
    (jrows, jres), (trows, tres) = outs["jax"], outs["port"]
    assert trows[0] == jrows[0]
    assert trows[0][:3] == ["folds", "val_cindex", "val_ibs"]
    assert len(trows[0]) == (5 if splits else 3)
    assert len(trows) == len(jrows) == 2
    for g, w, col in zip(trows[1], jrows[1], trows[0]):
        if col == "folds" or w == "":
            assert g == w, col
        else:
            assert float(g) == pytest.approx(float(w), rel=1e-6, abs=1e-6)
    assert list(tres) == list(jres)
    for name in jres:
        j, t = jres[name], tres[name]
        assert list(t) == list(j)
        np.testing.assert_array_equal(t["subject_id"], j["subject_id"])
        for k in ("disc_label", "survival", "censorship"):
            np.testing.assert_array_equal(t[k], j[k], err_msg=k)
        np.testing.assert_allclose(t["risk"], j["risk"], rtol=1e-5)
        if "prob" in j:
            np.testing.assert_allclose(t["prob"], j["prob"], rtol=1e-5,
                                       atol=1e-7)
            np.testing.assert_array_equal(t["times"], j["times"])


def test_eval_pretrained_keeps_results_unless_overwrite(jax_stage4_runs,
                                                        tmp_path):
    exp = jax_stage4_runs["kronecker_nll"]
    argv = ["--model_path", str(exp), "--results_dir", str(tmp_path),
            "--k_end", "1", "--device", "cpu"]
    assert port_eval(argv) == 0
    want = (tmp_path / "eval_summary.csv").read_text()
    (tmp_path / "eval_summary.csv").write_text("sentinel")
    assert port_eval(argv) == 0
    assert (tmp_path / "eval_summary.csv").read_text() == "sentinel"
    assert port_eval(argv + ["--overwrite"]) == 0
    assert (tmp_path / "eval_summary.csv").read_text() == want


@pytest.mark.parametrize("cohort", ["own", "label_free"])
def test_infer_serves_a_stage4_experiment(stage2, jax_stage4_runs, tmp_path,
                                          cohort):
    """cli.infer --device cpu on the JAX-trained kronecker experiment gives
    the JAX CLI's risks.csv (same subjects, columns; values at rel 1e-5),
    on its own cohort or on a label-free one with a subject that has no
    embedding at all."""
    base, _, _, subjects = stage2
    exp = jax_stage4_runs["kronecker_nll"]
    common = ["--model_path", str(exp), "--which_k", "0", "--batch_size", "8"]
    if cohort == "label_free":
        csv_path = tmp_path / "new.csv"
        csv_path.write_text("subject_id\n" + "".join(
            f"{s}\n" for s in subjects[10:] + ["NEW000"]))
        common += ["--csv", str(csv_path)]
    jcsv, tcsv = tmp_path / "jax.csv", tmp_path / "port.csv"
    assert jax_infer(common + ["--out", str(jcsv)]) == 0
    assert port_infer(common + ["--out", str(tcsv), "--device", "cpu"]) == 0
    with open(jcsv) as fj, open(tcsv) as ft:
        want, got = list(csv.DictReader(fj)), list(csv.DictReader(ft))
    assert [r["subject_id"] for r in got] == [r["subject_id"] for r in want]
    assert len(got) == (N_SUBJECTS if cohort == "own" else 11)
    assert list(got[0]) == list(want[0])
    assert "hazard_3" in got[0] and "S_3" in got[0]
    for g, w in zip(got, want):
        for col in w:
            if col != "subject_id":
                assert float(g[col]) == pytest.approx(float(w[col]),
                                                      rel=1e-5), col


@pytest.mark.parametrize("case", list(STAGE4))
def test_port_runs_stage4_end_to_end(stage2, embeddings, jax_stage4_runs,
                                     tmp_path, case):
    """The port alone on the CPU: its stage-3 embeddings -> main_pretrained
    -> eval_pretrained -> cli.infer.  Training writes the JAX CLI's files
    (.pt checkpoints only, BatchNorm running statistics included, and the
    resume bundle as the port's .pt) under
    the same experiment code, settings, metrics and summary layout, with
    finite losses; evaluation gives a finite c-index (and IBS for nll)."""
    base = stage2[0]
    texp_root = tmp_path / "s4"
    assert port_stage4(stage4_args(base, embeddings[1], texp_root, case,
                                   "--device", "cpu")) == 0
    jexp, texp = jax_stage4_runs[case], exp_dir(texp_root)
    assert texp.name == jexp.name
    jfiles = {p.relative_to(jexp).as_posix().replace(
        "_resume.msgpack", "_resume.pt") for p in jexp.rglob("*")
        if p.is_file() and (not p.name.endswith(".msgpack")
                            or p.name.endswith("_resume.msgpack"))}
    tfiles = {p.relative_to(texp).as_posix() for p in texp.rglob("*")
              if p.is_file()}
    assert tfiles == jfiles
    for name in ("s_0_checkpoint.pt", "s_0_minloss_checkpoint.pt"):
        jsd = torch.load(jexp / name, weights_only=True)
        tsd = torch.load(texp / name, weights_only=True)
        assert list(tsd) == list(jsd)
        assert all(tsd[k].shape == jsd[k].shape for k in jsd)
    settings_j = (jexp / f"experiment_{jexp.name}.txt").read_text()
    settings_t = (texp / f"experiment_{texp.name}.txt").read_text()
    assert settings_t.replace(str(texp_root), str(jexp.parents[2])).replace(
        str(embeddings[1]), str(embeddings[0])) == settings_j
    jrecs = [json.loads(x) for x in open(jexp / "0" / "metrics.jsonl")]
    trecs = [json.loads(x) for x in open(texp / "0" / "metrics.jsonl")]
    assert [list(r) for r in trecs] == [list(r) for r in jrecs]
    assert len(trecs) == 2 and all(
        math.isfinite(r[k]) for r in trecs
        for k in ("train_loss", "val_loss"))
    with open(jexp / "summary_partial_0_1.csv") as fj, \
            open(texp / "summary_partial_0_1.csv") as ft:
        assert next(csv.reader(ft)) == next(csv.reader(fj))
    with open(texp / "split_train_val_0_results.pkl", "rb") as f:
        tres = pickle.load(f)
    with open(jexp / "split_train_val_0_results.pkl", "rb") as f:
        jres = pickle.load(f)
    assert list(tres) == list(jres)
    np.testing.assert_array_equal(tres["subject_id"], jres["subject_id"])

    assert port_eval(["--model_path", str(texp), "--k_end", "1",
                      "--device", "cpu"]) == 0
    rows, _ = eval_outputs(texp)
    val_c, val_ibs = float(rows[1][1]), rows[1][2]
    assert math.isfinite(val_c)
    assert (0.0 < float(val_ibs) < 1.0 if "nll" in case else val_ibs == "")
    out = tmp_path / "risks.csv"
    assert port_infer(["--model_path", str(texp), "--out", str(out),
                       "--device", "cpu"]) == 0
    with open(out) as f:
        risks = [float(r["risk"]) for r in csv.DictReader(f)]
    assert len(risks) == N_SUBJECTS and all(map(math.isfinite, risks))


@pytest.mark.parametrize("extra", [
    ("--data_parallel", "--device", "cuda")],
    ids=lambda e: e[0].lstrip("-"))
def test_main_pretrained_unported_flags_raise(stage2, embeddings, tmp_path,
                                              extra, monkeypatch):
    """A torchrun launch of more ranks than the node's GPUs raises before
    anything is written (ranks never share a GPU).  (The operations flags
    are ported: tests/test_torch_ops_resume.py.)"""
    err, match = RuntimeError, "ranks never share a GPU"
    for k, v in (("WORLD_SIZE", "2"), ("RANK", "0"), ("LOCAL_RANK", "0")):
        monkeypatch.setenv(k, v)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(err, match=match):
        port_stage4(stage4_args(stage2[0], embeddings[1], tmp_path / "r",
                                "kronecker_nll", "--device", "cpu", *extra))
    assert not (tmp_path / "r").exists()


def test_stage3_refuses_a_radiology_experiment(stage2, tmp_path):
    """A path experiment whose settings say mode radio is refused: its
    model is not the radiology model that stage 3 extracts from (radio
    experiments themselves are extracted, tests/test_torch_radio_cli.py).
    """
    exp = tmp_path / "RADIO_exp"
    shutil.copytree(stage2[1]["path"], exp)
    settings = (exp / f"experiment_{stage2[1]['path'].name}.txt")
    text = settings.read_text().replace("'mode': 'path'", "'mode': 'radio'")
    (exp / "experiment_RADIO_exp.txt").write_text(text)
    with pytest.raises(ValueError, match="not of path_attention_mil"):
        port_stage3(stage3_argv(exp, tmp_path / "out") + ["--device", "cpu"])
