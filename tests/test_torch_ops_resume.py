"""The port's --resume on the CPU: a fold stopped after epoch 2 (or killed
with SIGKILL) and resumed to epoch 4 writes the straight 4-epoch fold's
metrics (all but ``sec``), checkpoints and results bit for bit, with
dropout on, with gradient accumulation, under both --ckpt_format names (both write
the one .pt bundle), for a stage-4 multimodal-dropout head whose frozen
branches keep their moments, and over two gloo ranks with ``--ckpt_format
orbax`` (rank 0 writes the .pt, every rank resumes from it).  The epoch sequence
is held to the JAX package's, a fold that stopped early is not trained
further, and a JAX bundle is refused."""
import json
import os
import pickle
import signal
import subprocess
import sys
import time

import numpy as np
import pytest
import torch
from tensorboard.backend.event_processing.event_file_loader import \
    EventFileLoader

from fixtures import (make_cohort_csv, make_feature_store,
                      make_pretrained_store, make_splits)
from torch_dist_ranks import spawn

from multimodalfusion_tpu.cli.main import main as jax_main
from multimodalfusion_tpu_torch.cli.main import main as port_main
from multimodalfusion_tpu_torch.cli.main_pretrained import \
    main as port_stage4

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def cohort(tmp_path_factory):
    """16 subjects of tests/fixtures.py, bags of 6-40 instances, a stage-4
    embedding store in which 4 subjects lack their path embedding (so
    multimodal dropout freezes that branch on some batches), two folds."""
    base = tmp_path_factory.mktemp("torch_ops_resume")
    csv_path, df, latent = make_cohort_csv(
        str(base / "dataset_csv" / "brain"), n=16, seed=5)
    make_feature_store(str(base / "features" / "brain"), df, latent, seed=5,
                       modalities=["T1"], bag_range=(6, 40))
    make_pretrained_store(str(base / "embeddings" / "brain"), df, latent,
                          seed=5)
    for sid in df["subject_id"][:4]:
        os.remove(base / "embeddings" / "brain" / "path_pt_files"
                  / f"{sid}.pt")
    make_splits(str(base / "splits" / "brain" / "2foldcv"), df, k=2,
                val_frac=0.3, seed=5)
    return base


def stage2_args(base, results, *extra):
    return ["--cancer_type", "brain", "--which_splits", "2foldcv",
            "--k", "2", "--k_end", "1", "--model_type",
            "path_attention_mil", "--mode", "path", "--bag_loss",
            "nll_surv", "--batch_size", "4", "--lr", "1e-3", "--gate_path",
            "--drop_out", "--data_root_dir", str(base / "features"),
            "--dataset_root", str(base / "dataset_csv"),
            "--splits_root", str(base / "splits"),
            "--results_dir", str(results), "--device", "cpu", *extra]


def stage4_args(base, results, *extra):
    return ["--cancer_type", "brain", "--which_splits", "2foldcv",
            "--k", "2", "--k_end", "1", "--model_type", "mm_attention_mil",
            "--mode", "path_omic", "--train_type", "multimodal-dropout",
            "--bag_loss", "nll_surv", "--batch_size", "4", "--lr", "1e-3",
            "--data_root_dir", str(base / "embeddings"),
            "--dataset_root", str(base / "dataset_csv"),
            "--splits_root", str(base / "splits"),
            "--results_dir", str(results), "--device", "cpu", *extra]


def exp_dir(results):
    root = results / "brain" / "2foldcv"
    return root / next(iter(os.listdir(root)))


def metrics(exp, fold=0):
    with open(exp / str(fold) / "metrics.jsonl") as f:
        return [json.loads(line) for line in f]


def assert_same_fold(got, want):
    """Two experiments' fold 0 agree bit for bit: metrics (but ``sec``),
    the final and minloss checkpoints, the results and the summary."""
    g, w = metrics(got), metrics(want)
    assert [r["epoch"] for r in g] == [r["epoch"] for r in w]
    for a, b in zip(g, w):
        assert {k: v for k, v in a.items() if k != "sec"} == \
            {k: v for k, v in b.items() if k != "sec"}
    for name in ("s_0_checkpoint.pt", "s_0_minloss_checkpoint.pt"):
        a, b = torch.load(got / name), torch.load(want / name)
        assert list(a) == list(b)
        for k in a:
            assert torch.equal(a[k], b[k]), (name, k)
    with open(got / "split_train_val_0_results.pkl", "rb") as f:
        a = pickle.load(f)
    with open(want / "split_train_val_0_results.pkl", "rb") as f:
        b = pickle.load(f)
    assert list(a) == list(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert (got / "summary_partial_0_1.csv").read_text() == \
        (want / "summary_partial_0_1.csv").read_text()


@pytest.fixture(scope="module")
def straight(cohort, tmp_path_factory):
    """Straight 4-epoch folds, by gradient accumulation steps."""
    out = {}
    for gc in ("1", "2"):
        res = tmp_path_factory.mktemp(f"straight_gc{gc}")
        assert port_main(stage2_args(cohort, res, "--gc", gc,
                                     "--max_epochs", "4")) == 0
        out[gc] = exp_dir(res)
    return out


@pytest.mark.parametrize("gc", ["1", "2"])
@pytest.mark.parametrize("fmt", ["msgpack", "orbax"])
def test_resumed_fold_equals_straight(cohort, straight, tmp_path, gc, fmt):
    """Two epochs, then --resume to four: the straight fold's files, bit for
    bit (dropout on; with --gc 2 the accumulator and its count carry over
    the resume point, since 3 batches an epoch leave one step pending).
    Either --ckpt_format writes the one s_0_resume.pt bundle."""
    extra = ("--gc", gc, "--ckpt_format", fmt)
    assert port_main(stage2_args(cohort, tmp_path, *extra,
                                 "--max_epochs", "2")) == 0
    exp = exp_dir(tmp_path)
    assert (exp / "s_0_resume.pt").is_file()
    assert sorted(f for f in os.listdir(exp) if "resume" in f) == \
        ["s_0_resume.pt"]
    assert [r["epoch"] for r in metrics(exp)] == [0, 1]
    assert port_main(stage2_args(cohort, tmp_path, *extra, "--resume",
                                 "--max_epochs", "4", "--overwrite")) == 0
    assert_same_fold(exp, straight[gc])


def test_resume_epoch_sequence_matches_jax(cohort, tmp_path):
    """JAX's test_resume_continues_from_epoch on both packages: two epochs
    then --resume to four gives one record per epoch, 0..3, in both."""
    seqs = {}
    for name, main, extra in (("jax", jax_main, ()),
                              ("port", port_main, ("--device", "cpu"))):
        res = tmp_path / name
        common = ["--cancer_type", "brain", "--which_splits", "2foldcv",
                  "--k", "1", "--k_end", "1", "--model_type", "max_net",
                  "--mode", "omic", "--bag_loss", "cox_surv",
                  "--batch_size", "16", "--lr", "1e-3",
                  "--data_root_dir", str(cohort / "features"),
                  "--dataset_root", str(cohort / "dataset_csv"),
                  "--splits_root", str(cohort / "splits"),
                  "--results_dir", str(res), "--overwrite", *extra]
        assert main(common + ["--max_epochs", "2"]) == 0
        assert main(common + ["--max_epochs", "4", "--resume"]) == 0
        seqs[name] = [r["epoch"] for r in metrics(exp_dir(res))]
    assert seqs["port"] == seqs["jax"] == [0, 1, 2, 3]


def test_resumed_multimodal_dropout_head_equals_straight(cohort, tmp_path):
    """A stage-4 multimodal-dropout head resumed at epoch 2 equals the
    straight one bit for bit: the bundle holds the moments a frozen branch
    kept and the step counts that advanced past them."""
    assert port_stage4(stage4_args(cohort, tmp_path / "straight",
                                   "--max_epochs", "4")) == 0
    res = tmp_path / "resumed"
    assert port_stage4(stage4_args(cohort, res, "--max_epochs", "2")) == 0
    assert port_stage4(stage4_args(cohort, res, "--max_epochs", "4",
                                   "--resume", "--overwrite")) == 0
    assert_same_fold(exp_dir(res), exp_dir(tmp_path / "straight"))
    bundle = torch.load(exp_dir(res) / "s_0_resume.pt")
    assert int(bundle["epoch"]) == 3
    steps = {float(v) for k, v in bundle.items() if k.endswith(".step")}
    assert len(steps) == 1  # one global count, as JAX's


# the subprocess SIGKILLs itself where the fold would write its first
# bundle: after epoch 0's record and event scalars, before any bundle
KILL_AT_FIRST_BUNDLE = (
    "import os, signal; from multimodalfusion_tpu_torch.engine import "
    "train; train.save_resume = lambda *a: os.kill(os.getpid(), "
    "signal.SIGKILL); ")


@pytest.mark.parametrize("when", ["after_epoch_1", "before_first_bundle"])
def test_resume_after_sigkill(cohort, straight, tmp_path, when):
    """JAX's test_resume_after_hard_kill: the CLI (with --tb) in a
    subprocess is killed with SIGKILL after its second epoch, or after
    epoch 0's record but before the first bundle; --resume to four epochs
    then writes one clean record and one event point per epoch and the
    straight fold's files."""
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    boot = ("import sys; from multimodalfusion_tpu_torch.cli.main import "
            "main; sys.exit(main(sys.argv[1:]))")
    early = when == "before_first_bundle"
    if early:
        boot = KILL_AT_FIRST_BUNDLE + boot
    proc = subprocess.Popen(
        [sys.executable, "-c", boot] + stage2_args(cohort, tmp_path,
                                                   "--max_epochs", "500",
                                                   "--tb"),
        env=env, stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
    log = None
    try:
        deadline = time.time() + 120
        while time.time() < deadline and proc.poll() is None:
            found = list(tmp_path.glob("brain/2foldcv/*/0/metrics.jsonl"))
            if found and len(found[0].read_text().splitlines()) >= 2:
                log = found[0]
                break
            time.sleep(0.2)
    finally:
        proc.send_signal(signal.SIGKILL)
        proc.wait(30)
    if early:
        assert proc.returncode == -signal.SIGKILL
        log = next(iter(tmp_path.glob("brain/2foldcv/*/0/metrics.jsonl")))
        assert [r["epoch"] for r in map(json.loads,
                                        log.read_text().splitlines())] == [0]
    assert log is not None, "training never reached its second epoch"
    exp = log.parent.parent
    assert (exp / "s_0_resume.pt").exists() != early
    assert not (exp / "summary_partial_0_1.csv").exists()
    assert port_main(stage2_args(cohort, tmp_path, "--max_epochs", "4",
                                 "--tb", "--resume", "--overwrite")) == 0
    assert [r["epoch"] for r in metrics(exp)] == [0, 1, 2, 3]
    assert_same_fold(exp, straight["1"])
    events = [f for f in os.listdir(exp / "0")
              if f.startswith("events.out.tfevents")]
    assert len(events) == 1, events
    steps = {}
    for ev in EventFileLoader(str(exp / "0" / events[0])).Load():
        for v in ev.summary.value:
            steps.setdefault(v.tag, []).append(ev.step)
    assert steps and all(s == [0, 1, 2, 3] for s in steps.values()), steps


def test_early_stopped_fold_is_not_trained_further(cohort, tmp_path,
                                                   capsys):
    """A bundle that says the fold stopped early sends --resume straight to
    the summary: no epoch is added and the final checkpoint holds the
    bundle's weights."""
    assert port_main(stage2_args(cohort, tmp_path, "--max_epochs", "2")) == 0
    exp = exp_dir(tmp_path)
    path = exp / "s_0_resume.pt"
    bundle = torch.load(path)
    bundle["stopped"] = torch.tensor(1)
    torch.save(bundle, path)
    capsys.readouterr()
    assert port_main(stage2_args(cohort, tmp_path, "--max_epochs", "4",
                                 "--resume", "--overwrite")) == 0
    assert "fold 0 already early-stopped; skipping to summary" in \
        capsys.readouterr().out
    assert [r["epoch"] for r in metrics(exp)] == [0, 1]
    final = torch.load(exp / "s_0_checkpoint.pt")
    for k, v in final.items():
        assert torch.equal(v, bundle[f"model.{k}"]), k


@pytest.mark.parametrize("fmt,name", [("msgpack", "s_0_resume.msgpack"),
                                      ("orbax", "s_0_resume.orbax")])
def test_jax_bundle_is_refused(cohort, tmp_path, fmt, name):
    """--resume that finds the JAX package's bundle (and none of the
    port's) raises naming it, rather than silently starting over."""
    assert port_main(stage2_args(cohort, tmp_path, "--max_epochs", "1",
                                 "--ckpt_format", fmt)) == 0
    exp = exp_dir(tmp_path)
    os.remove(exp / "s_0_resume.pt")
    if fmt == "orbax":
        (exp / name).mkdir()
        (exp / name / "_METADATA").write_text("{}")
    else:
        (exp / name).write_bytes(b"\x80")
    with pytest.raises(RuntimeError, match=name.replace(".", r"\.")):
        port_main(stage2_args(cohort, tmp_path, "--max_epochs", "2",
                              "--ckpt_format", fmt, "--resume",
                              "--overwrite"))


def test_dcp_resume_over_two_gloo_ranks(cohort, tmp_path):
    """Two data-parallel gloo ranks: two epochs with --ckpt_format orbax
    (rank 0 writes the one .pt bundle, as for msgpack), then --resume to
    four, every rank reading that file; the same two ranks' straight
    4-epoch fold, bit for bit."""
    def argv(res, *extra):
        return stage2_args(cohort, tmp_path / res, "--data_parallel",
                           *extra)
    runs = [("main", argv("straight", "--max_epochs", "4")),
            ("main", argv("resumed", "--max_epochs", "2", "--ckpt_format",
                          "orbax")),
            ("main", argv("resumed", "--max_epochs", "4", "--ckpt_format",
                          "orbax", "--resume", "--overwrite"))]
    work = tmp_path / "ranks"
    work.mkdir()
    (work / "cli_runs.json").write_text(json.dumps(runs))
    spawn("cli_runs", 2, str(work), torchrun_env=True)
    for r in range(2):
        assert json.loads((work / f"rcs_rank{r}.json").read_text()) == \
            [0, 0, 0]
    resumed = exp_dir(tmp_path / "resumed")
    assert sorted(f for f in os.listdir(resumed) if "resume" in f) == \
        ["s_0_resume.pt"]
    assert_same_fold(resumed, exp_dir(tmp_path / "straight"))
