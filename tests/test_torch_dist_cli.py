"""The port's CLIs under a torchrun-like environment (RANK, WORLD_SIZE,
LOCAL_RANK; two gloo ranks on the CPU, tests/torch_dist_ranks.py) against
the same CLIs in one process:

- ``cli.main --data_parallel`` and ``cli.main --bag_shard``: two epochs
  of path AMIL with --drop_out on a cohort whose bags (60-199 instances)
  fall in two buckets, so the ranks of a data-parallel batch bucket their
  rows differently;
- ``cli.main_pretrained --data_parallel``: an early-fcnn head
  (MaskedBatchNorm) over seeded embeddings;
- ``cli.feature_extraction --data_parallel``: a glioma cohort.

Only rank 0 writes, and the files are those of one process: the same
names, metrics.jsonl at rel 1e-4, the checkpoints (BatchNorm running
statistics included) at atol 1e-5 with rtol 5e-3 (as in
tests/test_torch_dist_train.py), the extracted
h5 and .pt files equal byte for byte.  The one-process runs pass the same
flags and print the JAX package's "only one device visible, running
unsharded" lines; the JAX package's layout errors and the launch errors
(more ranks than GPUs, several GPUs without torchrun) are raised before
anything is written."""
import contextlib
import io
import json
import os
import pickle

import numpy as np
import pytest
import torch

from fixtures import make_cohort_csv, make_feature_store, make_splits
from test_torch_extraction import _glioma_cohort
from test_torch_resnet import seeded_state_dict
from torch_dist_ranks import spawn

from multimodalfusion_tpu_torch.cli import feature_extraction as tfx
from multimodalfusion_tpu_torch.cli.main import main as port_main
from multimodalfusion_tpu_torch.cli.main_pretrained import \
    main as port_stage4
from multimodalfusion_tpu_torch.parallel import mesh as par


def _common(base):
    return ["--cancer_type", "brain", "--which_splits", "2foldcv",
            "--k", "2", "--k_end", "1", "--max_epochs", "2",
            "--batch_size", "4", "--lr", "1e-3", "--device", "cpu",
            "--dataset_root", str(base / "dataset_csv"),
            "--splits_root", str(base / "splits")]


def _stage2(base, results, *extra):
    return _common(base) + [
        "--model_type", "path_attention_mil", "--mode", "path",
        "--bag_loss", "nll_surv", "--gate_path", "--drop_out",
        "--data_root_dir", str(base / "features"),
        "--results_dir", str(results), *extra]


def _stage4(base, results, *extra):
    # SGD: Adam would move the biases before a BatchNorm, whose gradient
    # is 0 in exact arithmetic, by their rounding noise
    return _common(base) + [
        "--model_type", "mm_attention_mil", "--mode", "path_omic",
        "--train_type", "early-fcnn", "--bag_loss", "nll_surv", "--opt",
        "sgd", "--lr", "0.05", "--data_root_dir",
        str(base / "embeddings"), "--results_dir", str(results), *extra]


def _extract(base, out, *extra):
    radio_dir, csv_path = base / "scans", base / "scans.csv"
    return ["--radio_dir", str(radio_dir), "--csv_path", str(csv_path),
            "--cancer_type", "glioma", "--batch_size", "8", "--dtype",
            "float32", "--weights", str(base / "resnet50.pt"),
            "--device", "cpu", "--output_dir", str(out), *extra]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The directory of one cohort (stage-2 bags, stage-4 embeddings,
    glioma scans) with the outputs of every CLI in one process (``one_*``,
    their stdout in one_process.txt) and on two ranks (``two_*``)."""
    base = tmp_path_factory.mktemp("dist_cli")
    _, df, latent = make_cohort_csv(str(base / "dataset_csv" / "brain"),
                                    n=16, seed=7)
    make_feature_store(str(base / "features" / "brain"), df, latent, seed=7,
                       modalities=["T1"], bag_range=(60, 200))
    make_splits(str(base / "splits" / "brain" / "2foldcv"), df, k=2,
                val_frac=0.3, seed=7)
    rng = np.random.default_rng(7)
    for m in ("path", "omic"):
        d = base / "embeddings" / "brain" / f"{m}_pt_files"
        d.mkdir(parents=True)
        for sid in df["subject_id"]:
            torch.save(torch.from_numpy(rng.normal(size=256).astype(
                np.float32)), d / f"{sid}.pt")
    _glioma_cohort(str(base))
    torch.save(seeded_state_dict(3), base / "resnet50.pt")

    printed = io.StringIO()
    threads = torch.get_num_threads()
    with contextlib.redirect_stdout(printed):
        rcs = [port_main(_stage2(base, base / "one_dp", "--data_parallel",
                                 "--bag_shard", "--bag_shard_devices", "1")),
               port_stage4(_stage4(base, base / "one_s4", "--data_parallel"))]
        # one thread, as each rank runs: the CPU convolutions' sums then
        # run in one order, so the features can be held bit for bit
        torch.set_num_threads(1)
        try:
            rcs.append(tfx.main(_extract(base, base / "one_fx",
                                         "--data_parallel")))
        finally:
            torch.set_num_threads(threads)
    assert rcs == [0, 0, 0]
    (base / "one_process.txt").write_text(printed.getvalue())
    runs = [("main", _stage2(base, base / "two_dp", "--data_parallel")),
            ("main", _stage2(base, base / "two_bag", "--bag_shard")),
            ("main_pretrained", _stage4(base, base / "two_s4",
                                        "--data_parallel")),
            ("feature_extraction", _extract(base, base / "two_fx",
                                            "--data_parallel"))]
    work = base / "ranks"
    work.mkdir()
    (work / "cli_runs.json").write_text(json.dumps(runs))
    spawn("cli_runs", 2, str(work), torchrun_env=True)
    for r in range(2):
        assert json.loads((work / f"rcs_rank{r}.json").read_text()) == \
            [0] * len(runs)
    return base


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def _same_training(one, two):
    """The files of a one-process fold and of a two-rank one agree."""
    assert _files(one) == _files(two)
    for rel in _files(one):
        a, b = os.path.join(one, rel), os.path.join(two, rel)
        if rel.endswith("metrics.jsonl"):
            want = [json.loads(x) for x in open(a)]
            got = [json.loads(x) for x in open(b)]
            assert len(got) == len(want) == 2
            for g, w in zip(got, want):
                for k in w:
                    if k != "sec":
                        assert g[k] == pytest.approx(w[k], rel=1e-4), k
        elif rel.endswith("checkpoint.pt"):
            want = torch.load(a)
            got = torch.load(b)
            assert list(got) == list(want)
            for k, w in want.items():
                g = got[k]
                if not w.is_floating_point():
                    assert torch.equal(g, w), k
                    continue
                np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=5e-3,
                                           atol=1e-5, err_msg=rel + k)
        elif rel.endswith("results.pkl"):
            with open(a, "rb") as f:
                want = pickle.load(f)
            with open(b, "rb") as f:
                got = pickle.load(f)
            assert list(got["subject_id"]) == list(want["subject_id"])
            np.testing.assert_allclose(got["risk"], want["risk"], rtol=1e-4)
            np.testing.assert_array_equal(got["censorship"],
                                          want["censorship"])


@pytest.mark.parametrize("layout", ["two_dp", "two_bag"])
def test_cli_main_two_ranks_write_the_one_process_files(runs, layout):
    one = runs / "one_dp" / "brain" / "2foldcv"
    two = runs / layout / "brain" / "2foldcv"
    (exp,) = os.listdir(one)
    assert os.listdir(two) == [exp]
    _same_training(one / exp, two / exp)


def test_main_pretrained_two_ranks_write_the_one_process_files(runs):
    one = runs / "one_s4" / "brain" / "2foldcv"
    (exp,) = os.listdir(one)
    _same_training(one / exp, runs / "two_s4" / "brain" / "2foldcv" / exp)
    ckpt = torch.load(one / exp / "s_0_checkpoint.pt")
    assert any(k.endswith("running_mean") for k in ckpt)


def test_feature_extraction_two_ranks_write_the_same_bytes(runs):
    one, two = runs / "one_fx" / "glioma", runs / "two_fx" / "glioma"
    files = _files(one)
    assert files == _files(two)
    assert sum(f.endswith(".h5") for f in files) == 11
    for rel in files:
        if rel.endswith(".pkl"):
            with open(one / rel, "rb") as f:
                want = pickle.load(f)
            with open(two / rel, "rb") as f:
                assert [r[:-1] for r in pickle.load(f)] == \
                    [r[:-1] for r in want] == [("S3", "T2")]
        else:
            assert (one / rel).read_bytes() == (two / rel).read_bytes(), rel


def test_one_process_prints_the_jax_unsharded_lines(runs):
    """At world size 1 the flags run unsharded and say so with the JAX
    package's lines (engine/train.py:621, 481-482;
    cli/feature_extraction.py:72), once per fold of cli.main and
    cli.main_pretrained."""
    lines = (runs / "one_process.txt").read_text().splitlines()
    unsharded = "only one device visible, running unsharded"
    assert [x for x in lines if unsharded in x] == [
        f"bag_shard: {unsharded}", f"data_parallel: {unsharded}",
        f"data_parallel: {unsharded}", f"--data_parallel: {unsharded}"]


@pytest.mark.parametrize("case", ["batch_size", "ranks_per_gpu",
                                  "gpus_without_torchrun"])
def test_launch_errors_before_anything_is_written(runs, tmp_path,
                                                  monkeypatch, case):
    """JAX's batch-size error of the 2-D mesh at a launch of 4 ranks; a
    torchrun launch of more ranks than the node's GPUs; several visible
    GPUs and no torchrun environment."""
    for k in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "LOCAL_WORLD_SIZE"):
        monkeypatch.delenv(k, raising=False)
    out = tmp_path / "r"
    if case == "batch_size":
        monkeypatch.setenv("WORLD_SIZE", "4")
        argv = _stage2(runs, out, "--data_parallel", "--bag_shard",
                       "--bag_shard_devices", "2", "--batch_size", "3")
        err, match = ValueError, ("--batch_size 3 must be divisible by the "
                                  "data-axis size 2")
    else:
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
        argv = _stage2(runs, out, "--data_parallel", "--device", "cuda")
        if case == "ranks_per_gpu":
            for k, v in (("WORLD_SIZE", "3"), ("RANK", "2"),
                         ("LOCAL_RANK", "2")):
                monkeypatch.setenv(k, v)
            err, match = RuntimeError, "ranks never share a GPU"
        else:
            err, match = RuntimeError, "torchrun --nproc_per_node=2"
    with pytest.raises(err, match=match):
        port_main(argv)
    assert not out.exists()
    assert not par.is_distributed()
