"""The port's --tb and --profile_dir on the CPU: its own TensorBoard event
writer (utils/tb_writer.py) against tensorboardX and against a JAX --tb
run, the replay of a resumed fold's log, and the stage timings and trace
of --profile_dir against the JAX package's."""
import json
import os

import numpy as np
import pytest
import torch
import tensorboardX
from tensorboard.backend.event_processing.event_file_loader import \
    EventFileLoader

from fixtures import make_cohort_csv, make_feature_store, make_splits

from multimodalfusion_tpu.cli.main import main as jax_main
from multimodalfusion_tpu.utils import profiling as jprof
from multimodalfusion_tpu_torch.cli.main import main as port_main
from multimodalfusion_tpu_torch.utils import profiling as tprof
from multimodalfusion_tpu_torch.utils import tb_writer

TAGS = ("train/loss_surv", "train/loss", "train/c_index", "val/loss_surv",
        "val/loss", "val/c-index")
# each tag's metrics.jsonl key
TAG_KEYS = dict(zip(TAGS, ("train_loss", "train_total", "train_c_index",
                           "val_loss", "val_total", "val_c_index")))


@pytest.fixture(scope="module")
def cohort(tmp_path_factory):
    base = tmp_path_factory.mktemp("torch_ops_tb")
    csv_path, df, latent = make_cohort_csv(
        str(base / "dataset_csv" / "brain"), n=16, seed=5)
    make_feature_store(str(base / "features" / "brain"), df, latent, seed=5,
                       modalities=["T1"], bag_range=(6, 40))
    make_splits(str(base / "splits" / "brain" / "2foldcv"), df, k=2,
                val_frac=0.3, seed=5)
    return base


def cli_args(base, results, *extra):
    return ["--cancer_type", "brain", "--which_splits", "2foldcv",
            "--k", "2", "--k_end", "1", "--model_type", "max_net",
            "--mode", "omic", "--bag_loss", "cox_surv", "--batch_size", "16",
            "--lr", "1e-3", "--data_root_dir", str(base / "features"),
            "--dataset_root", str(base / "dataset_csv"),
            "--splits_root", str(base / "splits"),
            "--results_dir", str(results), "--overwrite", *extra]


def fold_dir(results):
    root = results / "brain" / "2foldcv"
    return root / next(iter(os.listdir(root))) / "0"


def read_events(folder):
    """{tag: [(step, value)]} of the one event file in ``folder``."""
    files = [f for f in os.listdir(folder)
             if f.startswith("events.out.tfevents")]
    assert len(files) == 1, files
    tags = {}
    for ev in EventFileLoader(os.path.join(folder, files[0])).Load():
        for v in ev.summary.value:
            # the loader moves a simple_value into a tensor
            val = (v.simple_value if v.HasField("simple_value")
                   else v.tensor.float_val[0])
            tags.setdefault(v.tag, []).append((ev.step, val))
    return tags


def test_crc32c_known_values():
    assert tb_writer.crc32c(b"") == 0
    assert tb_writer.crc32c(b"123456789") == 0xE3069283
    assert tb_writer.crc32c(bytes(32)) == 0x8A9136AA


@pytest.mark.parametrize("values", [
    [("train/loss", 0.5, 0), ("val/c-index", 0.0, 1)],
    [("a", -3.25e-7, 300), ("b", 1e30, 2 ** 40), ("a", float("inf"), 3)],
    [(f"t{i}", float(v), i) for i, v in enumerate(
        np.random.default_rng(0).normal(size=20))]])
def test_writer_parses_like_tensorboardx(tmp_path, values):
    """The same scalars through the port's writer and through tensorboardX
    read back, by tensorboard's loader, as the same (tag, step, value)."""
    ours = tb_writer.EventWriter(str(tmp_path / "port"))
    theirs = tensorboardX.SummaryWriter(str(tmp_path / "tbx"))
    for tag, value, step in values:
        ours.add_scalar(tag, value, step)
        theirs.add_scalar(tag, value, step)
    ours.close()
    theirs.close()
    assert read_events(tmp_path / "port") == read_events(tmp_path / "tbx")


def test_tb_run_matches_jax_and_metrics(cohort, tmp_path):
    """--tb of both CLIs: the same six tags (the reference's c_index /
    c-index mismatch included), one point per epoch; the port's values
    are its metrics.jsonl at rel 1e-6."""
    events = {}
    for name, main, extra in (("jax", jax_main, ()),
                              ("port", port_main, ("--device", "cpu"))):
        res = tmp_path / name
        assert main(cli_args(cohort, res, "--max_epochs", "3", "--tb",
                             *extra)) == 0
        events[name] = read_events(fold_dir(res))
    assert sorted(events["port"]) == sorted(events["jax"]) == sorted(TAGS)
    for tag in TAGS:
        assert [s for s, _ in events["port"][tag]] == \
            [s for s, _ in events["jax"][tag]] == [0, 1, 2]
    with open(fold_dir(tmp_path / "port") / "metrics.jsonl") as f:
        recs = [json.loads(line) for line in f]
    for tag, key in TAG_KEYS.items():
        np.testing.assert_allclose([v for _, v in events["port"][tag]],
                                   [r[key] for r in recs], rtol=1e-6)


def test_resumed_tb_replays_the_pruned_log(cohort, tmp_path):
    """A killed fold's event file holds an epoch past its bundle; --resume
    replaces it with one that replays the pruned log and goes on, one
    point per epoch, equal to a straight run's values."""
    assert port_main(cli_args(cohort, tmp_path / "straight", "--max_epochs",
                              "4", "--tb", "--device", "cpu")) == 0
    res = tmp_path / "resumed"
    assert port_main(cli_args(cohort, res, "--max_epochs", "2", "--tb",
                              "--device", "cpu")) == 0
    folder = fold_dir(res)
    with open(folder / "metrics.jsonl", "a") as f:  # a torn later epoch
        f.write('{"epoch": 2, "train_lo')
    assert port_main(cli_args(cohort, res, "--max_epochs", "4", "--tb",
                              "--resume", "--device", "cpu")) == 0
    got, want = read_events(folder), read_events(fold_dir(tmp_path /
                                                          "straight"))
    assert got == want
    assert all([s for s, _ in got[t]] == [0, 1, 2, 3] for t in TAGS)


def test_profile_dir_writes_jax_stage_keys_and_a_trace(cohort, tmp_path):
    """--profile_dir: stage_timings.json has the keys the JAX package's
    StageTimer writes for the same folds, and each fold's Chrome trace
    holds the training's operators."""
    prof = tmp_path / "prof"
    assert port_main(cli_args(cohort, tmp_path / "r", "--max_epochs", "1",
                              "--profile_dir", str(prof),
                              "--device", "cpu")) == 0
    got = json.loads((prof / "stage_timings.json").read_text())
    jt = jprof.StageTimer()
    with jt.stage("fold0"):
        pass
    assert sorted(got) == sorted(jt.summary()) == ["fold0"]
    assert sorted(got["fold0"]) == sorted(jt.summary()["fold0"])
    assert got["fold0"]["calls"] == 1 and got["fold0"]["total_s"] > 0
    trace = json.loads((prof / "fold0.pt.trace.json").read_text())
    names = {e.get("name", "") for e in trace["traceEvents"]}
    assert any(n.startswith("aten::") for n in names)


def test_stage_timer_matches_jax():
    """The port's StageTimer sums, counts and rounds as JAX's does."""
    timers = (tprof.StageTimer(), jprof.StageTimer())
    for t in timers:
        for name in ("a", "b", "a"):
            t.totals[name] = t.totals.get(name, 0.0) + 0.123456789
            t.counts[name] = t.counts.get(name, 0) + 1
    assert timers[0].summary() == timers[1].summary()
    stats = tprof.device_memory_stats()
    assert sorted(stats) == [f"cuda:{i}" for i in
                             range(torch.cuda.device_count())]
