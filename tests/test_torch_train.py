"""The port's training slice (multimodalfusion_tpu_torch.{data,engine,cli})
against the JAX package's on the CPU: the labelled cohort and the batch
order, five optimizer steps from one shared init, early stopping, and the
training CLI's files and ``--eval_only`` results."""
import csv
import functools
import json
import math
import os
import pickle
import shutil

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from fixtures import make_cohort_csv, make_feature_store, make_splits

from multimodalfusion_tpu.cli.main import main as jax_main
from multimodalfusion_tpu.data import loaders as jloaders
from multimodalfusion_tpu.data.survival_dataset import \
    SurvivalDataset as JaxDataset
from multimodalfusion_tpu.engine import train as jtrain
from multimodalfusion_tpu.models import PathAMIL as JaxPathAMIL
from multimodalfusion_tpu.ops import mil_attention as jmil
from multimodalfusion_tpu_torch.cli.infer import main as port_infer
from multimodalfusion_tpu_torch.cli.main import main as port_main
from multimodalfusion_tpu_torch.data import loaders as tloaders
from multimodalfusion_tpu_torch.data.survival_dataset import \
    SurvivalDataset as PortDataset
from multimodalfusion_tpu_torch.engine import train as ttrain
from multimodalfusion_tpu_torch.models.amil import PathAMIL
from multimodalfusion_tpu_torch.utils.params import state_dict_from_jax

BATCH_KEYS = ("Y", "t", "c", "valid", "path_bags", "path_mask")


@pytest.fixture(scope="module")
def cohort(tmp_path_factory):
    """The synthetic cohort of tests/fixtures.py: 16 subjects, bags of
    6-40 instances, two folds."""
    base = tmp_path_factory.mktemp("torch_train")
    csv_path, df, latent = make_cohort_csv(
        str(base / "dataset_csv" / "brain"), n=16, seed=5)
    make_feature_store(str(base / "features" / "brain"), df, latent, seed=5,
                       modalities=["T1"], bag_range=(6, 40))
    make_splits(str(base / "splits" / "brain" / "2foldcv"), df, k=2,
                val_frac=0.3, seed=5)
    return base


def cli_args(base, results_dir, *extra):
    return ["--cancer_type", "brain", "--which_splits", "2foldcv",
            "--k", "2", "--k_end", "1", "--max_epochs", "2",
            "--model_type", "path_attention_mil", "--mode", "path",
            "--bag_loss", "nll_surv", "--batch_size", "4", "--lr", "1e-3",
            "--gate_path", "--drop_out",
            "--data_root_dir", str(base / "features"),
            "--dataset_root", str(base / "dataset_csv"),
            "--splits_root", str(base / "splits"),
            "--results_dir", str(results_dir), *extra]


def datasets(base):
    csv_path = str(base / "dataset_csv" / "brain" / "survival.csv")
    data = str(base / "features" / "brain")
    split_csv = str(base / "splits" / "brain" / "2foldcv" / "splits_0.csv")
    jds = JaxDataset(csv_path, mode="path", data_dir=data, n_bins=4)
    tds = PortDataset(csv_path, mode="path", data_dir=data, n_bins=4)
    return jds, tds, jds.load_splits(split_csv), tds.load_splits(split_csv)


def test_labelled_cohort_matches_jax(cohort):
    jds, tds, (jtr, jva), (ttr, tva) = datasets(cohort)
    assert list(jds.patients["subject_id"]) == tds.patients
    np.testing.assert_array_equal(jds.patients["disc_label"], tds.disc_label)
    np.testing.assert_array_equal(jds.patients["label"], tds.label)
    np.testing.assert_array_equal(jds.bins, tds.bins)
    assert jds.label_dict == tds.label_dict
    for j, t in ((jtr, ttr), (jva, tva)):
        assert list(j.df["subject_id"]) == [tds.patients[r] for r in t.rows]
        assert jloaders.usable_indices(j) == tloaders.usable_indices(t)
        np.testing.assert_array_equal(j.class_weights(), t.class_weights())


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("seed", [0, 100003])
def test_batch_order_matches_jax(cohort, weighted, seed):
    """For the same seed, shuffled and class-weighted batches hold the same
    subjects in the same order, with the same Y/t/c/valid and bags."""
    _, _, (jtr, _), (ttr, _) = datasets(cohort)
    jb = list(jloaders.iter_batches(jtr, batch_size=4, shuffle=True,
                                    weighted=weighted, seed=seed,
                                    reuse_collation_buffers=False))
    tb = list(tloaders.prefetch(tloaders.iter_batches(
        ttr, batch_size=4, shuffle=True, weighted=weighted, seed=seed)))
    assert len(jb) == len(tb) > 1
    for j, t in zip(jb, tb):
        assert list(j["subject_ids"]) == list(t["subject_ids"])
        for k in BATCH_KEYS:
            np.testing.assert_array_equal(j[k], t[k], err_msg=k)
            assert j[k].dtype == t[k].dtype, k


def step_batches(seed, n=5, B=4, N=48):
    """Seeded host batches of full-width bags (1024 features), ragged,
    the last of each epoch partial (valid = 0 on one entry)."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        lens = rng.integers(5, N + 1, size=B)
        valid = np.ones(B, np.float32)
        if i in (2, 4):
            valid[-1] = 0.0
            lens[-1] = 0
        out.append({
            "path_bags": (rng.normal(size=(B, N, 1024)) * 0.5
                          ).astype(np.float32),
            "path_mask": (np.arange(N)[None, :] < lens[:, None]
                          ).astype(np.float32),
            "Y": rng.integers(0, 4, size=B).astype(np.int32),
            "t": rng.uniform(1, 60, size=B).astype(np.float32),
            "c": (rng.uniform(size=B) < 0.3).astype(np.float32),
            "valid": valid})
    return out


STEP_CASES = {"adam": {}, "sgd": {"opt": "sgd"}, "adam_gc2": {"gc": 2},
              "adam_l1": {"reg_type": "all"}}


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_train_steps_match_jax(case):
    """Five optimizer steps from one JAX init carried across with
    state_dict_from_jax, dropout off on both sides.  The loss agrees at
    every step at rel 1e-4.  After step 5 each parameter's distance from
    the init agrees to 1e-3 of its length (norm of the difference), and no
    element differs by more than 2e-4, a fifth of one Adam step at lr
    1e-3: Adam divides by sqrt(v), so an element whose gradient is near
    0 turns an f32 rounding difference into a visible fraction of a step
    (measured: at most 8e-5 of the distance, 1.1e-4 in one element).
    gc=2 spans the epoch boundary after step 3: the accumulation count
    carries over."""
    kw = dict(model_type="path_attention_mil", mode="path", gate_path=True,
              n_classes=4, lr=1e-3, reg=1e-5, batch_size=4,
              bag_loss="nll_surv", lambda_reg=1e-4, **STEP_CASES[case])
    jcfg = jtrain.TrainConfig(**kw)
    tcfg = ttrain.TrainConfig(device="cpu", **kw)
    batches = step_batches(0)

    jmodel = JaxPathAMIL(model_size="small", gate=True, n_classes=4)
    params = jmodel.init(jax.random.PRNGKey(0),
                         jnp.asarray(batches[0]["path_bags"]),
                         jnp.asarray(batches[0]["path_mask"]))["params"]
    tx = jtrain.make_optimizer(jcfg)
    opt_state = tx.init(params)
    spec = jtrain.make_loss_spec(jcfg)
    reg_fn = jtrain._reg_fn(jcfg)

    @jax.jit
    def jstep(params, opt_state, b):
        def loss_fn(p):
            out = jmodel.apply({"params": p}, b["path_bags"], b["path_mask"],
                               deterministic=True)
            loss = spec.apply(hazards=out["hazards"], S=out["S"],
                              risks=out["risk"], Y=b["Y"], times=b["t"],
                              c=b["c"], valid=b["valid"])
            total = loss
            if reg_fn is not None:
                total = total + jcfg.lambda_reg * reg_fn(p)
            return total, loss
        (_, loss), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
        updates, opt_state = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, loss

    port = PathAMIL("small", gate=True, n_classes=4)
    init = state_dict_from_jax("path_attention_mil", params)
    port.load_state_dict(init)
    port.attention_net_WSI[2].p = 0.0  # the FC dropout off
    opt = ttrain.make_optimizer(tcfg, port.parameters())
    train_step, _ = ttrain.make_steps(tcfg, port, opt, torch.device("cpu"))
    gen = torch.Generator().manual_seed(0)
    for i, b in enumerate(batches):
        params, opt_state, jloss = jstep(
            params, opt_state, {k: jnp.asarray(b[k]) for k in BATCH_KEYS})
        out = train_step(b, gen)
        assert float(out["loss"]) == pytest.approx(float(jloss), rel=1e-4), i
    want = state_dict_from_jax("path_attention_mil", params)
    got = port.state_dict()
    assert list(got) == list(want)
    for k in want:
        g, w, w0 = got[k].numpy(), want[k].numpy(), init[k].numpy()
        moved = np.linalg.norm(w - w0)
        assert np.linalg.norm(g - w) <= 1e-3 * moved + 1e-12, k
        assert np.abs(g - w).max() <= 2e-4, k


@pytest.mark.parametrize("opt", ["sgd", "adam"])
def test_bf16_train_step_matches_jax(opt, monkeypatch):
    """One optimizer step of the gated PathAMIL with bf16 bags
    (``bag_dtype="bfloat16"``, the JAX package's benchmark configuration,
    bench.py) from one JAX init, dropout off.  JAX runs its pooling
    through the Pallas kernels in interpret mode, the port its plain
    versions on the CPU.  Both round the FC output to bf16 and cast
    [dpa | dpb] to bf16 before the backward's products, each after f32
    sums in its own order, so an element can land one bf16 ulp (2^-8)
    apart.  The loss agrees at rel 1e-3 (measured 1.2e-5).  SGD's first
    step is lr * g, so it holds the gradients: each tensor's step to 2e-2
    of its length, the kernels' own bf16 tolerance (measured 5.5e-3).
    Adam's first step is lr * g / (|g| + eps), which turns a one-ulp
    difference of a near-zero gradient into a step of the other sign: at
    most 1e-3 of the elements may differ by more than lr (measured 2.3e-4,
    91 of 395,269)."""
    monkeypatch.setattr(jmil, "_use_pallas", lambda: True)
    for name in ("_fused_pool_pallas", "_fused_pool_bwd_pallas"):
        monkeypatch.setattr(jmil, name, functools.partial(
            getattr(jmil, name), interpret=True))
    kw = dict(model_type="path_attention_mil", mode="path", gate_path=True,
              n_classes=4, lr=1e-3, reg=1e-5, batch_size=4,
              bag_loss="nll_surv", bag_dtype="bfloat16", opt=opt)
    jcfg = jtrain.TrainConfig(**kw)
    tcfg = ttrain.TrainConfig(device="cpu", **kw)
    b = step_batches(0, n=1)[0]
    jb = {k: jnp.asarray(b[k]) for k in BATCH_KEYS}

    jmodel = JaxPathAMIL(model_size="small", gate=True, n_classes=4,
                         compute_dtype="bfloat16")
    params = jmodel.init(jax.random.PRNGKey(0), jb["path_bags"],
                         jb["path_mask"])["params"]
    tx = jtrain.make_optimizer(jcfg)
    spec = jtrain.make_loss_spec(jcfg)

    def loss_fn(p):
        out = jmodel.apply({"params": p}, jb["path_bags"], jb["path_mask"],
                           deterministic=True)
        return spec.apply(hazards=out["hazards"], S=out["S"],
                          risks=out["risk"], Y=jb["Y"], times=jb["t"],
                          c=jb["c"], valid=jb["valid"])
    jloss, grads = jax.value_and_grad(loss_fn)(params)
    updates, _ = tx.update(grads, tx.init(params), params)
    want = state_dict_from_jax("path_attention_mil",
                               optax.apply_updates(params, updates))

    port = PathAMIL("small", gate=True, n_classes=4,
                    compute_dtype="bfloat16")
    init = state_dict_from_jax("path_attention_mil", params)
    port.load_state_dict(init)
    port.attention_net_WSI[2].p = 0.0  # the FC dropout off
    opt_t = ttrain.make_optimizer(tcfg, port.parameters())
    train_step, _ = ttrain.make_steps(tcfg, port, opt_t, torch.device("cpu"))
    out = train_step(b, torch.Generator().manual_seed(0))
    assert float(out["loss"]) == pytest.approx(float(jloss), rel=1e-3)
    got = port.state_dict()
    assert list(got) == list(want)
    over = total = 0
    for k in want:
        g, w, w0 = got[k].numpy(), want[k].numpy(), init[k].numpy()
        if opt == "sgd":
            assert np.linalg.norm(g - w) <= 2e-2 * np.linalg.norm(w - w0), k
        over += int((np.abs(g - w) > kw["lr"]).sum())
        total += g.size
    assert over <= 1e-3 * total, (over, total)


def test_train_step_draws_dropout_from_its_generator():
    """With --drop_out, two runs with the same generator seed draw the same
    bits (same loss and parameters); another seed draws others."""
    cfg = ttrain.TrainConfig(model_type="path_attention_mil", mode="path",
                             gate_path=True, drop_out=True, batch_size=4,
                             device="cpu")
    b = step_batches(1, n=1)[0]

    def run(seed):
        model = ttrain.build_model(cfg, torch.Generator().manual_seed(0))
        opt = ttrain.make_optimizer(cfg, model.parameters())
        step, _ = ttrain.make_steps(cfg, model, opt, torch.device("cpu"))
        out = step(b, torch.Generator().manual_seed(seed))
        return float(out["loss"]), model.state_dict()
    (l1, s1), (l2, s2), (l3, _) = run(3), run(3), run(4)
    assert l1 == l2 and all(torch.equal(s1[k], s2[k]) for k in s1)
    assert l1 != l3


def test_early_stopping_matches_jax():
    """The same validation losses, NaN included, give the same counter,
    stop, best score and saves."""
    losses = [1.0, 0.9, 0.95, float("nan"), 0.85, 0.85, float("nan"), 1.2,
              1.3, 0.8]
    stoppers = {"jax": jtrain.EarlyStopping(warmup=1, patience=3,
                                            stop_epoch=4),
                "port": ttrain.EarlyStopping(warmup=1, patience=3,
                                             stop_epoch=4)}
    saves = {k: [] for k in stoppers}
    trace = {k: [] for k in stoppers}
    for name, s in stoppers.items():
        for epoch, v in enumerate(losses):
            s._save = (lambda e: lambda val, model, ckpt: (
                saves[name].append(e), setattr(s, "val_loss_min", val)))(
                    epoch)
            s(epoch, v, None, None)
            trace[name].append((s.counter, s.early_stop, s.best_score,
                                s.val_loss_min))
    assert saves["jax"] == saves["port"] == [1, 4, 5, 9]
    assert trace["jax"] == trace["port"]
    assert trace["port"][-1][1]  # stopped


@pytest.fixture(scope="module")
def jax_experiment(cohort):
    """One fold, two epochs of JAX training with the reference recipe's
    flags; writes msgpack checkpoints and their .pt exports."""
    assert jax_main(cli_args(cohort, cohort / "jax")) == 0
    return cohort / "jax"


def exp_dir(results_dir):
    return next((results_dir / "brain" / "2foldcv").iterdir())


def test_cli_writes_the_jax_file_set(cohort, jax_experiment, tmp_path):
    """Two epochs of the port's CLI on the CPU: the JAX CLI's files (but
    .pt checkpoints only, and the resume bundle as the port's .pt) with the
    same keys and columns, and the minloss checkpoint is served by the
    port's cli.infer."""
    assert port_main(cli_args(cohort, tmp_path / "port",
                              "--device", "cpu")) == 0
    jexp, texp = exp_dir(jax_experiment), exp_dir(tmp_path / "port")
    assert jexp.name == texp.name
    jfiles = {p.relative_to(jexp).as_posix().replace(
        "_resume.msgpack", "_resume.pt") for p in jexp.rglob("*")
        if p.is_file() and (not p.name.endswith(".msgpack")
                            or p.name.endswith("_resume.msgpack"))}
    tfiles = {p.relative_to(texp).as_posix() for p in texp.rglob("*")
              if p.is_file()}
    assert tfiles == jfiles
    assert "s_0_minloss_checkpoint.pt" in tfiles
    jrecs = [json.loads(x) for x in open(jexp / "0" / "metrics.jsonl")]
    trecs = [json.loads(x) for x in open(texp / "0" / "metrics.jsonl")]
    assert [list(r) for r in trecs] == [list(r) for r in jrecs]
    assert len(trecs) == 2
    assert all(math.isfinite(r["train_loss"]) for r in trecs)
    with open(jexp / "split_train_val_0_results.pkl", "rb") as f:
        jres = pickle.load(f)
    with open(texp / "split_train_val_0_results.pkl", "rb") as f:
        tres = pickle.load(f)
    assert list(tres) == list(jres)
    for k in jres:
        assert isinstance(tres[k], np.ndarray)
        assert tres[k].shape == jres[k].shape, k
    np.testing.assert_array_equal(tres["subject_id"], jres["subject_id"])
    summary = "summary_partial_0_1.csv"
    with open(jexp / summary) as fj, open(texp / summary) as ft:
        jrows, trows = list(csv.reader(fj)), list(csv.reader(ft))
    assert trows[0] == jrows[0] == ["", "folds", "val_cindex"]
    assert [r[:2] for r in trows] == [r[:2] for r in jrows]
    settings_j = (jexp / f"experiment_{jexp.name}.txt").read_text()
    settings_t = (texp / f"experiment_{texp.name}.txt").read_text()
    assert settings_t.replace(str(tmp_path / "port"),
                              str(jax_experiment)) == settings_j
    out = tmp_path / "risks.csv"
    assert port_infer(["--model_path", str(texp), "--which_k", "0",
                       "--out", str(out), "--device", "cpu"]) == 0
    with open(out) as f:
        rows = list(csv.DictReader(f))
    assert len(rows) == 16
    assert all(math.isfinite(float(r["risk"])) for r in rows)


def test_eval_only_matches_jax(cohort, jax_experiment, tmp_path):
    """--eval_only of the port on a JAX-trained experiment (its .pt export)
    gives the JAX CLI's --eval_only validation c-index and per-subject
    risks at rel 1e-4 (f32 on both sides, another summation order)."""
    runs = {}
    for name, main, extra in (("jax", jax_main, ()),
                              ("port", port_main, ("--device", "cpu"))):
        root = tmp_path / name
        shutil.copytree(jax_experiment, root)
        assert main(cli_args(cohort, root, "--eval_only", *extra)) == 0
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
    for k in ("disc_label", "survival", "censorship"):
        np.testing.assert_array_equal(tres[k], jres[k], err_msg=k)


# the multi-device flags are ported: misused, they raise the JAX
# package's errors, also before anything is written
LAYOUT_ERRORS = {
    "data_parallel": (("--data_parallel", "--bag_shard"),
                      "bag_shard \\+ data_parallel needs --bag_shard_devices",
                      None),
    "bag_shard": (("--bag_shard", "--model_type", "max_net", "--mode",
                   "omic"), "bag_shard applies to AMIL models only", None),
    "bag_shard_devices": (("--bag_shard_devices", "3", "--bag_shard",
                           "--data_parallel"),
                          "4 devices not divisible by bag_devices=3", "4"),
}


@pytest.mark.parametrize("extra", [
    pytest.param(name, id=name) for name in LAYOUT_ERRORS] + [
    ("--model_type", "radio_attention_mil", "--mode", "omic"),
    ("--mode", "radio")],
    ids=lambda e: e[0].lstrip("-") + (f"_{e[-1]}" if len(e) > 2 else ""))
def test_unported_flags_raise(cohort, tmp_path, extra, monkeypatch):
    """A model asked for in a mode it does not run in (radio AMIL on
    genomics, path AMIL on radiology) raises ValueError naming its mode,
    before anything is written.  So do the multi-device flags misused
    (``LAYOUT_ERRORS``; the world size of a torchrun launch comes from its
    environment).  (The operations flags are ported:
    tests/test_torch_ops_*.py.)"""
    if extra in LAYOUT_ERRORS:
        extra, match, world = LAYOUT_ERRORS[extra]
        err = ValueError
        if world is not None:
            monkeypatch.setenv("WORLD_SIZE", world)
    else:
        err, match = ValueError, "runs in mode"
    with pytest.raises(err, match=match):
        port_main(cli_args(cohort, tmp_path / "r", "--device", "cpu",
                           *extra))
    assert not (tmp_path / "r").exists()
