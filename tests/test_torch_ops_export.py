"""The port's cli.export_model and utils/model_export.py on the CPU: a
JAX-trained experiment exported by both packages' CLIs for the CPU gives
the same risk, hazards and S on JAX's probe; the models of JAX's
tests/test_export.py round-trip through torch.export, with the forward
kernel's custom op kept in the graph or the plain pooling traced; the
sidecar keeps JAX's keys."""
import json
import os

import jax
import numpy as np
import pytest
import torch

from fixtures import (make_cohort_csv, make_feature_store,
                      make_pretrained_store, make_splits)

from multimodalfusion_tpu.cli.export_model import main as jax_export
from multimodalfusion_tpu.cli.main import main as jax_stage2
from multimodalfusion_tpu.cli.main_pretrained import main as jax_stage4
from multimodalfusion_tpu.utils.model_export import load_scorer as jax_load
from multimodalfusion_tpu_torch.cli import export_model as port_cli
from multimodalfusion_tpu_torch.engine.train import TrainConfig, build_model
from multimodalfusion_tpu_torch.models.pooling import AttentionPool
from multimodalfusion_tpu_torch.ops import mil_attention as mil
from multimodalfusion_tpu_torch.utils import model_export

RUNS = {
    "path_amil_nll": (jax_stage2, "features",
                      ["--model_type", "path_attention_mil", "--mode",
                       "path", "--gate_path", "--bag_loss", "nll_surv"]),
    "max_net_cox": (jax_stage2, "features",
                    ["--model_type", "max_net", "--mode", "omic",
                     "--bag_loss", "cox_surv"]),
    "late_fcnn_nll": (jax_stage4, "embeddings",
                      ["--model_type", "mm_attention_mil", "--mode",
                       "radio_path_omic", "--train_type", "late-fcnn",
                       "--bag_loss", "nll_surv"]),
}


@pytest.fixture(scope="module")
def jax_experiments(tmp_path_factory):
    """One JAX-trained fold (one epoch) of each of ``RUNS`` on a 20-subject
    cohort."""
    base = tmp_path_factory.mktemp("torch_ops_export")
    _, df, latent = make_cohort_csv(str(base / "dataset_csv" / "brain"),
                                    n=20, seed=4)
    make_feature_store(str(base / "features" / "brain"), df, latent, seed=4,
                       modalities=["T1"], bag_range=(6, 20))
    make_pretrained_store(str(base / "embeddings" / "brain"), df, latent,
                          seed=4)
    make_splits(str(base / "splits" / "brain" / "2foldcv"), df, k=2,
                val_frac=0.3, seed=4)
    exps = {}
    for name, (main, data, flags) in RUNS.items():
        results = base / "results" / name
        assert main(["--cancer_type", "brain", "--which_splits", "2foldcv",
                     "--data_root_dir", str(base / data),
                     "--dataset_root", str(base / "dataset_csv"),
                     "--splits_root", str(base / "splits"),
                     "--k", "2", "--k_end", "1", "--max_epochs", "1",
                     "--batch_size", "4", "--lr", "1e-3",
                     "--results_dir", str(results), *flags]) == 0
        root = results / "brain" / "2foldcv"
        exps[name] = root / next(iter(os.listdir(root)))
    return exps


@pytest.mark.parametrize("name", list(RUNS))
def test_both_clis_export_the_same_scorer(jax_experiments, tmp_path, name):
    """Both CLIs export fold 0 for the CPU with --check; the two artifacts
    give risk, hazards and S at rel 1e-5 on JAX's probe, and the sidecars
    agree on every JAX key but the format."""
    exp = jax_experiments[name]
    common = ["--model_path", str(exp), "--which_k", "0", "--batch_size",
              "2", "--bag_len", "64", "--platforms", "cpu", "--check"]
    jpath, tpath = str(tmp_path / "a.stablehlo"), str(tmp_path / "a.pt2")
    assert jax_export(common + ["--out", jpath]) == 0
    assert port_cli.main(common + ["--out", tpath]) == 0
    with open(jpath + ".json") as f:
        jside = json.load(f)
    with open(tpath + ".json") as f:
        tside = json.load(f)
    assert set(tside) == set(jside) | {"requires"}
    assert tside["requires"] == []
    assert tside["format"] == "torch.export"
    for k in set(jside) - {"format"}:
        assert tside[k] == jside[k], k
    probe = port_cli.probe_inputs(tside)
    with open(jpath, "rb") as f:
        want = jax_load(f.read())(probe)
    got = model_export.load_scorer(tpath)(probe)
    assert sorted(got) == sorted(want)
    for k in got:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-5, atol=1e-6, err_msg=k)


# the models of JAX's tests/test_export.py, and the heads whose
# MaskedBatchNorm and Kronecker fusion torch.export must trace
CONFIGS = {
    "max_net_cox": dict(model_type="max_net", mode="omic",
                        omic_input_dim=36, bag_loss="cox_surv"),
    "path_amil_nll": dict(model_type="path_attention_mil", mode="path",
                          bag_loss="nll_surv", gate_path=True),
    "late_fcnn": dict(model_type="mm_attention_mil", mode="radio_path_omic",
                      pretrained=True, train_type="late-fcnn"),
    "kronecker": dict(model_type="mm_attention_mil", mode="radio_path_omic",
                      pretrained=True, train_type="kronecker"),
    "mm_dropout": dict(model_type="mm_attention_mil", mode="path_omic",
                       pretrained=True, train_type="multimodal-dropout",
                       bag_loss="cox_surv"),
    "path_omic_tensor": dict(model_type="mm_attention_mil", mode="path_omic",
                             omic_input_dim=20, fusion="tensor",
                             gate_path=True),
}


@pytest.mark.parametrize("keep_kernel", [True, False],
                         ids=["kernel_op", "plain"])
@pytest.mark.parametrize("name", list(CONFIGS))
def test_roundtrip_from_a_seeded_init(tmp_path, name, keep_kernel):
    """export -> torch.export.save -> load_scorer reproduces the eager model
    exactly; for cuda a model with attention pooling keeps
    ``mmf::fused_pool`` in its graph (traced here on the CPU, where the op
    runs its plain version), for cpu it traces the plain ops."""
    cfg = TrainConfig(**CONFIGS[name])
    model = build_model(cfg, torch.Generator().manual_seed(0)).eval()
    ep = model_export.export_scorer(
        model, cfg, batch_size=4, bag_len=64,
        platforms=["cuda"] if keep_kernel else ["cpu"])
    targets = {str(n.target) for n in ep.graph.nodes
               if n.op == "call_function"}
    pools = any(isinstance(m, AttentionPool) for m in model.modules())
    assert ("mmf.fused_pool.default" in targets) == (keep_kernel and pools)
    path = str(tmp_path / "m.pt2")
    torch.export.save(ep, path)
    probe = {k: np.random.default_rng(1).normal(size=v.shape).astype(
        np.float32) for k, v in model_export.example_inputs(
            cfg, 4, 64, "cpu").items()}
    if "valid" in probe:
        probe["valid"] = np.ones_like(probe["valid"])
    got = model_export.load_scorer(path)(probe)
    with torch.inference_mode():
        want = model(**{k: torch.from_numpy(v) for k, v in probe.items()})
    for k in got:
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0)


def test_platforms_choose_the_pooling_and_refuse_tpu():
    assert model_export.keeps_kernel(None)
    assert model_export.keeps_kernel(["cuda"])
    assert not model_export.keeps_kernel(["cuda", "cpu"])
    assert not model_export.keeps_kernel(["cpu"])
    assert model_export.export_device(["cpu", "cuda"]) == torch.device("cpu")
    assert model_export.export_device(["cuda", "cpu"]) == torch.device("cpu")
    assert model_export.export_device(["cpu"]) == torch.device("cpu")
    with pytest.raises(ValueError, match="tpu"):
        model_export.export_device(["tpu"])
    with pytest.raises(ValueError, match="tpu"):
        model_export.check_platforms(["cpu", "tpu"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="--device cpu"):
            model_export.export_device(None)


def test_plain_export_refuses_a_model_off_the_cpu():
    """A list but cuda alone traces the plain pooling on the CPU only, so
    the plain version never runs on another device's tensors."""
    cfg = TrainConfig(**CONFIGS["path_amil_nll"])
    model = build_model(cfg, torch.Generator().manual_seed(0)).to("meta")
    with pytest.raises(ValueError, match="on the CPU"):
        model_export.export_scorer(model, cfg, batch_size=2, bag_len=16,
                                   platforms=["cuda", "cpu"])


def test_mixed_platforms_export_on_the_cpu(jax_experiments, tmp_path):
    """--platforms cuda cpu --check exports and checks on the CPU: the
    artifact holds stock ops only, its weights lie on the CPU, and it gives
    what the --platforms cpu artifact gives, exactly."""
    exp = jax_experiments["path_amil_nll"]
    common = ["--model_path", str(exp), "--batch_size", "2", "--bag_len",
              "64", "--check"]
    mixed, cpu = str(tmp_path / "mixed.pt2"), str(tmp_path / "cpu.pt2")
    assert port_cli.main(common + ["--platforms", "cuda", "cpu", "--out",
                                   mixed]) == 0
    assert port_cli.main(common + ["--platforms", "cpu", "--out", cpu]) == 0
    side = json.loads(open(mixed + ".json").read())
    assert side["platforms"] == ["cuda", "cpu"] and side["requires"] == []
    scorer = model_export.load_scorer(mixed)
    targets = {str(n.target) for n in scorer.exported.graph.nodes
               if n.op == "call_function"}
    assert not any(t.startswith("mmf.") for t in targets)
    assert {v.device.type for v in
            scorer.exported.state_dict.values()} == {"cpu"}
    probe = port_cli.probe_inputs(side)
    got, want = scorer(probe), model_export.load_scorer(cpu)(probe)
    assert sorted(got) == sorted(want) == ["S", "hazards", "risk"]
    for k in got:
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0)


def test_pooling_route_is_scoped_and_checked():
    """``pooling_route`` takes one of its routes, restores the default
    however its block ends, and under "op" refuses a tensor on neither
    the CPU nor a card before the op's shape function sees it."""
    with pytest.raises(ValueError, match="route"):
        with mil.pooling_route("fast"):
            pass
    assert mil._route == "kernel"
    with pytest.raises(RuntimeError, match="inside"):
        with mil.pooling_route("plain"):
            assert mil._route == "plain"
            raise RuntimeError("inside")
    assert mil._route == "kernel"
    h = torch.zeros(2, 8, 32, device="meta")
    p = torch.zeros(32, 16, device="meta")
    params = mil.AttnParams(p, p[0], p, p[0], p[:, :1], p[0, :1])
    with mil.pooling_route("op"), pytest.raises(ValueError,
                                                 match="CUDA tensor"):
        mil._fused_pool(h, torch.ones(2, 8, device="meta"), params, True)


def test_export_requires_omic_dim():
    cfg = TrainConfig(model_type="max_net", mode="omic", omic_input_dim=0)
    with pytest.raises(ValueError, match="omic_input_dim"):
        model_export.example_batch(cfg)


def test_export_cli_reads_the_omic_width_and_writes_its_files(
        jax_experiments, tmp_path):
    """Defaults: the artifact and its sidecar beside the checkpoints; the
    omic width comes from the .pt's first omic layer."""
    exp = jax_experiments["max_net_cox"]
    width = port_cli.omic_width(str(exp / "s_0_minloss_checkpoint.pt"))
    assert width == 12  # tests/fixtures.py's genes
    assert port_cli.main(["--model_path", str(exp), "--batch_size", "4",
                          "--platforms", "cpu"]) == 0
    side = json.loads((exp / "s_0_scorer.pt2.json").read_text())
    assert side["inputs"] == {"genomic_features": {"shape": [4, width],
                                                   "dtype": "float32"}}
    assert side["outputs"] == {"risk": {"shape": [4], "dtype": "float32"}}
    assert side["platforms"] == ["cpu"]
    assert jax.default_backend() == "cpu"
