"""The port's serving path (multimodalfusion_tpu_torch.cli.infer and its
data layer) against the JAX package's: a JAX-trained path-AMIL experiment
scored by the JAX CLI and by the port on the CPU gives the same risks.csv
rows.  Also pins the port's import boundary."""
import ast
import csv
import os

import numpy as np
import pytest
import torch

from fixtures import make_cohort_csv, make_feature_store, make_splits

from multimodalfusion_tpu.cli.infer import main as jax_infer
from multimodalfusion_tpu.cli.main import main as jax_train
from multimodalfusion_tpu.data import bags as jbags
from multimodalfusion_tpu_torch import resolve_device
from multimodalfusion_tpu_torch.cli.infer import main as port_infer
from multimodalfusion_tpu_torch.data import bags as tbags
from multimodalfusion_tpu_torch.engine.train import TrainConfig, build_model

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "pandas", "h5py", "sklearn",
             "tensorboardX", "tensorboard", "orbax", "multimodalfusion_tpu",
             "yaml", "msgpack", "cv2", "matplotlib", "PIL", "pydicom",
             "torchvision", "openslide", "openjpeg", "glymur"}


def read_rows(path):
    with open(path, newline="") as f:
        return {r["subject_id"]: r for r in csv.DictReader(f)}


@pytest.fixture(scope="module")
def experiment(tmp_path_factory):
    """One fold of JAX path-AMIL training (one epoch) on the synthetic
    cohort of tests/fixtures.py, bags of at most 40 instances."""
    base = tmp_path_factory.mktemp("torch_infer")
    csv_path, df, latent = make_cohort_csv(
        str(base / "dataset_csv" / "brain"), n=16, seed=5)
    make_feature_store(str(base / "features" / "brain"), df, latent, seed=5,
                       modalities=["T1"], bag_range=(6, 40))
    make_splits(str(base / "splits" / "brain" / "2foldcv"), df, k=2,
                val_frac=0.3, seed=5)
    assert jax_train([
        "--cancer_type", "brain", "--which_splits", "2foldcv",
        "--k", "1", "--k_end", "1", "--max_epochs", "1",
        "--model_type", "path_attention_mil", "--mode", "path",
        "--bag_loss", "nll_surv", "--batch_size", "4", "--lr", "1e-3",
        "--gate_path", "--data_root_dir", str(base / "features"),
        "--dataset_root", str(base / "dataset_csv"),
        "--splits_root", str(base / "splits"),
        "--results_dir", str(base / "results"), "--overwrite"]) == 0
    exp = next((base / "results" / "brain" / "2foldcv").iterdir())
    # a label-free cohort: a subject with two slides, one whose slide
    # cell is empty and one whose bag is missing
    subjects = list(df["subject_id"])
    rows = [(s, f"{s}-SLIDE.svs") for s in subjects[:10]]
    rows += [(subjects[0], f"{subjects[1]}-SLIDE.svs"),
             (subjects[10], ""), ("NEW000", "NEW000-SLIDE.svs")]
    cohort = base / "unlabeled.csv"
    with open(cohort, "w") as f:
        f.write("subject_id,slide_id\n")
        f.writelines(f"{s},{sl}\n" for s, sl in rows)
    return exp, cohort


def test_port_infer_matches_jax_infer(experiment, tmp_path):
    exp, cohort = experiment
    assert (exp / "s_0_minloss_checkpoint.pt").exists()
    jax_csv, port_csv = tmp_path / "jax.csv", tmp_path / "port.csv"
    common = ["--model_path", str(exp), "--which_k", "0",
              "--csv", str(cohort), "--batch_size", "4"]
    assert jax_infer(common + ["--out", str(jax_csv)]) == 0
    assert port_infer(common + ["--out", str(port_csv),
                                "--device", "cpu"]) == 0
    want, got = read_rows(jax_csv), read_rows(port_csv)
    assert list(got) == list(want)            # same subjects, same order
    assert len(got) == 10                     # empty slide, missing bag
    assert list(next(iter(got.values()))) == list(next(iter(want.values())))
    for sid, row in want.items():
        for col, v in row.items():
            if col != "subject_id":
                assert float(got[sid][col]) == pytest.approx(
                    float(v), rel=1e-4), (sid, col)


def test_port_infer_default_cohort(experiment, tmp_path):
    """Without --csv the experiment's own labelled cohort is scored."""
    exp, _ = experiment
    jax_csv, port_csv = tmp_path / "jax.csv", tmp_path / "port.csv"
    common = ["--model_path", str(exp), "--which_k", "0"]
    assert jax_infer(common + ["--out", str(jax_csv)]) == 0
    assert port_infer(common + ["--out", str(port_csv),
                                "--device", "cpu"]) == 0
    want, got = read_rows(jax_csv), read_rows(port_csv)
    assert list(got) == list(want) and len(got) == 16
    for sid in want:
        assert float(got[sid]["risk"]) == pytest.approx(
            float(want[sid]["risk"]), rel=1e-4)


def test_pad_bags_matches_jax():
    rng = np.random.default_rng(0)
    bags = [rng.normal(size=(n, 1024)).astype(np.float32)
            for n in (3, 130, 1)] + [None, np.zeros((0, 1024), np.float32)]
    got, got_mask = tbags.pad_bags(bags, 1024)
    want, want_mask = jbags.pad_bags(bags, 1024)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got_mask, want_mask)
    assert got.shape == (5, 256, 1024)
    for n in (0, 1, 128, 129, 4096, 4097, 65536, 65537, 200_000):
        assert tbags.bucket_len(n) == jbags.bucket_len(n)


def test_other_kinds_raise_not_implemented():
    """The radiology kinds build (ported with radio AMIL); a model type
    that no CLI of the repo has raises NotImplementedError."""
    for cfg in (TrainConfig(model_type="radio_attention_mil", mode="radio"),
                TrainConfig(model_type="mm_attention_mil",
                            mode="radio_path_omic", omic_input_dim=8),
                TrainConfig(model_type="mm_attention_mil", mode="path")):
        assert "attention_net_radio" in dict(build_model(cfg).named_children(
        )) or cfg.mode == "path"
    with pytest.raises(NotImplementedError, match="not a model"):
        build_model(TrainConfig(model_type="clam_sb", mode="path"))


def test_entry_points_need_cuda_unless_cpu_is_asked():
    assert resolve_device("cpu") == torch.device("cpu")
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="--device cpu"):
        resolve_device(None)


def _imported_roots(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_port_imports_no_jax_and_no_jax_package():
    files = [os.path.join(REPO, "chip_smoke.py"),
             os.path.join(REPO, "tools", "cuda_fwd_variants.py")]
    for root, _, names in os.walk(os.path.join(REPO,
                                               "multimodalfusion_tpu_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    assert len(files) > 15
    scanned = {os.path.relpath(p, REPO) for p in files}
    for new in ("native.py", "models/genomic.py", "models/mm_amil.py",
                "models/modules.py", "utils/params.py", "data/bags.py",
                "models/pretrained_heads.py", "engine/evaluate.py",
                "cli/pre_trained_feature.py", "cli/main_pretrained.py",
                "cli/eval_pretrained.py", "data/hdf5.py", "data/io.py",
                "interpret/__init__.py", "interpret/ig.py",
                "utils/msgpack_io.py", "utils/yaml_subset.py",
                "utils/table.py", "cli/create_attributions.py",
                "cli/create_heatmaps.py", "models/resnet.py",
                "extract/__init__.py", "extract/features.py",
                "data/nifti.py", "data/ct_preprocess.py", "data/dicom.py",
                "data/radiology.py", "cli/feature_extraction.py",
                "utils/image_ops.py", "utils/png.py",
                "interpret/gradcam.py", "cli/gradcam.py",
                "parallel/__init__.py", "parallel/mesh.py",
                "ops/sharded_pool.py", "utils/tb_writer.py",
                "utils/profiling.py", "data/stratified.py",
                "utils/model_export.py", "cli/export_model.py",
                "cli/doctor.py", "analysis.py", "cli/summarize.py",
                "utils/contours.py", "utils/tiff.py", "utils/jpeg.py",
                "utils/j2k.py",
                "data/wsi.py", "cli/create_patches.py",
                "cli/extract_features_fp.py", "interpret/heatmaps.py",
                "interpret/explanations.py"):
        assert os.path.join("multimodalfusion_tpu_torch", new) in scanned
    bad = [(os.path.relpath(p, REPO), m) for p in files
           for m in _imported_roots(p) if m in FORBIDDEN]
    assert not bad, bad
    # the port builds its own csrc/bagio.cpp; it never loads the JAX
    # package's native/libbagio.so
    loads = [os.path.relpath(p, REPO) for p in files
             if "libbagio" in open(p).read()]
    assert not loads, loads
