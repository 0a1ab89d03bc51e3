"""The port's PathAMIL (multimodalfusion_tpu_torch.models.amil) against the
JAX package's, on the same seeded numpy bags, with weights carried over
by ``state_dict_from_jax`` and by the JAX package's own ``.pt`` export."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from multimodalfusion_tpu.models import PathAMIL as JaxPathAMIL
from multimodalfusion_tpu.models import heads as jheads
from multimodalfusion_tpu.utils import torch_interop as ti
from multimodalfusion_tpu_torch.engine.train import (TrainConfig,
                                                     build_model,
                                                     load_checkpoint)
from multimodalfusion_tpu_torch.models import heads as theads
from multimodalfusion_tpu_torch.models.amil import PathAMIL
from multimodalfusion_tpu_torch.utils.params import state_dict_from_jax

VARIANTS = [("small", True, False), ("small", False, False),
            ("big", True, False), ("big", False, False),
            ("small", False, True)]


def make_batch(seed, B=3, N=96):
    rng = np.random.default_rng(seed)
    bags = rng.normal(size=(B, N, 1024)).astype(np.float32)
    lens = np.array([N, 17, 60])[:B]
    mask = (np.arange(N)[None, :] < lens[:, None]).astype(np.float32)
    return bags, mask


def jax_model(size, gate, drop, dtype="float32"):
    model = JaxPathAMIL(model_size=size, gate=gate, attn_dropout=drop,
                        n_classes=4, compute_dtype=dtype)
    bags, mask = make_batch(0, B=1, N=8)
    variables = model.init(jax.random.PRNGKey(0), jnp.asarray(bags),
                           jnp.asarray(mask))
    return model, variables


def port_outputs(model, bags, mask):
    with torch.no_grad():
        out = model.eval()(torch.from_numpy(bags), torch.from_numpy(mask))
    return {k: out[k].numpy() for k in ("hazards", "S", "risk", "features")}


def assert_same(got, want, rtol=1e-5, atol=1e-6):
    for k in ("hazards", "S", "risk"):
        np.testing.assert_allclose(got[k], np.asarray(want[k]), rtol=rtol,
                                   atol=atol, err_msg=k)


@pytest.mark.parametrize("size,gate,drop", VARIANTS)
def test_path_amil_matches_jax(size, gate, drop):
    jm, variables = jax_model(size, gate, drop)
    bags, mask = make_batch(1)
    want = jm.apply(variables, jnp.asarray(bags), jnp.asarray(mask))
    port = PathAMIL(size, gate=gate, attn_dropout=drop)
    port.load_state_dict(state_dict_from_jax(
        "path_attention_mil", variables["params"], gated=gate,
        attn_dropout=drop), strict=True)
    got = port_outputs(port, bags, mask)
    assert_same(got, want)
    np.testing.assert_allclose(got["features"], np.asarray(want["features"]),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("size,gate,drop", VARIANTS)
def test_jax_pt_export_loads_strict(tmp_path, size, gate, drop):
    """The ``.pt`` side export JAX training writes beside each checkpoint
    (utils/torch_interop.py::export_pt with the config's spec) loads
    into the port unchanged."""
    jm, variables = jax_model(size, gate, drop)
    path = str(tmp_path / "s_0_minloss_checkpoint.pt")
    ti.export_pt(path, ti.build_spec("path_attention_mil", gated=gate,
                                     attn_dropout=drop), variables)
    cfg = TrainConfig(model_type="path_attention_mil", mode="path",
                      model_size_wsi=size, gate_path=gate, drop_out=drop)
    port = load_checkpoint(build_model(cfg), path)
    bags, mask = make_batch(2)
    assert_same(port_outputs(port, bags, mask),
                jm.apply(variables, jnp.asarray(bags), jnp.asarray(mask)))


def test_bf16_compute_dtype_keeps_head_f32():
    """bf16 runs the fc and the pooling input in bf16 while the pooled
    features and the classifier stay f32 (models/amil.py:27-30, :54).
    The JAX reference pooling multiplies bf16 h by f32 weights while the
    port reads the weights in bf16 as its kernel does: rel 2e-2."""
    jm, variables = jax_model("small", True, False, dtype="bfloat16")
    bags, mask = make_batch(3)
    want = jm.apply(variables, jnp.asarray(bags), jnp.asarray(mask))
    port = PathAMIL("small", gate=True, compute_dtype="bfloat16")
    port.load_state_dict(state_dict_from_jax("path_attention_mil",
                                             variables["params"]))
    got = port_outputs(port, bags, mask)
    assert got["features"].dtype == np.float32
    assert got["risk"].dtype == np.float32
    assert_same(got, want, rtol=2e-2, atol=2e-3)


def test_seeded_init_repeats():
    a = PathAMIL(generator=torch.Generator().manual_seed(7)).state_dict()
    b = PathAMIL(generator=torch.Generator().manual_seed(7)).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert (a["classifier.bias"] == 0).all()


def test_heads_match_jax():
    logits = np.random.default_rng(4).normal(size=(5, 4)).astype(np.float32)
    want = jheads.survival_outputs(jnp.asarray(logits))
    got = theads.survival_outputs(torch.from_numpy(logits))
    for k in ("hazards", "S", "risk", "Y_hat"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-6, atol=1e-7, err_msg=k)
    for shape in ((5, 1), (5,)):
        risk = logits[:, 0].reshape(shape)
        want = jheads.scalar_risk_outputs(jnp.asarray(risk))
        got = theads.scalar_risk_outputs(torch.from_numpy(risk))
        np.testing.assert_array_equal(got["risk"].numpy(),
                                      np.asarray(want["risk"]))
        assert got["hazards"] is None and got["S"] is None
