"""The port's attention read-out and attributions against the JAX
package's on the CPU, from the same seeded numpy inputs:
``attention_pool_with_attn``; the read-out escapes of PathAMIL, RadioAMIL
(concat and tensor) and MMAttentionMIL (radio_path_omic, path_omic), in
eval mode and in train mode with attention dropout on (both sides given
the same keep masks, every other dropout off), at rel 1e-5; and
integrated gradients (both quadratures), expected gradients fed JAX's
draws, ``modality_attributions`` and ``completeness_gap`` at rel 1e-5."""
import flax.linen as flax_nn
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from multimodalfusion_tpu.engine import train as jtrain
from multimodalfusion_tpu.interpret import ig as jig
from multimodalfusion_tpu.models import modules as jmodules
from multimodalfusion_tpu.ops import mil_attention as jmil
from multimodalfusion_tpu_torch.engine import train as ttrain
from multimodalfusion_tpu_torch.interpret import ig as tig
from multimodalfusion_tpu_torch.models import modules as tmodules
from multimodalfusion_tpu_torch.ops import mil_attention as tmil
from multimodalfusion_tpu_torch.utils import params as tparams

G = 12
SEQS = ("T1", "T2", "T1Gd", "FLAIR")


def t(x):
    return torch.from_numpy(np.array(x, np.float32))


def close(got, want, rtol=1e-5):
    """got (torch) vs want (jax) at rtol of the largest |want|."""
    got = got.detach().double().numpy()
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= rtol * max(np.abs(want).max(), 1e-30), err


# ---------------------------------------------------------------------------
# the read-out
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("gated", [True, False])
def test_attention_pool_with_attn_matches_jax(gated):
    """(pooled, attn, raw scores) at rel 1e-5, a fully masked bag and a
    ragged one in the batch; Da = 48, bags of 5-40."""
    rng = np.random.default_rng(3)
    B, N, D, Da = 3, 40, 32, 48
    h = rng.normal(size=(B, N, D)).astype(np.float32)
    mask = (np.arange(N)[None] < np.array([40, 0, 5])[:, None]).astype(
        np.float32)
    p = [(rng.normal(size=s) * 0.2).astype(np.float32)
         for s in ((D, Da), (Da,), (D, Da), (Da,), (Da, 1), (1,))]
    want = jmil.attention_pool_with_attn(
        jnp.asarray(h), jnp.asarray(mask),
        jmil.AttnParams(*map(jnp.asarray, p)), gated)
    got = tmil.attention_pool_with_attn(t(h), t(mask),
                                        tmil.AttnParams(*map(t, p)), gated)
    for g, w in zip(got, want):
        close(g, w)
    assert float(got[1][1].abs().sum()) == 0.0   # the empty bag


def inputs(seed, n_mod, B=3, Nr=16, Np=24):
    rng = np.random.default_rng(seed)
    lens_r = np.array([Nr, 5, 1])[:B]
    lens_p = np.array([7, Np, 12])[:B]
    return {"radio_bags": (rng.normal(size=(B, Nr, n_mod * 1024)) * 0.5
                           ).astype(np.float32),
            "radio_mask": (np.arange(Nr)[None, :] < lens_r[:, None]
                           ).astype(np.float32),
            "path_bags": (rng.normal(size=(B, Np, 1024)) * 0.5
                          ).astype(np.float32),
            "path_mask": (np.arange(Np)[None, :] < lens_p[:, None]
                          ).astype(np.float32),
            "genomic": rng.normal(size=(B, G)).astype(np.float32)}


def config(model_type, mode, n_mod, **kw):
    kw = {**dict(model_type=model_type, mode=mode, modalities=SEQS[:n_mod],
                 omic_input_dim=G, n_classes=4, gate_radio=True,
                 gate_path=True), **kw}
    return jtrain.TrainConfig(**kw), ttrain.TrainConfig(device="cpu", **kw)


def carried(jcfg, tcfg, b, seed=0):
    """(JAX model, its variables, the port model holding the same
    parameters)."""
    jm = jtrain.build_model(jcfg)
    variables = jm.init(jax.random.PRNGKey(seed), **jtrain.model_inputs(
        jcfg, {k: jnp.asarray(v) for k, v in b.items()}))
    port = ttrain.build_model(tcfg)
    port.load_state_dict(tparams.state_dict_from_jax(
        tparams.spec_from_config(tcfg), variables["params"]))
    return jm, variables, port


@pytest.fixture
def same_keep_masks(monkeypatch):
    """Train mode on both sides with the same attention keep masks (one
    seeded draw per mask shape, handed to both packages' pooling) and
    every other dropout off (flax Dropout and the JAX AlphaDropout the
    identity, the port's at rate 0), whose bits differ by design."""
    drawn = {}

    def masks(shape, gated):
        if shape not in drawn:
            rng = np.random.default_rng(sum(shape))
            da, db = (rng.random(shape) >= 0.25 for _ in range(2))
            drawn[shape] = da.astype(np.uint8), db.astype(np.uint8)
        da, db = drawn[shape]
        return da, (db if gated else da)

    monkeypatch.setattr(
        jmil, "make_dropout_masks",
        lambda rng, shape, gated=True, rate=0.25: tuple(
            jnp.asarray(m) for m in masks(tuple(shape), gated)))
    monkeypatch.setattr(
        tmil, "make_dropout_masks",
        lambda generator, shape, gated=True, rate=0.25, device=None: tuple(
            torch.from_numpy(m) for m in masks(tuple(shape), gated)))
    monkeypatch.setattr(flax_nn.Dropout, "__call__",
                        lambda self, inputs, deterministic=None, rng=None:
                        inputs)
    monkeypatch.setattr(jmodules.AlphaDropout, "__call__",
                        lambda self, x, deterministic: x)

    def port_train(model):
        for m in model.modules():
            if isinstance(m, tmodules.Dropout):
                m.p = 0.0
        return model.train()
    return drawn, port_train


AMIL_CASES = {"path": ("path_attention_mil", "path", 4, {}),
              "path_ungated": ("path_attention_mil", "path", 4,
                               dict(gate_path=False)),
              "radio_concat": ("radio_attention_mil", "radio", 4,
                               dict(radio_fusion="concat")),
              "radio_tensor": ("radio_attention_mil", "radio", 2,
                               dict(radio_fusion="tensor",
                                    gate_radio=False))}


def _amil_inputs(model_type, b):
    key = "path" if model_type == "path_attention_mil" else "radio"
    return b[f"{key}_bags"], b[f"{key}_mask"]


@pytest.mark.parametrize("case", list(AMIL_CASES))
def test_amil_attention_only_matches_jax(case):
    """Eval mode: attention_only's raw scores [B, N] at rel 1e-5, with and
    without the attention-dropout layout (a no-op in eval)."""
    model_type, mode, n_mod, kw = AMIL_CASES[case]
    b = inputs(11, n_mod)
    for drop_out in (False, True):
        jcfg, tcfg = config(model_type, mode, n_mod, drop_out=drop_out,
                            **kw)
        jm, variables, port = carried(jcfg, tcfg, b)
        bags, mask = _amil_inputs(model_type, b)
        want = jm.apply(variables, jnp.asarray(bags), jnp.asarray(mask),
                        attention_only=True)
        with torch.no_grad():
            got = port.eval()(t(bags), t(mask), attention_only=True)
        close(got, want)


@pytest.mark.parametrize("case", list(AMIL_CASES))
def test_amil_attention_only_with_attention_dropout(case, same_keep_masks):
    """Train mode, attention dropout on: the same keep masks give JAX's
    raw scores at rel 1e-5, and they differ from the scores without
    dropout."""
    drawn, port_train = same_keep_masks
    model_type, mode, n_mod, kw = AMIL_CASES[case]
    b = inputs(12, n_mod)
    jcfg, tcfg = config(model_type, mode, n_mod, drop_out=True, **kw)
    jm, variables, port = carried(jcfg, tcfg, b)
    bags, mask = _amil_inputs(model_type, b)
    want = jm.apply(variables, jnp.asarray(bags), jnp.asarray(mask),
                    deterministic=False, attention_only=True,
                    rngs={"dropout": jax.random.PRNGKey(1)})
    got = port_train(port)(t(bags), t(mask), attention_only=True)
    close(got, want)
    assert len(drawn) == 1
    with torch.no_grad():
        plain = port.eval()(t(bags), t(mask), attention_only=True)
    assert not torch.allclose(got, plain)


MM_CASES = [("radio_path_omic", "concat"), ("radio_path_omic", "tensor"),
            ("path_omic", "concat")]


@pytest.mark.parametrize("mode,radio_fusion", MM_CASES)
@pytest.mark.parametrize("dropout", [False, True])
def test_mm_attention_mil_return_attention_matches_jax(
        mode, radio_fusion, dropout, request):
    """return_attention: A_raw of each attention branch and the risk (its
    pooled features from the read-out) at rel 1e-5, in eval mode, and in
    train mode with attention dropout on and the same keep masks; without
    it A_raw is empty and the outputs are the fused path's."""
    b = inputs(13, 2)
    jcfg, tcfg = config("mm_attention_mil", mode, 2, fusion="tensor",
                        radio_fusion=radio_fusion, gate=True,
                        drop_out=dropout)
    jm, variables, port = carried(jcfg, tcfg, b)
    jkw = {k: jnp.asarray(v) for k, v in jtrain.model_inputs(
        jcfg, {k: jnp.asarray(v) for k, v in b.items()}).items()}
    tkw = ttrain.model_inputs(tcfg, b, torch.device("cpu"))
    if dropout:
        drawn, port_train = request.getfixturevalue("same_keep_masks")
        want = jm.apply(variables, **jkw, deterministic=False,
                        return_attention=True,
                        rngs={"dropout": jax.random.PRNGKey(2)})
        got = port_train(port)(**tkw, return_attention=True)
        assert len(drawn) == sum(m in mode for m in ("radio", "path"))
    else:
        want = jm.apply(variables, **jkw, return_attention=True)
        with torch.no_grad():
            got = port.eval()(**tkw, return_attention=True)
            fused = port(**tkw)
        assert fused["A_raw"] == {}
        close(fused["risk"], want["risk"])
    names = [n for n, m in (("radiology", "radio"), ("pathology", "path"))
             if m in mode]
    assert sorted(got["A_raw"]) == sorted(want["A_raw"]) == sorted(names)
    for n in names:
        close(got["A_raw"][n], want["A_raw"][n])
    close(got["risk"], want["risk"])


# ---------------------------------------------------------------------------
# attributions
# ---------------------------------------------------------------------------

def _fns():
    """The same two-input nonlinear function in both packages."""
    rng = np.random.default_rng(5)
    W = rng.normal(size=(6, 4)).astype(np.float32)
    V = rng.normal(size=(3, 4)).astype(np.float32)

    def jfn(a, b):
        return jnp.sum(jnp.tanh(a @ W) * jax.nn.sigmoid(b @ V), axis=-1)

    def tfn(a, b):
        return (torch.tanh(a @ t(W)) * torch.sigmoid(b @ t(V))).sum(-1)
    return jfn, tfn


@pytest.mark.parametrize("method", ["gausslegendre", "riemann_middle"])
@pytest.mark.parametrize("n_steps", [1, 7, 20])
def test_integrated_gradients_matches_jax(method, n_steps):
    """Both quadratures at several node counts, two inputs, zero and
    given baselines: each attribution at rel 1e-5."""
    rng = np.random.default_rng(n_steps)
    a = rng.normal(size=(5, 6)).astype(np.float32)
    b = rng.normal(size=(5, 3)).astype(np.float32)
    a0 = rng.normal(size=(5, 6)).astype(np.float32) * 0.1
    b0 = np.zeros((5, 3), np.float32)
    jfn, tfn = _fns()
    ja, jw = jig._quadrature(n_steps, method)
    ta, tw = tig._quadrature(n_steps, method)
    assert np.array_equal(ja, ta) and np.array_equal(jw, tw)
    for base in (None, (a0, b0)):
        want = jig.integrated_gradients(
            jfn, (a, b), None if base is None else
            tuple(map(jnp.asarray, base)), n_steps=n_steps, method=method)
        got = tig.integrated_gradients(
            tfn, (t(a), t(b)), None if base is None else
            tuple(map(t, base)), n_steps=n_steps, method=method)
        for g, w in zip(got, want):
            close(g, w)


def test_integrated_gradients_of_a_stage4_head_matches_jax():
    """IG of an early-fcnn head's risk (MaskedBatchNorm on its running
    statistics, eval mode) with respect to the three embeddings, and the
    per-modality |IG| sums and completeness gap: rel 1e-5."""
    rng = np.random.default_rng(8)
    jcfg = jtrain.TrainConfig(model_type="mm_attention_mil",
                              mode="radio_path_omic", pretrained=True,
                              train_type="early-fcnn", bag_loss="nll_surv")
    tcfg = ttrain.TrainConfig(device="cpu", **{
        k: getattr(jcfg, k) for k in ("model_type", "mode", "pretrained",
                                      "train_type", "bag_loss")})
    h = [rng.normal(size=(6, 256)).astype(np.float32) for _ in range(3)]
    jm = jtrain.build_model(jcfg)
    variables = jm.init(jax.random.PRNGKey(4), *map(jnp.asarray, h))
    stats = jax.tree.map(lambda x: x + 0.1, variables["batch_stats"])
    variables = {**variables, "batch_stats": stats}
    port = ttrain.build_model(tcfg)
    port.load_state_dict(tparams.state_dict_from_jax(
        tparams.spec_from_config(tcfg), variables["params"],
        batch_stats=variables["batch_stats"]))
    port.eval()

    def jfn(*e):
        return jm.apply(variables, *e)["risk"]

    def tfn(*e):
        return port(*e)["risk"]
    want = jig.integrated_gradients(jfn, tuple(map(jnp.asarray, h)))
    got = tig.integrated_gradients(tfn, tuple(map(t, h)))
    for g, w in zip(got, want):
        close(g, w)
    names = ("radio", "path", "omic")
    jmod = jig.modality_attributions(jfn, tuple(map(jnp.asarray, h)), names)
    tmod = tig.modality_attributions(tfn, tuple(map(t, h)), names)
    for n in names:
        close(tmod[n], jmod[n])
    jgap = jig.completeness_gap(jfn, tuple(map(jnp.asarray, h)), want)
    tgap = tig.completeness_gap(tfn, tuple(map(t, h)), got)
    assert abs(tgap - jgap) <= 1e-5 * max(
        abs(float(jnp.sum(jfn(*map(jnp.asarray, h))))), 1.0)


def _jax_draws(seed, n_samples, B, M):
    """The draws of the JAX package's expected_gradients (JAX
    interpret/ig.py:86-90)."""
    key = jax.random.PRNGKey(seed)
    bidx = jax.random.randint(key, (n_samples, B), 0, M)
    alphas = jax.random.uniform(jax.random.fold_in(key, 1), (n_samples, B))
    return np.asarray(bidx), np.asarray(alphas)


def test_expected_gradients_with_jax_draws_matches_jax():
    """A max_net's risk (eval mode): expected gradients over JAX's own
    background and interpolation draws at rel 1e-5."""
    rng = np.random.default_rng(9)
    x = rng.normal(size=(7, G)).astype(np.float32)
    background = rng.normal(size=(11, G)).astype(np.float32)
    jcfg, tcfg = config("max_net", "omic", 4, bag_loss="nll_surv")
    jm, variables, port = carried(jcfg, tcfg, {"genomic": x})
    port.eval()

    def jfn(g):
        return jm.apply(variables, genomic_features=g)["risk"]

    def tfn(g):
        return port(genomic_features=g)["risk"]
    want = jig.expected_gradients(jfn, jnp.asarray(x),
                                  jnp.asarray(background), n_samples=24,
                                  seed=3)
    bidx, alphas = _jax_draws(3, 24, 7, 11)
    got = tig.expected_gradients(
        tfn, t(x), t(background),
        (torch.from_numpy(bidx.astype(np.int64)), t(alphas)))
    close(got, want)


def test_expected_gradient_draws_are_seeded():
    """The port's draws: shapes, ranges, and the same draws from the same
    seed, others from another."""
    def draw(seed):
        return tig.expected_gradient_draws(
            50, 6, 9, torch.Generator().manual_seed(seed))
    (b1, a1), (b2, a2), (b3, _) = draw(1), draw(1), draw(2)
    assert b1.shape == a1.shape == (50, 6) and b1.dtype == torch.int64
    assert int(b1.min()) >= 0 and int(b1.max()) <= 8
    assert float(a1.min()) >= 0.0 and float(a1.max()) < 1.0
    assert torch.equal(b1, b2) and torch.equal(a1, a2)
    assert not torch.equal(b1, b3)
