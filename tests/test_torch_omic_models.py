"""The port's stage-2 genomic and path+omic models
(multimodalfusion_tpu_torch.models.{modules,genomic,mm_amil} and
utils/params.py) against the JAX package's on the CPU: the same JAX
params carried over with state_dict_from_jax give the same outputs at rel
1e-5, the checkpoint's key set and placeholders are the JAX export's, and
five optimizer steps from one JAX init give JAX's losses at rel 1e-4."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from multimodalfusion_tpu.engine import train as jtrain
from multimodalfusion_tpu.models import modules as jmodules
from multimodalfusion_tpu.models.genomic import MaxNet as JaxMaxNet
from multimodalfusion_tpu.models.mm_amil import MMAttentionMIL as JaxMM
from multimodalfusion_tpu.utils import torch_interop
from multimodalfusion_tpu_torch.engine import train as ttrain
from multimodalfusion_tpu_torch.models import modules
from multimodalfusion_tpu_torch.models.genomic import MaxNet
from multimodalfusion_tpu_torch.models.mm_amil import MMAttentionMIL
from multimodalfusion_tpu_torch.utils import params as tparams

G = 20
RTOL = 1e-5


def close(got, want, rtol=RTOL):
    """got (torch) vs want (jax) at rtol of the largest |want|."""
    got = got.detach().double().numpy()
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= rtol * max(np.abs(want).max(), 1e-30)


def inputs(seed, B=4, N=48, lens=None):
    rng = np.random.default_rng(seed)
    lens = rng.integers(1, N + 1, size=B) if lens is None else lens
    return {"path_bags": (rng.normal(size=(B, N, 1024)) * 0.5
                          ).astype(np.float32),
            "path_mask": (np.arange(N)[None, :] < np.asarray(lens)[:, None]
                          ).astype(np.float32),
            "genomic": rng.normal(size=(B, G)).astype(np.float32)}


def test_alpha_dropout_matches_the_jax_formula():
    """With the same keep bits, AlphaDropout is JAX's a*where(keep, x,
    alpha')+b; its draw comes from the generator; eval is the identity."""
    x = torch.randn(64, 32, generator=torch.Generator().manual_seed(0))
    drop = modules.AlphaDropout(0.25)
    got = drop(x, torch.Generator().manual_seed(3))
    keep = torch.rand(x.shape, generator=torch.Generator().manual_seed(3)
                      ) >= 0.25
    p, q, ap = 0.25, 0.75, jmodules._ALPHA_PRIME
    a = (q + ap ** 2 * q * p) ** -0.5
    want = a * np.where(keep.numpy(), x.numpy(), ap) - a * ap * p
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    assert torch.equal(drop.eval()(x), x)


def test_snn_block_matches_jax():
    x = jnp.asarray(inputs(0)["genomic"])
    jblock = jmodules.SNNBlock(256)
    params = jblock.init(jax.random.PRNGKey(1), x)["params"]
    block = modules.SNNBlock(G, 256).eval()
    block.load_state_dict(tparams.state_dict_from_jax(
        [("linear", "0", ["Dense_0"])], params))
    close(block(torch.from_numpy(np.asarray(x))),
          jblock.apply({"params": params}, x))


@pytest.mark.parametrize("gate", [True, False])
@pytest.mark.parametrize("n_mod", [2, 3])
def test_xlinear_fusion_matches_jax(gate, n_mod):
    rng = np.random.default_rng(n_mod)
    vs = [rng.normal(size=(4, 256)).astype(np.float32) for _ in range(n_mod)]
    jfuse = jmodules.XlinearFusion(dim=256, scale_dim=16, mmhid1=512,
                                   mmhid2=512, num_modalities=n_mod,
                                   skip=True, gate=gate)
    params = jfuse.init(jax.random.PRNGKey(2), [jnp.asarray(v) for v in vs])
    fuse = modules.XlinearFusion(dim=256, scale_dim=16, mmhid1=512,
                                 mmhid2=512, num_modalities=n_mod, skip=True,
                                 gate=gate).eval()
    sd = tparams.state_dict_from_jax(
        tparams._xfusion_entries("mm", ["mm"], n_mod, gate),
        {"mm": params["params"]})
    fuse.load_state_dict({k[3:]: v for k, v in sd.items()})
    close(fuse([torch.from_numpy(v) for v in vs]),
          jfuse.apply(params, [jnp.asarray(v) for v in vs]))


def jax_mm(mode, fusion, gate, gate_path, attn_dropout=False):
    return JaxMM(mode=mode, omic_input_dim=G, fusion=fusion, gate=gate,
                 gate_path=gate_path, attn_dropout=attn_dropout)


def port_mm(mode, fusion, gate, gate_path, attn_dropout=False):
    return MMAttentionMIL(mode=mode, omic_input_dim=G, fusion=fusion,
                          gate=gate, gate_path=gate_path,
                          attn_dropout=attn_dropout)


def jax_call(mode, b):
    return {k: jnp.asarray(v) for k, v in b.items()
            if ("path" in mode and k.startswith("path")) or k == "genomic"}


MM_CASES = [("path_omic", "tensor", True, True),
            ("path_omic", "tensor", False, True),
            ("path_omic", "tensor", False, False),
            ("path_omic", "concat", False, True),
            ("path_omic", "concat", True, False),
            ("omic", "tensor", False, True),
            ("omic", "concat", False, True)]


@pytest.mark.parametrize("mode,fusion,gate,gate_path", MM_CASES)
def test_mm_attention_mil_matches_jax(mode, fusion, gate, gate_path):
    """Eval outputs at rel 1e-5 from one JAX init; a fully padded bag in
    the batch (its genomic row still counts)."""
    b = inputs(5, lens=[48, 0, 17, 1])
    jm = jax_mm(mode, fusion, gate, gate_path)
    params = jm.init(jax.random.PRNGKey(4), **jax_call(mode, b))["params"]
    want = jm.apply({"params": params}, **jax_call(mode, b))
    model = port_mm(mode, fusion, gate, gate_path).eval()
    model.load_state_dict(tparams.state_dict_from_jax(
        "mm_attention_mil", params, gated=gate_path, mode=mode,
        fusion=fusion, gate=gate))
    with torch.no_grad():
        got = model(**{k: torch.from_numpy(np.asarray(v))
                       for k, v in jax_call(mode, b).items()})
    for k in ("hazards", "S", "risk"):
        close(got[k], want[k])


@pytest.mark.parametrize("bag_loss", ["nll_surv", "cox_surv", "ce_surv"])
def test_max_net_matches_jax(bag_loss):
    x = jnp.asarray(inputs(6)["genomic"])
    jm = JaxMaxNet(model_size="small", bag_loss=bag_loss, n_classes=4)
    params = jm.init(jax.random.PRNGKey(5), x)["params"]
    want = jm.apply({"params": params}, x)
    model = MaxNet(G, "small", bag_loss, 4).eval()
    model.load_state_dict(tparams.state_dict_from_jax("max_net", params))
    with torch.no_grad():
        got = model(torch.from_numpy(np.asarray(x)))
    close(got["risk"], want["risk"])
    if bag_loss == "cox_surv":
        assert got["S"] is None and got["hazards"] is None
    else:
        close(got["S"], want["S"])


@pytest.mark.parametrize("radio_fusion", ["concat", "tensor"])
@pytest.mark.parametrize("mode,fusion,gate,gate_path,drop", [
    ("path_omic", "tensor", False, True, True),
    ("path_omic", "concat", True, False, False),
    ("omic", "tensor", False, False, True)])
def test_checkpoint_keys_and_placeholders_are_the_jax_exports(
        mode, fusion, gate, gate_path, drop, radio_fusion):
    """A port checkpoint (model + placeholders) has the JAX export's keys
    in its order, shapes and placeholder values; loading drops exactly
    the placeholders."""
    b = inputs(7)
    jm = jax_mm(mode, fusion, gate, gate_path, drop)
    variables = jm.init(jax.random.PRNGKey(6), **jax_call(mode, b))
    jcfg = jtrain.TrainConfig(model_type="mm_attention_mil", mode=mode,
                              fusion=fusion, radio_fusion=radio_fusion,
                              gate=gate, gate_path=gate_path,
                              gate_radio=True, drop_out=drop,
                              omic_input_dim=G)
    want = torch_interop.variables_to_torch(
        torch_interop.spec_from_config(jcfg), variables)
    tcfg = ttrain.TrainConfig(
        **{f: getattr(jcfg, f) for f in (
            "model_type", "mode", "fusion", "radio_fusion", "gate",
            "gate_path", "gate_radio", "drop_out", "omic_input_dim",
            "modalities")}, device="cpu")
    spec = tparams.spec_from_config(tcfg)
    model = ttrain.build_model(tcfg)
    model.load_state_dict(tparams.state_dict_from_jax(
        spec, variables["params"]))
    got = tparams.reference_state_dict(model.state_dict(), spec)
    assert list(got) == list(want)
    for k in want:
        assert got[k].shape == want[k].shape, k
        assert torch.equal(got[k], want[k].float()), k
    assert list(tparams.without_fillers(got, spec)) == list(
        model.state_dict())


def test_loading_a_checkpoint_refuses_unknown_or_missing_keys(tmp_path):
    cfg = ttrain.TrainConfig(model_type="mm_attention_mil", mode="path_omic",
                             omic_input_dim=G, device="cpu")
    spec = tparams.spec_from_config(cfg)
    model = ttrain.build_model(cfg)
    path = str(tmp_path / "ck.pt")
    ttrain.save_checkpoint(path, model, spec)
    sd = torch.load(path)
    assert set(tparams.filler_keys(spec)) < set(sd)
    ttrain.load_checkpoint(ttrain.build_model(cfg), path, spec)
    for broken in ({**sd, "stray.weight": torch.zeros(1)},
                   {k: v for k, v in sd.items() if k != "mm.encoder1.0.bias"}):
        torch.save(broken, path)
        with pytest.raises(RuntimeError, match="state_dict"):
            ttrain.load_checkpoint(ttrain.build_model(cfg), path, spec)


def step_batches(seed, n=5, B=4, N=48):
    """Seeded host batches: full-width bags, genomic rows, labels with at
    least one event; the last entry of batches 2 and 4 is padding
    (valid = 0)."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        b = inputs(seed * 10 + i, B, N)
        valid = np.ones(B, np.float32)
        if i in (2, 4):
            valid[-1] = 0.0
            b["path_mask"][-1] = 0.0
            b["genomic"][-1] = 0.0
        c = (rng.uniform(size=B) < 0.3).astype(np.float32)
        c[0] = 0.0  # an event in every batch: the Cox loss has a gradient
        b.update(Y=rng.integers(0, 4, size=B).astype(np.int32),
                 t=rng.uniform(1, 60, size=B).astype(np.float32),
                 c=c, valid=valid)
        out.append(b)
    return out


STEP_CASES = {
    "max_net_nll": dict(model_type="max_net", mode="omic"),
    # SGD: with Adam, one bias element of fc_omic.1 whose summed gradient
    # cancels to f32 rounding noise takes a step whose size and sign
    # follow that noise (the gradients agree at rel 1e-6 at every step)
    "max_net_cox_sgd": dict(model_type="max_net", mode="omic",
                            bag_loss="cox_surv", opt="sgd"),
    "mm_tensor_omic_mm_l1": dict(model_type="mm_attention_mil",
                                 mode="path_omic", fusion="tensor",
                                 gate_path=True, reg_type="omic_mm"),
    "mm_concat_sgd": dict(model_type="mm_attention_mil", mode="path_omic",
                          fusion="concat", gate_path=False, opt="sgd"),
}


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_train_steps_match_jax(case):
    """Five optimizer steps from one JAX init carried over with
    state_dict_from_jax, every dropout off on both sides (as in
    tests/test_torch_train.py): the loss agrees at every step at rel
    1e-4; after step 5 each parameter's distance from the init agrees to
    1e-3 of its length and no element differs by more than 2e-4.  The
    distance holds to 1e-8 more: the Cox head's bias has an exact zero
    gradient (the loss is invariant to a shift of every risk), so it
    moves by rounding alone, about 1e-10."""
    kw = {**dict(n_classes=4, lr=1e-3, reg=1e-5, batch_size=4,
                 bag_loss="nll_surv", lambda_reg=1e-4, omic_input_dim=G),
          **STEP_CASES[case]}
    jcfg = jtrain.TrainConfig(**kw)
    tcfg = ttrain.TrainConfig(device="cpu", **kw)
    batches = step_batches(1)
    jmodel = jtrain.build_model(jcfg)
    params = jmodel.init(jax.random.PRNGKey(0), **jtrain.model_inputs(
        jcfg, {k: jnp.asarray(v) for k, v in batches[0].items()}))["params"]
    tx = jtrain.make_optimizer(jcfg)
    opt_state = tx.init(params)
    spec = jtrain.make_loss_spec(jcfg)
    reg_fn = jtrain._reg_fn(jcfg)

    @jax.jit
    def jstep(params, opt_state, b):
        def loss_fn(p):
            out = jmodel.apply({"params": p}, deterministic=True,
                               **jtrain.model_inputs(jcfg, b))
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

    tspec = tparams.spec_from_config(tcfg)
    port = ttrain.build_model(tcfg)
    init = tparams.state_dict_from_jax(tspec, params)
    port.load_state_dict(init)
    for m in port.modules():  # every dropout off
        if isinstance(m, modules.Dropout):
            m.p = 0.0
    opt = ttrain.make_optimizer(tcfg, port.parameters())
    train_step, _ = ttrain.make_steps(tcfg, port, opt, torch.device("cpu"))
    gen = torch.Generator().manual_seed(0)
    for i, b in enumerate(batches):
        params, opt_state, jloss = jstep(
            params, opt_state, {k: jnp.asarray(v) for k, v in b.items()})
        out = train_step(b, gen)
        assert float(out["loss"]) == pytest.approx(float(jloss), rel=1e-4), i
    want = tparams.state_dict_from_jax(tspec, params)
    got = port.state_dict()
    assert sorted(got) == sorted(want)
    for k in want:
        g, w, w0 = got[k].numpy(), want[k].numpy(), init[k].numpy()
        moved = np.linalg.norm(w - w0)
        assert np.linalg.norm(g - w) <= 1e-3 * moved + 1e-8, k
        assert np.abs(g - w).max() <= 2e-4, k


def test_omic_models_draw_dropout_from_the_step_generator():
    """path+omic with --drop_out: the same generator seed draws the same
    bits (FC, attention branches, AlphaDropout, fusion, classifier), and
    another seed draws others."""
    cfg = ttrain.TrainConfig(model_type="mm_attention_mil", mode="path_omic",
                             gate_path=True, drop_out=True, batch_size=4,
                             omic_input_dim=G, device="cpu")
    b = step_batches(2, n=1)[0]

    def run(seed):
        model = ttrain.build_model(cfg, torch.Generator().manual_seed(0))
        opt = ttrain.make_optimizer(cfg, model.parameters())
        step, _ = ttrain.make_steps(cfg, model, opt, torch.device("cpu"))
        out = step(b, torch.Generator().manual_seed(seed))
        return float(out["loss"]), model.state_dict()
    (l1, s1), (l2, s2), (l3, _) = run(3), run(3), run(4)
    assert l1 == l2 and all(torch.equal(s1[k], s2[k]) for k in s1)
    assert l1 != l3
