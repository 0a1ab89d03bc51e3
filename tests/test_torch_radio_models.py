"""The port's radiology models (``RadioAMIL`` in models/amil.py, the
radiology branch and the path-only mode of ``MMAttentionMIL`` in
models/mm_amil.py, their specs in utils/params.py) against the JAX
package's on the CPU: the same JAX params carried over with
state_dict_from_jax give the same outputs at rel 1e-5 and the same
gradients at rel 1e-4; five Adam steps from one JAX init give JAX's
losses at rel 1e-4; checkpoints load strictly both ways, placeholders
included.  The Kronecker radiology fusion runs at 2 sequences (17^2 = 289
wide) for the steps and once at 4 (17^4 = 83,521 wide) for a forward."""
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from multimodalfusion_tpu.engine import train as jtrain
from multimodalfusion_tpu.utils import torch_interop
from multimodalfusion_tpu_torch.engine import train as ttrain
from multimodalfusion_tpu_torch.models import modules
from multimodalfusion_tpu_torch.utils import params as tparams

G = 12
SEQS = ("T1", "T2", "T1Gd", "FLAIR")


def close(got, want, rtol=1e-5):
    """got (torch) vs want (jax) at rtol of the largest |want|."""
    got = got.detach().double().numpy()
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= rtol * max(np.abs(want).max(), 1e-30)


def inputs(seed, n_mod, B=3, Nr=16, Np=24, lens_r=None):
    rng = np.random.default_rng(seed)
    lens_r = (rng.integers(1, Nr + 1, size=B) if lens_r is None
              else np.asarray(lens_r))
    lens_p = rng.integers(1, Np + 1, size=B)
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
    """The same TrainConfig for both packages."""
    kw = {**dict(model_type=model_type, mode=mode, modalities=SEQS[:n_mod],
                 omic_input_dim=G, n_classes=4, gate_radio=True,
                 gate_path=True), **kw}
    return jtrain.TrainConfig(**kw), ttrain.TrainConfig(device="cpu", **kw)


def jax_inputs(jcfg, b):
    return jtrain.model_inputs(jcfg, {k: jnp.asarray(v) for k, v in
                                      b.items()})


def carried(jcfg, tcfg, b, seed=0):
    """(JAX model, its variables, the port model holding the same
    parameters, the port's spec)."""
    jm = jtrain.build_model(jcfg)
    variables = jm.init(jax.random.PRNGKey(seed), **jax_inputs(jcfg, b))
    spec = tparams.spec_from_config(tcfg)
    port = ttrain.build_model(tcfg)
    port.load_state_dict(tparams.state_dict_from_jax(
        spec, variables["params"]))
    return jm, variables, port, spec


def port_inputs(tcfg, b):
    return ttrain.model_inputs(tcfg, b, torch.device("cpu"))


RADIO_CASES = [("concat", 4, "small", True), ("concat", 4, "big", False),
               ("tensor", 2, "small", True), ("tensor", 3, "small", False),
               ("concat", 1, "small", True), ("tensor", 1, "big", True)]


@pytest.mark.parametrize("radio_fusion,n_mod,size,gate", RADIO_CASES)
def test_radio_amil_matches_jax(radio_fusion, n_mod, size, gate):
    """Eval outputs and the stage-3 features at rel 1e-5 from one JAX init,
    with a fully padded bag in the batch."""
    b = inputs(1, n_mod, lens_r=[16, 0, 5])
    jcfg, tcfg = config("radio_attention_mil", "radio", n_mod,
                        radio_fusion=radio_fusion, model_size_radio=size,
                        gate_radio=gate)
    jm, variables, port, _ = carried(jcfg, tcfg, b)
    want = jm.apply(variables, **jax_inputs(jcfg, b))
    feats = jm.apply(variables, return_features=True,
                     **jax_inputs(jcfg, b))
    port.eval()
    with torch.no_grad():
        got = port(**port_inputs(tcfg, b))
        got_feats = port(**port_inputs(tcfg, b), return_features=True)
    for k in ("hazards", "S", "risk"):
        close(got[k], want[k])
    close(got_feats, feats)


def test_radio_amil_tensor_fusion_of_four_sequences_matches_jax():
    """The full-width Kronecker fusion of 4 sequences (encoder1 83,521 ->
    1024): one forward."""
    b = inputs(2, 4, B=2, Nr=4)
    jcfg, tcfg = config("radio_attention_mil", "radio", 4,
                        radio_fusion="tensor")
    jm, variables, port, spec = carried(jcfg, tcfg, b)
    want = jm.apply(variables, **jax_inputs(jcfg, b))
    with torch.no_grad():
        got = port.eval()(**port_inputs(tcfg, b))
    close(got["risk"], want["risk"])
    # 4 sequences: the reference's own radio_xfusion shapes, no placeholder
    assert not tparams.filler_keys(spec)


MM_MODES = ["radio", "radio_path", "radio_omic", "radio_path_omic", "path"]


@pytest.mark.parametrize("fusion", ["tensor", "concat"])
@pytest.mark.parametrize("mode", MM_MODES)
def test_mm_attention_mil_radio_modes_match_jax(mode, fusion):
    """Eval outputs at rel 1e-5 for every mode with radiology and the
    path-only mode, the radiology sequences fused by concatenation (with
    the model's tensor fusion) or by a Kronecker product (with concat),
    gated or not, a fully padded radiology bag in the batch."""
    radio_fusion = "concat" if fusion == "tensor" else "tensor"
    b = inputs(3, 2, lens_r=[0, 16, 7])
    jcfg, tcfg = config("mm_attention_mil", mode, 2, fusion=fusion,
                        radio_fusion=radio_fusion, gate=fusion == "tensor",
                        gate_radio=mode != "radio_omic")
    jm, variables, port, _ = carried(jcfg, tcfg, b)
    want = jm.apply(variables, **jax_inputs(jcfg, b))
    with torch.no_grad():
        got = port.eval()(**port_inputs(tcfg, b))
    for k in ("hazards", "S", "risk"):
        close(got[k], want[k])


GRAD_CASES = {
    "radio_concat": ("radio_attention_mil", "radio", 4,
                     dict(radio_fusion="concat")),
    "radio_tensor": ("radio_attention_mil", "radio", 2,
                     dict(radio_fusion="tensor")),
    "mm_radio_path_omic": ("mm_attention_mil", "radio_path_omic", 2,
                           dict(fusion="tensor", radio_fusion="tensor",
                                gate=True)),
}


@pytest.mark.parametrize("case", list(GRAD_CASES))
def test_gradients_match_jax(case):
    """d(sum of risks and hazards)/d(parameters) at rel 1e-4 of each
    tensor's largest entry, through the plain pooling backward."""
    model_type, mode, n_mod, kw = GRAD_CASES[case]
    b = inputs(4, n_mod, lens_r=[16, 3, 9])
    jcfg, tcfg = config(model_type, mode, n_mod, **kw)
    jm, variables, port, spec = carried(jcfg, tcfg, b)
    jin = jax_inputs(jcfg, b)

    def jloss(p):
        out = jm.apply({"params": p}, **jin)
        return out["risk"].sum() + out["hazards"].sum()
    jgrads = jax.grad(jloss)(variables["params"])
    port.eval()
    out = port(**port_inputs(tcfg, b))
    (out["risk"].sum() + out["hazards"].sum()).backward()
    want = tparams.state_dict_from_jax(spec, jgrads)
    got = {k: p.grad for k, p in port.named_parameters()}
    assert sorted(got) == sorted(want)
    for k in want:
        close(got[k], want[k].numpy(), rtol=1e-4)


def step_batches(seed, n_mod, n=5, B=4):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        b = inputs(seed * 10 + i, n_mod, B=B)
        valid = np.ones(B, np.float32)
        if i in (2, 4):
            valid[-1] = 0.0
            for k in ("radio_mask", "path_mask", "genomic"):
                b[k][-1] = 0.0
        c = (rng.uniform(size=B) < 0.3).astype(np.float32)
        c[0] = 0.0
        b.update(Y=rng.integers(0, 4, size=B).astype(np.int32),
                 t=rng.uniform(1, 60, size=B).astype(np.float32),
                 c=c, valid=valid)
        out.append(b)
    return out


STEP_CASES = {
    "radio_concat": ("radio_attention_mil", "radio", 4,
                     dict(radio_fusion="concat")),
    "radio_tensor_2seq": ("radio_attention_mil", "radio", 2,
                          dict(radio_fusion="tensor")),
    "mm_radio_path_omic": ("mm_attention_mil", "radio_path_omic", 2,
                           dict(fusion="tensor", radio_fusion="concat",
                                gate=True, reg_type="omic_mm")),
}


@pytest.mark.parametrize("opt_name", ["adam", "sgd"])
@pytest.mark.parametrize("case", list(STEP_CASES))
def test_train_steps_match_jax(case, opt_name):
    """Five optimizer steps from one JAX init, every dropout off on both
    sides: the loss at every step at rel 1e-4.  With SGD, after step 5
    each parameter's distance from the init agrees to 1e-3 of its length
    (+1e-8: a parameter that the loss does not reach moves by rounding)
    and no element differs by more than 2e-4.  (With Adam the parameters
    are not compared: an element whose gradient sums to rounding noise,
    such as a fusion feature that ReLU nearly always zeroes, takes steps
    of about lr whose sign follows that noise, as in
    tests/test_torch_omic_models.py.)"""
    model_type, mode, n_mod, kw = STEP_CASES[case]
    kw = {**dict(lr=1e-3, reg=1e-5, batch_size=4, bag_loss="nll_surv",
                 opt=opt_name), **kw}
    jcfg, tcfg = config(model_type, mode, n_mod, **kw)
    batches = step_batches(1, n_mod)
    jm = jtrain.build_model(jcfg)
    params = jm.init(jax.random.PRNGKey(0), **jax_inputs(
        jcfg, batches[0]))["params"]
    tx = jtrain.make_optimizer(jcfg)
    opt_state = tx.init(params)
    spec = jtrain.make_loss_spec(jcfg)
    reg_fn = jtrain._reg_fn(jcfg)

    @jax.jit
    def jstep(params, opt_state, b):
        def loss_fn(p):
            out = jm.apply({"params": p}, deterministic=True,
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
    for m in port.modules():
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
    if opt_name == "adam":
        return
    for k in want:
        g, w, w0 = got[k].numpy(), want[k].numpy(), init[k].numpy()
        moved = np.linalg.norm(w - w0)
        assert np.linalg.norm(g - w) <= 1e-3 * moved + 1e-8, k
        assert np.abs(g - w).max() <= 2e-4, k


def test_radio_models_draw_dropout_from_the_step_generator():
    """--drop_out: the same generator seed draws the same bits (FC, the
    attention branches, the Kronecker fusion), another seed others."""
    _, cfg = config("radio_attention_mil", "radio", 2, radio_fusion="tensor",
                    drop_out=True, batch_size=4)
    b = step_batches(2, 2, n=1)[0]

    def run(seed):
        model = ttrain.build_model(cfg, torch.Generator().manual_seed(0))
        opt = ttrain.make_optimizer(cfg, model.parameters())
        step, _ = ttrain.make_steps(cfg, model, opt, torch.device("cpu"))
        out = step(b, torch.Generator().manual_seed(seed))
        return float(out["loss"]), model.state_dict()
    (l1, s1), (l2, s2), (l3, _) = run(3), run(3), run(4)
    assert l1 == l2 and all(torch.equal(s1[k], s2[k]) for k in s1)
    assert l1 != l3


CKPT_CASES = {
    # the reference's full key set, nothing filled
    "radio_concat_4seq": ("radio_attention_mil", "radio", 4,
                          dict(radio_fusion="concat", drop_out=True)),
    "mm_radio_path_omic": ("mm_attention_mil", "radio_path_omic", 4,
                           dict(fusion="tensor", radio_fusion="concat",
                                gate=True)),
    # placeholders: the reduce_dim of one sequence; the pathology branch
    "mm_radio_1seq": ("mm_attention_mil", "radio_omic", 1,
                      dict(fusion="concat", radio_fusion="concat",
                           gate_path=False)),
    # placeholders: the radiology branch and its fusion; the genomic SNN
    # at the cohort's width
    "mm_path": ("mm_attention_mil", "path", 4,
                dict(fusion="tensor", radio_fusion="concat", gate=False,
                     drop_out=True)),
}


@pytest.mark.parametrize("case", list(CKPT_CASES))
def test_checkpoints_load_strictly_both_ways(case, tmp_path):
    """The JAX .pt export loads into the port with strict=True (its
    placeholders dropped); the port's checkpoint has the export's keys,
    order, shapes and values, and the JAX package imports it back to the
    same parameters."""
    model_type, mode, n_mod, kw = CKPT_CASES[case]
    b = inputs(6, n_mod)
    jcfg, tcfg = config(model_type, mode, n_mod, **kw)
    jm = jtrain.build_model(jcfg)
    variables = jm.init(jax.random.PRNGKey(6), **jax_inputs(jcfg, b))
    jspec = torch_interop.spec_from_config(jcfg)
    jax_pt = str(tmp_path / "jax.pt")
    torch_interop.export_pt(jax_pt, jspec, variables)
    spec = tparams.spec_from_config(tcfg)
    port = ttrain.load_checkpoint(ttrain.build_model(tcfg), jax_pt, spec)
    want = torch.load(jax_pt, weights_only=True)

    port_pt = str(tmp_path / "port.pt")
    ttrain.save_checkpoint(port_pt, port, spec)
    got = torch.load(port_pt, weights_only=True)
    assert list(got) == list(want)
    for k in want:
        assert got[k].shape == want[k].shape, k
        assert torch.equal(got[k], want[k].float()), k
    back = torch_interop.torch_to_variables(jspec, got, variables)
    for (path, a), (_, c) in zip(
            jax.tree_util.tree_leaves_with_path(variables["params"]),
            jax.tree_util.tree_leaves_with_path(back["params"])):
        assert np.array_equal(np.asarray(a), np.asarray(c)), path


@pytest.mark.parametrize("n_mod", [2, 3])
def test_two_sequence_tensor_fusion_checkpoint(n_mod, tmp_path):
    """2 or 3 sequences, tensor fusion: the JAX package's checkpoint
    writer (its training's save_checkpoint) puts the reference's
    4-sequence placeholder in the .pt where the trained fusion should be,
    and the trained radio_xfusion in the flax msgpack beside it.  The port
    loads the .pt with the fusion from the msgpack and gives JAX's outputs
    at rel 1e-5; without the msgpack it refuses the .pt, naming the
    missing file.  The port's own checkpoint carries its trained
    radio_xfusion at its own shapes and loads back into the port, while
    the JAX package imports every other parameter from it and keeps its
    own radio_xfusion (its spec reads nothing there)."""
    b = inputs(7, n_mod)
    jcfg, tcfg = config("radio_attention_mil", "radio", n_mod,
                        radio_fusion="tensor")
    spec = tparams.spec_from_config(tcfg)
    jspec = torch_interop.spec_from_config(jcfg)
    assert ("fill_xfusion", "radio_xfusion",
            (1024, 64, 1024, 1024, 4, True, False)) in jspec
    assert not tparams.filler_keys(spec)
    jm = jtrain.build_model(jcfg)
    variables = jm.init(jax.random.PRNGKey(7), **jax_inputs(jcfg, b))
    flax_ckpt = str(tmp_path / "s_0_minloss_checkpoint.msgpack")
    jtrain.save_checkpoint(flax_ckpt, variables, jspec)
    jax_pt = str(tmp_path / "s_0_minloss_checkpoint.pt")
    assert tuple(torch.load(jax_pt, weights_only=True)[
        "radio_xfusion.encoder1.0.weight"].shape) == (1024, 17 ** 4)
    served = ttrain.load_checkpoint(ttrain.build_model(tcfg), jax_pt, spec)
    want = jm.apply(variables, **jax_inputs(jcfg, b))
    with torch.no_grad():
        got = served.eval()(**port_inputs(tcfg, b))
    for k in ("hazards", "S", "risk"):
        close(got[k], want[k])
    os.remove(flax_ckpt)
    with pytest.raises(RuntimeError, match=(
            f"{n_mod}-sequence .*/s_0_minloss_checkpoint.msgpack, which "
            f"does not exist")):
        ttrain.load_checkpoint(ttrain.build_model(tcfg), jax_pt, spec)

    model = ttrain.build_model(tcfg, torch.Generator().manual_seed(1))
    path = str(tmp_path / "port.pt")
    ttrain.save_checkpoint(path, model, spec)
    again = ttrain.load_checkpoint(ttrain.build_model(tcfg), path, spec)
    for k, v in model.state_dict().items():
        assert torch.equal(again.state_dict()[k], v), k
    sd = torch.load(path, weights_only=True)
    back = torch_interop.torch_to_variables(jspec, sd, variables)
    want = tparams.state_dict_from_jax(spec, back["params"])
    for k, v in model.state_dict().items():
        if k.startswith("radio_xfusion."):
            continue
        assert torch.equal(want[k], v), k
    for (path_, a), (_, c) in zip(
            jax.tree_util.tree_leaves_with_path(
                variables["params"]["radio_xfusion"]),
            jax.tree_util.tree_leaves_with_path(
                back["params"]["radio_xfusion"])):
        assert np.array_equal(np.asarray(a), np.asarray(c)), path_
