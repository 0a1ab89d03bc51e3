"""The port's stage-4 modules (multimodalfusion_tpu_torch.models.
{modules,pretrained_heads}, utils/params.py and the engine's train step)
against the JAX package's on the CPU, from the same seeded numpy inputs:
MaskedBatchNorm at 1e-6, Highway and Residual at 1e-5, every head in eval
mode at rel 1e-5 from one JAX init carried over with
state_dict_from_jax, and three Adam train steps (early-fcnn and the
multimodal-dropout freeze) against JAX's train_step."""
import flax.linen as flax_nn
import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from multimodalfusion_tpu.engine import train as jtrain
from multimodalfusion_tpu.models import modules as jmodules
from multimodalfusion_tpu.utils import torch_interop
from multimodalfusion_tpu_torch.engine import train as ttrain
from multimodalfusion_tpu_torch.models import modules
from multimodalfusion_tpu_torch.utils import params as tparams

MODALITIES = ("radio", "path", "omic")


def t(x):
    return torch.from_numpy(np.array(x, np.float32))


def close(got, want, rtol):
    """got (torch) vs want (jax) at rtol of the largest |want|."""
    got = got.detach().double().numpy()
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= rtol * max(np.abs(want).max(), 1e-30), err


@pytest.fixture
def no_flax_dropout(monkeypatch):
    """Every flax Dropout is the identity while the test runs (the JAX
    package itself is unchanged): the train-mode comparisons need both
    sides without dropout, whose bits differ by design."""
    monkeypatch.setattr(flax_nn.Dropout, "__call__",
                        lambda self, inputs, deterministic=None, rng=None:
                        inputs)


def drop_port_dropout(model):
    for m in model.modules():
        if isinstance(m, modules.Dropout):
            m.p = 0.0


VALID_CASES = {"padded": [1, 1, 0, 1, 0, 1], "one_row": [0, 0, 1, 0, 0, 0],
               "none": None}


@pytest.mark.parametrize("case", list(VALID_CASES))
def test_masked_batch_norm_matches_jax(case):
    """Three train-mode updates: each output, and the running mean and
    var after them, at 1e-6 (rel of the largest entry); then eval mode
    with those statistics.  Padded rows are outside the statistics, and a
    one-row batch normalises by a zero variance without raising."""
    rng = np.random.default_rng(1)
    valid = VALID_CASES[case]
    jbn = jmodules.MaskedBatchNorm()
    xs = [(rng.normal(size=(6, 8)) * 3 + 1).astype(np.float32)
          for _ in range(3)]
    jv = None if valid is None else jnp.asarray(valid, jnp.float32)
    variables = jbn.init(jax.random.PRNGKey(0), jnp.asarray(xs[0]), jv)
    bn = modules.MaskedBatchNorm(8).train()
    tv = None if valid is None else t(valid)
    for x in xs:
        want, upd = jbn.apply(variables, jnp.asarray(x), jv,
                              use_running_average=False,
                              mutable=["batch_stats"])
        variables = {**variables, **upd}
        close(bn(t(x), tv), want, 1e-6)
    stats = variables["batch_stats"]
    close(bn.running_mean, stats["mean"], 1e-6)
    close(bn.running_var, stats["var"], 1e-6)
    assert int(bn.num_batches_tracked) == 3
    bn.eval()
    close(bn(t(xs[0]), tv), jbn.apply(variables, jnp.asarray(xs[0]), jv),
          1e-6)


def _block_case(jblock, block, spec, seed, n_features=32):
    """Train mode (statistics from the valid rows, dropout off on both
    sides) and then eval mode, from one JAX init, at rel 1e-5."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(5, n_features)).astype(np.float32)
    valid = np.array([1, 1, 1, 0, 1], np.float32)
    variables = jblock.init({"params": jax.random.PRNGKey(seed),
                             "dropout": jax.random.PRNGKey(1)},
                            jnp.asarray(x), True, jnp.asarray(valid))
    sd = tparams.state_dict_from_jax(spec, variables["params"],
                                     batch_stats=variables["batch_stats"])
    block.load_state_dict({k.split(".", 1)[1]: v for k, v in sd.items()})
    drop_port_dropout(block)
    want, upd = jblock.apply(variables, jnp.asarray(x), False,
                             jnp.asarray(valid), mutable=["batch_stats"])
    close(block.train()(t(x), t(valid))[valid > 0],
          np.asarray(want)[valid > 0], 1e-5)
    variables = {**variables, **upd}
    with torch.no_grad():
        close(block.eval()(t(x), t(valid)),
              jblock.apply(variables, jnp.asarray(x), True,
                           jnp.asarray(valid)), 1e-5)


@pytest.mark.parametrize("n_layers", [1, 2])
def test_highway_matches_jax(no_flax_dropout, n_layers):
    _block_case(jmodules.Highway(32, n_layers),
                modules.Highway(32, n_layers),
                tparams._highway_entries("blk", [], n_layers), 3 + n_layers)


@pytest.mark.parametrize("n_layers", [1, 2])
def test_residual_matches_jax(n_layers):
    _block_case(jmodules.Residual(32, n_layers),
                modules.Residual(32, n_layers),
                tparams._residual_entries("blk", [], n_layers), 5 + n_layers)


HEAD_CASES = (
    [("mm_attention_mil", tt, loss, mode)
     for tt in ("late-fcnn", "late-highway", "early-fcnn", "early-highway",
                "kronecker", "multimodal-dropout")
     for loss in ("nll_surv", "cox_surv")
     for mode in ("path_omic", "radio_path_omic")]
    + [("max_net", tt, loss, mode)
       for tt in ("fcnn", "highway", "residual")
       for loss in ("nll_surv", "cox_surv")
       for mode in ("path", "omic")])


def embeddings(seed, B=6):
    rng = np.random.default_rng(seed)
    return {f"h_{m}": rng.normal(size=(B, 256)).astype(np.float32)
            for m in MODALITIES}


def configs(**kw):
    kw = {**dict(pretrained=True, n_classes=4, n_layers=2), **kw}
    return jtrain.TrainConfig(**kw), ttrain.TrainConfig(device="cpu", **kw)


@pytest.mark.parametrize("model_type,train_type,bag_loss,mode", HEAD_CASES,
                         ids=lambda v: str(v))
def test_heads_match_jax_in_eval_mode(model_type, train_type, bag_loss,
                                      mode):
    """One JAX init (its BatchNorm running statistics moved off 0 and 1),
    carried over by state_dict_from_jax: eval outputs at rel 1e-5, and the
    port's reference-layout state_dict has the JAX export's keys, order
    and values."""
    jcfg, tcfg = configs(model_type=model_type, mode=mode,
                         train_type=train_type, bag_loss=bag_loss)
    h = embeddings(7)
    jmodel = jtrain.build_model(jcfg)
    jh = {k: jnp.asarray(v) for k, v in h.items()}
    variables = dict(jmodel.init({"params": jax.random.PRNGKey(2),
                                  "dropout": jax.random.PRNGKey(3)},
                                 deterministic=True, **jh))
    if "batch_stats" in variables:
        rng = np.random.default_rng(4)
        variables["batch_stats"] = jax.tree.map(
            lambda a: jnp.asarray(rng.uniform(0.5, 1.5, a.shape)
                                  .astype(np.float32)),
            variables["batch_stats"])
    want = jmodel.apply(variables, deterministic=True, **jh)
    spec = tparams.spec_from_config(tcfg)
    model = ttrain.build_model(tcfg).eval()
    model.load_state_dict(tparams.state_dict_from_jax(
        spec, variables["params"], batch_stats=variables.get("batch_stats")))
    with torch.no_grad():
        got = model(**{k: t(v) for k, v in h.items()})
    close(got["risk"], want["risk"], 1e-5)
    if "nll" in bag_loss:
        close(got["S"], want["S"], 1e-5)
        close(got["hazards"], want["hazards"], 1e-5)
    else:
        assert got["S"] is None and want["S"] is None
    export = torch_interop.variables_to_torch(
        torch_interop.spec_from_config(jcfg), variables)
    mine = tparams.reference_state_dict(model.state_dict(), spec)
    assert list(mine) == list(export)
    for k, v in export.items():
        assert torch.equal(mine[k], v.to(mine[k].dtype)), k


def step_batches(seed, absent_at, B=4):
    """Three seeded batches: an event in each; the last row of the second
    batch is padding (valid 0, zero embeddings); at ``absent_at`` the whole
    batch lacks its path embedding."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(3):
        b = embeddings(seed * 10 + i, B)
        valid = np.ones(B, np.float32)
        if i == 1:
            valid[-1] = 0.0
            for m in MODALITIES:
                b[f"h_{m}"][-1] = 0.0
        if i == absent_at:
            b["h_path"][:] = 0.0
        c = (rng.uniform(size=B) < 0.3).astype(np.float32)
        c[0] = 0.0
        b.update(Y=rng.integers(0, 4, size=B).astype(np.int32),
                 t=rng.uniform(1, 60, size=B).astype(np.float32), c=c,
                 valid=valid)
        out.append(b)
    return out


def _adam_state(opt_state):
    return next(s for s in opt_state if isinstance(s, optax.ScaleByAdamState))


STEP_CASES = {"early_fcnn": ("early-fcnn", "path_omic", None),
              "mm_dropout_frozen_at_step_2": ("multimodal-dropout",
                                              "radio_path_omic", 1),
              "mm_dropout_frozen_at_step_1": ("multimodal-dropout",
                                              "path_omic", 0)}


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_train_steps_match_jax(no_flax_dropout, case):
    """Three Adam steps (weight decay 1e-3) from one JAX init, dropout off
    on both sides, JAX's own train_step: the loss at rel 1e-5 at every
    step; after step 3 each parameter within 1e-3 of its movement (1e-8
    absolute) and no element further than 2e-4 (a fifth of lr), the
    BatchNorm running variances at rel 1e-5, the Adam moments at 1e-4 of
    their tensor's largest entry, and every tensor's Adam step count 3,
    as JAX's one count.  In the multimodal-dropout cases the step whose
    batch lacks the path embedding leaves the path branch (layer_WSI.*)
    and its moments exactly where they were, on both sides.

    The bias of a Linear that feeds a train-mode BatchNorm has a zero
    gradient in exact arithmetic (the BatchNorm takes the batch mean
    out), so Adam moves it by its rounding noise, up to lr a step, in
    directions that differ between the two sides.  Those biases are held
    to that bound (3 lr from the init) instead, their moments are not
    compared, and the running mean of the BatchNorm after them is
    compared at rel 1e-5 once the recorded bias difference of each step
    is taken out (the running mean sums 0.1 * 0.9^(2-k) times step k's
    batch mean, of which the bias is a part)."""
    train_type, mode, absent_at = STEP_CASES[case]
    jcfg, tcfg = configs(model_type="mm_attention_mil", mode=mode,
                         train_type=train_type, bag_loss="nll_surv",
                         batch_size=4, lr=1e-3, reg=1e-3)
    batches = step_batches(3, absent_at)
    jmodel = jtrain.build_model(jcfg)
    variables = dict(jmodel.init(
        {"params": jax.random.PRNGKey(5), "dropout": jax.random.PRNGKey(6)},
        deterministic=True, **{k: jnp.asarray(v) for k, v in
                               batches[0].items() if k.startswith("h_")}))
    tx = jtrain.make_optimizer(jcfg)
    opt_state = tx.init(variables["params"])
    jstep, _ = jtrain.make_steps(jcfg, jmodel, tx)

    spec = tparams.spec_from_config(tcfg)
    port = ttrain.build_model(tcfg)
    init = tparams.state_dict_from_jax(spec, variables["params"],
                                       batch_stats=variables["batch_stats"])
    port.load_state_dict(init)
    drop_port_dropout(port)
    opt = ttrain.make_optimizer(tcfg, port.parameters())
    tstep, _ = ttrain.make_steps(tcfg, port, opt, torch.device("cpu"))
    named = dict(port.named_parameters())
    wsi = [k for k in named if k.startswith("layer_WSI.")]
    assert wsi or absent_at is None

    def jax_wsi(tree):
        return jax.tree.map(np.array, {k: v for k, v in tree.items()
                                       if k.startswith("layer_WSI")})

    # each BatchNorm after a Linear: (bn prefix, the Linear's bias key)
    pre_bn = [(spec[i + 1][1], f"{e[1]}.bias") for i, e in enumerate(spec)
              if e[0] == "linear" and i + 1 < len(spec)
              and spec[i + 1][0] == "bn"]
    assert pre_bn
    bias_gap = {bn: 0.0 for bn, _ in pre_bn}
    for i, b in enumerate(batches):
        jbias = tparams.state_dict_from_jax(spec, variables["params"])
        for bn, bias in pre_bn:
            bias_gap[bn] = 0.9 * bias_gap[bn] + 0.1 * (
                named[bias].detach().numpy() - jbias[bias].numpy())
        before_t = {k: (named[k].detach().clone(),
                        {s: v.clone() for s, v in opt.state[named[k]]
                         .items() if s != "step"}) for k in wsi}
        before_j = (jax_wsi(variables["params"]),
                    jax_wsi(_adam_state(opt_state).mu))
        variables, opt_state, jout = jstep(
            variables, opt_state, {k: jnp.asarray(v) for k, v in b.items()},
            jax.random.PRNGKey(10 + i))
        tout = tstep(b, torch.Generator().manual_seed(i))
        assert float(tout["loss"]) == pytest.approx(float(jout["loss"]),
                                                    rel=1e-5), i
        if i == absent_at:
            for k, (value, moments) in before_t.items():
                assert torch.equal(named[k], value), k
                for s, v in moments.items():
                    assert torch.equal(opt.state[named[k]][s], v), (k, s)
                for s in ("exp_avg", "exp_avg_sq"):
                    if s not in moments:  # created by this step: zeros
                        assert not opt.state[named[k]][s].any(), (k, s)
            after_j = (jax_wsi(variables["params"]),
                       jax_wsi(_adam_state(opt_state).mu))
            for was, now in zip(before_j, after_j):
                assert was.keys() == now.keys() and was
                for a, z in zip(jax.tree.leaves(was), jax.tree.leaves(now)):
                    np.testing.assert_array_equal(a, np.asarray(z))

    want = tparams.state_dict_from_jax(spec, variables["params"],
                                       batch_stats=variables["batch_stats"])
    got = port.state_dict()
    assert sorted(got) == sorted(want)
    noise = {bias for _, bias in pre_bn}
    for k in want:
        g, w, w0 = got[k].numpy(), want[k].numpy(), init[k].numpy()
        if k.endswith("num_batches_tracked"):
            assert int(g) == 3
        elif k.endswith("running_var"):
            close(got[k], w, 1e-5)
        elif k.endswith("running_mean"):
            close(got[k] - torch.from_numpy(
                np.asarray(bias_gap[k[:-len(".running_mean")]],
                           np.float32)), w, 1e-5)
        elif k in noise:
            bound = 3 * tcfg.lr * (1 + 1e-3)
            assert np.abs(g - w0).max() <= bound, k
            assert np.abs(w - w0).max() <= bound, k
        else:
            assert np.linalg.norm(g - w) <= 1e-3 * np.linalg.norm(
                w - w0) + 1e-8, k
            assert np.abs(g - w).max() <= 2e-4, k
    adam = _adam_state(opt_state)
    assert int(adam.count) == 3
    for name, tree in (("exp_avg", adam.mu), ("exp_avg_sq", adam.nu)):
        moments = tparams.state_dict_from_jax(spec, tree)
        for k, p in named.items():
            assert float(opt.state[p]["step"]) == 3, k
            if k not in noise:
                close(opt.state[p][name], moments[k], 1e-4)


def test_multimodal_dropout_refuses_gradient_accumulation():
    _, tcfg = configs(model_type="mm_attention_mil", mode="path_omic",
                      train_type="multimodal-dropout", gc=2, batch_size=2)
    model = ttrain.build_model(tcfg)
    with pytest.raises(ValueError, match="gc > 1"):
        ttrain.make_steps(tcfg, model,
                          ttrain.make_optimizer(tcfg, model.parameters()),
                          torch.device("cpu"))


def test_frozen_parameters_follow_the_jax_markers():
    """The branch a batch freezes is the one whose modality has all-zero
    embeddings in every row (padding included); each parameter belongs to
    the first modality whose marker its name holds."""
    _, tcfg = configs(model_type="mm_attention_mil", mode="radio_path_omic",
                      train_type="multimodal-dropout")
    model = ttrain.build_model(tcfg)
    names = {id(p): n for n, p in model.named_parameters()}
    b = embeddings(0, 3)
    assert ttrain.frozen_parameters(model, b) == []
    b["h_radio"][:] = 0.0
    b["h_omic"][:] = 0.0
    frozen = {names[id(p)] for p in ttrain.frozen_parameters(model, b)}
    assert frozen == {n for n in names.values()
                      if n.startswith(("layer_MRI.", "layer_omic."))}
    assert frozen and not any(n.startswith("classifier") for n in frozen)


def test_heads_refuse_unknown_train_types():
    for kw in (dict(model_type="mm_attention_mil", mode="path_omic",
                    train_type="fcnn"),
               dict(model_type="max_net", mode="omic",
                    train_type="kronecker"),
               dict(model_type="max_net", mode="path_omic",
                    train_type="fcnn"),
               dict(model_type="mm_attention_mil", mode="path_omic",
                    train_type="multimodal-early-fcnn")):
        with pytest.raises(ValueError, match="train_type|unimodal"):
            ttrain.build_model(configs(**kw)[1])
