"""Training steps of the port under its multi-GPU layouts on gloo ranks
(tests/torch_dist_ranks.py), against the port's world-size-1 step and,
without dropout, the JAX package's step on its 8-device CPU mesh.  Every
batch comes from the loader over an in-memory cohort, as the CLIs make
them: each rank collates only its rows of the global batch (bags
bucketed, a data rank by its own rows).

- Bag sharding, 2 ranks: PathAMIL small (with and without --drop_out),
  RadioAMIL over two sequences with concat fusion, and with tensor
  fusion and dropout (its per-instance draws are flattened rows of the
  bag).
- Data parallelism, 2 ranks, B = 3 (one padding row, and in the second
  batch a rank of padding rows only): max_net with nll_surv and with
  cox_surv (the risk sets span the ranks), PathAMIL and mm_attention_mil
  path_omic with dropout, and two stage-4 heads: highway
  (MaskedBatchNorm: statistics over the global batch) and
  multimodal-dropout (a branch is frozen only when the global batch lacks
  its modality).
- The 2-D layout, 4 ranks (data 2 x bag 2): PathAMIL with and without
  dropout.

Each run of two steps: the losses equal the world-size-1 step's at rel
1e-5 and, for PathAMIL, RadioAMIL concat and max_net without dropout,
JAX's at rel 1e-4; the gradients that the first step applies, after the
sums over the groups, equal the world-size-1 step's per tensor within
1e-5 of its norm plus 1e-7 of the largest tensor's norm (measured: at
most 1.3e-5 of a norm, 3.6e-7 of the largest; a bias before a BatchNorm
has a gradient of rounding noise); every rank's parameters (and
BatchNorm running statistics) equal each other's exactly and the
world-size-1 step's at atol 1e-5 with JAX's rtol of 5e-3 for this
comparison (tests/test_sharding.py:213-217: Adam divides by sqrt(v), so
an element whose gradient is near 0 turns the other summation order of
the sharded sums into a visible part of a step; measured: 4 of
RadioAMIL's 2.1 M reduce_dim weights off by 3.0e-5, at rel 1.9e-3), and
each tensor's distance from it is within 1e-3 of how far the tensor
moved (plus 1e-8, the rounding noise by which a bias before a BatchNorm
moves).  Dropout bits are the global batch's, so a sharded step with
dropout equals the one-process step with the same generator; the draw
itself is held in process to the one-process draw for each layout."""
import contextlib
import json

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from torch_dist_ranks import MemoryView, run_steps, spawn

from multimodalfusion_tpu.engine import train as jtrain
from multimodalfusion_tpu.parallel import mesh as jmesh
from multimodalfusion_tpu_torch.data.loaders import iter_batches
from multimodalfusion_tpu_torch.data.survival_dataset import Sample
from multimodalfusion_tpu_torch.engine import train as ttrain
from multimodalfusion_tpu_torch.ops import mil_attention as tmil
from multimodalfusion_tpu_torch.parallel import mesh as par
from multimodalfusion_tpu_torch.utils import params as tparams

PATH = dict(model_type="path_attention_mil", mode="path", gate_path=True,
            bag_loss="nll_surv")
RADIO = dict(model_type="radio_attention_mil", mode="radio",
             gate_radio=True, bag_loss="nll_surv", modalities=["T1", "T2"])
OMIC = dict(model_type="max_net", mode="omic", omic_input_dim=12)
MM = dict(model_type="mm_attention_mil", mode="path_omic", fusion="tensor",
          gate_path=True, omic_input_dim=12, bag_loss="nll_surv")
HEAD = dict(model_type="path_attention_mil", mode="path", pretrained=True,
            train_type="highway", bag_loss="nll_surv")
# SGD (lr 0.05): the bias of a Linear before a train-mode BatchNorm, and
# a Cox head's last bias, have a zero gradient in exact arithmetic, which
# Adam would turn into steps of +-lr in the direction of the rounding
# noise (tests/test_torch_pretrained_models.py, test_train_steps_match_jax)
MMDROP = dict(model_type="mm_attention_mil", mode="path_omic",
              pretrained=True, train_type="multimodal-dropout",
              bag_loss="cox_surv", opt="sgd", lr=0.05)

# name: (layout, world, config, drop_out, batch kind, B, N, JAX mesh)
CASES = {
    "bag_path": ("bag", 2, PATH, False, "path", 2, 264, "bag"),
    "bag_path_dropout": ("bag", 2, PATH, True, "path", 2, 263, None),
    "bag_radio_concat": ("bag", 2, dict(RADIO, radio_fusion="concat"),
                         False, "radio", 2, 72, "bag"),
    "bag_radio_tensor_dropout": ("bag", 2, dict(RADIO, radio_fusion="tensor"),
                                 True, "radio", 2, 71, None),
    "dp_omic_nll": ("data", 2, dict(OMIC, bag_loss="nll_surv"), False,
                    "omic", 3, 0, "data"),
    "dp_omic_cox": ("data", 2, dict(OMIC, bag_loss="cox_surv"), False,
                    "omic", 3, 0, "data"),
    "dp_path_dropout": ("data", 2, PATH, True, "path", 3, 130, None),
    "dp_mm_dropout": ("data", 2, MM, True, "path_omic", 3, 90, None),
    "dp_head_highway": ("data", 2, HEAD, True, "embed", 5, 0, None),
    "dp_head_mmdrop": ("data", 2, MMDROP, True, "embed_absent", 5, 0, None),
    "2d_path": ("2d", 4, PATH, False, "path", 4, 256, None),
    "2d_path_dropout": ("2d", 4, PATH, True, "path", 4, 250, None),
}

# the first step's gradients: per tensor within GRAD_RTOL of its norm
# plus GRAD_ATOL of the largest tensor's norm (a bias before a BatchNorm
# has a gradient of rounding noise only)
GRAD_RTOL, GRAD_ATOL = 1e-5, 1e-7


def _view(case, seed):
    """A seeded cohort of 2B - 1 subjects for the case: two loader
    batches, the second with a padding row (valid 0); bags ragged, the
    first subject's N instances long.  The first subject of each batch
    has an event before every other time, so that a Cox loss has a risk
    set of more than one row (a lone latest event's loss is 0 and its
    value rounding noise)."""
    _, _, cfg, _, kind, B, N, _ = CASES[case]
    rng = np.random.default_rng(seed)
    samples = []
    for i in range(2 * B - 1):
        s = Sample(subject_id=f"s{i}", disc_label=int(rng.integers(0, 4)),
                   event_time=float(rng.uniform(1, 50)),
                   censorship=float(rng.uniform() < 0.3))
        if i % B == 0:
            s.event_time, s.censorship = 0.5, 0.0
        n = N if i == 0 else int(rng.integers(N // 3, N + 1)) if N else 0
        for m, width in (("path", 1024), ("radio", 2048)):
            if m in kind:
                setattr(s, m, (rng.normal(size=(n, width)) * 0.5
                               ).astype(np.float32))
        if "omic" in kind:
            s.omic = rng.normal(size=12).astype(np.float32)
        if kind.startswith("embed"):
            for m in ("radio", "path", "omic"):
                setattr(s, f"h_{m}",
                        rng.normal(size=256).astype(np.float32))
            if kind == "embed_absent" and (i < B // 2 + 1 or i >= B):
                # rank 0's rows lack the path embedding in batch 0 (the
                # global batch has it: nothing frozen); no row has it in
                # batch 1 (the path branch is frozen)
                s.h_path = np.zeros(256, np.float32)
        s.present = {m: True for m in ("radio", "path", "omic")}
        samples.append(s)
    return MemoryView(cfg["mode"], samples, cfg.get("modalities", ()),
                      pretrained=kind.startswith("embed"),
                      genomic_cols=[f"g{j}" for j in range(12)])


def _config(case):
    layout, _, cfg, drop_out, _, B, _, _ = CASES[case]
    return dict(cfg, batch_size=B, drop_out=drop_out,
                data_parallel=layout in ("data", "2d"),
                bag_shard=layout in ("bag", "2d"),
                bag_shard_devices=2 if layout == "2d" else 0)


def _jax_steps(case, view):
    """(init params, losses) of JAX steps without dropout
    (deterministic=True) on the case's mesh of the 8 CPU devices, over
    the one-process loader's batches of ``view``."""
    kind = CASES[case][-1]
    kw = {k: (tuple(v) if isinstance(v, list) else v)
          for k, v in _config(case).items()}
    cfg = jtrain.TrainConfig(**kw)
    mesh = {"bag": jmesh.make_bag_mesh, "data": jmesh.make_mesh,
            }[kind]()
    model = jtrain.build_model(cfg, bag_mesh=None if kind == "data"
                               else mesh)
    batches = [{k: v for k, v in b.items() if k != "subject_ids"}
               for b in iter_batches(view, batch_size=cfg.batch_size)]
    first = {k: jnp.asarray(v) for k, v in batches[0].items()}
    params = model.init(jax.random.PRNGKey(0), deterministic=True,
                        **jtrain.model_inputs(cfg, first))["params"]
    tx = jtrain.make_optimizer(cfg)
    spec = jtrain.make_loss_spec(cfg)

    @jax.jit
    def step(params, opt_state, b):
        def loss_fn(p):
            out = model.apply({"params": p}, deterministic=True,
                              **jtrain.model_inputs(cfg, b))
            return spec.apply(hazards=out["hazards"], S=out["S"],
                              risks=out["risk"], Y=b["Y"], times=b["t"],
                              c=b["c"], valid=b["valid"])
        loss, grads = jax.value_and_grad(loss_fn)(params)
        updates, opt_state = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, loss

    shard = {"bag": lambda b: jmesh.shard_batch_bags(b, mesh),
             "data": lambda b: jmesh.shard_batch(
                 jmesh.pad_batch_to_devices(b, mesh.size), mesh)}[kind]
    init, state, losses = params, tx.init(params), []
    for b in batches:
        params, state, loss = step(params, state, shard(dict(b)))
        losses.append(float(loss))
    return init, losses


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{case: (every rank's (losses, state, grads), the world-size-1
    (losses, state, grads), JAX's losses or None, the init state_dict)}."""
    refs, setups = {}, {}
    for i, case in enumerate(CASES):
        layout, world, _, drop_out, kind, B, N, jax_kind = CASES[case]
        view = _view(case, seed=i)
        cfg = _config(case)
        tcfg = ttrain.TrainConfig(device="cpu", **cfg)
        jax_losses = None
        if jax_kind is not None:
            jinit, jax_losses = _jax_steps(case, view)
            init = tparams.state_dict_from_jax(
                tparams.spec_from_config(tcfg), jinit)
        else:
            init = ttrain.build_model(
                tcfg, torch.Generator().manual_seed(i)).state_dict()
        spec = {"name": case, "layout": layout, "cfg": cfg, "seed": 7 + i,
                "dropout": drop_out, "bag_devices": 2}
        setups.setdefault(world, []).append((spec, view, init))
        refs[case] = (run_steps(spec, view, init), jax_losses, init)
    got = {}
    for world, specs in setups.items():
        work = tmp_path_factory.mktemp(f"train{world}")
        for spec, view, init in specs:
            torch.save({"view": view, "init": init},
                       work / f"{spec['name']}.pt")
        (work / "train_cases.json").write_text(
            json.dumps([s for s, _, _ in specs]))
        spawn("train_cases", world, str(work))
        for spec, _, _ in specs:
            got[spec["name"]] = [
                torch.load(work / f"{spec['name']}_rank{r}.pt",
                           weights_only=False)
                for r in range(world)]
    return {case: (got[case],) + refs[case] for case in CASES}


@pytest.mark.parametrize("case", list(CASES))
def test_sharded_step_equals_one_process_step(runs, case):
    ranks, (want_losses, want_state, _), jax_losses, init = runs[case]
    assert len(want_losses) == 2
    for r in ranks:
        assert r["losses"] == pytest.approx(want_losses, rel=1e-5)
        if jax_losses is not None:
            assert r["losses"] == pytest.approx(jax_losses, rel=1e-4)
        assert list(r["state"]) == list(want_state)
        for k, want in want_state.items():
            got = r["state"][k]
            assert torch.equal(got, ranks[0]["state"][k]), k
            if not want.is_floating_point():
                assert torch.equal(got, want), k
                continue
            np.testing.assert_allclose(got.numpy(), want.numpy(),
                                       rtol=5e-3, atol=1e-5, err_msg=k)
            # 1e-8: a bias before a BatchNorm moves by rounding noise only
            moved = float((want - init[k]).norm())
            assert float((got - want).norm()) <= 1e-3 * moved + 1e-8, k


@pytest.mark.parametrize("case", list(CASES))
def test_sharded_step_applies_one_process_gradients(runs, case):
    """The gradient that the first step hands the optimizer, after the
    sums over the bag and data groups, is the world-size-1 step's: a
    gradient scaled by a group's size, or summed over a group twice,
    fails here even where Adam's update would hide the scale."""
    ranks, (_, _, want_grads), _, _ = runs[case]
    want = want_grads[0]
    scale = max(float(g.norm()) for g in want.values())
    for r in ranks:
        got = r["grads"][0]
        assert sorted(got) == sorted(want)
        for k, g in want.items():
            err = float((got[k] - g).norm())
            assert err <= GRAD_RTOL * float(g.norm()) + GRAD_ATOL * scale, k


# the layouts of the draw tests: (data ranks, bag ranks); with 4 data
# ranks the last holds padding rows only
LAYOUTS = {"bag2": (1, 2), "bag3": (1, 3), "data2": (2, 1), "data4": (4, 1),
           "2d": (2, 2)}
DRAW_B, DRAW_N, DRAW_L = 3, 301, 5


def _draw_fn(form):
    if form == "masks":
        return lambda shape, g: tmil.make_dropout_masks(g, shape)
    return lambda shape, g: torch.rand(shape, generator=g)


@pytest.mark.parametrize("slab", [64, 8192])
@pytest.mark.parametrize("form", ["uniform", "masks", "flat", "per_sample"])
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_rank_draw_is_block_of_one_process_draw(monkeypatch, layout, form,
                                                slab):
    """Each rank's ``draw`` (in process: the draw needs no collective) is
    its block of the one-process draw of the global batch, bit for bit,
    with zeros on padding rows and instances, and leaves its generator as
    the one-process draw does (a rank of padding rows only included).
    In slabs of 64 rows the one-process draw takes several and a rank
    draws only those that hold its rows: fewer rows than the global
    draw's under bag sharding.  In one slab it is ``fn`` on the generator
    itself, the draw of a one-process run without the multi-GPU layer."""
    monkeypatch.setattr(par, "DRAW_SLAB", slab)
    kd, kb = LAYOUTS[layout]
    bag = form != "per_sample"
    full = ((DRAW_B * DRAW_N, DRAW_L) if form == "flat" else
            (DRAW_B, DRAW_N, DRAW_L) if bag else (DRAW_B, DRAW_L))
    drawn = []

    def fn(shape, g):  # a slab's shape is [rows, L]
        drawn.append(shape[0])
        return _draw_fn(form)(shape, g)

    def one(shape, shard=None):
        ctx = par.bag_axis("path") if bag else contextlib.nullcontext()
        gen = torch.Generator().manual_seed(5)
        with par.local_rows(shard), ctx:
            got = par.draw(fn, shape, gen, "cpu")
        states.append(gen.get_state())
        return got if isinstance(got, tuple) else (got,)

    states = []
    want = [t.reshape((DRAW_B, DRAW_N, DRAW_L) if bag else full)
            for t in one(full)]
    several = bag and slab < DRAW_B * DRAW_N
    if not several:
        plain = _draw_fn(form)(full, torch.Generator().manual_seed(5))
        plain = plain if isinstance(plain, tuple) else (plain,)
        assert all(torch.equal(w.reshape(full), p)
                   for w, p in zip(want, plain))
    for d in range(kd):
        for j in range(kb):
            b0, b1 = par.block(DRAW_B, kd, d)
            i0, i1 = par.block(DRAW_N, kb, j)
            shard = par.Shard((b0, b1, DRAW_B), {"path": (i0, i1, DRAW_N)})
            nb, n = b1 - b0, i1 - i0
            shape = ((nb * n, DRAW_L) if form == "flat" else
                     (nb, n, DRAW_L) if bag else (nb, DRAW_L))
            drawn.clear()
            got = one(shape, shard)
            # the generator advances as in one process, padding rows or
            # not, so the next draw is the same on every rank
            assert torch.equal(states[-1], states[0])
            for w, g in zip(want, got):
                expect = torch.zeros((nb, n, DRAW_L) if bag else shape,
                                     dtype=w.dtype)
                rows = w[b0:min(b1, DRAW_B)]
                if bag:
                    rows = rows[:, i0:min(i1, DRAW_N)]
                    expect[:rows.shape[0], :rows.shape[1]] = rows
                else:
                    expect[:rows.shape[0]] = rows
                assert torch.equal(g.reshape(expect.shape), expect)
            if several and kb > 1:
                assert sum(drawn) < DRAW_B * DRAW_N
                assert sum(drawn) <= nb * n + 2 * nb * par.DRAW_SLAB
