"""The port's bag-sharded attention pooling (ops/sharded_pool.py) on 2 and
4 gloo ranks against the JAX package's sharded op on its 8-device CPU mesh
and against the port's unsharded ``attention_pool``, on the same seeded
inputs: gated and ungated, with and without the attention-branch dropout
masks (JAX's masks handed to both), N = 1021 (a multiple of neither 2 nor
4, so the ranks pad it with masked rows) and a bag of 300 valid rows, of
which whole blocks are masked.  Pooled output, dh and the parameter
gradients at JAX's own tolerances (tests/test_sharding.py:45-46: rtol
2e-5, atol 2e-5); a masked block's dh is exactly 0.  The ranks run in
tests/torch_dist_ranks.py (one spawn per world size)."""
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from torch_dist_ranks import ATTN_FIELDS, spawn

from multimodalfusion_tpu.ops import mil_attention as jmil
from multimodalfusion_tpu.ops.sharded_pool import \
    sharded_attention_pool as jax_sharded_pool
from multimodalfusion_tpu_torch.ops import mil_attention as tmil

B, N, D, DA = 2, 1021, 64, 32
LENS = (300, 1021)
CASES = [(f"{'gated' if g else 'ungated'}{'_dropout' if d else ''}", g, d)
         for g in (True, False) for d in (False, True)]
WORLDS = (2, 4)
RTOL = ATOL = 2e-5


def _inputs(seed):
    rng = np.random.default_rng(seed)
    x = {"h": rng.normal(size=(B, N, D)).astype(np.float32),
         "mask": (np.arange(N)[None, :] < np.array(LENS)[:, None]
                  ).astype(np.float32),
         "g": rng.normal(size=(B, D)).astype(np.float32),
         "da": (rng.uniform(size=(B, N, DA)) > 0.25).astype(np.uint8),
         "db": (rng.uniform(size=(B, N, DA)) > 0.25).astype(np.uint8)}
    for k, shape in zip(ATTN_FIELDS, ((D, DA), (DA,), (D, DA), (DA,),
                                      (DA, 1), (1,))):
        x[k] = (rng.normal(size=shape) * 0.1).astype(np.float32)
    return x


def _jax_reference(x, gated, dropout):
    """(out, dh, {field: grad}) of the JAX sharded op on the 8-device
    mesh, for the loss sum(out * g)."""
    mesh = Mesh(np.array(jax.devices()), ("bag",))
    kw = ({"da": jnp.asarray(x["da"]), "db": jnp.asarray(x["db"])}
          if dropout else {})
    mask, g = jnp.asarray(x["mask"]), jnp.asarray(x["g"])

    def loss(h, p):
        out = jax_sharded_pool(h, mask, p, gated, mesh, **kw)
        return jnp.sum(out * g), out

    params = jmil.AttnParams(*(jnp.asarray(x[k]) for k in ATTN_FIELDS))
    (_, out), (dh, dp) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(jnp.asarray(x["h"]), params)
    grads = {k: np.asarray(getattr(dp, k)) for k in ATTN_FIELDS}
    if not gated:  # the port returns no Wb/bb gradient when ungated
        grads["Wb"], grads["bb"] = (np.zeros_like(x["Wb"]),
                                    np.zeros_like(x["bb"]))
    return np.asarray(out), np.asarray(dh), grads


def _port_unsharded(x, gated, dropout):
    h = torch.from_numpy(x["h"]).requires_grad_()
    params = tmil.AttnParams(*(torch.from_numpy(x[k]).requires_grad_()
                               for k in ATTN_FIELDS))
    mask = torch.from_numpy(x["mask"])
    out = (tmil.attention_pool_dropout(h, mask, torch.from_numpy(x["da"]),
                                       torch.from_numpy(x["db"]), params,
                                       gated)
           if dropout else tmil.attention_pool(h, mask, params, gated))
    out.backward(torch.from_numpy(x["g"]))
    grads = {k: (np.zeros_like(x[k]) if p.grad is None else p.grad.numpy())
             for k, p in zip(ATTN_FIELDS, params)}
    return out.detach().numpy(), h.grad.numpy(), grads


@pytest.fixture(scope="module")
def references(runs):
    """{case: (the JAX sharded op's results, the port's unsharded
    ones)}, computed once for both world sizes."""
    inputs, _ = runs
    return {name: (_jax_reference(inputs[name], g, d),
                   _port_unsharded(inputs[name], g, d))
            for name, g, d in CASES}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the inputs of each case, {world: {case: (every rank's results,
    dh [B, padded N, D] assembled from the ranks' blocks)}})."""
    inputs = {name: _inputs(i) for i, (name, _, _) in enumerate(CASES)}
    got = {}
    for world in WORLDS:
        work = tmp_path_factory.mktemp(f"pool{world}")
        for name, x in inputs.items():
            np.savez(work / f"{name}.npz", **x)
        (work / "pool_cases.json").write_text(json.dumps(CASES))
        spawn("pool_cases", world, str(work))
        got[world] = {}
        for name, _, _ in CASES:
            ranks = [dict(np.load(work / f"{name}_rank{r}.npz"))
                     for r in range(world)]
            dh = np.concatenate([r["dh"] for r in ranks], axis=1)
            got[world][name] = (ranks, dh)
    return inputs, got


@pytest.mark.parametrize("world", WORLDS, ids=lambda w: f"k{w}")
@pytest.mark.parametrize("case", CASES, ids=lambda c: c[0])
def test_sharded_pool_matches_jax_and_unsharded(runs, references, world,
                                               case):
    name = case[0]
    ranks, dh = runs[1][world][name]
    for ref in references[name]:
        want_out, want_dh, want_grads = ref
        for r in ranks:  # every rank holds the whole pooled output
            np.testing.assert_allclose(r["out"], want_out, rtol=RTOL,
                                       atol=ATOL)
            for k in ATTN_FIELDS:
                np.testing.assert_allclose(r[f"d{k}"], want_grads[k],
                                           rtol=RTOL, atol=ATOL, err_msg=k)
        assert dh.shape[1] >= N and not dh[:, N:].any()
        np.testing.assert_allclose(dh[:, :N], want_dh, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("world", WORLDS, ids=lambda w: f"k{w}")
def test_masked_blocks_merge_to_zero_weight(runs, world):
    """The 300-row bag leaves whole blocks without a valid row: their
    merge weight l exp(NEG_INF - m) is 0, not NaN, and their dh is exactly
    0 under the global residuals; the padded rows of N get dh = 0 too."""
    inputs, got = runs
    for name, _, _ in CASES:
        ranks, dh = got[world][name]
        empty = [r for r in ranks if r["lo"] >= LENS[0]]
        assert empty, (world, [(int(r["lo"]), int(r["hi"])) for r in ranks])
        for r in empty:
            assert np.all(r["dh"][0] == 0.0)
            assert np.isfinite(r["out"]).all()
        assert np.all(dh[0, LENS[0]:] == 0.0)
        assert np.abs(dh[0, :LENS[0]]).max() > 0
