"""The port's attention pooling (multimodalfusion_tpu_torch.ops.mil_attention)
against the JAX package's: the plain version vs ``_pool_reference`` in f32,
and vs the Pallas kernel run in interpret mode for bf16 bags and for the
``ml`` residuals.  On the CPU the port runs its plain version; the CUDA
kernel itself is held against it on the card by chip_smoke.py."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from multimodalfusion_tpu.ops import mil_attention as jmil
from multimodalfusion_tpu_torch.ops import cuda_build
from multimodalfusion_tpu_torch.ops import mil_attention as tmil


def make_inputs(seed, B=4, N=300, D=64, Da=32, empty_bag=True):
    """Seeded numpy bags, a ragged mask (bag 1 fully masked) and params."""
    rng = np.random.default_rng(seed)
    h = rng.normal(size=(B, N, D)).astype(np.float32)
    lens = rng.integers(1, N + 1, size=B)
    if empty_bag:
        lens[1] = 0
    mask = (np.arange(N)[None, :] < lens[:, None]).astype(np.float32)
    p = [(rng.normal(size=s) * 0.1).astype(np.float32)
         for s in ((D, Da), (Da,), (D, Da), (Da,), (Da, 1), (1,))]
    return h, mask, p


def to_jax(h, mask, p, dtype=jnp.float32):
    return (jnp.asarray(h).astype(dtype), jnp.asarray(mask),
            jmil.AttnParams(*[jnp.asarray(x) for x in p]))


def to_torch(h, mask, p, dtype=torch.float32):
    return (torch.from_numpy(h).to(dtype), torch.from_numpy(mask),
            tmil.AttnParams(*[torch.from_numpy(x) for x in p]))


def rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-30)


@pytest.mark.parametrize("gated", [True, False])
def test_plain_matches_jax_reference_f32(gated):
    h, mask, p = make_inputs(0)
    want = jmil._pool_reference(*to_jax(h, mask, p), gated)
    pooled, _ = tmil._fused_pool(*to_torch(h, mask, p), gated)
    np.testing.assert_allclose(pooled.numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        tmil.attention_pool(*to_torch(h, mask, p), gated).numpy(),
        np.asarray(want), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        tmil._pool_reference(*to_torch(h, mask, p), gated).numpy(),
        np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("gated", [True, False])
def test_ml_residuals_match_pallas_interpret_f32(gated):
    h, mask, p = make_inputs(1, empty_bag=False)
    want, want_ml = jmil._fused_pool_pallas(*to_jax(h, mask, p), gated,
                                            tile_n=128, interpret=True)
    pooled, ml = tmil._fused_pool(*to_torch(h, mask, p), gated)
    np.testing.assert_allclose(pooled.numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(ml.numpy(), np.asarray(want_ml)[:, 0],
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("gated", [True, False])
def test_bf16_bags_match_pallas_interpret(gated):
    """bf16 bags: the weights are read in bf16 and everything accumulates
    in f32 on both sides; rel 2e-2 covers bf16 rounding of the pooling
    weights on the Pallas side."""
    h, mask, p = make_inputs(2, empty_bag=False)
    want, want_ml = jmil._fused_pool_pallas(
        *to_jax(h, mask, p, jnp.bfloat16), gated, tile_n=128,
        interpret=True)
    pooled, ml = tmil._fused_pool(*to_torch(h, mask, p, torch.bfloat16),
                                  gated)
    assert pooled.dtype == torch.float32 and ml.dtype == torch.float32
    assert rel(pooled.numpy(), want) < 2e-2
    want_ml = np.asarray(want_ml)[:, 0]
    assert rel(ml[:, 0].numpy(), want_ml[:, 0]) < 2e-2
    assert rel(ml[:, 1].numpy(), want_ml[:, 1]) < 2e-2


def test_fully_masked_bag_pools_to_zero():
    h, mask, p = make_inputs(3)
    mask[:] = 0.0
    pooled, ml = tmil._fused_pool(*to_torch(h, mask, p), True)
    assert torch.isfinite(pooled).all()
    assert (pooled == 0).all()
    assert (ml[:, 0] == tmil.NEG_INF).all() and (ml[:, 1] == 0).all()
    want = jmil._pool_reference(*to_jax(h, mask, p), True)
    np.testing.assert_array_equal(pooled.numpy(), np.asarray(want))


def test_non_cpu_tensor_never_falls_back(tmp_path, monkeypatch):
    """Off the CPU the wrapper launches the kernel or raises: a tensor on
    another device is refused, and with no nvcc the kernel cannot be built
    and the build raises instead of handing over to the plain version."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the kernel would run")
    h, mask, p = (t.to("meta") for t in (torch.zeros(2, 64, 32),
                                          torch.ones(2, 64),
                                          torch.zeros(32, 16)))
    params = tmil.AttnParams(p, p[0], p, p[0], p[:, :1], p[0, :1])
    before = tmil._fused_pool_cuda.launches
    with pytest.raises(ValueError, match="CUDA tensor"):
        tmil.attention_pool(h, mask, params, True)
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(cuda_build, "BUILD_DIR", str(tmp_path / "kernels"))
    monkeypatch.setattr(cuda_build, "_libs", {})
    with pytest.raises(RuntimeError, match="nvcc not found"):
        cuda_build.load("mil_pool_fwd")
    assert tmil._fused_pool_cuda.launches == before
