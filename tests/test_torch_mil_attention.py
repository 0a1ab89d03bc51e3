"""The port's attention pooling (multimodalfusion_tpu_torch.ops.mil_attention)
against the JAX package's: the plain version vs ``_pool_reference`` in f32,
and vs the Pallas kernel run in interpret mode for bf16 bags and for the
``ml`` residuals.  On the CPU the port runs its plain version; the CUDA
kernel itself is held against it on the card by chip_smoke.py."""
import os
import re
import shutil

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


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("sms", [1, 8, 132])
@pytest.mark.parametrize("B,N,D,Da,gated", [
    (32, 4096, 256, 256, True),    # the serving and kernel-timing shape
    (48, 4096, 256, 256, True),    # the JAX bench's bf16 training step
    (8, 4096, 256, 256, True),     # a B=8 training step
    (3, 300, 64, 64, True),
    (3, 300, 64, 64, False),
    (4, 700, 512, 384, True),
    (4, 700, 512, 384, False),
    (2, 32768, 256, 256, True),
    (1, 1, 64, 64, True),          # N = 1
    (5, 1, 128, 64, False),
    (4, 0, 256, 256, True),        # N = 0: one split that scores nothing
    (0, 100, 64, 64, True),
])
def test_forward_launch_plan(B, N, D, Da, gated, sms, bf16):
    """``fwd_plan``: each bag's splits cover every row, each split is a
    whole number of the dtype's tiles and holds at least one row, the grid
    stays within one wave, and the scratch has the shapes the C interface
    of mil_pool_fwd.cu documents."""
    tile = 128  # GT of sgemm_core.cuh (f32), BM of mma_core.cuh (bf16)
    for ctas_per_sm in (1, 2, 4):
        plan = tmil.fwd_plan(B, N, D, Da, gated, bf16, sms, ctas_per_sm)
        assert plan.tile_rows == tile
        assert plan.splits >= 1
        assert plan.rows_per_split >= tile
        assert plan.rows_per_split % tile == 0
        covered = np.zeros(N, bool)
        for s in range(plan.splits):
            rows = range(s * plan.rows_per_split,
                         min(N, (s + 1) * plan.rows_per_split))
            assert N == 0 or len(rows) > 0
            covered[rows.start:rows.stop] = True
        assert covered.all()
        assert plan.splits == 1 or B * plan.splits <= ctas_per_sm * sms
        assert plan.part_acc == (B, plan.splits, D)
        assert plan.part_ml == (B, plan.splits, 2)
    if (B, N, D, Da, gated, sms) == (32, 4096, 256, 256, True, 132):
        # 32 bags x 8 splits of 512 rows: one wave of 2 x 132 CTAs
        plan = tmil.fwd_plan(B, N, D, Da, gated, bf16, sms, 2)
        assert (plan.splits, plan.rows_per_split) == (8, 512)
    if (B, N, D, Da, gated, sms) == (48, 4096, 256, 256, True, 132):
        # 48 bags x 5 splits of 7 tiles (896 rows; the last 512): 240 of
        # the 2 x 132 CTAs that fit
        plan = tmil.fwd_plan(B, N, D, Da, gated, bf16, sms, 2)
        assert (plan.splits, plan.rows_per_split) == (5, 896)
        assert plan.ctas() == {"partial": 240, "merge": 48}


def _source(name):
    with open(os.path.join(cuda_build.CSRC_DIR, name)) as f:
        return f.read()


def test_forward_plan_constants_match_the_source():
    """The wrapper's per-dtype tile rows and widest D agree with the
    constants of csrc/mil_pool_fwd.cu (MAX_D) and of the cores it
    includes: GT of csrc/sgemm_core.cuh (f32 tiles) and BM of
    csrc/mma_core.cuh (bf16 tiles); on the card the wrapper also checks
    the built library.  The bf16 partial kernel scores on the tensor-core
    core with no mma.sync wrapper of its own, and its dynamic shared
    memory (the resident tile [BM][D + 8] bf16, the core's STAGES weight
    buffers [BM][BK + 8] bf16, a [BM][BM] byte buffer of keep bytes with
    dropout, the running max and normalizer) fits the CTAs per SM that
    its design note states: two up to D = 256, one at D = 512, each
    within 227 KB (228 KB an SM, 1 KB of it reserved per CTA)."""
    fwd, sgemm = _source("mil_pool_fwd.cu"), _source("sgemm_core.cuh")
    core = _source("mma_core.cuh")

    def const(text, k):
        return int(re.search(rf"constexpr int {k} = (\d+);", text)[1])
    assert '#include "sgemm_core.cuh"' in fwd
    assert '#include "mma_core.cuh"' in fwd
    assert "mma.sync.aligned" not in fwd and "mma_bf16(" not in fwd
    assert "return bf16 ? mma::BM : GT;" in fwd
    assert tmil._TILE_ROWS == {torch.float32: const(sgemm, "GT"),
                               torch.bfloat16: const(core, "BM")}
    assert tmil._MAX_D == const(fwd, "MAX_D")
    assert "constexpr int KEEP_BYTES = mma::BM * mma::BM;" in fwd
    BM, BK, stages = (const(core, k) for k in ("BM", "BK", "STAGES"))

    def smem(D, dropout):
        keep_bufs = 1 if D // BK >= stages else stages
        return (BM * (D + 8) * 2 + stages * BM * (BK + 8) * 2
                + (keep_bufs * BM * BM if dropout else 0) + 16)
    for dropout in (False, True):
        assert smem(tmil._MAX_D, dropout) <= 227 * 1024
        assert 2 * (smem(256, dropout) + 1024) <= 228 * 1024
    assert "Two CTAs share an SM up to D = 256" in fwd


def test_build_hash_covers_the_headers(tmp_path, monkeypatch):
    """A build is named by a hash of its source and of the headers beside
    it: editing sgemm_core.cuh (or adding a header) changes the hash of
    both kernels' sources, so a stale library is never reused.  Runs on a
    copy of csrc/ with no nvcc."""
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    csrc = tmp_path / "csrc"
    shutil.copytree(cuda_build.CSRC_DIR, csrc,
                    ignore=shutil.ignore_patterns("__pycache__"))
    monkeypatch.setattr(cuda_build, "CSRC_DIR", str(csrc))
    monkeypatch.setattr(cuda_build, "BUILD_DIR", str(tmp_path / "kernels"))
    srcs = [str(csrc / f"{n}.cu") for n in ("mil_pool_fwd", "mil_pool_bwd")]
    before = [cuda_build._digest(s) for s in srcs]
    assert before == [cuda_build._digest(s) for s in srcs]
    # a library built from these sources is found and reused
    os.makedirs(cuda_build.BUILD_DIR)
    built = os.path.join(cuda_build.BUILD_DIR,
                         f"mil_pool_fwd-{before[0]}.so")
    open(built, "w").close()
    assert cuda_build.build("mil_pool_fwd") == built

    with open(csrc / "sgemm_core.cuh", "a") as f:
        f.write("// edited\n")
    edited = [cuda_build._digest(s) for s in srcs]
    assert all(a != b for a, b in zip(before, edited))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        cuda_build.build("mil_pool_fwd")  # must rebuild: no nvcc here
    (csrc / "extra.cuh").write_text("// a new header\n")
    assert all(a != b for a, b in zip(edited, [cuda_build._digest(s)
                                               for s in srcs]))
