"""The port's training pooling (multimodalfusion_tpu_torch.ops.mil_attention)
against the JAX package's: the plain backward vs the Pallas backward kernel
in interpret mode and vs ``_pool_bwd_reference``; the plain forward with
dropout masks vs the Pallas forward kernel; the autograd Functions vs
``jax.grad``; and the properties of ``make_dropout_masks``.  On the CPU the
port runs its plain versions; the CUDA kernels are held against them on
the card by chip_smoke.py."""
import os
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from multimodalfusion_tpu.ops import mil_attention as jmil
from multimodalfusion_tpu_torch.ops import mil_attention as tmil

FIELDS = tmil.AttnParams._fields


def make_inputs(seed, B=4, N=300, D=64, Da=32, keep=0.75):
    """Seeded numpy bags with a ragged mask (bag 1 fully masked, bag 3 a
    zero padding row of a partial batch), params, keep masks and a
    cotangent."""
    rng = np.random.default_rng(seed)
    h = rng.normal(size=(B, N, D)).astype(np.float32)
    lens = rng.integers(1, N + 1, size=B)
    lens[1] = 0
    lens[3] = 0
    h[3] = 0.0
    mask = (np.arange(N)[None, :] < lens[:, None]).astype(np.float32)
    p = [(rng.normal(size=s) * 0.1).astype(np.float32)
         for s in ((D, Da), (Da,), (D, Da), (Da,), (Da, 1), (1,))]
    da = (rng.uniform(size=(B, N, Da)) < keep).astype(np.uint8)
    db = (rng.uniform(size=(B, N, Da)) < keep).astype(np.uint8)
    g = rng.normal(size=(B, D)).astype(np.float32)
    return h, mask, p, da, db, g


def rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-30)


def jax_bwd(h, mask, p, da, db, g, gated, dropout, dtype=jnp.float32):
    """(out, ml) of the Pallas forward and the Pallas backward, both in
    interpret mode, and the XLA reference backward on the same
    residuals."""
    jh = jnp.asarray(h).astype(dtype)
    jp = jmil.AttnParams(*[jnp.asarray(x) for x in p])
    kw = {}
    if dropout:
        kw = dict(da=jnp.asarray(da), db=jnp.asarray(db) if gated else None)
    out, ml = jmil._fused_pool_pallas(jh, jnp.asarray(mask), jp, gated,
                                      tile_n=128, interpret=True, **kw)
    dh, dp = jmil._fused_pool_bwd_pallas(jh, jnp.asarray(mask), jp, out, ml,
                                         jnp.asarray(g), gated, tile_n=128,
                                         interpret=True, **kw)
    ref_dh, ref_dp = jmil._pool_bwd_reference(jh, jnp.asarray(mask), jp, out,
                                              ml[:, 0], jnp.asarray(g), gated,
                                              **kw)
    return (out, ml[:, 0]), (dh, dp), (ref_dh, ref_dp)


def port_bwd(h, mask, p, da, db, g, gated, dropout, dtype=torch.float32):
    th = torch.from_numpy(h).to(dtype)
    tp = tmil.AttnParams(*[torch.from_numpy(x) for x in p])
    kw = {}
    if dropout:
        kw = dict(da=torch.from_numpy(da), db=torch.from_numpy(db))
    out, ml = tmil._pool_plain(th, torch.from_numpy(mask), tp, gated, **kw)
    dh, dp = tmil._pool_bwd_plain(th, torch.from_numpy(mask), tp, out, ml,
                                  torch.from_numpy(g), gated, **kw)
    return (out, ml), (dh, dp)


@pytest.mark.parametrize("dropout", [False, True])
@pytest.mark.parametrize("gated", [True, False])
def test_plain_backward_matches_pallas_and_reference_f32(gated, dropout):
    """f32: dh and every parameter gradient at rel 1e-5 (the same f32
    products, summed in another order); dcc an exact 0; dh an exact 0 on
    every masked row, the fully masked bag and the zero padding row
    included."""
    h, mask, p, da, db, g = make_inputs(0)
    (_, _), (dh, dp), (ref_dh, ref_dp) = jax_bwd(h, mask, p, da, db, g,
                                                 gated, dropout)
    (out, ml), (tdh, tdp) = port_bwd(h, mask, p, da, db, g, gated, dropout)
    assert tdh.dtype == torch.float32
    for want_dh, want in ((dh, dp), (ref_dh, ref_dp)):
        assert rel(tdh.numpy(), want_dh) < 1e-5
        for k in FIELDS[:5] if gated else ("Wa", "ba", "wc"):
            assert rel(getattr(tdp, k).numpy(), getattr(want, k)) < 1e-5, k
    assert (tdp.cc == 0).all()
    if not gated:
        assert (tdp.Wb == 0).all() and (tdp.bb == 0).all()
    masked = torch.from_numpy(mask) == 0
    assert (tdh[masked] == 0).all()
    assert torch.isfinite(tdh).all()
    assert all(torch.isfinite(x).all() for x in tdp)


@pytest.mark.parametrize("dropout", [False, True])
@pytest.mark.parametrize("gated", [True, False])
def test_plain_backward_bf16_matches_pallas(gated, dropout):
    """bf16 bags, compared in f32: both sides read the weights and cast
    dpa/dpb to bf16 before the products and accumulate in f32; a last-bit
    difference can round an element to the other bf16 neighbour, and dh
    is stored in bf16: rel 2e-2."""
    h, mask, p, da, db, g = make_inputs(1)
    (_, _), (dh, dp), _ = jax_bwd(h, mask, p, da, db, g, gated, dropout,
                                  jnp.bfloat16)
    (_, _), (tdh, tdp) = port_bwd(h, mask, p, da, db, g, gated, dropout,
                                  torch.bfloat16)
    assert tdh.dtype == torch.bfloat16
    assert rel(tdh.float().numpy(), np.asarray(dh, np.float32)) < 2e-2
    for k in FIELDS[:5] if gated else ("Wa", "ba", "wc"):
        assert rel(getattr(tdp, k).numpy(), getattr(dp, k)) < 2e-2, k
    assert (tdp.cc == 0).all()
    assert (tdh[torch.from_numpy(mask) == 0] == 0).all()


@pytest.mark.parametrize("gated", [True, False])
def test_forward_with_dropout_matches_pallas(gated):
    """The plain forward with keep masks vs the Pallas kernel with the same
    masks: pooled and ml at rel 1e-5 (f32, another summation order)."""
    h, mask, p, da, db, g = make_inputs(2)
    (want, want_m), _, _ = jax_bwd(h, mask, p, da, db, g, gated, True)
    (out, ml), _ = port_bwd(h, mask, p, da, db, g, gated, True)
    assert rel(out.numpy(), want) < 1e-5
    live = mask.sum(1) > 0
    np.testing.assert_allclose(ml.numpy()[live], np.asarray(want_m)[live],
                               rtol=1e-5, atol=1e-6)
    # and the unfused JAX reference
    ref = jmil._pool_reference_dropout(
        jnp.asarray(h), jnp.asarray(mask), jnp.asarray(da), jnp.asarray(db),
        jmil.AttnParams(*[jnp.asarray(x) for x in p]), gated)
    got = tmil._pool_reference_dropout(
        torch.from_numpy(h), torch.from_numpy(mask), torch.from_numpy(da),
        torch.from_numpy(db), tmil.AttnParams(*map(torch.from_numpy, p)),
        gated)
    assert rel(got.numpy(), ref) < 1e-5


@pytest.mark.parametrize("dropout", [False, True])
@pytest.mark.parametrize("gated", [True, False])
def test_autograd_matches_jax_grad(gated, dropout):
    """Gradients of sum(pooled * w) through the port's autograd Function
    vs jax.grad through the JAX package's custom_vjp op, at rel 1e-5."""
    h, mask, p, da, db, g = make_inputs(3, N=100)
    w = np.random.default_rng(9).normal(size=g.shape).astype(np.float32)

    def jloss(hh, pp):
        jp = jmil.AttnParams(*pp)
        if dropout:
            out = jmil.attention_pool_dropout(hh, jnp.asarray(mask),
                                              jnp.asarray(da),
                                              jnp.asarray(db), jp, gated)
        else:
            out = jmil.attention_pool(hh, jnp.asarray(mask), jp, gated)
        return jnp.sum(out * w)
    jgh, jgp = jax.grad(jloss, argnums=(0, 1))(
        jnp.asarray(h), [jnp.asarray(x) for x in p])

    th = torch.from_numpy(h).requires_grad_()
    tp = [torch.from_numpy(x).requires_grad_() for x in p]
    params = tmil.AttnParams(*tp)
    if dropout:
        out = tmil.attention_pool_dropout(th, torch.from_numpy(mask),
                                          torch.from_numpy(da),
                                          torch.from_numpy(db), params, gated)
    else:
        out = tmil.attention_pool(th, torch.from_numpy(mask), params, gated)
    (out * torch.from_numpy(w)).sum().backward()
    assert rel(th.grad.numpy(), jgh) < 1e-5
    for k, t, want in zip(FIELDS, tp, jgp):
        if not gated and k in ("Wb", "bb"):
            assert t.grad is None  # ungated calls return no Wb/bb gradient
            continue
        if k == "cc":
            assert (t.grad == 0).all()
            continue
        assert rel(t.grad.numpy(), want) < 1e-5, k


@pytest.mark.parametrize("dropout", [False, True])
@pytest.mark.parametrize("gated", [True, False])
def test_gradcheck_float64(gated, dropout):
    """torch.autograd.gradcheck of the autograd Function in float64 (the
    plain versions compute in f64 for f64 bags).  cc is left out: its
    gradient is set to an exact 0, which is right only analytically."""
    rng = np.random.default_rng(4)
    B, N, D, Da = 2, 7, 5, 4
    h = torch.from_numpy(rng.normal(size=(B, N, D))).requires_grad_()
    mask = torch.ones(B, N, dtype=torch.float64)
    mask[1, 4:] = 0
    p = [torch.from_numpy(rng.normal(size=s) * 0.5).requires_grad_()
         for s in ((D, Da), (Da,), (D, Da), (Da,), (Da, 1))]
    cc = torch.zeros(1, dtype=torch.float64)
    da = torch.from_numpy((rng.uniform(size=(B, N, Da)) < 0.75)
                          .astype(np.uint8))
    db = torch.from_numpy((rng.uniform(size=(B, N, Da)) < 0.75)
                          .astype(np.uint8))

    def f(h, Wa, ba, Wb, bb, wc):
        params = tmil.AttnParams(Wa, ba, Wb, bb, wc, cc)
        if dropout:
            return tmil.attention_pool_dropout(h, mask, da, db, params,
                                               gated)
        return tmil.attention_pool(h, mask, params, gated)
    inputs = (h, *p)
    if not gated:  # Wb/bb get no gradient: hold them fixed
        p[2].requires_grad_(False)
        p[3].requires_grad_(False)
    assert torch.autograd.gradcheck(f, inputs, eps=1e-6, atol=1e-6)


def test_dropout_mask_properties():
    """keep rate 0.75 within sampling error, da and db independent, the
    ungated alias, and a rate that is not a multiple of 1/16."""
    g = torch.Generator().manual_seed(0)
    shape = (8, 512, 64)
    n = np.prod(shape)
    da, db = tmil.make_dropout_masks(g, shape, gated=True)
    assert da.dtype == db.dtype == torch.uint8 and da.shape == shape
    assert set(torch.unique(da).tolist()) <= {0, 1}
    sd = np.sqrt(0.75 * 0.25 / n)  # binomial standard error of the rate
    for m in (da, db):
        assert abs(m.float().mean().item() - 0.75) < 5 * sd
    both = (da & db).float().mean().item()
    assert abs(both - 0.75 ** 2) < 5 * np.sqrt(0.5625 * 0.4375 / n)
    ua, ub = tmil.make_dropout_masks(g, shape, gated=False)
    assert ua is ub
    ra, rb = tmil.make_dropout_masks(g, shape, gated=True, rate=0.3)
    for m in (ra, rb):
        assert abs(m.float().mean().item() - 0.7) < 5 * np.sqrt(
            0.21 / n)
    assert not torch.equal(ra, rb)
    # same seed, same bits
    a1, _ = tmil.make_dropout_masks(torch.Generator().manual_seed(3), shape)
    a2, _ = tmil.make_dropout_masks(torch.Generator().manual_seed(3), shape)
    assert torch.equal(a1, a2)


def test_backward_wrapper_refuses_cpu_tensors():
    """The CUDA backward wrapper launches its kernel or raises: a CPU
    tensor is refused, never handed to the plain version."""
    h, mask, p, da, db, g = make_inputs(5, N=64, D=64, Da=64)
    th = torch.from_numpy(h)
    params = tmil.AttnParams(*map(torch.from_numpy, p))
    out, ml = tmil._pool_plain(th, torch.from_numpy(mask), params, True)
    before = tmil._fused_pool_bwd_cuda.launches
    with pytest.raises(ValueError, match="CUDA tensor"):
        tmil._fused_pool_bwd_cuda(th, torch.from_numpy(mask), params, out,
                                  ml, torch.from_numpy(g), True)
    assert tmil._fused_pool_bwd_cuda.launches == before


def test_backward_plan_constants_match_the_source():
    """The wrapper's mirror of the backward source's constants (the row
    and output tile GT of the SGEMM core and BM of the tensor-core core,
    the dW kernel's staged depth by dtype: GK of the SGEMM core for f32
    and BK of the tensor-core core for bf16, the column-sum group VG, the
    widest D) agrees with csrc/mil_pool_bwd.cu and the two cores it
    includes, csrc/sgemm_core.cuh and csrc/mma_core.cuh; on the card the
    wrapper also checks the built library.  Two CTAs of each bf16 kernel
    fit one SM's shared memory (228 KB, 1 KB of it reserved per CTA)."""
    csrc = os.path.join(os.path.dirname(os.path.dirname(tmil.__file__)),
                        "csrc")
    text = ""
    for name in ("mil_pool_bwd.cu", "sgemm_core.cuh", "mma_core.cuh"):
        with open(os.path.join(csrc, name)) as f:
            text += f.read()
    assert '#include "sgemm_core.cuh"' in text
    assert '#include "mma_core.cuh"' in text
    got = {k: int(re.search(rf"constexpr int {k} = (\d+);", text)[1])
           for k in ("GT", "GK", "BM", "BK", "STAGES", "VG", "MAX_D")}
    stages = got.pop("STAGES")
    assert got == {"GT": tmil._BWD_TILE, "BM": tmil._BWD_TILE,
                   "GK": tmil._BWD_DEPTH[torch.float32],
                   "BK": tmil._BWD_DEPTH[torch.bfloat16],
                   "VG": tmil._BWD_VEC_GROUP, "MAX_D": tmil._MAX_D}
    # the core's buffers: STAGES x (A, B) x 128 rows of BK + 8 bf16; the
    # rows kernel's own arrays: s_s, ds_s, red[3][16][64], red_s[4][GT]
    dynamic = stages * 2 * got["BM"] * (got["BK"] + 8) * 2
    rows_static = 4 * (2 * got["GT"] + 3 * 16 * 64 + 4 * got["GT"])
    dw_extra = 4 * stages * got["BK"]
    for per_cta in (dynamic + rows_static, dynamic + dw_extra):
        assert 2 * (per_cta + 1024) <= 228 * 1024, per_cta


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("sms", [1, 8, 132])
@pytest.mark.parametrize("B,N,D,Da,gated", [
    (32, 4096, 256, 256, True),    # the training CLI's kernel shape
    (48, 4096, 256, 256, True),    # the JAX bench's bf16 training step
    (8, 4096, 256, 256, True),     # a B=8 training step
    (3, 300, 64, 64, True),        # half a 128-wide tile; 900 rows end
    (3, 300, 64, 64, False),       # the last split mid-chunk
    (4, 700, 512, 384, True),      # Da = 384: Kc = 768 gated
    (4, 700, 512, 384, False),
    (2, 32768, 256, 256, True),
    (1, 1, 64, 64, True),          # N = 1
    (5, 1, 128, 64, False),
    (4, 0, 256, 256, True),        # N = 0: nothing is launched
    (0, 100, 64, 64, True),
])
def test_backward_launch_plan(B, N, D, Da, gated, sms, bf16):
    """``bwd_plan``: the dW partial kernel's row splits cover every row,
    each split is a whole number of the kernel's row chunks (GK rows for
    f32 bags, BK for bf16) and holds at least one row, the grid stays
    within one wave, and the scratch has the shapes the C interface of
    mil_pool_bwd.cu documents."""
    rows, Kc = B * N, (2 * Da if gated else Da)
    depth = tmil._BWD_DEPTH[torch.bfloat16 if bf16 else torch.float32]
    out_tiles = -(-D // 128) * -(-Kc // 128)
    tiles = -(-rows // 128)
    for ctas_per_sm in (1, 2, 4):
        plan = tmil.bwd_plan(B, N, D, Da, gated, sms, ctas_per_sm, bf16)
        assert plan.splits >= 1
        assert plan.splits * plan.rows_per_split >= rows
        assert plan.rows_per_split >= depth
        assert plan.rows_per_split % depth == 0
        if rows:
            assert (plan.splits - 1) * plan.rows_per_split < rows
        assert (plan.splits == 1
                or plan.splits * out_tiles <= ctas_per_sm * sms)
        assert plan.dp == plan.tu == (rows, Kc)
        assert plan.part_vec == (tiles, 3, Da)
        assert plan.part_grp == (-(-tiles // 64), 3, Da)
        assert plan.part_dw == (plan.splits, D, Kc)
    if (B, N, D, Da, sms) == (32, 4096, 256, 256, 132) and gated:
        # 8 output tiles x 33 splits: one wave of 2 x 132; f32 splits of
        # 497 GK chunks (3,976 rows), bf16 of 125 BK chunks (4,000 rows)
        plan = tmil.bwd_plan(B, N, D, Da, gated, sms, 2, bf16)
        assert (plan.splits, plan.rows_per_split) == (
            (33, 4000) if bf16 else (33, 3976))
    if (B, N, D, Da, sms, bf16) == (48, 4096, 256, 256, 132, True):
        # the bf16 step: 196,608 rows in 33 splits of 187 BK chunks
        plan = tmil.bwd_plan(B, N, D, Da, gated, sms, 2, bf16)
        assert (plan.splits, plan.rows_per_split) == (33, 5984)
        assert plan.ctas() == {"rows": 1536, "dh": 3072,
                               "dw_partial": 264}
