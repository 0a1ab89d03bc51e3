"""The CUDA pooling wrappers take any D up to 512 and any Da, as the
Pallas kernels do: widths that are not the kernels' multiples are
zero-padded around the launch (multimodalfusion_tpu_torch/ops/
mil_attention.py, ``pool_padded`` / ``pool_bwd_padded``).

The padding plan runs here through the plain versions (pad, pool, unpad
must equal the plain pooling at the unpadded widths), and through the CUDA
wrappers with a stub library that records the widths each launch gets.
On the card, chip_smoke.py [kernels] holds the kernels at the same odd
widths against their plain versions.
"""
import ctypes
import types

import numpy as np
import pytest
import torch

from multimodalfusion_tpu_torch.ops import mil_attention as mil

ODD_WIDTHS = [(200, 72), (96, 40)]


def _case(D, Da, gated, dropout, seed=0, B=3, N=50):
    rng = np.random.default_rng(seed)
    h = torch.from_numpy(rng.standard_normal((B, N, D)).astype(np.float32))
    lens = [N, 0, 17][:B]
    mask = (torch.arange(N)[None, :] < torch.tensor(lens)[:, None]).float()
    p = [torch.from_numpy(rng.standard_normal(s).astype(np.float32) * 0.1)
         for s in ((D, Da), (Da,), (D, Da), (Da,), (Da, 1), (1,))]
    params = mil.AttnParams(*p)
    da = db = None
    if dropout:
        da, db = mil.make_dropout_masks(torch.Generator().manual_seed(seed),
                                        (B, N, Da), gated)
    g = torch.from_numpy(rng.standard_normal((B, D)).astype(np.float32))
    return h, mask, params, da, db, g


def _rel(got, want) -> float:
    got, want = got.double(), want.double()
    return float((got - want).abs().max()
                 / want.abs().max().clamp_min(1e-30))


@pytest.mark.parametrize("dropout", [False, True])
@pytest.mark.parametrize("gated", [True, False])
@pytest.mark.parametrize("D,Da", ODD_WIDTHS)
def test_padding_plan_is_exact_through_the_plain_versions(D, Da, gated,
                                                          dropout):
    h, mask, params, da, db, g = _case(D, Da, gated, dropout)
    want_out, want_ml = mil._pool_plain(h, mask, params, gated, da, db)
    seen = []

    def fwd(h_, mask_, params_, *rest):
        seen.append((h_.shape[-1], params_.Wa.shape[1]))
        return mil._pool_plain(h_, mask_, params_, *rest)
    out, ml = mil.pool_padded(fwd, mil.FWD_MULTIPLES[torch.float32], h,
                              mask, params, gated, da, db)
    assert seen == [(mil._round_up(D, 32), mil._round_up(Da, 8))]
    assert out.shape == want_out.shape
    assert _rel(out, want_out) <= 1e-6
    assert _rel(ml, want_ml) <= 1e-6

    want_dh, want = mil._pool_bwd_plain(h, mask, params, want_out, want_ml,
                                        g, gated, da, db)

    def bwd(h_, mask_, params_, out_, ml_, g_, *rest):
        seen.append((h_.shape[-1], params_.Wa.shape[1], out_.shape[-1],
                     g_.shape[-1]))
        return mil._pool_bwd_plain(h_, mask_, params_, out_, ml_, g_, *rest)
    dh, grads = mil.pool_bwd_padded(bwd, mil.BWD_MULTIPLES, h, mask, params,
                                    want_out, want_ml, g, gated, da, db)
    Dp = mil._round_up(D, 64)
    assert seen[1] == (Dp, mil._round_up(Da, 64), Dp, Dp)
    assert dh.shape == want_dh.shape
    assert _rel(dh, want_dh) <= 1e-6
    for k in mil.AttnParams._fields:
        got, ref = getattr(grads, k), getattr(want, k)
        assert got.shape == ref.shape, k
        if k == "cc" or (not gated and k in ("Wb", "bb")):
            assert torch.equal(got, ref), k  # exact zeros on both sides
        else:
            assert _rel(got, ref) <= 1e-6, k


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D,Da", ODD_WIDTHS + [(256, 72)])
def test_forward_pads_to_the_multiples_of_the_bag_dtype(monkeypatch, D, Da,
                                                        dtype):
    """The forward's CUDA wrapper pads to the multiples of the bag's dtype:
    D to 32, Da to 8 for f32 bags and to 16 for bf16 bags (whose kernel
    stages the keep bytes in 16-byte pieces); the padded launch through the
    plain version gives the caller's result."""
    h, mask, params, da, db, _ = _case(D, Da, True, True)
    h = h.to(dtype)
    seen = []

    def launch(h_, mask_, params_, *rest):
        seen.append((h_.dtype, h_.shape[-1], params_.Wa.shape[1],
                     rest[1].shape[-1]))
        return mil._pool_plain(h_, mask_, params_, *rest)
    monkeypatch.setattr(mil, "_launch_fwd", launch)
    out, ml = mil._fused_pool_cuda(h, mask, params, True, da, db)
    step = 8 if dtype == torch.float32 else 16
    assert mil.FWD_MULTIPLES[dtype] == (32, step)
    Da_to = mil._round_up(Da, step)
    assert seen == [(dtype, mil._round_up(D, 32), Da_to, Da_to)]
    want_out, want_ml = mil._pool_plain(h, mask, params, True, da, db)
    assert out.shape == want_out.shape
    assert _rel(out, want_out) <= 1e-6
    assert _rel(ml, want_ml) <= 1e-6


def test_widths_already_multiples_take_no_copy():
    h, mask, params, _, _, g = _case(64, 64, True, False)
    got = []

    def launch(*args):
        got.append(args)
        return "launched"
    assert mil.pool_padded(launch, mil.FWD_MULTIPLES[torch.float32], h,
                           mask, params, True) == "launched"
    assert got[0][0] is h and got[0][2] is params
    out = torch.zeros(3, 64)
    ml = torch.zeros(3, 2)
    assert mil.pool_bwd_padded(launch, mil.BWD_MULTIPLES, h, mask, params,
                               out, ml, g, True) == "launched"
    assert got[1][0] is h and got[1][3] is out and got[1][5] is g


def test_widths_past_the_limit_or_mismatched_raise():
    h, mask, params, _, _, _ = _case(520, 8, True, False)
    with pytest.raises(ValueError, match="up to 512"):
        mil.pool_padded(mil._pool_plain, mil.FWD_MULTIPLES[torch.float32], h,
                        mask, params, True)
    h, mask, params, _, _, _ = _case(200, 72, True, False)
    bad = params._replace(Wb=params.Wb[:150])
    with pytest.raises(ValueError, match="Wb must be"):
        mil.pool_padded(mil._pool_plain, mil.FWD_MULTIPLES[torch.float32], h,
                        mask, bad, True)


@pytest.mark.parametrize("D,Da", ODD_WIDTHS)
def test_cuda_wrappers_launch_at_padded_widths(monkeypatch, D, Da):
    """Both CUDA wrappers hand their library the padded widths and give back
    the caller's: a stub library records (D, Da) of each launch and writes
    nothing (the launch's own checks see CPU tensors as if on the card)."""
    seen = []

    class Lib:
        def mil_pool_fwd(self, *args):
            seen.append(("fwd", args[17], args[18]))  # D, Da
            return 0

        def mil_pool_bwd(self, *args):
            seen.append(("bwd", args[26], args[27]))
            return 0

    def no_cuda_check(h, mask, params, gated, da, db):
        return (mask.float(), params.ba, params.bb,
                params.wc.reshape(-1), params.cc, da, db)

    monkeypatch.setattr(torch.cuda, "device", lambda dev: _Null())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: types.SimpleNamespace(
                            cuda_stream=0))
    monkeypatch.setattr(mil, "_fwd_lib", Lib)
    monkeypatch.setattr(mil, "_bwd_lib", Lib)
    monkeypatch.setattr(mil, "_sms", lambda dev: 132)
    monkeypatch.setattr(mil, "_fwd_ctas_per_sm", lambda *a: 2)
    monkeypatch.setattr(mil, "_dw_ctas_per_sm", lambda *a: 2)
    monkeypatch.setattr(mil, "_check_inputs", no_cuda_check)
    for fn in (mil._fused_pool_cuda, mil._fused_pool_bwd_cuda):
        monkeypatch.setattr(fn, "launches", 0)
        monkeypatch.setattr(fn, "last_plan", None)
    h, mask, params, da, db, g = _case(D, Da, True, True)
    out, ml = mil._fused_pool_cuda(h, mask, params, True, da, db)
    dh, grads = mil._fused_pool_bwd_cuda(h, mask, params, out, ml, g, True,
                                         da, db)
    assert seen == [("fwd", mil._round_up(D, 32), mil._round_up(Da, 8)),
                    ("bwd", mil._round_up(D, 64), mil._round_up(Da, 64))]
    assert out.shape == (3, D) and dh.shape == h.shape
    assert [tuple(t.shape) for t in grads] == [
        (D, Da), (Da,), (D, Da), (Da,), (Da, 1), (1,)]
    assert mil._fused_pool_cuda.launches == 1
    assert mil._fused_pool_bwd_cuda.launches == 1
    # the plans recorded are those of the padded widths
    assert mil._fused_pool_cuda.last_plan.part_acc[2] == mil._round_up(D, 32)
    assert mil._fused_pool_bwd_cuda.last_plan.part_dw[1:] == (
        mil._round_up(D, 64), 2 * mil._round_up(Da, 64))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_forward_launch_hands_over_the_documented_weight_layout(
        monkeypatch, dtype):
    """The weights reach the forward's library as its C interface states,
    from the transposed views that ``models/pooling.py`` passes (Wa =
    weight.t()): [D, Da] row-major f32 for f32 bags, [Da, D] row-major
    bf16 for bf16 bags.  A stub library reads them at the pointers it is
    given (host memory here)."""
    D, Da = 64, 32
    h, mask, params, _, _, _ = _case(D, Da, True, False)
    params = params._replace(Wa=params.Wa.t().contiguous().t(),
                             Wb=params.Wb.t().contiguous().t())
    assert not params.Wa.is_contiguous()
    h = h.to(dtype)
    seen = []

    class Lib:
        def mil_pool_fwd(self, *args):
            for ptr, W in ((args[2], params.Wa), (args[4], params.Wb)):
                if dtype == torch.float32:
                    want = W.contiguous().view(-1).numpy()
                    raw = ctypes.c_float * (D * Da)
                else:
                    want = (W.t().to(dtype).contiguous().view(torch.int16)
                            .view(-1).numpy().view(np.uint16))
                    raw = ctypes.c_uint16 * (D * Da)
                got = np.ctypeslib.as_array(raw.from_address(ptr))
                seen.append(np.array_equal(got, want))
            return 0

    def no_cuda_check(h, mask, params, gated, da, db):
        return (mask.float(), params.ba, params.bb,
                params.wc.reshape(-1), params.cc, da, db)

    monkeypatch.setattr(torch.cuda, "device", lambda dev: _Null())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: types.SimpleNamespace(
                            cuda_stream=0))
    monkeypatch.setattr(mil, "_fwd_lib", Lib)
    monkeypatch.setattr(mil, "_sms", lambda dev: 132)
    monkeypatch.setattr(mil, "_fwd_ctas_per_sm", lambda *a: 2)
    monkeypatch.setattr(mil, "_check_inputs", no_cuda_check)
    monkeypatch.setattr(mil._fused_pool_cuda, "launches", 0)
    monkeypatch.setattr(mil._fused_pool_cuda, "last_plan", None)
    mil._fused_pool_cuda(h, mask, params, True)
    assert seen == [True, True]


def test_launch_plans_count_their_ctas():
    """CTAs per kernel at the radiology shape (B=8, N=256, D=Da=256, gated,
    f32) on 132 SMs with one CTA per SM: two 128-row tiles per bag."""
    fwd = mil.fwd_plan(8, 256, 256, 256, True, False, 132, 1)
    assert fwd.ctas() == {"partial": 16, "merge": 8}
    bwd = mil.bwd_plan(8, 256, 256, 256, True, 132, 1)
    # 16 row tiles; dh 2 column blocks x 16; dW 4 x 2 output tiles x 16
    # splits of 128 rows
    assert bwd.ctas() == {"rows": 16, "dh": 32, "dw_partial": 128}


class _Null:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False
