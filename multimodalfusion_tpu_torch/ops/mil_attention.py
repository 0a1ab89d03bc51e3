"""Fused masked attention-MIL pooling: the plain PyTorch versions and the
wrappers of their hand-written CUDA kernels (``csrc/mil_pool_fwd.cu``,
``csrc/mil_pool_bwd.cu``).

Port of multimodalfusion_tpu/ops/mil_attention.py.  Bags are batched and
padded to [B, N, D] with a float mask [B, N]; the pooling is

    a = tanh(h @ Wa + ba) [* sigmoid(h @ Wb + bb)]   # gated
    s = a @ wc + cc, masked to NEG_INF               # [B, N]
    pooled = softmax(s) @ h                          # [B, D]

optionally with attention-branch dropout: uint8 keep masks ``da``/``db``
[B, N, Da] scale the tanh and sigmoid branches by 1/(1-rate).

``attention_pool`` and ``attention_pool_dropout`` are
``torch.autograd.Function``s.  For a tensor on the CPU their forward and
backward are the plain versions; for a tensor on the card they are the
CUDA kernels.  A wrapper never falls back from one to the other.  The
wrappers take any D up to 512 and any Da: the kernels' own steps (D in
multiples of 32 forward and 64 backward, Da in multiples of 8 and 64) are
met by zero-padding around the launch, which leaves the result exact.
Only on request (``pooling_route``) does a call on the card take another
route: "op" sends the forward through the custom op ``mmf::fused_pool``
so that ``torch.export`` keeps the kernel, and "plain" takes the plain
versions, as the reference the kernels are held against.
"""
from __future__ import annotations

import contextlib
import ctypes
import functools
from typing import NamedTuple, Optional, Tuple

import torch
from torch.nn import functional as F

from multimodalfusion_tpu_torch.ops import sharded_pool

NEG_INF = -1e30

# the reference hardcodes 0.25 on both attention branches
# (model_modules.py:97-99 nn.Dropout(0.25))
ATTN_DROPOUT_RATE = 0.25


class AttnParams(NamedTuple):
    """Attention-net parameters in the JAX package's layout (gated: all
    fields; ungated: Wb/bb unused).  Wa/Wb are [D, Da] (input-major, the
    transpose of an ``nn.Linear`` weight), ba/bb [Da], wc [Da, 1], cc [1].
    """
    Wa: torch.Tensor
    ba: torch.Tensor
    Wb: torch.Tensor
    bb: torch.Tensor
    wc: torch.Tensor
    cc: torch.Tensor


# ---------------------------------------------------------------------------
# Attention-branch dropout masks.
# ---------------------------------------------------------------------------

def make_dropout_masks(generator: Optional[torch.Generator], shape,
                       gated: bool = True, rate: float = ATTN_DROPOUT_RATE,
                       device=None):
    """Per-branch keep masks (da, db), uint8 ``shape`` = [B, N, Da], 1 =
    keep, drawn with ``generator`` on ``device`` (the generator's device
    when None).

    As in the JAX package, both masks come from one uint8 draw: the low
    nibble gives da and the high nibble db, each an exact Bernoulli(keep)
    when 16 * keep is an integer (the reference's rate 0.25 is).  Other
    rates draw 16-bit values against a threshold.  Ungated attention
    never reads db, so it aliases da.  The bits differ from JAX's by
    design (another generator): tests hand both sides the same masks.
    """
    if device is None:
        device = generator.device if generator is not None else "cpu"
    keep = 1.0 - rate
    k16 = keep * 16.0
    if k16 == int(k16):
        r = torch.randint(0, 256, tuple(shape), dtype=torch.uint8,
                          generator=generator, device=device)
        da = ((r & 0x0F) < int(k16)).to(torch.uint8)
        if not gated:
            return da, da
        return da, ((r >> 4) < int(k16)).to(torch.uint8)
    thresh = min(round(keep * 65536.0), 65535)

    def draw():
        return (torch.randint(0, 65536, tuple(shape), dtype=torch.int32,
                              generator=generator, device=device)
                < thresh).to(torch.uint8)
    da = draw()
    return (da, da) if not gated else (da, draw())


# ---------------------------------------------------------------------------
# Plain PyTorch versions (the CPU path and the kernels' oracles on the card).
# ---------------------------------------------------------------------------

def attention_scores(h, params: AttnParams, gated: bool = True):
    """Raw attention logits s [B, N] (pre-softmax, unmasked)."""
    a = torch.tanh(h @ params.Wa + params.ba)
    if gated:
        a = a * torch.sigmoid(h @ params.Wb + params.bb)
    return (a @ params.wc + params.cc)[..., 0]


def attention_scores_dropout(h, da, db, params: AttnParams,
                             gated: bool = True,
                             rate: float = ATTN_DROPOUT_RATE):
    """Raw attention logits with inverted dropout on the tanh branch (mask
    da) and the sigmoid gate (mask db), each scaled by 1/(1-rate)."""
    inv = 1.0 / (1.0 - rate)
    a = torch.tanh(h @ params.Wa + params.ba) * (da.to(h.dtype) * inv)
    if gated:
        a = a * (torch.sigmoid(h @ params.Wb + params.bb)
                 * (db.to(h.dtype) * inv))
    return (a @ params.wc + params.cc)[..., 0]


def _softmax_pool(s, h, mask):
    """(pooled [B, D], attn [B, N], max [B, 1], normalizer [B, 1]) of the
    masked softmax of s [B, N] over N.  Fully-masked bags pool to 0."""
    valid = mask > 0
    s = torch.where(valid, s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=1, keepdim=True)
    p = torch.exp(s - m) * valid
    l = p.sum(dim=1, keepdim=True)
    attn = p / l.clamp_min(1e-30)
    return torch.einsum("bn,bnd->bd", attn, h), attn, m, l


def masked_softmax_pool(s, h, mask):
    """Masked softmax of s [B, N] over N, then pooled = A @ h.

    Returns (pooled [B, D], attn [B, N]).  Fully-masked bags pool to 0.
    """
    return _softmax_pool(s, h, mask)[:2]


def attention_pool_with_attn(h, mask, params: AttnParams,
                             gated: bool = True, da=None, db=None):
    """The unfused read-out: (pooled [B, D], attn [B, N], raw scores s
    [B, N]) for interpretability (JAX ops/mil_attention.py:800-806; ref
    model_attention_mil_path.py:68-70), with the branch keep masks
    ``da``/``db`` when given (JAX models/pooling.py:76-90).  Plain
    PyTorch ops on any device: no kernel."""
    s = (attention_scores(h, params, gated) if da is None else
         attention_scores_dropout(h, da, db, params, gated))
    pooled, attn = masked_softmax_pool(s, h, mask)
    return pooled, attn, s


def _pool_reference(h, mask, params: AttnParams, gated: bool):
    s = attention_scores(h, params, gated)
    return masked_softmax_pool(s, h, mask)[0]


def _pool_reference_dropout(h, mask, da, db, params: AttnParams,
                            gated: bool, rate: float = ATTN_DROPOUT_RATE):
    s = attention_scores_dropout(h, da, db, params, gated, rate)
    return masked_softmax_pool(s, h, mask)[0]


def _acc_dtype(h) -> torch.dtype:
    """The type the kernels compute in: f32 for f32 and bf16 bags (f64
    for f64 bags, which only the gradient checks use)."""
    return torch.promote_types(h.dtype, torch.float32)


def _kernel_params(params: AttnParams, h) -> AttnParams:
    """The parameters as the kernels read them: the weights through the
    bag's dtype, then everything in the compute type."""
    acc = _acc_dtype(h)
    return AttnParams(Wa=params.Wa.to(h.dtype).to(acc), ba=params.ba.to(acc),
                      Wb=params.Wb.to(h.dtype).to(acc), bb=params.bb.to(acc),
                      wc=params.wc.to(acc), cc=params.cc.to(acc))


def _pool_plain(h, mask, params: AttnParams, gated: bool, da=None, db=None,
                rate: float = ATTN_DROPOUT_RATE
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """What the forward kernel computes, in plain PyTorch: the weights are
    cast to the bag's dtype as the kernel reads them, everything else is
    f32.  Returns (pooled [B, D] f32, ml [B, 2] f32 = (max logit,
    normalizer))."""
    hf = h.to(_acc_dtype(h))
    p = _kernel_params(params, h)
    s = (attention_scores(hf, p, gated) if da is None else
         attention_scores_dropout(hf, da, db, p, gated, rate))
    pooled, _, m, l = _softmax_pool(s, hf, mask)
    return pooled, torch.cat([m, l], dim=1)


def _pool_bwd_plain(h, mask, params: AttnParams, out, ml, g, gated: bool,
                    da=None, db=None, rate: float = ATTN_DROPOUT_RATE
                    ) -> Tuple[torch.Tensor, AttnParams]:
    """What the backward kernel computes, in plain PyTorch (the mirror of
    the JAX package's ``_pool_bwd_reference``, with the kernel's casts):
    the weights and dpa/dpb are cast to the bag's dtype before the
    products, everything else is f32.  (out, ml) are the forward's
    residuals and g the cotangent of out.

    Returns dh [B, N, D] in the bag's dtype and the parameter gradients
    (f32).  dcc is an exact 0: softmax attention is invariant to a
    constant logit shift, so sum_i ds_i is 0 per bag.  Ungated calls get
    zero Wb/bb gradients.
    """
    acc = _acc_dtype(h)
    p = _kernel_params(params, h)
    hf = h.to(acc)
    g, out = g.to(acc), out.to(acc)
    m = ml[:, :1].to(acc)
    l = ml[:, 1:].to(acc).clamp_min(1e-30)
    inv_keep = 1.0 / (1.0 - rate)
    t = torch.tanh(hf @ p.Wa + p.ba)
    daf = da.to(acc) * inv_keep if da is not None else None
    if gated:
        u = torch.sigmoid(hf @ p.Wb + p.bb)
        if da is not None:
            dbf = db.to(acc) * inv_keep
            ta, ub = t * daf, u * dbf
        else:
            ta, ub = t, u
        z = ta * ub
    else:
        z = t * daf if da is not None else t
    wc = p.wc.reshape(-1)
    valid = mask > 0
    s = torch.where(valid, z @ wc + p.cc[0], torch.full_like(z[..., 0],
                                                             NEG_INF))
    # masked before the exp: an all-masked bag has m = NEG_INF
    a = torch.where(valid, torch.exp(s - m) / l, torch.zeros_like(s))
    alpha = (hf * g[:, None, :]).sum(-1)                    # [B, N]
    gout = (g * out).sum(-1, keepdim=True)                  # [B, 1]
    ds = a * (alpha - gout)                                 # [B, N]
    dz = ds[..., None] * wc
    if gated:
        dpa = dz * ub * (1.0 - t * t)
        dpb = dz * ta * u * (1.0 - u)
        if da is not None:
            dpa, dpb = dpa * daf, dpb * dbf
    else:
        dpa = dz * (1.0 - t * t)
        if da is not None:
            dpa = dpa * daf
        dpb = torch.zeros_like(dpa)

    def via_bag(x):
        return x.to(h.dtype).to(acc)
    dpa_c, dpb_c = via_bag(dpa), via_bag(dpb)
    dh = a[..., None] * g[:, None, :] + dpa_c @ p.Wa.t()
    if gated:
        dh = dh + dpb_c @ p.Wb.t()
    zeros = torch.zeros_like
    grads = AttnParams(
        Wa=torch.einsum("bnd,bnk->dk", hf, dpa_c),
        ba=dpa.sum((0, 1)),
        Wb=(torch.einsum("bnd,bnk->dk", hf, dpb_c) if gated
            else zeros(p.Wb)),
        bb=dpb.sum((0, 1)) if gated else zeros(p.bb),
        wc=torch.einsum("bnk,bn->k", z, ds).reshape(-1, 1),
        cc=zeros(p.cc))
    return dh.to(h.dtype), grads


# ---------------------------------------------------------------------------
# CUDA kernel wrappers.
# ---------------------------------------------------------------------------

_VP, _INT, _FLOAT = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_DTYPES = (torch.float32, torch.bfloat16)
# rows per tile of the forward's partial kernel by bag dtype: GT of
# sgemm_core.cuh for f32 bags, BM of mma_core.cuh for bf16 bags
_TILE_ROWS = {torch.float32: 128, torch.bfloat16: 128}
_MAX_D = 512     # MAX_D in both sources
# GT of sgemm_core.cuh (the backward's row tile, as the f32 forward's,
# and the output tile of both its cores), the staged depth of the dW
# kernel by bag dtype (GK of sgemm_core.cuh for f32, BK of mma_core.cuh
# for bf16) and the backward source's VG (row tiles per group of column
# sums)
_BWD_TILE, _BWD_VEC_GROUP = _TILE_ROWS[torch.float32], 64
_BWD_DEPTH = {torch.float32: 8, torch.bfloat16: 32}


def _fwd_lib():
    from multimodalfusion_tpu_torch.ops import cuda_build
    lib = cuda_build.load("mil_pool_fwd")
    if lib.mil_pool_fwd.argtypes is None:
        lib.mil_pool_fwd.argtypes = ([_VP] * 14 + [_FLOAT] + [_INT] * 8
                                     + [_VP])
        lib.mil_pool_fwd.restype = ctypes.c_int
        lib.mil_pool_fwd_ctas_per_sm.argtypes = [_INT] * 4
        lib.mil_pool_fwd_tile_rows.argtypes = [_INT]
        built = (lib.mil_pool_fwd_tile_rows(0), lib.mil_pool_fwd_tile_rows(1),
                 lib.mil_pool_fwd_max_d())
        want = (_TILE_ROWS[torch.float32], _TILE_ROWS[torch.bfloat16],
                _MAX_D)
        if built != want:
            raise RuntimeError(f"mil_pool_fwd was built with (f32 tile rows, "
                               f"bf16 tile rows, MAX_D) = {built}, the "
                               f"wrapper expects {want}")
    return lib


def _bwd_lib():
    from multimodalfusion_tpu_torch.ops import cuda_build
    lib = cuda_build.load("mil_pool_bwd")
    if lib.mil_pool_bwd.argtypes is None:
        lib.mil_pool_bwd.argtypes = ([_VP] * 23 + [_FLOAT] + [_INT] * 8
                                     + [_VP])
        lib.mil_pool_bwd.restype = ctypes.c_int
        lib.mil_pool_bwd_dw_ctas_per_sm.argtypes = [_INT]
        lib.mil_pool_bwd_depth.argtypes = [_INT]
        built = (lib.mil_pool_bwd_tile(), lib.mil_pool_bwd_depth(0),
                 lib.mil_pool_bwd_depth(1), lib.mil_pool_bwd_vec_group())
        want = (_BWD_TILE, _BWD_DEPTH[torch.float32],
                _BWD_DEPTH[torch.bfloat16], _BWD_VEC_GROUP)
        if built != want:
            raise RuntimeError(f"mil_pool_bwd was built with (GT, f32 depth, "
                               f"bf16 depth, VG) = {built}, the wrapper "
                               f"expects {want}")
    return lib


@functools.lru_cache(maxsize=None)
def _sms(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


class FwdPlan(NamedTuple):
    """Grid and scratch shapes of one forward launch, as the C interface
    of ``csrc/mil_pool_fwd.cu`` documents them: ``splits`` CTAs per bag,
    each over ``rows_per_split`` rows in tiles of ``tile_rows``."""
    splits: int
    rows_per_split: int
    tile_rows: int
    part_acc: Tuple[int, int, int]  # [B, splits, D] f32
    part_ml: Tuple[int, int, int]   # [B, splits, 2] f32

    def ctas(self) -> dict:
        """CTAs of the launch's kernels: the partial (splits x B) and the
        merge (one per bag)."""
        B = self.part_acc[0]
        return {"partial": self.splits * B, "merge": B}


def fwd_plan(B: int, N: int, D: int, Da: int, gated: bool, bf16: bool,
             sms: int, ctas_per_sm: int) -> FwdPlan:
    """The forward's launch plan on a card with ``sms`` SMs that run
    ``ctas_per_sm`` CTAs of the partial kernel each: each bag's row tiles
    split over at most one wave of CTAs in all, so no CTA waits for a
    second wave; each split is a whole number of tiles and holds at least
    one row (one split when N = 0).  ``Da`` and ``gated`` do not change
    the plan: they choose the variant, whose occupancy ``ctas_per_sm``
    gives."""
    tile = _TILE_ROWS[torch.bfloat16 if bf16 else torch.float32]
    n_tiles = max(1, -(-N // tile))
    splits = min(n_tiles, max(1, ctas_per_sm * sms // max(B, 1)))
    rows_per_split = -(-n_tiles // splits) * tile
    splits = -(-N // rows_per_split) if N else 1
    return FwdPlan(splits=splits, rows_per_split=rows_per_split,
                   tile_rows=tile, part_acc=(B, splits, D),
                   part_ml=(B, splits, 2))


@functools.lru_cache(maxsize=None)
def _fwd_ctas_per_sm(device: torch.device, D: int, gated: bool, bf16: bool,
                     dropout: bool) -> int:
    """CTAs of the forward partial kernel that one SM runs at once."""
    lib = _fwd_lib()
    with torch.cuda.device(device):
        n = lib.mil_pool_fwd_ctas_per_sm(D, int(gated), int(bf16),
                                         int(dropout))
    if n < 1:
        raise RuntimeError(f"mil_pool_fwd cannot run at D={D} on {device}")
    return n


def _check_inputs(h, mask, params: AttnParams, gated: bool, da, db):
    """Shared argument checks of the two launches (the widths are checked
    and padded before, by ``_padded_widths``).  Returns (mask, ba, bb, wc,
    cc) as contiguous f32 and the dropout masks (db aliased to da when
    ungated)."""
    if not h.is_cuda:
        raise ValueError(f"the CUDA pooling kernels need a CUDA tensor, got "
                         f"one on {h.device}")
    if h.dtype not in _DTYPES:
        raise TypeError(f"bag dtype {h.dtype}: the kernels take float32 "
                        f"or bfloat16")
    if h.dim() != 3 or mask.shape != h.shape[:2]:
        raise ValueError(f"expected h [B, N, D] and mask [B, N], got "
                         f"{tuple(h.shape)} and {tuple(mask.shape)}")
    B, N = h.shape[:2]
    Da = params.Wa.shape[1]
    f32 = torch.float32
    mask = mask.to(f32).contiguous()
    ba, bb, wc, cc = (p.reshape(-1).to(f32).contiguous()
                      for p in (params.ba, params.bb, params.wc, params.cc))
    if wc.numel() != Da or cc.numel() != 1:
        raise ValueError("wc must be [Da, 1] and cc [1]")
    if da is not None:
        if db is None or not gated:
            db = da
        for m in (da, db):
            if m.dtype != torch.uint8 or tuple(m.shape) != (B, N, Da):
                raise ValueError(f"dropout masks must be uint8 "
                                 f"{(B, N, Da)}, got {m.dtype} "
                                 f"{tuple(m.shape)}")
        da, db = da.contiguous(), db.contiguous()
    for t in (mask, params.Wa, params.Wb, ba, bb, wc, cc) + (
            (da, db) if da is not None else ()):
        if t.device != h.device:
            raise ValueError(f"all inputs must be on {h.device}, got "
                             f"{t.device}")
    return mask, ba, bb, wc, cc, da, db


def _ptr(t) -> Optional[int]:
    return None if t is None else t.data_ptr()


# ---------------------------------------------------------------------------
# Widths: the kernels take D in multiples of d and Da in multiples of da,
# (d, da) below; the wrappers take any D up to _MAX_D and any Da, as the
# Pallas kernels do, by zero-padding around the launch.
# ---------------------------------------------------------------------------

# the forward's column and attention-unit steps by bag dtype (bf16 stages
# its keep bytes in 16-byte pieces)
FWD_MULTIPLES = {torch.float32: (32, 8), torch.bfloat16: (32, 16)}
BWD_MULTIPLES = (64, 64)   # the backward's (the 64-wide edges of its tiles)


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def pad_widths(D_to: int, Da_to: int, h, params: AttnParams, da=None,
               db=None, rows=()):
    """Zero-pad the pooling's inputs from widths (D, Da) to (D_to, Da_to):
    h's feature columns, the rows of Wa and Wb and each [.., D] tensor of
    ``rows`` (out and g of the backward) to D_to; the columns of Wa and
    Wb, ba, bb, wc and the keep masks to Da_to.  The padding is exact: a
    zero feature column adds 0 to every product, and a padded attention
    unit scores tanh(0) [* sigmoid(0)] * 0 = 0 with a zero mask, so the
    logits, the softmax and the pooled real columns do not change, and
    the padded columns pool to 0.  Returns (h, params, da, db, rows)."""
    dD, dA = D_to - h.shape[-1], Da_to - params.Wa.shape[1]

    def cols(x, n):  # zeros after the last dimension's entries
        return F.pad(x, (0, n)) if n else x
    W = [cols(F.pad(w, (0, 0, 0, dD)), dA) for w in (params.Wa, params.Wb)]
    params = AttnParams(Wa=W[0], ba=cols(params.ba, dA), Wb=W[1],
                        bb=cols(params.bb, dA),
                        wc=F.pad(params.wc, (0, 0, 0, dA)), cc=params.cc)
    masks = [None if m is None else cols(m, dA) for m in (da, db)]
    return (cols(h, dD), params, masks[0], masks[1],
            tuple(cols(r, dD) for r in rows))


def unpad_grads(grads: AttnParams, D: int, Da: int) -> AttnParams:
    """The parameter gradients of padded widths cut back to (D, Da)."""
    return AttnParams(Wa=grads.Wa[:D, :Da], ba=grads.ba[:Da],
                      Wb=grads.Wb[:D, :Da], bb=grads.bb[:Da],
                      wc=grads.wc[:Da], cc=grads.cc)


def _padded_widths(h, params: AttnParams, multiples) -> Tuple[int, int]:
    """The one check of the wrappers' widths (D up to _MAX_D, Wa and Wb
    [D, Da]), and the widths padded up to ``multiples``."""
    D, Da = h.shape[-1], params.Wa.shape[1]
    if D > _MAX_D:
        raise ValueError(f"D={D}: the kernels take D up to {_MAX_D}")
    for name in ("Wa", "Wb"):
        if tuple(getattr(params, name).shape) != (D, Da):
            raise ValueError(f"{name} must be [D, Da] = {(D, Da)}, got "
                             f"{tuple(getattr(params, name).shape)}")
    return _round_up(D, multiples[0]), _round_up(Da, multiples[1])


def pool_padded(launch, multiples, h, mask, params: AttnParams, gated: bool,
                da=None, db=None, rate: float = ATTN_DROPOUT_RATE):
    """``launch`` (a forward with ``_pool_plain``'s arguments and results)
    at widths padded up to ``multiples``, the padded columns of pooled cut
    off.  Widths that are already multiples take no copy."""
    D, Da = h.shape[-1], params.Wa.shape[1]
    D_to, Da_to = _padded_widths(h, params, multiples)
    if (D_to, Da_to) == (D, Da):
        return launch(h, mask, params, gated, da, db, rate)
    h, params, da, db, _ = pad_widths(D_to, Da_to, h, params, da, db)
    out, ml = launch(h, mask, params, gated, da, db, rate)
    return out[:, :D], ml


def pool_bwd_padded(launch, multiples, h, mask, params: AttnParams, out, ml,
                    g, gated: bool, da=None, db=None,
                    rate: float = ATTN_DROPOUT_RATE):
    """``launch`` (a backward with ``_pool_bwd_plain``'s arguments and
    results) at widths padded up to ``multiples`` (out and g too), dh and
    the parameter gradients cut back.  Widths that are already multiples
    take no copy."""
    D, Da = h.shape[-1], params.Wa.shape[1]
    D_to, Da_to = _padded_widths(h, params, multiples)
    if (D_to, Da_to) == (D, Da):
        return launch(h, mask, params, out, ml, g, gated, da, db, rate)
    h, params, da, db, (out, g) = pad_widths(D_to, Da_to, h, params, da, db,
                                             (out, g))
    dh, grads = launch(h, mask, params, out, ml, g, gated, da, db, rate)
    return dh[..., :D], unpad_grads(grads, D, Da)


def _fused_pool_cuda(h, mask, params: AttnParams, gated: bool, da=None,
                     db=None, rate: float = ATTN_DROPOUT_RATE):
    """Launch ``csrc/mil_pool_fwd.cu`` on the bag's device and stream, at
    any D up to _MAX_D and any Da: other widths than the kernel's
    multiples are zero-padded around the launch (``pool_padded``)."""
    multiples = FWD_MULTIPLES.get(h.dtype, FWD_MULTIPLES[torch.float32])
    return pool_padded(_launch_fwd, multiples, h, mask, params, gated, da,
                       db, rate)


def _launch_fwd(h, mask, params: AttnParams, gated: bool, da, db,
                rate: float):
    mask, ba, bb, wc, cc, da, db = _check_inputs(h, mask, params, gated,
                                                 da, db)
    B, N, D = h.shape
    Da = params.Wa.shape[1]
    bf16 = h.dtype == torch.bfloat16
    dev = h.device
    f32 = torch.float32
    h = h.contiguous()
    if h.data_ptr() % 16:
        h = h.clone()  # 16-byte row loads
    if da is not None and (da.data_ptr() % 16 or db.data_ptr() % 16):
        da, db = da.clone(), db.clone()  # 16-byte copies of the bf16 kernel
    wa, wb = ((params.Wa.t(), params.Wb.t()) if bf16
              else (params.Wa, params.Wb))
    wa = wa.to(h.dtype).contiguous()
    wb = wb.to(h.dtype).contiguous() if gated else wa

    out = torch.empty((B, D), dtype=f32, device=dev)
    ml = torch.empty((B, 2), dtype=f32, device=dev)
    if B == 0:
        return out, ml
    lib = _fwd_lib()
    plan = fwd_plan(B, N, D, Da, gated, bf16, _sms(dev),
                    _fwd_ctas_per_sm(dev, D, gated, bf16, da is not None))
    part_acc = torch.empty(plan.part_acc, dtype=f32, device=dev)
    part_ml = torch.empty(plan.part_ml, dtype=f32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    # the launch goes to the current device: make it the bag's, whose
    # stream is passed in
    with torch.cuda.device(dev):
        err = lib.mil_pool_fwd(
            h.data_ptr(), mask.data_ptr(), wa.data_ptr(), ba.data_ptr(),
            wb.data_ptr(), bb.data_ptr(), wc.data_ptr(), cc.data_ptr(),
            _ptr(da), _ptr(db), part_acc.data_ptr(), part_ml.data_ptr(),
            out.data_ptr(), ml.data_ptr(), 1.0 / (1.0 - rate), B, N, D, Da,
            plan.splits, plan.rows_per_split, int(gated), int(bf16), stream)
    if err != 0:
        raise RuntimeError(f"mil_pool_fwd launch failed: CUDA error {err}")
    _fused_pool_cuda.launches += 1
    _fused_pool_cuda.last_plan = plan
    return out, ml


_fused_pool_cuda.launches = 0
_fused_pool_cuda.last_plan = None  # the FwdPlan of the latest launch


class BwdPlan(NamedTuple):
    """Grid and scratch shapes of one backward launch, as the C interface
    of ``csrc/mil_pool_bwd.cu`` documents them (M = B * N rows, Kc
    columns of [dpa | dpb], ``tiles`` = ceil(M / 128))."""
    splits: int                # row splits of the dW partial kernel
    rows_per_split: int
    dp: Tuple[int, int]        # [M, Kc], the bag's dtype
    tu: Tuple[int, int]        # [M, Kc] f32 (dp itself for f32 bags)
    part_vec: Tuple[int, int, int]  # [tiles, 3, Da]
    part_grp: Tuple[int, int, int]  # [ceil(tiles / VG), 3, Da]
    part_dw: Tuple[int, int, int]   # [splits, D, Kc]

    def ctas(self) -> dict:
        """CTAs of the launch's kernels that scale with the shape: the
        rows kernel (one per tile), dh (per tile and 128-column block) and
        the dW partial (per 128 x 128 output tile and split)."""
        tiles, (splits, D, Kc) = self.part_vec[0], self.part_dw
        n_col = -(-D // _BWD_TILE)
        return {"rows": tiles, "dh": n_col * tiles,
                "dw_partial": -(-Kc // _BWD_TILE) * n_col * splits}


def bwd_plan(B: int, N: int, D: int, Da: int, gated: bool, sms: int,
             ctas_per_sm: int, bf16: bool = False) -> BwdPlan:
    """The backward's launch plan on a card with ``sms`` SMs that run
    ``ctas_per_sm`` CTAs of the dW partial kernel each, for f32 or
    ``bf16`` bags.  Its ceil(D/128) x ceil(Kc/128) output tiles times the
    row splits fill at most one wave; each split is a whole number of the
    kernel's row chunks (8 rows deep for f32, 32 for bf16) and holds at
    least one row."""
    rows = B * N
    Kc = 2 * Da if gated else Da
    depth = _BWD_DEPTH[torch.bfloat16 if bf16 else torch.float32]
    tiles = -(-rows // _BWD_TILE)
    groups = -(-tiles // _BWD_VEC_GROUP)
    out_tiles = -(-D // _BWD_TILE) * -(-Kc // _BWD_TILE)
    chunks = max(1, -(-rows // depth))
    splits = max(1, min(chunks, ctas_per_sm * sms // out_tiles))
    rows_per_split = -(-chunks // splits) * depth
    splits = max(1, -(-rows // rows_per_split))
    return BwdPlan(splits=splits, rows_per_split=rows_per_split,
                   dp=(rows, Kc), tu=(rows, Kc), part_vec=(tiles, 3, Da),
                   part_grp=(groups, 3, Da), part_dw=(splits, D, Kc))


@functools.lru_cache(maxsize=None)
def _dw_ctas_per_sm(device: torch.device, bf16: bool) -> int:
    """CTAs of the backward's dW partial kernel that one SM runs at once."""
    lib = _bwd_lib()
    with torch.cuda.device(device):
        n = lib.mil_pool_bwd_dw_ctas_per_sm(int(bf16))
    if n < 1:
        raise RuntimeError(f"mil_pool_bwd cannot run on {device}")
    return n


def _fused_pool_bwd_cuda(h, mask, params: AttnParams, out, ml, g,
                         gated: bool, da=None, db=None,
                         rate: float = ATTN_DROPOUT_RATE
                         ) -> Tuple[torch.Tensor, AttnParams]:
    """Launch ``csrc/mil_pool_bwd.cu`` on the bag's device and stream, at
    any D up to _MAX_D and any Da (zero-padded around the launch, as the
    forward is).  Returns dh [B, N, D] in the bag's dtype and the
    parameter gradients in f32 (Wb/bb zero for ungated calls, cc an exact
    0)."""
    return pool_bwd_padded(_launch_bwd, BWD_MULTIPLES, h, mask, params, out,
                           ml, g, gated, da, db, rate)


def _launch_bwd(h, mask, params: AttnParams, out, ml, g, gated: bool, da,
                db, rate: float) -> Tuple[torch.Tensor, AttnParams]:
    mask, ba, bb, wc, cc, da, db = _check_inputs(h, mask, params, gated,
                                                 da, db)
    B, N, D = h.shape
    Da = params.Wa.shape[1]
    dev = h.device
    f32 = torch.float32
    h = h.contiguous()
    if h.data_ptr() % 16:
        h = h.clone()
    if mask.data_ptr() % 16:
        mask = mask.clone()  # 16-byte loads of the bf16 dW kernel
    for name, t in (("out", out), ("ml", ml), ("g", g)):
        if t.device != dev:
            raise ValueError(f"{name} must be on {dev}, got {t.device}")
    out = out.to(f32).contiguous()
    ml = ml.to(f32).contiguous()
    g = g.to(f32).contiguous()
    if out.shape != (B, D) or g.shape != (B, D) or ml.shape != (B, 2):
        raise ValueError("expected out and g [B, D] and ml [B, 2]")
    # weights in the bag's dtype: W [D, Da] for the scoring products,
    # Wcat = [Wa^T; Wb^T] [Kc, D] for dh = [dpa | dpb] @ Wcat
    wa = params.Wa.to(h.dtype).contiguous()
    wb = params.Wb.to(h.dtype).contiguous() if gated else wa
    wcat = (torch.cat([wa.t(), wb.t()]) if gated else wa.t()).contiguous()
    Kc = wcat.shape[0]

    dh = torch.empty_like(h)
    dW = torch.empty((D, Kc), dtype=f32, device=dev)
    dvec = torch.empty((3, Da), dtype=f32, device=dev)  # dba, dbb, dwc
    if B and N:
        bf16 = h.dtype == torch.bfloat16
        plan = bwd_plan(B, N, D, Da, gated, _sms(dev),
                        _dw_ctas_per_sm(dev, bf16), bf16)
        # scratch: [dpa | dpb] per row in the bag's dtype; t and u per row
        # in f32 between the rows kernel's two passes (dp itself for f32
        # bags, overwritten in place); the attention weights a; per-tile
        # column sums of (dpa, dpb, z * ds) and their group sums; the dW
        # partials of the row splits
        dp = torch.empty(plan.dp, dtype=h.dtype, device=dev)
        tu = torch.empty(plan.tu, dtype=f32, device=dev) if bf16 else dp
        a = torch.empty((B, N), dtype=f32, device=dev)
        part_vec = torch.empty(plan.part_vec, dtype=f32, device=dev)
        part_grp = torch.empty(plan.part_grp, dtype=f32, device=dev)
        part_dw = torch.empty(plan.part_dw, dtype=f32, device=dev)
        lib = _bwd_lib()
        stream = torch.cuda.current_stream(dev).cuda_stream
        with torch.cuda.device(dev):  # as in _fused_pool_cuda
            err = lib.mil_pool_bwd(
                h.data_ptr(), mask.data_ptr(), wa.data_ptr(), ba.data_ptr(),
                wb.data_ptr(), bb.data_ptr(), wc.data_ptr(), cc.data_ptr(),
                wcat.data_ptr(), _ptr(da), _ptr(db), out.data_ptr(),
                ml.data_ptr(), g.data_ptr(), dp.data_ptr(), tu.data_ptr(),
                a.data_ptr(), part_vec.data_ptr(), part_grp.data_ptr(),
                part_dw.data_ptr(), dh.data_ptr(), dW.data_ptr(),
                dvec.data_ptr(), 1.0 / (1.0 - rate), B, N, D, Da,
                plan.splits, plan.rows_per_split, int(gated), int(bf16),
                stream)
        if err != 0:
            raise RuntimeError(f"mil_pool_bwd launch failed: CUDA error "
                               f"{err}")
        _fused_pool_bwd_cuda.launches += 1
        _fused_pool_bwd_cuda.last_plan = plan
    else:
        dh.zero_()
        dW.zero_()
        dvec.zero_()
    # dcc = sum(ds) is analytically 0: written as an exact 0, never summed
    grads = AttnParams(
        Wa=dW[:, :Da], ba=dvec[0],
        Wb=dW[:, Da:] if gated else torch.zeros_like(dW),
        bb=dvec[1] if gated else torch.zeros_like(dvec[1]),
        wc=dvec[2].reshape(Da, 1), cc=torch.zeros(1, dtype=f32, device=dev))
    return dh, grads


_fused_pool_bwd_cuda.launches = 0
_fused_pool_bwd_cuda.last_plan = None  # the BwdPlan of the latest launch


# How ``_fused_pool`` and ``_fused_pool_bwd`` route a tensor on the card:
# "kernel" launches the kernels directly; "op" sends the forward through the
# custom op ``mmf::fused_pool`` (so that ``torch.export`` keeps it in its
# graph); "plain" takes the plain versions on any device, as the reference
# that the kernels are held against.  A tensor on the CPU takes the plain
# versions under "kernel" and "plain".  Set with ``pooling_route``.
_ROUTES = ("kernel", "op", "plain")
_route = "kernel"


@contextlib.contextmanager
def pooling_route(route: str):
    """Route the pooling as ``route`` (one of ``_ROUTES``) while the
    context lasts."""
    global _route
    if route not in _ROUTES:
        raise ValueError(f"pooling route {route!r} is not one of {_ROUTES}")
    before, _route = _route, route
    try:
        yield
    finally:
        _route = before


@torch.library.custom_op("mmf::fused_pool", mutates_args=())
def fused_pool_op(h: torch.Tensor, mask: torch.Tensor, Wa: torch.Tensor,
                  ba: torch.Tensor, Wb: torch.Tensor, bb: torch.Tensor,
                  wc: torch.Tensor, cc: torch.Tensor,
                  da: Optional[torch.Tensor], db: Optional[torch.Tensor],
                  gated: bool, rate: float
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The forward as the torch custom op ``mmf::fused_pool``, so that
    ``torch.export`` keeps the kernel in its graph (the ctypes launch reads
    ``data_ptr()``, which a traced tensor lacks).  A tensor on the CPU
    takes the plain version; any other device launches
    ``csrc/mil_pool_fwd.cu`` (width padding included) or raises."""
    params = AttnParams(Wa, ba, Wb, bb, wc, cc)
    if h.device.type == "cpu":
        return _pool_plain(h, mask, params, gated, da, db, rate)
    out, ml = _fused_pool_cuda(h, mask, params, gated, da, db, rate)
    return out.contiguous(), ml  # a padded launch's out is a column slice


@fused_pool_op.register_fake
def _fused_pool_fake(h, mask, Wa, ba, Wb, bb, wc, cc, da, db, gated, rate):
    acc = _acc_dtype(h)
    return (h.new_empty((h.shape[0], h.shape[2]), dtype=acc),
            h.new_empty((h.shape[0], 2), dtype=acc))


def _fused_pool(h, mask, params: AttnParams, gated: bool, da=None, db=None,
                rate: float = ATTN_DROPOUT_RATE
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(pooled [B, D] f32, ml [B, 2] f32) with the residuals of the TPU
    kernel: ml = (max logit, softmax normalizer) per bag.  A tensor on the
    CPU takes the plain version; any other device launches the kernel or
    raises.  Under the route "op" the call goes through ``fused_pool_op``,
    and a tensor on neither the CPU nor a card is refused here: the op
    would hand a meta tensor to its shape function."""
    if _route == "op":
        if h.device.type not in ("cpu", "cuda"):
            raise ValueError(f"the CUDA pooling kernels need a CUDA tensor, "
                             f"got one on {h.device}")
        return fused_pool_op(h, mask, *params, da, db, gated, rate)
    if h.device.type == "cpu" or _route == "plain":
        return _pool_plain(h, mask, params, gated, da, db, rate)
    return _fused_pool_cuda(h, mask, params, gated, da, db, rate)


def _fused_pool_bwd(h, mask, params: AttnParams, out, ml, g, gated: bool,
                    da=None, db=None, rate: float = ATTN_DROPOUT_RATE):
    """(dh, parameter gradients): the plain version for a tensor on the
    CPU, the backward kernel (or an error) on any other device."""
    if h.device.type == "cpu" or _route == "plain":
        return _pool_bwd_plain(h, mask, params, out, ml, g, gated, da, db,
                               rate)
    return _fused_pool_bwd_cuda(h, mask, params, out, ml, g, gated, da, db,
                                rate)


# ---------------------------------------------------------------------------
# Public ops with their backward (the custom_vjp pair of the JAX package).
# ---------------------------------------------------------------------------

class _AttentionPool(torch.autograd.Function):
    """pooled = pool(h, mask, params[, da, db]), over the bag blocks of
    ``group`` when one is given (``ops/sharded_pool.py``); the forward
    saves (h, mask, params, out, ml[, da, db]) and the backward is one
    call of the fused backward.  Ungated calls return no gradient for
    Wb/bb."""

    @staticmethod
    def forward(ctx, h, mask, da, db, Wa, ba, Wb, bb, wc, cc, gated, rate,
                group):
        params = AttnParams(Wa, ba, Wb, bb, wc, cc)
        out, ml = sharded_pool.merge(
            *_fused_pool(h, mask, params, gated, da, db, rate), group)
        ctx.save_for_backward(h, mask, da, db, Wa, ba, Wb, bb, wc, cc, out,
                              ml)
        ctx.gated, ctx.rate, ctx.group = gated, rate, group
        return out

    @staticmethod
    def backward(ctx, g):
        h, mask, da, db, *p, out, ml = ctx.saved_tensors
        params = AttnParams(*p)
        dh, grads = _fused_pool_bwd(h, mask, params, out, ml, g, ctx.gated,
                                    da, db, ctx.rate)
        grads = sharded_pool.sum_over(grads, ctx.group)
        dp = [d.to(w.dtype) for d, w in zip(grads, params)]
        if not ctx.gated:
            dp[2] = dp[3] = None
        return (dh, None, None, None, *dp, None, None, None)


def attention_pool(h, mask, params: AttnParams, gated: bool = True,
                   group=None):
    """Fused gated/ungated attention-MIL pooling, differentiable in h and
    the parameters.

    h:    [B, N, D] padded bag features (post-FC), f32 or bf16
    mask: [B, N]    1.0 for real instances, 0.0 for padding
    group: a process group over whose ranks the instance axis is split;
          h and mask are then this rank's block (``ops/sharded_pool.py``)
    Returns pooled [B, D] in f32 (of the whole bags).
    """
    return _AttentionPool.apply(h, mask, None, None, *params, gated,
                                ATTN_DROPOUT_RATE, group)


def attention_pool_dropout(h, mask, da, db, params: AttnParams,
                           gated: bool = True,
                           rate: float = ATTN_DROPOUT_RATE, group=None):
    """Fused attention-MIL pooling with attention-branch dropout (ref
    model_modules.py:97-99; every published reference recipe passes
    --drop_out).  ``da``/``db``: uint8 [B, N, Da] keep masks from
    ``make_dropout_masks``, applied by the forward and the backward alike
    (under a ``group``, this rank's rows of them, cut as h is).  Returns
    pooled [B, D] in f32."""
    return _AttentionPool.apply(h, mask, da, db if gated else da, *params,
                                gated, rate, group)
