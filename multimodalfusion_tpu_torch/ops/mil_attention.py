"""Fused masked attention-MIL pooling: the plain PyTorch version and the
wrapper of its hand-written CUDA kernel (``csrc/mil_pool_fwd.cu``).

Port of multimodalfusion_tpu/ops/mil_attention.py.  Bags are batched and
padded to [B, N, D] with a float mask [B, N]; the pooling is

    a = tanh(h @ Wa + ba) [* sigmoid(h @ Wb + bb)]   # gated
    s = a @ wc + cc, masked to NEG_INF               # [B, N]
    pooled = softmax(s) @ h                          # [B, D]

``attention_pool`` runs the plain version for a tensor on the CPU and the
CUDA kernel for a tensor on the card; it never falls back from one to the
other.  Forward only: the backward kernel and attention-branch dropout
come with the training slice (ROADMAP.md).
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Tuple

import torch

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
# Plain PyTorch version (the CPU path and the kernel's oracle on the card).
# ---------------------------------------------------------------------------

def attention_scores(h, params: AttnParams, gated: bool = True):
    """Raw attention logits s [B, N] (pre-softmax, unmasked)."""
    a = torch.tanh(h @ params.Wa + params.ba)
    if gated:
        a = a * torch.sigmoid(h @ params.Wb + params.bb)
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


def _pool_reference(h, mask, params: AttnParams, gated: bool):
    s = attention_scores(h, params, gated)
    return masked_softmax_pool(s, h, mask)[0]


def _pool_plain(h, mask, params: AttnParams, gated: bool
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """What the kernel computes, in plain PyTorch: the weights are cast to
    the bag's dtype as the kernel reads them, everything else is f32.
    Returns (pooled [B, D] f32, ml [B, 2] f32 = (max logit, normalizer))."""
    f32 = torch.float32
    hf = h.to(f32)
    p32 = AttnParams(Wa=params.Wa.to(h.dtype).to(f32), ba=params.ba.to(f32),
                     Wb=params.Wb.to(h.dtype).to(f32), bb=params.bb.to(f32),
                     wc=params.wc.to(f32), cc=params.cc.to(f32))
    pooled, _, m, l = _softmax_pool(attention_scores(hf, p32, gated), hf,
                                    mask)
    return pooled, torch.cat([m, l], dim=1)


# ---------------------------------------------------------------------------
# CUDA kernel wrapper.
# ---------------------------------------------------------------------------

_VP, _INT = ctypes.c_void_p, ctypes.c_int
_DTYPES = (torch.float32, torch.bfloat16)
_TILE_ROWS = 64  # TM in the source
_MAX_D = 512     # MAX_D in the source


def _kernel_lib():
    from multimodalfusion_tpu_torch.ops import cuda_build
    lib = cuda_build.load("mil_pool_fwd")
    if lib.mil_pool_fwd.argtypes is None:
        lib.mil_pool_fwd.argtypes = [_VP] * 12 + [_INT] * 8 + [_VP]
        lib.mil_pool_fwd.restype = ctypes.c_int
        lib.mil_pool_fwd_ctas_per_sm.argtypes = [_INT] * 3
        built = (lib.mil_pool_fwd_tile_rows(), lib.mil_pool_fwd_max_d())
        if built != (_TILE_ROWS, _MAX_D):
            raise RuntimeError(f"mil_pool_fwd was built with (TM, MAX_D) = "
                               f"{built}, the wrapper expects "
                               f"{(_TILE_ROWS, _MAX_D)}")
    return lib


@functools.lru_cache(maxsize=None)
def _wave(device: torch.device, D: int, gated: bool, bf16: bool) -> int:
    """CTAs of the partial kernel that the card runs at once."""
    lib = _kernel_lib()
    with torch.cuda.device(device):
        per_sm = lib.mil_pool_fwd_ctas_per_sm(D, int(gated), int(bf16))
    if per_sm < 1:
        raise RuntimeError(f"mil_pool_fwd cannot run at D={D} on {device}")
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return per_sm * sms


def _grid(device, B, N, D, gated, bf16):
    """(splits, rows per split): each bag's row tiles split over at most one
    wave of CTAs in all, so no CTA waits for a second wave."""
    n_tiles = max(1, -(-N // _TILE_ROWS))
    splits = min(n_tiles, max(1, _wave(device, D, gated, bf16) // B))
    rows_per_split = -(-n_tiles // splits) * _TILE_ROWS
    return (-(-N // rows_per_split) if N else 1), rows_per_split


def _fused_pool_cuda(h, mask, params: AttnParams, gated: bool):
    """Launch ``csrc/mil_pool_fwd.cu`` on the bag's device and stream."""
    if not h.is_cuda:
        raise ValueError(f"the CUDA pooling kernel needs a CUDA tensor, got "
                         f"one on {h.device}")
    if torch.is_grad_enabled() and (
            h.requires_grad or any(p.requires_grad for p in params)):
        raise NotImplementedError(
            "attention_pool on CUDA is forward-only until the backward "
            "kernel is ported (ROADMAP.md, training slice); run it under "
            "torch.no_grad()")
    if h.dtype not in _DTYPES:
        raise TypeError(f"bag dtype {h.dtype}: the kernel takes float32 "
                        f"or bfloat16")
    if h.dim() != 3 or mask.shape != h.shape[:2]:
        raise ValueError(f"expected h [B, N, D] and mask [B, N], got "
                         f"{tuple(h.shape)} and {tuple(mask.shape)}")
    B, N, D = h.shape
    Da = params.Wa.shape[1]
    bf16 = h.dtype == torch.bfloat16
    if tuple(params.Wa.shape) != (D, Da) or D > _MAX_D or D % 32 or Da % 8:
        raise ValueError(f"unsupported widths: h D={D}, Wa "
                         f"{tuple(params.Wa.shape)} (D must be a multiple "
                         f"of 32 up to {_MAX_D}, Da a multiple of 8)")
    dev = h.device
    f32 = torch.float32
    h = h.contiguous()
    if h.data_ptr() % 16:
        h = h.clone()  # 16-byte row loads
    mask = mask.to(f32).contiguous()
    # f32 bags read W [D, Da]; bf16 bags read its transpose [Da, D]
    wa, wb = ((params.Wa.t(), params.Wb.t()) if bf16
              else (params.Wa, params.Wb))
    wa = wa.to(h.dtype).contiguous()
    wb = wb.to(h.dtype).contiguous() if gated else wa
    ba, bb, wc, cc = (p.reshape(-1).to(f32).contiguous()
                      for p in (params.ba, params.bb, params.wc, params.cc))
    if wc.numel() != Da or cc.numel() != 1:
        raise ValueError("wc must be [Da, 1] and cc [1]")
    for t in (mask, wa, wb, ba, bb, wc, cc):
        if t.device != dev:
            raise ValueError(f"all inputs must be on {dev}, got {t.device}")

    out = torch.empty((B, D), dtype=f32, device=dev)
    ml = torch.empty((B, 2), dtype=f32, device=dev)
    if B == 0:
        return out, ml
    lib = _kernel_lib()
    splits, rows_per_split = _grid(dev, B, N, D, gated, bf16)
    part_acc = torch.empty((B, splits, D), dtype=f32, device=dev)
    part_ml = torch.empty((B, splits, 2), dtype=f32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.mil_pool_fwd(
        h.data_ptr(), mask.data_ptr(), wa.data_ptr(), ba.data_ptr(),
        wb.data_ptr(), bb.data_ptr(), wc.data_ptr(), cc.data_ptr(),
        part_acc.data_ptr(), part_ml.data_ptr(),
        out.data_ptr(), ml.data_ptr(), B, N, D, Da, splits, rows_per_split,
        int(gated), int(bf16), stream)
    if err != 0:
        raise RuntimeError(f"mil_pool_fwd launch failed: CUDA error {err}")
    _fused_pool_cuda.launches += 1
    return out, ml


_fused_pool_cuda.launches = 0


def _fused_pool(h, mask, params: AttnParams, gated: bool
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(pooled [B, D] f32, ml [B, 2] f32) with the residuals of the TPU
    kernel: ml = (max logit, softmax normalizer) per bag.  A tensor on the
    CPU takes the plain version; any other device launches the kernel or
    raises."""
    if h.device.type == "cpu":
        return _pool_plain(h, mask, params, gated)
    return _fused_pool_cuda(h, mask, params, gated)


def attention_pool(h, mask, params: AttnParams, gated: bool = True):
    """Fused gated/ungated attention-MIL pooling.

    h:    [B, N, D] padded bag features (post-FC), f32 or bf16
    mask: [B, N]    1.0 for real instances, 0.0 for padding
    Returns pooled [B, D] in f32.
    """
    return _fused_pool(h, mask, params, gated)[0]
