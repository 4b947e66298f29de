"""Flash attention in the model layout: the CUDA kernel for CUDA tensors,
the plain version (``ref.attention_ref``) for CPU tensors.

``flash_attention`` keeps the model layout (B, S, H, hd) at its public
function, like the reference's ``ops.flash_attention``; the kernel reads
that layout through its strides, so nothing is transposed or copied on
the card.  The reference's block-size choice (``_largest_divisor_block``)
has no counterpart: the kernel masks ragged tiles itself and any S and T
work.  Which kernel a call launches depends on its type and head dim
alone (``kernel_symbol``): bf16 at hd 64 and 128 takes the Hopper
pipeline, which loads q, k and v with TMA through tensor maps built for
each call over their (hd, H, S, B) views; that needs every row to start
on a 16-byte boundary (a 16-byte aligned pointer, strides that are
multiples of 8 elements), as do the 16-byte loads of the bf16 kernel for
hd 16 and 32.  bf16 operands that break the rule (an odd view) are
copied once.  The kernel is forward-only, as the TPU kernel is: with
autograd recording and an input that requires grad, the op raises
instead of returning a wrong gradient.
"""
from __future__ import annotations

import ctypes

import torch

from ...core.kernels._backend import (aligned_rows, call, count_launch,
                                      no_dtensor)
from . import ref

HEAD_DIMS = (16, 32, 64, 128)
_TYPE_FLAG = {torch.float32: 0, torch.bfloat16: 1}
# (q, k, v, o, work counter, 4 x (b, s, h) strides, B, Hq, Hkv, S, T, hd,
#  causal, window, q_offset, is_bf16, stream) -> cudaError_t
_ARGTYPES = ((ctypes.c_void_p,) * 5 + (ctypes.c_int64,) * 12
             + (ctypes.c_int,) * 10 + (ctypes.c_void_p,))


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: int | None = None,
                  q_offset: int = 0) -> torch.Tensor:
    """The plain version in the model layout: q (B, S, Hq, hd), k and v
    (B, T, Hkv, hd) -> (B, S, Hq, hd); query row r at position
    ``q_offset + r``."""
    return ref.attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                             v.transpose(1, 2), causal=causal,
                             window=window,
                             q_offset=q_offset).transpose(1, 2)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           window: int | None, q_offset: int) -> None:
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"expected q (B, S, Hq, hd) and k, v (B, T, Hkv, "
                         f"hd), got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, _, Hq, hd = q.shape
    if k.shape[0] != B or k.shape[3] != hd or Hq % k.shape[2]:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} need "
                         "one batch and head dim, and Hkv dividing Hq")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head dim {hd} not supported by the flash "
                         f"kernel; it takes {HEAD_DIMS}")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1 or None, got {window}")
    if q_offset < 0:
        raise ValueError(f"q_offset must be >= 0, got {q_offset}")
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        raise RuntimeError("flash_attention is forward-only (the kernel "
                           "has no backward); run it under torch.no_grad() "
                           "or use attn_impl='ref' for gradients")


def _hopper(dtype: torch.dtype, hd: int) -> bool:
    return dtype == torch.bfloat16 and hd >= 64


def kernel_symbol(dtype: torch.dtype, hd: int) -> str:
    """The CUDA kernel that a call with this type and head dim launches,
    as a profiler names its template instance: the Hopper pipeline (TMA,
    wgmma, warp-specialised, persistent) for bf16 at hd 64 and 128,
    ``mma.sync`` for bf16 at hd 16 and 32, plain FMAs for fp32."""
    if _hopper(dtype, hd):
        return f"flash_fwd_wgmma_kernel<{hd}>"
    if dtype == torch.bfloat16:
        return f"flash_fwd_mma_kernel<{hd}>"
    return f"flash_fwd_kernel<{hd}>"


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int | None = None,
                    q_offset: int = 0) -> torch.Tensor:
    """q: (B, S, Hq, hd); k,v: (B, T, Hkv, hd) -> (B, S, Hq, hd) in q's
    dtype.  fp32 or bf16, hd in ``HEAD_DIMS``.  Key t sits at position t
    and query row r at ``q_offset + r`` (a shard of a sequence-parallel
    q; 0: causal masking top-left aligned); the masks compare
    positions."""
    no_dtensor("flash_attention", q, k, v)
    _check(q, k, v, window, q_offset)
    if q.device.type == "cpu":
        return attention_ref(q, k, v, causal=causal, window=window,
                             q_offset=q_offset)
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device or t.dtype != q.dtype:
            raise TypeError(f"{name} must be {q.dtype} on {q.device}, got "
                            f"{t.dtype} on {t.device}")
        if t.stride(3) != 1:
            raise ValueError(f"{name} needs a dense head dim, got strides "
                             f"{t.stride()}")
    if q.dtype not in _TYPE_FLAG:
        raise TypeError(f"flash_attention takes float32 or bfloat16, got "
                        f"{q.dtype}")
    if q.dtype == torch.bfloat16:           # TMA and 16-byte tile loads
        q, k, v = (aligned_rows(t) for t in (q, k, v))
    B, S, Hq, hd = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    # the Hopper kernel's blocks take work items from this counter, which
    # its launch sets to 0
    work = (torch.empty(1, dtype=torch.int32, device=q.device)
            if _hopper(q.dtype, hd) else None)
    call("flash_attention", _ARGTYPES, q.device,
         q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
         None if work is None else work.data_ptr(),
         *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
         *out.stride()[:3], B, Hq, Hkv, S, T, hd, int(causal),
         window or 0, int(q_offset), _TYPE_FLAG[q.dtype])
    count_launch(flash_attention)
    return out


flash_attention.launches = 0
