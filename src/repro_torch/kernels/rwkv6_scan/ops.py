"""The chunked RWKV6 WKV scan in the model layout: the CUDA kernel for
CUDA tensors, the plain version (``ref.wkv6_ref``) for CPU tensors.

``wkv6`` keeps the reference's signature and model layout (r (b, S, nh,
hd)).  The reference's wrapper precomputes the in-chunk decay cumsum and
moves heads in front of the sequence, and hands a carried state ``S0``
to the plain chunked form; the kernel does the cumsum inside the block
that walks the chunks, reads r, k, v and logw through their strides, and
takes ``S0`` itself (zero when absent), so a CUDA tensor never reaches
the plain version.  Which kernel a call launches depends on its type and
head dim alone (``kernel_symbol``): bf16 at hd 16, 32 and 64 takes the
tensor-core kernel, which loads its tiles with 16-byte ``cp.async``
copies and so needs every (b, s, h) row on a 16-byte boundary; a bf16
view that breaks the rule is copied once.  The kernel is forward-only,
as the TPU kernel is: with autograd recording and an input that requires
grad, the op raises.
"""
from __future__ import annotations

import ctypes

import torch

from ...core.kernels._backend import (aligned_rows, call, count_launch,
                                      no_dtensor)
from . import ref

MAX_CHUNK = 64
HEAD_DIMS = (16, 32, 64, 128)       # the hd the kernels are built for
MMA_HEAD_DIMS = (16, 32, 64)        # bf16 on tensor cores
_TYPE_FLAG = {torch.float32: 0, torch.bfloat16: 1}
# (r, k, v, logw, u, S0 or NULL, o, S_final, r/k/v/logw/o (b, s, h)
#  strides, batch, S, nh, hd, chunk, is_bf16, stream) -> cudaError_t
_ARGTYPES = ((ctypes.c_void_p,) * 8 + (ctypes.c_int64,) * 15
             + (ctypes.c_int,) * 6 + (ctypes.c_void_p,))


def _check(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           logw: torch.Tensor, u: torch.Tensor, S0: torch.Tensor | None,
           chunk: int) -> int:
    """Shapes as the reference takes them; returns the chunk length."""
    if r.dim() != 4 or not (r.shape == k.shape == v.shape == logw.shape):
        raise ValueError(f"r, k, v and logw must share one (b, S, nh, hd) "
                         f"shape, got {tuple(r.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}, {tuple(logw.shape)}")
    b, S, nh, hd = r.shape
    if u.shape != (nh, hd):
        raise ValueError(f"u must be (nh, hd) = {(nh, hd)}, got "
                         f"{tuple(u.shape)}")
    if S0 is not None and S0.shape != (b, nh, hd, hd):
        raise ValueError(f"S0 must be (b, nh, hd, hd) = {(b, nh, hd, hd)}, "
                         f"got {tuple(S0.shape)}")
    if S == 0 or chunk < 1:
        raise ValueError(f"need S >= 1 and chunk >= 1, got S {S}, chunk "
                         f"{chunk}")
    Q = min(chunk, S)
    if S % Q:
        raise ValueError(f"seq {S} not divisible by chunk {Q}")
    operands = (r, k, v, logw, u) + (() if S0 is None else (S0,))
    if torch.is_grad_enabled() and any(t.requires_grad for t in operands):
        raise RuntimeError("wkv6 is forward-only (the kernel has no "
                           "backward); run it under torch.no_grad() or use "
                           "ssm_impl='ref' for gradients")
    return Q


def _tensor_cores(dtype: torch.dtype, hd: int) -> bool:
    return dtype == torch.bfloat16 and hd in MMA_HEAD_DIMS


def kernel_symbol(dtype: torch.dtype, hd: int) -> str:
    """The CUDA kernel that a call with this type and head dim launches,
    as a profiler names its template instance: tensor cores (mma.sync,
    cp.async, the decay factored over sub-blocks) for bf16 at hd 16, 32
    and 64, plain float32 FMAs for fp32 and for bf16 at hd 128."""
    if _tensor_cores(dtype, hd):
        return f"wkv6_mma_kernel<{hd}>"
    if dtype == torch.bfloat16:
        return f"wkv6_fwd_kernel<__nv_bfloat16, {hd}>"
    return f"wkv6_fwd_kernel<float, {hd}>"


def wkv6(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
         logw: torch.Tensor, u: torch.Tensor, *, chunk: int = 32,
         S0: torch.Tensor | None = None
         ) -> tuple[torch.Tensor, torch.Tensor]:
    """r,k,v,logw: (b,S,nh,hd); u: (nh,hd); S0: (b,nh,hd,hd) or None.
    -> (o (b,S,nh,hd) in r's dtype, S_final (b,nh,hd,hd) float32).
    Matches ``ref.wkv6_ref``.  r, k, v and logw share one type, float32
    or bfloat16; the kernel takes chunk <= 64 and hd in ``HEAD_DIMS``."""
    no_dtensor("wkv6", r, k, v, logw, u, S0)
    Q = _check(r, k, v, logw, u, S0, chunk)
    if r.device.type == "cpu":
        return ref.wkv6_ref(r, k, v, logw, u, S0)
    for name, t in (("k", k), ("v", v), ("logw", logw)):
        if t.device != r.device or t.dtype != r.dtype:
            raise TypeError(f"{name} must be {r.dtype} on {r.device}, got "
                            f"{t.dtype} on {t.device}")
        if t.stride(3) != 1:
            raise ValueError(f"{name} needs a dense head dim")
    if r.dtype not in _TYPE_FLAG:
        raise TypeError(f"wkv6 takes float32 or bfloat16, got {r.dtype}")
    b, S, nh, hd = r.shape
    if Q > MAX_CHUNK or hd not in HEAD_DIMS or r.stride(3) != 1:
        raise ValueError(f"the wkv6 kernel takes chunk <= {MAX_CHUNK}, hd in "
                         f"{HEAD_DIMS} and a dense head dim; got chunk {Q}, "
                         f"hd {hd}, strides {r.stride()}")
    if _tensor_cores(r.dtype, hd):  # cp.async rows
        r, k, v, logw = (aligned_rows(t) for t in (r, k, v, logw))
    dev = r.device
    u32 = u.to(device=dev, dtype=torch.float32).contiguous()
    s0 = (None if S0 is None
          else S0.to(device=dev, dtype=torch.float32).contiguous())
    o = torch.empty(r.shape, dtype=r.dtype, device=dev)
    s_fin = torch.empty((b, nh, hd, hd), dtype=torch.float32, device=dev)
    call("wkv6", _ARGTYPES, dev,
         r.data_ptr(), k.data_ptr(), v.data_ptr(), logw.data_ptr(),
         u32.data_ptr(), None if s0 is None else s0.data_ptr(),
         o.data_ptr(), s_fin.data_ptr(),
         *(st for t in (r, k, v, logw, o) for st in t.stride()[:3]),
         b, S, nh, hd, Q, _TYPE_FLAG[r.dtype])
    count_launch(wkv6)
    return o, s_fin


wkv6.launches = 0
