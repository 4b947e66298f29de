"""The chunked Mamba2 SSD scan in the model layout: the CUDA kernel for
CUDA tensors, the plain version (``ref.ssd_ref``) for CPU tensors.

``ssd`` keeps the reference's signature and model layout (x (b, S, nh,
hd)).  The reference's wrapper precomputes the dt-weighted x and the
in-chunk log-decay cumsum and moves heads in front of the sequence; the
kernel does both itself, inside the block that walks the chunks, and
reads x, dt, B and C through their strides, so nothing is copied here.
Which kernel a call launches depends on its type and dims alone
(``kernel_symbol``): bf16 at hd and ds 16, 32 and 64 takes the
tensor-core kernel, which loads x, B and C with 16-byte ``cp.async``
copies and so needs every row on a 16-byte boundary (the model's views
of its fused projection have it); a bf16 view that breaks the rule is
copied once.  The kernel is forward-only, as the TPU kernel is: with
autograd recording and an input that requires grad, the op raises.
"""
from __future__ import annotations

import ctypes

import torch

from ...core.kernels._backend import (aligned_rows, call, count_launch,
                                      no_dtensor)
from . import ref

MAX_CHUNK = 64
DIMS = (16, 32, 64, 128)            # the hd and ds the kernels are built for
MMA_DIMS = (16, 32, 64)             # bf16 on tensor cores
_TYPE_FLAG = {torch.float32: 0, torch.bfloat16: 1}
# (x, dt, a_log, B, C, y, h_final, x/dt/y (b, s, h) strides, B/C (b, s)
#  strides, batch, S, nh, hd, ds, chunk, is_bf16, stream) -> cudaError_t
_ARGTYPES = ((ctypes.c_void_p,) * 7 + (ctypes.c_int64,) * 13
             + (ctypes.c_int,) * 7 + (ctypes.c_void_p,))


def _check(x: torch.Tensor, dt: torch.Tensor, a_log: torch.Tensor,
           B: torch.Tensor, C: torch.Tensor, chunk: int) -> int:
    """Shapes as the reference takes them; returns the chunk length."""
    if x.dim() != 4:
        raise ValueError(f"x must be (b, S, nh, hd), got {tuple(x.shape)}")
    b, S, nh, _ = x.shape
    if (dt.shape != (b, S, nh) or a_log.shape != (nh,)
            or B.dim() != 3 or B.shape[:2] != (b, S) or C.shape != B.shape):
        raise ValueError(
            f"expected dt (b, S, nh), a_log (nh,), B and C (b, S, ds) for x "
            f"{tuple(x.shape)}, got {tuple(dt.shape)}, {tuple(a_log.shape)}, "
            f"{tuple(B.shape)}, {tuple(C.shape)}")
    if S == 0 or chunk < 1:
        raise ValueError(f"need S >= 1 and chunk >= 1, got S {S}, chunk "
                         f"{chunk}")
    Q = min(chunk, S)
    if S % Q:
        raise ValueError(f"seq {S} not divisible by chunk {Q}")
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, dt, a_log, B, C)):
        raise RuntimeError("ssd is forward-only (the kernel has no "
                           "backward); run it under torch.no_grad() or use "
                           "ssm_impl='ref' for gradients")
    return Q


def _tensor_cores(dtype: torch.dtype, hd: int, ds: int) -> bool:
    return dtype == torch.bfloat16 and hd in MMA_DIMS and ds in MMA_DIMS


def kernel_symbol(dtype: torch.dtype, hd: int, ds: int) -> str:
    """The CUDA kernel that a call with this type, head dim and state
    dim launches, as a profiler names its template instance: tensor
    cores (mma.sync, cp.async) for bf16 with hd and ds in ``MMA_DIMS``,
    plain float32 FMAs otherwise."""
    if _tensor_cores(dtype, hd, ds):
        return f"ssd_mma_kernel<{hd}, {ds}>"
    if dtype == torch.bfloat16:
        return f"ssd_fwd_kernel<__nv_bfloat16, {hd}, {ds}>"
    return f"ssd_fwd_kernel<float, {hd}, {ds}>"


def ssd(x: torch.Tensor, dt: torch.Tensor, a_log: torch.Tensor,
        B: torch.Tensor, C: torch.Tensor, *, chunk: int = 64
        ) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (b,S,nh,hd); dt: (b,S,nh); a_log: (nh,); B,C: (b,S,ds).
    -> (y (b,S,nh,hd) in x's dtype, h_final (b,nh,hd,ds) float32).
    Matches ``ref.ssd_ref``.  x, dt, B and C share one type, float32 or
    bfloat16; the kernel takes chunk <= 64 and hd, ds in ``DIMS``."""
    no_dtensor("ssd", x, dt, a_log, B, C)
    Q = _check(x, dt, a_log, B, C, chunk)
    if x.device.type == "cpu":
        return ref.ssd_ref(x, dt, a_log, B, C)
    for name, t in (("dt", dt), ("B", B), ("C", C)):
        if t.device != x.device or t.dtype != x.dtype:
            raise TypeError(f"{name} must be {x.dtype} on {x.device}, got "
                            f"{t.dtype} on {t.device}")
    if x.dtype not in _TYPE_FLAG:
        raise TypeError(f"ssd takes float32 or bfloat16, got {x.dtype}")
    b, S, nh, hd = x.shape
    ds = B.shape[-1]
    if Q > MAX_CHUNK or hd not in DIMS or ds not in DIMS:
        raise ValueError(f"the ssd kernel takes chunk <= {MAX_CHUNK} and "
                         f"hd, ds in {DIMS}; got chunk {Q}, hd {hd}, ds {ds}")
    if x.stride(3) != 1 or B.stride(2) != 1 or C.stride(2) != 1:
        raise ValueError("x, B and C need a dense last dim")
    if _tensor_cores(x.dtype, hd, ds):  # cp.async rows
        x, B, C = (aligned_rows(t) for t in (x, B, C))
    a32 = a_log.to(device=x.device, dtype=torch.float32).contiguous()
    y = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    h = torch.empty((b, nh, hd, ds), dtype=torch.float32, device=x.device)
    call("ssd", _ARGTYPES, x.device,
         x.data_ptr(), dt.data_ptr(), a32.data_ptr(), B.data_ptr(),
         C.data_ptr(), y.data_ptr(), h.data_ptr(),
         *x.stride()[:3], *dt.stride(), *y.stride()[:3],
         *B.stride()[:2], *C.stride()[:2],
         b, S, nh, hd, ds, Q, _TYPE_FLAG[x.dtype])
    count_launch(ssd)
    return y, h


ssd.launches = 0
