"""Matérn-5/2 cross-covariance for the GP sampler, unmasked and with the
GP's masks: one CUDA kernel and the plain versions.

Expanding the squared distance,

    d²[a,b] = |as_a|² + |bs_b|² - 2 as_a · bs_b     (as = a/ls, bs = b/ls)

turns the (A, B) kernel matrix into one (A, D)x(D, B) contraction plus
rank-1 terms.  ``csrc/matern.cu`` computes it from the raw operands
(a, b, ls), applies the element-wise Matérn form and, for
``matern52_masked``, the GP's masks and jitter diagonal in the same
launch.

``matern52_cross`` and ``matern52_masked`` launch the kernel for CUDA
tensors (one launch per call) and take their plain versions
(``matern52_cross_plain``, ``matern52_masked_plain``) only for CPU
tensors.
"""
from __future__ import annotations

import ctypes
import math

import torch

from ._backend import call, count_launch, no_dtensor

_SQRT5 = math.sqrt(5.0)
MAX_DIM = 512          # widest point the kernel takes
_ARGTYPES = ((ctypes.c_void_p,) * 5 + (ctypes.c_float, ctypes.c_int,
                                       ctypes.c_void_p)
             + (ctypes.c_int,) * 3 + (ctypes.c_void_p,))


def _matern_form(d2: torch.Tensor) -> torch.Tensor:
    d = torch.sqrt(torch.clamp(d2, min=1e-12))
    s5d = _SQRT5 * d
    return (1.0 + s5d + s5d * s5d / 3.0) * torch.exp(-s5d)


def matern52_cross_plain(a: torch.Tensor, b: torch.Tensor, ls: torch.Tensor
                         ) -> torch.Tensor:
    """Plain PyTorch version of ``matern52_cross`` (any device)."""
    as_ = a / ls
    bs = b / ls
    sa = (as_ * as_).sum(-1)
    sb = (bs * bs).sum(-1)
    d2 = sa[:, None] + sb[None, :] - 2.0 * (as_ @ bs.T)
    return _matern_form(d2)


def matern52_masked_plain(a: torch.Tensor, b: torch.Tensor,
                          ls: torch.Tensor,
                          row_mask: torch.Tensor | None = None,
                          col_mask: torch.Tensor | None = None,
                          jitter: float | None = None) -> torch.Tensor:
    """Plain PyTorch version of ``matern52_masked`` (any device): the
    GP sampler's composition of the unmasked form with its masks."""
    k = matern52_cross_plain(a, b, ls)
    if row_mask is not None:
        k = torch.where(row_mask[:, None] > 0, k, 0.0)
    if col_mask is not None:
        k = torch.where(col_mask[None, :] > 0, k, 0.0)
    if jitter is not None:
        k = k + torch.diag(torch.where(row_mask > 0, jitter, 1.0))
    return k


def _matern_cuda(a: torch.Tensor, b: torch.Tensor, ls: torch.Tensor,
                 row_mask: torch.Tensor | None,
                 col_mask: torch.Tensor | None,
                 jitter: float | None) -> torch.Tensor:
    """One launch of the kernel."""
    if a.device.type != "cuda":
        raise ValueError(f"a must be on a CUDA device, got {a.device}")
    if a.dim() != 2 or not 1 <= a.shape[1] <= MAX_DIM:
        raise ValueError(f"a must be (A, D) with 1 <= D <= {MAX_DIM}, got "
                         f"{tuple(a.shape)}")
    na, d = a.shape
    nb = b.shape[0] if b.dim() == 2 else -1
    for name, t, shape in (("a", a, (na, d)), ("b", b, (nb, d)),
                           ("ls", ls, (d,)), ("row_mask", row_mask, (na,)),
                           ("col_mask", col_mask, (nb,))):
        if t is None:
            continue
        if t.device != a.device or t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32 on {a.device}, got "
                            f"{t.dtype} on {t.device}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}; a is "
                             f"{tuple(a.shape)}, b {tuple(b.shape)}")
    if jitter is not None and (row_mask is None or na != nb):
        raise ValueError("the jitter diagonal needs a row mask and a "
                         "square output")
    # contiguous operands, held until the launch is enqueued
    ops = [None if t is None else t.contiguous()
           for t in (a, b, ls, row_mask, col_mask)]
    out = torch.empty((na, nb), device=a.device, dtype=torch.float32)
    call("matern", _ARGTYPES, a.device,
         *(None if t is None else t.data_ptr() for t in ops),
         0.0 if jitter is None else jitter, int(jitter is not None),
         out.data_ptr(), na, nb, d)
    return out


def matern52_cross(a: torch.Tensor, b: torch.Tensor, ls: torch.Tensor
                   ) -> torch.Tensor:
    """(A, B) Matérn-5/2 cross-covariance of two point sets on the unit
    cube with per-dim lengthscales ``ls``.  All float32 on one device: one
    kernel launch on a CUDA device, the plain version on the CPU."""
    no_dtensor("matern52_cross", a, b, ls)
    if a.device.type == "cpu":
        return matern52_cross_plain(a, b, ls)
    out = _matern_cuda(a, b, ls, None, None, None)
    count_launch(matern52_cross)
    return out


def matern52_masked(a: torch.Tensor, b: torch.Tensor, ls: torch.Tensor,
                    row_mask: torch.Tensor | None = None,
                    col_mask: torch.Tensor | None = None,
                    jitter: float | None = None) -> torch.Tensor:
    """``matern52_cross`` masked as the GP sampler needs it.

    Entries whose row or column is padding (mask 0; masks hold 0 or 1)
    are 0; with ``jitter`` (a square output and a row mask) the diagonal
    gets ``jitter`` where the row is valid and 1.0 where it is padding.
    All float32 on one device: one kernel launch on a CUDA device, the
    plain version on the CPU.
    """
    no_dtensor("matern52_masked", a, b, ls, row_mask, col_mask)
    if a.device.type == "cpu":
        return matern52_masked_plain(a, b, ls, row_mask, col_mask, jitter)
    out = _matern_cuda(a, b, ls, row_mask, col_mask, jitter)
    count_launch(matern52_masked)
    return out


matern52_cross.launches = 0
matern52_masked.launches = 0
