"""Matérn-5/2 cross-covariance for the GP sampler: CUDA kernel and plain
version.

Expanding the squared distance,

    d²[a,b] = |as_a|² + |bs_b|² - 2 as_a · bs_b     (as = a/ls, bs = b/ls)

turns the (A, B) kernel matrix into one (A, D)x(D, B) contraction plus
rank-1 terms.  ``csrc/matern.cu`` folds them into one augmented
contraction per output (aa = [-2·as, |as|², 1], bb = [bs, 1, |bs|²])
followed by the element-wise Matérn form.

``matern52_cross`` launches the kernel for CUDA tensors and takes the
plain version (``matern52_cross_plain``) only for CPU tensors.
"""
from __future__ import annotations

import math

import torch

from ._backend import check_cuda_operand, count_launch, launch

_SQRT5 = math.sqrt(5.0)


def _matern_form(d2: torch.Tensor) -> torch.Tensor:
    d = torch.sqrt(torch.clamp(d2, min=1e-12))
    s5d = _SQRT5 * d
    return (1.0 + s5d + s5d * s5d / 3.0) * torch.exp(-s5d)


def _terms(a: torch.Tensor, b: torch.Tensor, ls: torch.Tensor
           ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    as_ = a / ls
    bs = b / ls
    return as_, bs, (as_ * as_).sum(-1), (bs * bs).sum(-1)


def matern52_cross_plain(a: torch.Tensor, b: torch.Tensor, ls: torch.Tensor
                         ) -> torch.Tensor:
    """Plain PyTorch version of ``matern52_cross`` (any device)."""
    as_, bs, sa, sb = _terms(a, b, ls)
    d2 = sa[:, None] + sb[None, :] - 2.0 * (as_ @ bs.T)
    return _matern_form(d2)


def matern_cuda(aa: torch.Tensor, bb: torch.Tensor) -> torch.Tensor:
    """(A, B) Matérn form of ``aa @ bb.T``, computed by the CUDA kernel on
    the augmented operands."""
    check_cuda_operand(aa, "aa", 2)
    check_cuda_operand(bb, "bb", 2)
    if aa.shape[1] != bb.shape[1] or aa.device != bb.device:
        raise ValueError(f"aa {tuple(aa.shape)} and bb {tuple(bb.shape)} "
                         "need the same width and device")
    out = torch.empty((aa.shape[0], bb.shape[0]), device=aa.device,
                      dtype=torch.float32)
    launch("matern", aa, bb, out)
    count_launch(matern52_cross)
    return out


def matern52_cross(a: torch.Tensor, b: torch.Tensor, ls: torch.Tensor
                   ) -> torch.Tensor:
    """(A, B) Matérn-5/2 cross-covariance of two point sets on the unit
    cube with per-dim lengthscales ``ls``.  All float32 on one device: the
    CUDA kernel on a CUDA device, the plain version on the CPU."""
    if a.device.type == "cpu":
        return matern52_cross_plain(a, b, ls)
    for name, t in (("a", a), ("b", b), ("ls", ls)):
        if t.device != a.device or t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32 on {a.device}, got "
                            f"{t.dtype} on {t.device}")
    as_, bs, sa, sb = _terms(a, b, ls)
    aa = torch.cat([-2.0 * as_, sa[:, None], torch.ones_like(sa)[:, None]],
                   dim=1)
    bb = torch.cat([bs, torch.ones_like(sb)[:, None], sb[:, None]], dim=1)
    return matern_cuda(aa, bb)


matern52_cross.launches = 0
