"""Masked TPE Parzen-mixture log-density: CUDA kernel and plain version.

The TPE acquisition scores C candidates against N observations under a
per-dimension Gaussian mixture:

    out[c] = logsumexp_n[ sum_d( -0.5 z²  - log(bw_d √2π) ) ],
    z = (x[c,d] - obs[n,d]) / bw_d

Expanding the square turns the inner sum into one (C, D)x(D, N)
contraction plus rank-1 terms:

    logk[c,n] = xs_c · os_n - 0.5|xs_c|² - (0.5|os_n|² + Σ_d log(bw_d√2π))
    (xs = x / bw, os = obs / bw)

The per-candidate term is pulled out of the logsumexp and the
per-observation term is folded into the contraction by augmenting each
operand with one column (xa = [xs, -1], oa = [os, so]); padding rows get
``so = +1e30``.  ``csrc/parzen.cu`` runs that contraction with an online
logsumexp and never writes the (C, N) score matrix.

``parzen_log_density`` launches the kernel for CUDA tensors and takes
the plain version (``parzen_log_density_plain``, the same matmul form
with ``where(mask)`` and ``logsumexp``) only for CPU tensors.  One known
difference: for a fully masked row the plain version gives -inf and the
kernel about -1e30; callers always have at least one valid row.
"""
from __future__ import annotations

import math

import torch

from ._backend import check_cuda_operand, count_launch, launch

MASKED_SO = 1e30


def _terms(x: torch.Tensor, obs: torch.Tensor, bw: torch.Tensor
           ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    xs = x / bw
    os_ = obs / bw
    sx = 0.5 * (xs * xs).sum(-1)                                   # (C,)
    log_norm = torch.log(bw * math.sqrt(2 * math.pi)).sum()
    so = 0.5 * (os_ * os_).sum(-1) + log_norm                      # (N,)
    return xs, os_, sx, so


def parzen_log_density_plain(x: torch.Tensor, obs: torch.Tensor,
                             mask: torch.Tensor, bw: torch.Tensor
                             ) -> torch.Tensor:
    """Plain PyTorch version of ``parzen_log_density`` (any device)."""
    xs, os_, sx, so = _terms(x, obs, bw)
    s = xs @ os_.T - so[None, :]                                   # (C, N)
    s = torch.where(mask[None, :] > 0, s, -math.inf)
    return torch.logsumexp(s, dim=1) - sx


def parzen_lse_cuda(xa: torch.Tensor, oa: torch.Tensor) -> torch.Tensor:
    """(C,) ``log(max(Σ_n exp(s - m), 1e-37)) + m`` of ``s = xa @ oa.T``,
    computed by the CUDA kernel on the augmented operands."""
    check_cuda_operand(xa, "xa", 2)
    check_cuda_operand(oa, "oa", 2)
    if xa.shape[1] != oa.shape[1] or xa.device != oa.device:
        raise ValueError(f"xa {tuple(xa.shape)} and oa {tuple(oa.shape)} "
                         "need the same width and device")
    out = torch.empty(xa.shape[0], device=xa.device, dtype=torch.float32)
    launch("parzen", xa, oa, out)
    count_launch(parzen_log_density)
    return out


def parzen_log_density(x: torch.Tensor, obs: torch.Tensor,
                       mask: torch.Tensor, bw: torch.Tensor) -> torch.Tensor:
    """(C,) masked Parzen-mixture log-density of candidates ``x``.

    x: (C, D) candidates; obs: (N, D) observations (padded);
    mask: (N,) validity; bw: (D,) per-dim bandwidths.  All float32 on one
    device: the CUDA kernel on a CUDA device, the plain version on the CPU.
    """
    if x.device.type == "cpu":
        return parzen_log_density_plain(x, obs, mask, bw)
    for name, t in (("x", x), ("obs", obs), ("mask", mask), ("bw", bw)):
        if t.device != x.device or t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32 on {x.device}, got "
                            f"{t.dtype} on {t.device}")
    xs, os_, sx, so = _terms(x, obs, bw)
    so_masked = torch.where(mask > 0, so, MASKED_SO)
    xa = torch.cat([xs, -torch.ones_like(sx)[:, None]], dim=1)
    oa = torch.cat([os_, so_masked[:, None]], dim=1)
    return parzen_lse_cuda(xa, oa) - sx


parzen_log_density.launches = 0
