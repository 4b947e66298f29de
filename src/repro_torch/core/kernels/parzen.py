"""Masked TPE Parzen-mixture log-density and the TPE acquisition score:
one CUDA kernel and their plain versions.

The TPE acquisition scores C candidates against N observations under a
per-dimension Gaussian mixture:

    out[c] = logsumexp_n[ sum_d( -0.5 z²  - log(bw_d √2π) ) ],
    z = (x[c,d] - obs[n,d]) / bw_d

Expanding the square turns the inner sum into one (C, D)x(D, N)
contraction plus rank-1 terms:

    logk[c,n] = xs_c · os_n - 0.5|xs_c|² - (0.5|os_n|² + Σ_d log(bw_d√2π))
    (xs = x / bw, os = obs / bw)

``csrc/parzen.cu`` computes that with an online logsumexp from the raw
operands (x, obs, mask, bw) and never writes the (C, N) score matrix.
The same kernel, given the good and the bad mixture, writes the whole
proposal round's score (``tpe_score``): each side adds the uniform
prior and the 1/(n + 1) weight, and the score is log l(x) - log g(x).

Each op launches the kernel for CUDA tensors (one launch per call) and
takes its plain version only for CPU tensors: ``parzen_log_density_plain``
(the same matmul form with ``where(mask)`` and ``logsumexp``) and
``tpe_score_plain`` (two such calls and the prior, in PyTorch ops).  A
fully masked mixture gives -inf on both routes.
"""
from __future__ import annotations

import ctypes
import math

import torch

from ._backend import call, count_launch, no_dtensor

CLUSTER = 8            # blocks of a cluster: the row slices of one tile
THREADS = 256          # threads of a block
MAX_DIM = 512          # widest point the kernel takes
# dynamic shared memory for a block's tiles: what a launch takes without
# opting in (48 KB less the static arrays), else what it may opt in to
_SMEM_BYTES = (43 * 1024, 200 * 1024)
_ARGTYPES = ((ctypes.c_void_p, ctypes.c_int, ctypes.c_int)
             + (ctypes.c_void_p,) * 3 + (ctypes.c_int,)
             + (ctypes.c_void_p,) * 3 + (ctypes.c_int,) * 4
             + (ctypes.c_void_p,) * 2)


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


def _log_parzen_prior(x: torch.Tensor, obs: torch.Tensor,
                      mask: torch.Tensor, bw: torch.Tensor) -> torch.Tensor:
    """Mixture log-density plus the uniform-prior component (a wide
    Gaussian at the cube center with weight 1, Optuna's
    ``prior_weight``): without it the l/g ratio over-exploits the
    incumbent cluster and TPE degenerates to local search."""
    logk = parzen_log_density_plain(x, obs, mask, bw)
    zp = x - 0.5
    logp = (-0.5 * zp * zp - math.log(math.sqrt(2 * math.pi))).sum(-1)
    n = torch.clamp(mask.sum(), min=1.0)
    return torch.logaddexp(logk, logp) - torch.log(n + 1.0)


def tpe_score_plain(cands: torch.Tensor, xg: torch.Tensor, mg: torch.Tensor,
                    xb: torch.Tensor, mb: torch.Tensor, bw: torch.Tensor,
                    bw_b: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of ``tpe_score`` (any device)."""
    return (_log_parzen_prior(cands, xg, mg, bw)
            - _log_parzen_prior(cands, xb, mb, bw_b))


def plan(c: int, d: int, n_rows: int) -> tuple[int, int, int]:
    """(cb, slice, tile) of a launch over C candidates of width D and
    ``n_rows`` observation rows (both mixtures together): cb candidates
    per cluster (a power of two up to 16, so that about 16 clusters
    cover C), ``slice`` rows per cluster rank, and ``tile`` rows staged
    in shared memory at a time (a multiple of 32, at most 2048: the
    service's slices of ~1028 rows fit one tile)."""
    if not 1 <= d <= MAX_DIM:
        raise ValueError(f"points of width {d}: the Parzen kernel takes "
                         f"1 to {MAX_DIM}")
    cb = 1
    while cb < 16 and cb * 16 < c:
        cb *= 2
    slice_ = -(-n_rows // CLUSTER)
    fixed = 4 * (2 * cb * d + 2 * d)
    for budget in _SMEM_BYTES:
        tile = min(2048, (budget - fixed) // (4 * (d + 1)) // 32 * 32)
        if tile >= 256:
            break
    return cb, slice_, tile


def _check(x: torch.Tensor, mixtures: list[tuple[torch.Tensor, ...]]
           ) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"x must be on a CUDA device, got {x.device}")
    if x.dim() != 2:
        raise ValueError(f"x must be (C, D), got {tuple(x.shape)}")
    d = x.shape[1]
    checks = [("x", x, x.shape)]
    for obs, mask, bw in mixtures:
        checks += [("obs", obs, (None, d)), ("mask", mask, (obs.shape[0],)),
                   ("bw", bw, (d,))]
    for name, t, shape in checks:
        if t.device != x.device or t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32 on {x.device}, got "
                            f"{t.dtype} on {t.device}")
        if t.dim() != len(shape) or any(want is not None and got != want
                                        for got, want in zip(t.shape, shape)):
            raise ValueError(f"{name} has shape {tuple(t.shape)}; x is "
                             f"{tuple(x.shape)}")


def _parzen_cuda(x: torch.Tensor, mixtures: list[tuple[torch.Tensor, ...]]
                 ) -> torch.Tensor:
    """One launch of the kernel: logk of one mixture, or the TPE score of
    two ([good, bad])."""
    _check(x, mixtures)
    c, d = x.shape
    out = torch.empty(c, device=x.device, dtype=torch.float32)
    if c == 0:
        return out
    cb, slice_, tile = plan(c, d, sum(m[0].shape[0] for m in mixtures))
    # contiguous operands, held until the launch is enqueued
    x = x.contiguous()
    ops = [tuple(t.contiguous() for t in m) for m in mixtures]
    args: list = []
    for obs, mask, bw in ops:
        args += [obs.data_ptr(), mask.data_ptr(), bw.data_ptr(),
                 obs.shape[0]]
    args += [None, None, None, 0] * (2 - len(ops))
    call("parzen", _ARGTYPES, x.device, x.data_ptr(), c, d, *args, cb,
         slice_, tile, out.data_ptr())
    return out


def parzen_log_density(x: torch.Tensor, obs: torch.Tensor,
                       mask: torch.Tensor, bw: torch.Tensor) -> torch.Tensor:
    """(C,) masked Parzen-mixture log-density of candidates ``x``.

    x: (C, D) candidates; obs: (N, D) observations (padded);
    mask: (N,) validity; bw: (D,) per-dim bandwidths.  All float32 on one
    device: one kernel launch on a CUDA device, the plain version on the
    CPU.
    """
    no_dtensor("parzen_log_density", x, obs, mask, bw)
    if x.device.type == "cpu":
        return parzen_log_density_plain(x, obs, mask, bw)
    out = _parzen_cuda(x, [(obs, mask, bw)])
    count_launch(parzen_log_density)
    return out


def tpe_score(cands: torch.Tensor, xg: torch.Tensor, mg: torch.Tensor,
              xb: torch.Tensor, mb: torch.Tensor, bw: torch.Tensor,
              bw_b: torch.Tensor) -> torch.Tensor:
    """(C,) TPE acquisition  log l(x) - log g(x)  of the candidates, each
    side the mixture log-density with the uniform prior, weighted by
    1/(n + 1).

    cands: (C, D); xg: (Ng, D), mg: (Ng,) the good rows and their
    validity, bw: (D,) their bandwidths; xb, mb, bw_b the bad mixture's.
    All float32 on one device: one kernel launch on a CUDA device, the
    plain version on the CPU.
    """
    no_dtensor("tpe_score", cands, xg, mg, xb, mb, bw, bw_b)
    if cands.device.type == "cpu":
        return tpe_score_plain(cands, xg, mg, xb, mb, bw, bw_b)
    out = _parzen_cuda(cands, [(xg, mg, bw), (xb, mb, bw_b)])
    count_launch(tpe_score)
    return out


parzen_log_density.launches = 0
tpe_score.launches = 0
