"""Gaussian-process Bayesian optimization with Expected Improvement.

A second Bayesian backend beside TPE (the paper plans 'future extensions to
additional frameworks').  Matérn-5/2 kernel on the unit cube, Cholesky
posterior in PyTorch on the sampler's device, EI acquisition maximized
over quasi-random candidates.

The covariance matrices go through ``repro_torch.core.kernels.
matern52_masked`` (one CUDA kernel launch each for K and Ks on the card,
masks and jitter diagonal included; its plain matmul-form version on the
CPU — no (A, B, D) pairwise-difference intermediate);
the Cholesky factor and the triangular solves are ``torch.linalg`` library
calls, as they were XLA library calls in the reference.  On the service
ask path the padded (X, y, mask) buffers come straight from the
per-study ``ObservationCache`` (pow-2 capacity).
"""
from __future__ import annotations

import math
from typing import Any

import numpy as np
import torch

from ..kernels import matern52_masked, resolve_device
from ..kernels._backend import load_cuda_linalg
from ..obs_cache import check_liar
from ..obs_cache import liar_value as _liar_value
from ..obs_cache import pad_pow2 as _pad_pow2
from ..space import SearchSpace
from ..types import Direction, Trial
from .base import Sampler
from .quasirandom import QuasiRandomSampler


def _gp_ei(X: torch.Tensor, y: torch.Tensor, mask: torch.Tensor,
           cands: torch.Tensor, ls: torch.Tensor) -> torch.Tensor:
    """Expected improvement of candidates under a GP fit to (X, y, mask)."""
    n = torch.clamp(mask.sum(), min=1.0)
    mu0 = (y * mask).sum() / n
    var0 = ((y - mu0) ** 2 * mask).sum() / n + 1e-12
    yn = (y - mu0) / torch.sqrt(var0)

    # padded rows and columns masked out, unit diag for padded rows
    K = matern52_masked(X, X, ls, mask, mask, jitter=1e-6 + 1e-3)
    L = torch.linalg.cholesky(K)
    alpha = torch.cholesky_solve((yn * mask)[:, None], L)[:, 0]

    Ks = matern52_masked(cands, X, ls, col_mask=mask)
    mu = Ks @ alpha
    v = torch.linalg.solve_triangular(L, Ks.T, upper=False)
    var = torch.clamp(1.0 - (v ** 2).sum(0), min=1e-9)
    sd = torch.sqrt(var)

    best = torch.min(torch.where(mask > 0, yn, math.inf))
    z = (best - mu) / sd
    phi = torch.exp(-0.5 * z ** 2) / math.sqrt(2 * math.pi)
    Phi = 0.5 * (1 + torch.special.erf(z / math.sqrt(2)))
    return sd * (z * Phi + phi)


class GPSampler(Sampler):
    uses_cache = True
    pending_aware = True

    # GP is O(n^3); beyond this many observations defer to quasirandom
    # exploration (TPE is the scalable default anyway).
    MAX_OBSERVATIONS = 512

    def __init__(self, n_startup_trials: int = 8, n_candidates: int = 256,
                 lengthscale: float = 0.25, seed: int = 0,
                 liar: str = "mean", device: str | None = None):
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            # before any thread fits a GP on the card (see the function)
            load_cuda_linalg(self.device)
        self.n_startup_trials = int(n_startup_trials)
        self.n_candidates = int(n_candidates)
        self.lengthscale = float(lengthscale)
        self.liar = check_liar(liar)
        self._startup = QuasiRandomSampler(seed=seed)

    def _padded_obs(self, space: SearchSpace, trials: list[Trial],
                    direction: Direction, cache: Any
                    ) -> tuple[np.ndarray, np.ndarray, np.ndarray, int,
                               float | None]:
        """(Xp, yp, mp, n_obs, liar) — pow-2 padded posterior evidence
        including the constant-liar fantasy rows for RUNNING trials."""
        if cache is not None:
            n_obs = cache.count
            if self.liar != "none":
                Xp, yp, mp = cache.padded_augmented()
                lv = cache.liar_value()
            else:
                Xp, yp, mp = cache.padded()
                lv = None
            return Xp, yp, mp, n_obs, lv
        X, y, n_obs = self.observations_pending(
            space, trials, direction, liar=self.liar)
        total = len(y)
        n = _pad_pow2(total)
        Xp = np.zeros((n, space.dim)); Xp[:total] = X
        yp = np.zeros(n); yp[:total] = y
        mp = np.zeros(n); mp[:total] = 1.0
        lv = (_liar_value(y[:n_obs], self.liar)
              if self.liar != "none" and n_obs else None)
        return Xp, yp, mp, n_obs, lv

    def _ei_argmax(self, space: SearchSpace, rng: np.random.Generator,
                   Xp: np.ndarray, yp: np.ndarray, mp: np.ndarray
                   ) -> np.ndarray:
        """Unit-cube point maximizing EI over one fresh Halton pool."""
        # one batched Halton draw — no per-candidate sampler construction
        qr = QuasiRandomSampler(seed=int(rng.integers(0, 2**31 - 1)))
        cands = qr.points(0, self.n_candidates, space.dim)
        # float32 as the reference computes (jnp.asarray with x64 off)
        X, y, m, c = (torch.as_tensor(a, dtype=torch.float32,
                                      device=self.device)
                      for a in (Xp, yp, mp, cands))
        ls = torch.full((space.dim,), self.lengthscale, dtype=torch.float32,
                        device=self.device)
        ei = _gp_ei(X, y, m, c, ls)
        return cands[int(np.argmax(ei.cpu().numpy()))]

    def speculative_ready(self, cache: Any) -> bool:
        return (self.liar != "none"
                and self.n_startup_trials <= cache.count
                <= self.MAX_OBSERVATIONS)

    def suggest(self, space: SearchSpace, trials: list[Trial],
                direction: Direction, rng: np.random.Generator,
                cache: Any = None) -> dict[str, Any]:
        Xp, yp, mp, n_obs, _ = self._padded_obs(
            space, trials, direction, cache)
        if n_obs < self.n_startup_trials or space.dim == 0 \
                or n_obs > self.MAX_OBSERVATIONS:
            return self._startup.suggest(space, trials, direction, rng)
        return space.from_unit_vector(
            self._ei_argmax(space, rng, Xp, yp, mp))

    def suggest_batch(self, space: SearchSpace, trials: list[Trial],
                      direction: Direction, rng: np.random.Generator,
                      n: int, cache: Any = None, chunk: int | None = None,
                      **kwargs: Any) -> list[dict[str, Any]]:
        """Fantasy-accumulating batch: after each pick the point is
        appended as a liar-valued observation, so the next EI round is
        repelled from it — n distinct proposals, not n argmax copies.
        ``chunk`` (the speculative streaming hint) is accepted for API
        parity with TPE and ignored: GP batches are inherently
        per-point fantasy updates."""
        Xp, yp, mp, n_obs, lv = self._padded_obs(
            space, trials, direction, cache)
        if lv is None or n_obs < self.n_startup_trials or space.dim == 0 \
                or n_obs > self.MAX_OBSERVATIONS:
            return super().suggest_batch(space, trials, direction, rng, n,
                                         cache=cache, **kwargs)
        # private copies: the padded views may be the cache's memoized
        # buffers and must not see our fantasy rows
        Xc, yc, mc = np.array(Xp), np.array(yp), np.array(mp)
        total = int(mc.sum())
        out: list[np.ndarray] = []
        for _ in range(n):
            pick = self._ei_argmax(space, rng, Xc, yc, mc)
            out.append(pick)
            if total == len(yc):          # grow to the next pow-2 shape
                cap = _pad_pow2(total + 1)
                Xg = np.zeros((cap, space.dim)); Xg[:total] = Xc[:total]
                yg = np.zeros(cap); yg[:total] = yc[:total]
                mg = np.zeros(cap); mg[:total] = mc[:total]
                Xc, yc, mc = Xg, yg, mg
            Xc[total], yc[total], mc[total] = pick, lv, 1.0
            total += 1
        return space.from_unit_matrix(np.stack(out))
