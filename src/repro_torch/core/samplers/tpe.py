"""Tree-structured Parzen Estimator (Bergstra et al. 2011) — the Optuna
default sampler the paper's reference implementation relies on.

The surrogate math runs in PyTorch on the sampler's device: trial
histories are padded to power-of-two lengths and cast to float32, and
a proposal round's acquisition scores go through
``repro_torch.core.kernels.tpe_score`` — one CUDA kernel launch on the
card that scores both Parzen mixtures from the raw split buffers
(online logsumexp over the observations, no (C, N) or (C, N, D)
intermediate), and two plain matmul-form ``parzen_log_density`` calls
on the CPU.

On the service ask path the observation matrix comes from the per-study
``ObservationCache`` (``cache=`` kwarg): history featurization is an O(1)
incremental append on tell, not a per-ask rescan of every trial.

Model: completed observations are split into the best ``gamma``-fraction
(l, "good") and the rest (g, "bad").  Each set defines a per-dimension
Parzen mixture (truncated Gaussians on the unit cube; categorical weights
for discrete dims).  ``n_candidates`` points are drawn from l(x) and the
one maximizing  log l(x) - log g(x)  (equivalently EI) is suggested.
"""
from __future__ import annotations

import math
from typing import Any

import numpy as np
import torch

from ..kernels import resolve_device, tpe_score
from ..obs_cache import check_liar, liar_value
from ..obs_cache import pad_pow2 as _pad_pow2
from ..space import SearchSpace
from ..types import Direction, Trial
from .base import Sampler
from .quasirandom import QuasiRandomSampler


def _bandwidth(obs: torch.Tensor, mask: torch.Tensor, lo: float,
               hi: float) -> torch.Tensor:
    d = obs.shape[1]
    n = torch.clamp(mask.sum(), min=1.0)
    mean = (obs * mask[:, None]).sum(0) / n
    var = ((obs - mean) ** 2 * mask[:, None]).sum(0) / n
    return torch.clamp(torch.sqrt(var + 1e-12) * n ** (-1.0 / (d + 4)),
                       lo, hi)


def _tpe_candidates(xg: torch.Tensor, mg: torch.Tensor, xb: torch.Tensor,
                    mb: torch.Tensor, generator: torch.Generator,
                    n_candidates: int
                    ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(cands, bw, bw_b): ``n_candidates`` unit-cube points, 3/4 sampled
    from l(x) (a good point plus bandwidth jitter), every fourth uniform;
    and the good and bad mixtures' bandwidths.

    xg: (Ng, D) good observations (padded), mg: (Ng,) validity mask.
    xb: (Nb, D) bad observations (padded),  mb: (Nb,) validity mask.
    """
    d = xg.shape[1]
    bw = _bandwidth(xg, mg, 0.05, 0.5)
    bw_b = _bandwidth(xb, mb, 0.08, 0.7)
    ng = torch.clamp(mg.sum(), min=1.0)
    idx = torch.multinomial(mg / ng + 1e-20, n_candidates, replacement=True,
                            generator=generator)
    noise = torch.randn((n_candidates, d), generator=generator,
                        device=xg.device) * bw
    from_l = torch.clamp(xg[idx] + noise, 0.0, 1.0)
    uniform = torch.rand((n_candidates, d), generator=generator,
                         device=xg.device)
    take_l = (torch.arange(n_candidates, device=xg.device) % 4 != 3)[:, None]
    return torch.where(take_l, from_l, uniform), bw, bw_b


# (C,) acquisition  log l(x) - log g(x)  of a round's candidates, each
# side with the uniform-prior component (Optuna's ``prior_weight``)
_tpe_score = tpe_score


def _tpe_propose(xg: torch.Tensor, mg: torch.Tensor, xb: torch.Tensor,
                 mb: torch.Tensor, seed: int, n_candidates: int
                 ) -> np.ndarray:
    """(n_candidates, D) unit-cube candidates, best acquisition score
    first (stable order on ties); the caller slices the top-k it needs."""
    gen = torch.Generator(device=xg.device)
    gen.manual_seed(seed)
    cands, bw, bw_b = _tpe_candidates(xg, mg, xb, mb, gen, n_candidates)
    score = _tpe_score(cands, xg, mg, xb, mb, bw, bw_b)
    return cands[torch.argsort(-score, stable=True)].cpu().numpy()


class TPESampler(Sampler):
    uses_cache = True
    pending_aware = True

    def __init__(self, n_startup_trials: int = 10, gamma: float | None = None,
                 n_candidates: int = 64, seed: int = 0, liar: str = "mean",
                 liar_chunk: int = 4, device: str | None = None):
        self.device = resolve_device(device)
        self.n_startup_trials = int(n_startup_trials)
        self.gamma = gamma                 # None -> Optuna default schedule
        self.n_candidates = int(n_candidates)
        self.liar = check_liar(liar)
        # batched asks re-split after every `liar_chunk` fantasy appends:
        # within a chunk the proposals are distinct top-scored candidates
        # of one fused evaluation, across chunks the liar rows push the
        # next chunk away from what the batch already claimed
        self.liar_chunk = max(1, int(liar_chunk))
        self._startup = QuasiRandomSampler(seed=seed)
        # good/bad split of the cached observations, memoized on the
        # cache token (observed count + pending-set fingerprint): the
        # split (and the padded device buffers) only changes when a tell
        # lands or the in-flight set churns — repeat asks against an
        # unchanged history skip straight to the proposal
        self._split_key: tuple | None = None
        self._split: tuple | None = None

    def _n_good(self, n: int) -> int:
        if self.gamma is not None:
            return max(2, int(math.ceil(self.gamma * n)))
        return max(2, min(int(math.ceil(0.1 * n)), 25))   # Optuna default_gamma

    def _split_xy(self, space: SearchSpace, X: np.ndarray, y: np.ndarray
                  ) -> tuple:
        """Good/bad Parzen split of (X, y) as padded float32 buffers on
        the sampler's device."""
        n_good = self._n_good(len(y))
        order = np.argsort(y)
        good, bad = X[order[:n_good]], X[order[n_good:]]
        if len(bad) == 0:       # degenerate split: everything is "good"
            bad = good

        ng, nb = _pad_pow2(len(good)), _pad_pow2(len(bad))
        xg = np.zeros((ng, space.dim)); xg[: len(good)] = good
        mg = np.zeros(ng); mg[: len(good)] = 1.0
        xb = np.zeros((nb, space.dim)); xb[: len(bad)] = bad
        mb = np.zeros(nb); mb[: len(bad)] = 1.0
        # float32 as the reference computes (its arrays are cast at
        # jnp.asarray with x64 off); as_tensor alone would keep float64
        return tuple(torch.as_tensor(a, dtype=torch.float32,
                                     device=self.device)
                     for a in (xg, mg, xb, mb))

    def _split_observations(self, space: SearchSpace, trials: list[Trial],
                            direction: Direction, cache: Any) -> tuple | None:
        """Padded (xg, mg, xb, mb) device buffers, or None in startup."""
        memo_key = None if cache is None else (id(cache), cache.token)
        if memo_key is not None and memo_key == self._split_key:
            return self._split
        X, y, n_obs = self.observations_pending(
            space, trials, direction, cache=cache, liar=self.liar)
        if n_obs < self.n_startup_trials or space.dim == 0:
            return None
        split = self._split_xy(space, X, y)
        if memo_key is not None:
            self._split_key, self._split = memo_key, split
        return split

    def speculative_ready(self, cache: Any) -> bool:
        return (self.liar != "none"
                and cache.count >= self.n_startup_trials)

    def _propose(self, space: SearchSpace, trials: list[Trial],
                 direction: Direction, rng: np.random.Generator,
                 k: int, cache: Any = None) -> np.ndarray | None:
        """(k, D) unit-cube proposals, or None while still in startup."""
        split = self._split_observations(space, trials, direction, cache)
        if split is None:
            return None
        xg, mg, xb, mb = split
        seed = int(rng.integers(0, 2**31 - 1))
        return _tpe_propose(xg, mg, xb, mb, seed, self._pool(k))[:k]

    def _pool(self, k: int) -> int:
        """Candidate-pool size for a top-``k`` draw: at least 4x the
        ask so the acquisition keeps selection pressure (top-k of a
        k-sized pool is just the pool, ranked), pow-2-padded as the
        reference pads it."""
        return max(self.n_candidates, _pad_pow2(4 * k))

    def suggest(self, space: SearchSpace, trials: list[Trial],
                direction: Direction, rng: np.random.Generator,
                cache: Any = None) -> dict[str, Any]:
        u = self._propose(space, trials, direction, rng, 1, cache=cache)
        if u is None:
            return self._startup.suggest(space, trials, direction, rng)
        return space.from_unit_vector(u[0])

    def suggest_batch(self, space: SearchSpace, trials: list[Trial],
                      direction: Direction, rng: np.random.Generator,
                      n: int, cache: Any = None, chunk: int | None = None,
                      **kwargs: Any) -> list[dict[str, Any]]:
        """Batch proposal with incremental constant-liar updates.

        The batch is built in chunks of ``liar_chunk``: each chunk takes
        the top-scored candidates of one fused KDE evaluation (distinct
        points, not copies of the argmax), then the chunk is appended to
        the history as fantasy rows at the liar value and the split is
        recomputed — so later chunks are repelled from what the batch
        already claimed, the same way concurrent workers repel each
        other through the pending view.  With ``liar="none"`` this
        degrades to the legacy single fused top-n draw.

        ``chunk`` overrides the adaptive chunk size — the speculative
        precompute streams a round as slices whose liar chaining happens
        in the caller (``CacheSnapshot.with_fantasies``), so each slice
        must be exactly one fused evaluation, not re-chunked here.
        """
        if self.liar == "none":
            u = self._propose(space, trials, direction, rng, n, cache=cache)
            if u is None:       # startup: fall back to the sequential path
                return super().suggest_batch(space, trials, direction, rng,
                                             n, cache=cache, **kwargs)
            return space.from_unit_matrix(u)

        X, y, n_obs = self.observations_pending(
            space, trials, direction, cache=cache, liar=self.liar)
        if n_obs < self.n_startup_trials or space.dim == 0:
            return super().suggest_batch(space, trials, direction, rng, n,
                                         cache=cache, **kwargs)
        lv = liar_value(y[:n_obs], self.liar)
        # large batches (speculative precompute at high parallelism) cap
        # the split count at 8: re-splitting every `liar_chunk` rows
        # would make a 256-proposal round ~64 KDE rebuilds, slow enough
        # to starve the queue it is meant to fill
        if chunk is None:
            chunk = max(self.liar_chunk, -(-n // 8))
        else:
            chunk = max(1, int(chunk))
        chunks: list[np.ndarray] = []
        got = 0
        while got < n:
            k = min(chunk, n - got)
            xg, mg, xb, mb = self._split_xy(space, X, y)
            seed = int(rng.integers(0, 2**31 - 1))
            u = _tpe_propose(xg, mg, xb, mb, seed, self._pool(k))[:k]
            chunks.append(u)
            got += k
            if got < n:
                X = np.concatenate([X, u])
                y = np.concatenate([y, np.full(k, lv)])
        return space.from_unit_matrix(np.concatenate(chunks))
