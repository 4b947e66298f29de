from __future__ import annotations

from typing import Any

import numpy as np

from ..space import SearchSpace
from ..types import Direction, Trial
from .base import Sampler

_PRIMES = [2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37, 41, 43, 47, 53, 59,
           61, 67, 71, 73, 79, 83, 89, 97, 101, 103, 107, 109, 113]


def _radical_inverse(i: np.ndarray, base: int) -> np.ndarray:
    """Vectorized van-der-Corput radical inverse of an index array."""
    i = np.asarray(i, dtype=np.int64).copy()
    f = 1.0
    r = np.zeros(i.shape, dtype=np.float64)
    while i.max(initial=0) > 0:
        f /= base
        r += f * (i % base)
        i //= base
    return r


class QuasiRandomSampler(Sampler):
    """Scrambled Halton low-discrepancy sequence.

    Better space coverage than i.i.d. uniform for the startup phase of an
    optimization campaign; used as the TPE startup strategy too.
    """

    def __init__(self, scramble: bool = True, seed: int = 0):
        self.scramble = scramble
        self.seed = int(seed)

    def points(self, start: int, n: int, dim: int) -> np.ndarray:
        """(n, dim) Halton points for indices start..start+n-1, computed
        as one array expression per dimension (no per-point Python)."""
        idx = np.arange(start + 1, start + n + 1, dtype=np.int64)
        u = np.empty((n, dim), dtype=np.float64)
        for d in range(dim):
            u[:, d] = _radical_inverse(idx, _PRIMES[d % len(_PRIMES)])
        if self.scramble:
            shift = np.random.default_rng(self.seed).uniform(size=dim)
            u = (u + shift) % 1.0
        return u

    def point(self, index: int, dim: int) -> np.ndarray:
        return self.points(index, 1, dim)[0]

    def suggest(self, space: SearchSpace, trials: list[Trial],
                direction: Direction, rng: np.random.Generator) -> dict[str, Any]:
        return space.from_unit_vector(self.point(len(trials), space.dim))
