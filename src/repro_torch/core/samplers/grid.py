from __future__ import annotations

from typing import Any

import numpy as np

from ..space import SearchSpace
from ..types import Direction, Trial
from .base import Sampler


class GridSampler(Sampler):
    """Full-factorial grid search; cycles once the lattice is exhausted."""

    def __init__(self, points_per_dim: int = 5):
        self.points_per_dim = int(points_per_dim)
        self._lattice: list[dict[str, Any]] | None = None

    def suggest(self, space: SearchSpace, trials: list[Trial],
                direction: Direction, rng: np.random.Generator) -> dict[str, Any]:
        if self._lattice is None:
            self._lattice = space.grid(self.points_per_dim)
        idx = len(trials) % len(self._lattice)
        return dict(self._lattice[idx])
