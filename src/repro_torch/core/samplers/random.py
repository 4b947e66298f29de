from __future__ import annotations

from typing import Any

import numpy as np

from ..space import SearchSpace
from ..types import Direction, Trial
from .base import Sampler


class RandomSampler(Sampler):
    """Independent uniform sampling (the paper's non-Bayesian baseline)."""

    def suggest(self, space: SearchSpace, trials: list[Trial],
                direction: Direction, rng: np.random.Generator) -> dict[str, Any]:
        return space.sample_uniform(rng)
