from __future__ import annotations

import hashlib

from ..types import Study, Trial
from .base import Pruner
from .sha import SuccessiveHalvingPruner


class HyperbandPruner(Pruner):
    """Hyperband (Li et al. 2017): a portfolio of SHA brackets with
    different early-stopping aggressiveness; each trial is deterministically
    hashed to a bracket so all service workers agree without coordination."""

    def __init__(self, min_resource: int = 1, max_resource: int = 81,
                 reduction_factor: int = 3):
        self.brackets: list[SuccessiveHalvingPruner] = []
        s = 0
        r = min_resource
        while r <= max_resource:
            self.brackets.append(SuccessiveHalvingPruner(
                min_resource=min_resource, reduction_factor=reduction_factor,
                min_early_stopping_rate=s))
            s += 1
            r *= reduction_factor

    def bracket_of(self, trial: Trial) -> SuccessiveHalvingPruner:
        h = int(hashlib.sha1(trial.uid.encode()).hexdigest(), 16)
        return self.brackets[h % len(self.brackets)]

    def should_prune(self, study: Study, trial: Trial, step: int) -> bool:
        return self.bracket_of(trial).should_prune(study, trial, step)
