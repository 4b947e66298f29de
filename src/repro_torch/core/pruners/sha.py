from __future__ import annotations

import math

import numpy as np

from ..types import Study, Trial
from .base import Pruner


class SuccessiveHalvingPruner(Pruner):
    """Asynchronous successive halving (ASHA, Li et al. 2018).

    Rungs sit at ``min_resource * reduction_factor**k`` steps.  At each rung
    a trial survives only if its value is within the top ``1/reduction_factor``
    of everything that has reached that rung so far.  Asynchronous: decisions
    never wait for a full cohort — exactly what a multi-site opportunistic
    campaign needs (stragglers can't block promotions).
    """

    def __init__(self, min_resource: int = 1, reduction_factor: int = 3,
                 min_early_stopping_rate: int = 0):
        self.min_resource = max(int(min_resource), 1)
        self.rf = max(int(reduction_factor), 2)
        self.s = int(min_early_stopping_rate)

    def rung_of(self, step: int) -> int | None:
        """Largest rung index k with resource(k) <= step+1, or None."""
        r = self.min_resource * self.rf ** self.s
        if step + 1 < r:
            return None
        return int(math.floor(math.log((step + 1) / r, self.rf)))

    def rung_resource(self, k: int) -> int:
        return self.min_resource * self.rf ** (self.s + k)

    def should_prune(self, study: Study, trial: Trial, step: int) -> bool:
        k = self.rung_of(step)
        if k is None:
            return False
        sign = self._sign(study)
        resource = self.rung_resource(k)
        # value of a trial "at rung k" = best intermediate within the
        # resource, read from the study's incremental rung snapshot
        # (maintained per report under the shard lock) — heartbeats no
        # longer rescan every trial's intermediates
        mine = study.rung_value(trial.uid, resource, sign)
        if mine is None:
            return False
        # competitors: other trials that *reached* the rung
        others = study.rung_competitors(resource, sign, trial.uid)
        if len(others) < self.rf - 1:
            return False         # not enough rung population yet
        cutoff = float(np.percentile(others, 100.0 / self.rf))
        return mine > cutoff
