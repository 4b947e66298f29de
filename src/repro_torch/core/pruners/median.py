from __future__ import annotations

import numpy as np

from ..types import Study, Trial
from .base import Pruner


class PercentilePruner(Pruner):
    """Prune if the trial's intermediate is worse than the given percentile
    of other trials' intermediates at the same step (Optuna semantics)."""

    def __init__(self, percentile: float = 50.0, n_startup_trials: int = 4,
                 n_warmup_steps: int = 0, interval_steps: int = 1):
        self.percentile = float(percentile)
        self.n_startup_trials = int(n_startup_trials)
        self.n_warmup_steps = int(n_warmup_steps)
        self.interval_steps = max(int(interval_steps), 1)

    def should_prune(self, study: Study, trial: Trial, step: int) -> bool:
        if step < self.n_warmup_steps:
            return False
        if (step - self.n_warmup_steps) % self.interval_steps != 0:
            return False
        sign = self._sign(study)
        # competitors: every other trial that reported at `step`, read from
        # the study's incremental per-step report index (maintained on
        # report under the shard lock) — no scan over the trial list
        others = [sign * v for uid, v in study.reports_at(step).items()
                  if uid != trial.uid]
        if len(others) < self.n_startup_trials:
            return False
        threshold = float(np.percentile(others, self.percentile))
        # best value this trial has achieved up to `step` (noise-robust)
        mine = min(sign * v for s, v in trial.intermediates.items() if s <= step)
        return mine > threshold


class MedianPruner(PercentilePruner):
    """Prune if worse than the median of other trials at the same step
    (Optuna's default pruner)."""

    def __init__(self, n_startup_trials: int = 4, n_warmup_steps: int = 0,
                 interval_steps: int = 1):
        super().__init__(percentile=50.0, n_startup_trials=n_startup_trials,
                         n_warmup_steps=n_warmup_steps, interval_steps=interval_steps)
