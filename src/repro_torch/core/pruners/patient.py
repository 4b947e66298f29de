from __future__ import annotations

from ..types import Study, Trial
from .base import Pruner


class PatientPruner(Pruner):
    """Prune when a trial hasn't improved its own best intermediate for
    ``patience`` consecutive reports (plateau detection — useful for the
    GAN workloads of paper sec. 4 whose losses are noisy)."""

    def __init__(self, patience: int = 8, min_delta: float = 0.0):
        self.patience = int(patience)
        self.min_delta = float(min_delta)

    def should_prune(self, study: Study, trial: Trial, step: int) -> bool:
        sign = self._sign(study)
        hist = sorted(trial.intermediates.items())
        if len(hist) <= self.patience:
            return False
        vals = [sign * v for _, v in hist]
        best_before = min(vals[: -self.patience])
        recent = min(vals[-self.patience:])
        # no strict improvement over the pre-window best => plateau => prune
        return recent >= best_before - self.min_delta
