from __future__ import annotations

import abc

from ..types import Direction, Study, Trial


class Pruner(abc.ABC):
    """Decides whether a RUNNING trial should be early-terminated.

    ``trial.intermediates`` already contains the just-reported (step, value)
    when ``should_prune`` is called.  Values are normalized to minimization
    internally (sign-flip for maximize studies).
    """

    @abc.abstractmethod
    def should_prune(self, study: Study, trial: Trial, step: int) -> bool:
        ...

    @staticmethod
    def _sign(study: Study) -> float:
        return 1.0 if study.config.direction == Direction.MINIMIZE else -1.0


class NonePruner(Pruner):
    def should_prune(self, study: Study, trial: Trial, step: int) -> bool:
        return False
