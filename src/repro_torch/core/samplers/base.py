from __future__ import annotations

import abc
from typing import Any

import numpy as np

from ..obs_cache import liar_value
from ..space import SearchSpace
from ..types import Direction, Trial, TrialState


class Sampler(abc.ABC):
    """Strategy that proposes the next hyperparameter set for a study."""

    #: numeric samplers set this so the server hands them the per-study
    #: ObservationCache (``cache=`` kwarg) instead of letting them rescan
    #: the trial list on every ask
    uses_cache = False

    #: pending-aware samplers understand the constant-liar view (RUNNING
    #: trials as fantasy observations) and can batch with incremental
    #: liar updates — the prerequisites for speculative precompute
    pending_aware = False

    @abc.abstractmethod
    def suggest(self, space: SearchSpace, trials: list[Trial],
                direction: Direction, rng: np.random.Generator) -> dict[str, Any]:
        ...

    def suggest_batch(self, space: SearchSpace, trials: list[Trial],
                      direction: Direction, rng: np.random.Generator,
                      n: int, **kwargs: Any) -> list[dict[str, Any]]:
        """Propose ``n`` parameter sets at once (the `ask_batch` path).

        The default extends the trial history with RUNNING placeholders
        between draws so index-based samplers (grid, Halton) advance and
        don't hand the same point to every worker in the batch.  Samplers
        with a vectorized proposal path (e.g. TPE top-k) override this.
        """
        virtual = list(trials)
        out: list[dict[str, Any]] = []
        for _ in range(n):
            params = self.suggest(space, virtual, direction, rng, **kwargs)
            out.append(params)
            virtual.append(Trial(trial_id=len(virtual), uid="", study_key="",
                                 params=params, state=TrialState.RUNNING))
        return out

    # -- helpers shared by the numeric samplers -------------------------
    @staticmethod
    def observations(space: SearchSpace, trials: list[Trial], direction: Direction,
                     cache: Any = None) -> tuple[np.ndarray, np.ndarray]:
        """(X, y) of observations in unit-cube coords, minimization sign.

        With an ``ObservationCache`` (the service ask path) this is O(1):
        the cache was synced incrementally on tell.  Without one (direct
        sampler use, tests) the trial list is featurized from scratch with
        the vectorized space codec — same rows, bit-identical.
        """
        if cache is not None:
            return cache.observations()
        done = [t for t in trials
                if t.state == TrialState.COMPLETED and t.value is not None]
        if not done:
            return np.zeros((0, space.dim)), np.zeros((0,))
        X = space.to_unit_matrix([t.params for t in done])
        sign = 1.0 if direction == Direction.MINIMIZE else -1.0
        y = np.array([sign * t.value for t in done], dtype=np.float64)
        return X, y

    @classmethod
    def observations_pending(cls, space: SearchSpace, trials: list[Trial],
                             direction: Direction, cache: Any = None,
                             liar: str = "mean"
                             ) -> tuple[np.ndarray, np.ndarray, int]:
        """(X, y, n_obs): the constant-liar view of the history.

        The first ``n_obs`` rows are real observations (trial-id order);
        the rest are RUNNING trials with an imputed objective so the
        acquisition repels in-flight points.  With a liar-enabled
        ``ObservationCache`` this is the incrementally maintained
        ``augmented()`` view; without one the trial list is scanned —
        same sorted construction, bit-identical rows.  Startup gating
        must use ``n_obs``, never ``len(y)``: fantasy rows are not
        evidence.
        """
        if cache is not None and liar != "none":
            X, y = cache.augmented()
            return X, y, cache.count
        X, y = cls.observations(space, trials, direction, cache=cache)
        n_obs = len(y)
        if liar != "none" and n_obs:
            pend = [t for t in trials if t.state == TrialState.RUNNING]
            if pend:
                lv = liar_value(y, liar)
                Xp = space.to_unit_matrix([t.params for t in pend])
                X = np.concatenate([X, Xp])
                y = np.concatenate([y, np.full(len(pend), lv)])
        return X, y, n_obs

    def speculative_ready(self, cache: Any) -> bool:
        """Whether a precomputed proposal batch against ``cache`` would
        be purely model-driven.  False while an index-based startup
        fallback (which needs the live trial count) would kick in — the
        precompute worker must not publish from that regime."""
        return False
