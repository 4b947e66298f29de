"""NSGA-II sampler for multi-objective studies (the paper's sec. 5
future work: "introduce support to multi-objective optimizations").

Deb et al. 2002, adapted to the ask/tell service model: each `suggest`
call performs binary-tournament selection over the completed trials
(rank by non-dominated front, tie-break by crowding distance), then SBX
crossover + polynomial mutation in the unit hypercube.  Matches the
spirit of Optuna's NSGAIISampler default configuration.
"""
from __future__ import annotations

from typing import Any

import numpy as np

from ..space import SearchSpace
from ..types import Direction, Trial, TrialState
from .base import Sampler


def _objective_matrix(trials: list[Trial], signs: list[float]
                      ) -> tuple[np.ndarray, list[Trial]]:
    done = [t for t in trials if t.state == TrialState.COMPLETED
            and t.values is not None and len(t.values) == len(signs)]
    if not done:
        return np.zeros((0, len(signs))), []
    Y = np.array([[s * v for s, v in zip(signs, t.values)] for t in done])
    return Y, done


def non_dominated_sort(Y: np.ndarray) -> list[np.ndarray]:
    """-> list of fronts (arrays of row indices), best first.  All
    objectives minimized."""
    n = len(Y)
    dominated_by = [[] for _ in range(n)]
    dom_count = np.zeros(n, dtype=int)
    for i in range(n):
        for j in range(i + 1, n):
            if np.all(Y[i] <= Y[j]) and np.any(Y[i] < Y[j]):
                dominated_by[i].append(j)
                dom_count[j] += 1
            elif np.all(Y[j] <= Y[i]) and np.any(Y[j] < Y[i]):
                dominated_by[j].append(i)
                dom_count[i] += 1
    fronts = []
    current = np.flatnonzero(dom_count == 0)
    while len(current):
        fronts.append(current)
        nxt = []
        for i in current:
            for j in dominated_by[i]:
                dom_count[j] -= 1
                if dom_count[j] == 0:
                    nxt.append(j)
        current = np.array(sorted(set(nxt)), dtype=int)
    return fronts


def crowding_distance(Y: np.ndarray) -> np.ndarray:
    n, m = Y.shape
    if n <= 2:
        return np.full(n, np.inf)
    dist = np.zeros(n)
    for k in range(m):
        order = np.argsort(Y[:, k])
        span = Y[order[-1], k] - Y[order[0], k]
        dist[order[0]] = dist[order[-1]] = np.inf
        if span <= 0:
            continue
        dist[order[1:-1]] += (Y[order[2:], k] - Y[order[:-2], k]) / span
    return dist


class NSGA2Sampler(Sampler):
    multi_objective = True          # server passes direction signs

    def __init__(self, population: int = 16, crossover_prob: float = 0.9,
                 eta_crossover: float = 20.0, eta_mutation: float = 20.0,
                 mutation_prob: float | None = None):
        self.population = int(population)
        self.crossover_prob = float(crossover_prob)
        self.eta_c = float(eta_crossover)
        self.eta_m = float(eta_mutation)
        self.mutation_prob = mutation_prob

    # ------------------------------------------------------------------
    def _ranked(self, Y: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        fronts = non_dominated_sort(Y)
        rank = np.zeros(len(Y), dtype=int)
        crowd = np.zeros(len(Y))
        for r, f in enumerate(fronts):
            rank[f] = r
            crowd[f] = crowding_distance(Y[f])
        return rank, crowd

    def _make_child(self, space: SearchSpace, done: list[Trial],
                    rank: np.ndarray, crowd: np.ndarray,
                    rng: np.random.Generator) -> dict[str, Any]:
        def tournament() -> int:
            i, j = rng.integers(0, len(done), size=2)
            if rank[i] != rank[j]:
                return i if rank[i] < rank[j] else j
            return i if crowd[i] >= crowd[j] else j

        i1 = tournament()
        i2 = tournament()
        for _ in range(4):                       # prefer distinct parents
            if i2 != i1:
                break
            i2 = tournament()
        p1 = space.to_unit_vector(done[i1].params)
        p2 = space.to_unit_vector(done[i2].params)
        child = self._sbx(np.asarray(p1), np.asarray(p2), rng)
        child = self._mutate(child, rng)
        return space.from_unit_vector(np.clip(child, 0.0, 1.0))

    def suggest(self, space: SearchSpace, trials: list[Trial],
                direction: Direction, rng: np.random.Generator,
                signs: list[float] | None = None) -> dict[str, Any]:
        signs = signs or [1.0]
        Y, done = _objective_matrix(trials, signs)
        if len(done) < self.population:
            return space.sample_uniform(rng)         # random warmup
        rank, crowd = self._ranked(Y)
        return self._make_child(space, done, rank, crowd, rng)

    def suggest_batch(self, space: SearchSpace, trials: list[Trial],
                      direction: Direction, rng: np.random.Generator,
                      n: int, signs: list[float] | None = None,
                      **kwargs: Any) -> list[dict[str, Any]]:
        """One non-dominated sort serves the whole offspring batch — the
        generational shape NSGA-II actually wants (Deb et al. 2002)."""
        signs = signs or [1.0]
        Y, done = _objective_matrix(trials, signs)
        if len(done) < self.population:
            return [space.sample_uniform(rng) for _ in range(n)]
        rank, crowd = self._ranked(Y)
        return [self._make_child(space, done, rank, crowd, rng)
                for _ in range(n)]

    # ------------------------------------------------------------------
    def _sbx(self, a: np.ndarray, b: np.ndarray,
             rng: np.random.Generator) -> np.ndarray:
        if rng.uniform() > self.crossover_prob:
            return a.copy()
        u = rng.uniform(size=a.shape)
        beta = np.where(u <= 0.5,
                        (2 * u) ** (1.0 / (self.eta_c + 1)),
                        (1.0 / (2 * (1 - u))) ** (1.0 / (self.eta_c + 1)))
        c1 = 0.5 * ((1 + beta) * a + (1 - beta) * b)
        c2 = 0.5 * ((1 - beta) * a + (1 + beta) * b)
        # per-variable exchange (standard SBX): pick c1 or c2 per dim
        return np.where(rng.uniform(size=a.shape) < 0.5, c1, c2)

    def _mutate(self, x: np.ndarray, rng: np.random.Generator) -> np.ndarray:
        prob = self.mutation_prob
        if prob is None:
            prob = 1.0 / max(len(x), 1)
        u = rng.uniform(size=x.shape)
        do = rng.uniform(size=x.shape) < prob
        delta = np.where(u < 0.5,
                         (2 * u) ** (1.0 / (self.eta_m + 1)) - 1.0,
                         1.0 - (2 * (1 - u)) ** (1.0 / (self.eta_m + 1)))
        return np.where(do, x + delta, x)
