"""CMA-ES (covariance matrix adaptation evolution strategy).

Evolutionary backend (paper sec. 2 mentions evolutionary algorithms as a
search modality).  Standard (mu/mu_w, lambda) CMA-ES on the unit cube,
adapted to the asynchronous ask/tell service model: a generation's
candidates are handed out as trials; the covariance update runs whenever
>= lambda new completed trials have accumulated since the last update.
"""
from __future__ import annotations

import math
from typing import Any

import numpy as np

from ..space import SearchSpace
from ..types import Direction, Trial
from .base import Sampler


class CmaEsSampler(Sampler):
    uses_cache = True

    def __init__(self, sigma0: float = 0.3, popsize: int | None = None, seed: int = 0):
        self.sigma0 = float(sigma0)
        self.popsize = popsize
        self._state: dict[str, Any] | None = None
        self._seen = 0
        self._queue: list[np.ndarray] = []

    def _init_state(self, d: int) -> dict[str, Any]:
        lam = self.popsize or (4 + int(3 * math.log(max(d, 1))))
        mu = lam // 2
        w = np.log(mu + 0.5) - np.log(np.arange(1, mu + 1))
        w /= w.sum()
        mueff = 1.0 / (w ** 2).sum()
        cc = (4 + mueff / d) / (d + 4 + 2 * mueff / d)
        cs = (mueff + 2) / (d + mueff + 5)
        c1 = 2 / ((d + 1.3) ** 2 + mueff)
        cmu = min(1 - c1, 2 * (mueff - 2 + 1 / mueff) / ((d + 2) ** 2 + mueff))
        damps = 1 + 2 * max(0.0, math.sqrt((mueff - 1) / (d + 1)) - 1) + cs
        return dict(lam=lam, mu=mu, w=w, mueff=mueff, cc=cc, cs=cs, c1=c1,
                    cmu=cmu, damps=damps, mean=np.full(d, 0.5), sigma=self.sigma0,
                    C=np.eye(d), ps=np.zeros(d), pc=np.zeros(d), gen=0)

    def _update(self, X: np.ndarray, y: np.ndarray) -> None:
        s = self._state
        d = len(s["mean"])
        order = np.argsort(y)[: s["mu"]]
        xsel = X[order]
        old_mean = s["mean"].copy()
        s["mean"] = s["w"] @ xsel

        eig, B = np.linalg.eigh(s["C"])
        eig = np.maximum(eig, 1e-12)
        inv_sqrt_C = B @ np.diag(eig ** -0.5) @ B.T

        zmean = inv_sqrt_C @ (s["mean"] - old_mean) / s["sigma"]
        s["ps"] = (1 - s["cs"]) * s["ps"] + math.sqrt(
            s["cs"] * (2 - s["cs"]) * s["mueff"]) * zmean
        chi_n = math.sqrt(d) * (1 - 1 / (4 * d) + 1 / (21 * d ** 2))
        hsig = float(np.linalg.norm(s["ps"]) /
                     math.sqrt(1 - (1 - s["cs"]) ** (2 * (s["gen"] + 1))) < (1.4 + 2 / (d + 1)) * chi_n)
        s["pc"] = (1 - s["cc"]) * s["pc"] + hsig * math.sqrt(
            s["cc"] * (2 - s["cc"]) * s["mueff"]) * (s["mean"] - old_mean) / s["sigma"]

        artmp = (xsel - old_mean) / s["sigma"]
        s["C"] = ((1 - s["c1"] - s["cmu"]) * s["C"]
                  + s["c1"] * (np.outer(s["pc"], s["pc"])
                               + (1 - hsig) * s["cc"] * (2 - s["cc"]) * s["C"])
                  + s["cmu"] * (artmp.T * s["w"]) @ artmp)
        s["sigma"] *= math.exp((s["cs"] / s["damps"]) *
                               (np.linalg.norm(s["ps"]) / chi_n - 1))
        s["sigma"] = float(np.clip(s["sigma"], 1e-4, 1.0))
        s["gen"] += 1

    def suggest(self, space: SearchSpace, trials: list[Trial],
                direction: Direction, rng: np.random.Generator,
                cache: Any = None) -> dict[str, Any]:
        d = space.dim
        if d == 0:
            return space.sample_uniform(rng)
        if self._state is None:
            self._state = self._init_state(d)

        X, y = self.observations(space, trials, direction, cache=cache)
        # consume newly completed evaluations generation-wise
        if len(y) - self._seen >= self._state["lam"]:
            self._update(X[self._seen:], y[self._seen:])
            self._seen = len(y)

        if not self._queue:
            s = self._state
            eig, B = np.linalg.eigh(s["C"])
            eig = np.maximum(eig, 1e-12)
            A = B @ np.diag(np.sqrt(eig))
            z = rng.standard_normal((s["lam"], d))
            pts = np.clip(s["mean"] + s["sigma"] * z @ A.T, 0.0, 1.0)
            self._queue = list(pts)
        return space.from_unit_vector(self._queue.pop(0))
