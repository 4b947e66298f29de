"""Hyperparameter search-space specification.

Spaces are JSON-serializable (they travel in the body of `ask` requests,
paper sec. 2) and support an internal mapping to the unit hypercube, which
is what the numeric samplers (TPE / GP / CMA-ES) operate on.

Spec grammar (the ``properties`` dict of a study):
    {"lr":     {"type": "loguniform", "low": 1e-5, "high": 1e-1},
     "layers": {"type": "int", "low": 1, "high": 8},
     "act":    {"type": "categorical", "choices": ["relu", "gelu"]},
     "dropout":{"type": "uniform", "low": 0.0, "high": 0.5}}
Plain scalars (int/float/str/bool) are passed through as constants, which
lets a client pin some properties while scanning others.

The unit-cube codec is vectorized: ``SearchSpace`` precomputes per-dim
``low/high/log/kind`` arrays at construction so that featurizing or
decoding k points (``to_unit_matrix`` / ``from_unit_matrix``) is one
batched numpy expression per dimension instead of k*D scalar Python calls
with per-element ``math.log``.  The scalar ``Param.to_unit``/``from_unit``
are kept as the per-kind reference implementation.

Categoricals map to the unit interval with equal-width bins: choice ``i``
of ``n`` encodes to the bin center ``(i + 0.5) / n`` and ``u`` decodes to
``min(floor(u * n), n - 1)``, so uniformly drawn candidates weight every
choice equally (the previous ``round(u * (n - 1))`` binning gave the two
edge choices half-width bins).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import numpy as np


@dataclasses.dataclass(frozen=True)
class Param:
    """One dimension of the search space."""

    name: str
    kind: str                      # uniform | loguniform | int | logint | categorical | const
    low: float = 0.0
    high: float = 1.0
    choices: tuple = ()
    value: Any = None              # for const

    # ---- unit-cube mapping (used by TPE/GP/CMA-ES) -------------------
    def to_unit(self, v: Any) -> float:
        if self.kind == "uniform":
            return (float(v) - self.low) / (self.high - self.low)
        if self.kind == "loguniform":
            return (math.log(float(v)) - math.log(self.low)) / (
                math.log(self.high) - math.log(self.low))
        if self.kind == "int":
            return (float(v) - self.low) / max(self.high - self.low, 1e-12)
        if self.kind == "logint":
            return (math.log(float(v)) - math.log(self.low)) / (
                math.log(self.high) - math.log(self.low))
        if self.kind == "categorical":
            # inverse of the equal-width binning below: the bin center
            return (self.choices.index(v) + 0.5) / len(self.choices)
        return 0.0  # const

    def from_unit(self, u: float) -> Any:
        u = min(max(float(u), 0.0), 1.0)
        if self.kind == "uniform":
            return self.low + u * (self.high - self.low)
        if self.kind == "loguniform":
            return math.exp(math.log(self.low) + u * (math.log(self.high) - math.log(self.low)))
        if self.kind == "int":
            return int(round(self.low + u * (self.high - self.low)))
        if self.kind == "logint":
            return int(round(math.exp(
                math.log(self.low) + u * (math.log(self.high) - math.log(self.low)))))
        if self.kind == "categorical":
            # equal-width bins: every choice owns a 1/n slice of [0, 1)
            n = len(self.choices)
            return self.choices[min(int(u * n), n - 1)]
        return self.value  # const

    @property
    def n_categories(self) -> int:
        return len(self.choices) if self.kind == "categorical" else 0

    @property
    def is_searchable(self) -> bool:
        return self.kind != "const"

    # ---- (de)serialization -------------------------------------------
    def to_spec(self) -> Any:
        if self.kind == "const":
            return self.value
        d: dict[str, Any] = {"type": self.kind}
        if self.kind == "categorical":
            d["choices"] = list(self.choices)
        else:
            d["low"], d["high"] = self.low, self.high
        return d

    @classmethod
    def from_spec(cls, name: str, spec: Any) -> "Param":
        if not isinstance(spec, dict) or "type" not in spec:
            return cls(name=name, kind="const", value=spec)
        kind = spec["type"]
        if kind == "categorical":
            return cls(name=name, kind=kind, choices=tuple(spec["choices"]))
        if kind not in ("uniform", "loguniform", "int", "logint"):
            raise ValueError(f"unknown space type {kind!r} for {name!r}")
        return cls(name=name, kind=kind, low=float(spec["low"]), high=float(spec["high"]))


class SearchSpace:
    """An ordered collection of ``Param``s with unit-cube vectorization."""

    def __init__(self, params: list[Param]):
        self.params = params
        self.searchable = [p for p in params if p.is_searchable]
        self._build_codec()

    def _build_codec(self) -> None:
        """Precompute per-dim codec arrays so batch (en/de)coding is pure
        numpy — one array expression per dimension, no per-point Python."""
        d = len(self.searchable)
        self._log_mask = np.zeros(d, dtype=bool)
        self._int_mask = np.zeros(d, dtype=bool)
        self._cat_mask = np.zeros(d, dtype=bool)
        self._lo_t = np.zeros(d)          # low in the (log-)transformed domain
        self._enc_span = np.ones(d)       # divisor used by to_unit (guarded)
        self._dec_span = np.ones(d)       # multiplier used by from_unit
        self._n_cat = np.ones(d, dtype=np.int64)
        self._cat_index: list[dict[Any, int] | None] = []
        for i, p in enumerate(self.searchable):
            if p.kind == "categorical":
                self._cat_mask[i] = True
                self._n_cat[i] = len(p.choices)
                self._cat_index.append({c: j for j, c in enumerate(p.choices)})
                continue
            self._cat_index.append(None)
            self._log_mask[i] = p.kind in ("loguniform", "logint")
            self._int_mask[i] = p.kind in ("int", "logint")
            if self._log_mask[i]:
                self._lo_t[i] = math.log(p.low)
                span = math.log(p.high) - math.log(p.low)
                self._enc_span[i] = self._dec_span[i] = span
            else:
                self._lo_t[i] = p.low
                self._dec_span[i] = p.high - p.low
                # to_unit guards the int divisor (degenerate low == high)
                self._enc_span[i] = (max(p.high - p.low, 1e-12)
                                     if p.kind == "int" else p.high - p.low)

    @classmethod
    def from_properties(cls, properties: dict[str, Any]) -> "SearchSpace":
        return cls([Param.from_spec(k, v) for k, v in sorted(properties.items())])

    @property
    def dim(self) -> int:
        return len(self.searchable)

    def names(self) -> list[str]:
        return [p.name for p in self.searchable]

    def sample_uniform(self, rng: np.random.Generator) -> dict[str, Any]:
        u = rng.uniform(size=self.dim)
        return self.from_unit_vector(u)

    # ---- batched codec ------------------------------------------------
    def to_unit_matrix(self, params_list: list[dict[str, Any]]) -> np.ndarray:
        """Featurize k parameter dicts into a (k, dim) unit-cube matrix."""
        k = len(params_list)
        U = np.empty((k, self.dim), dtype=np.float64)
        for i, p in enumerate(self.searchable):
            col = [ps[p.name] for ps in params_list]
            if self._cat_mask[i]:
                index = self._cat_index[i]
                idx = np.fromiter((index[v] for v in col),
                                  dtype=np.float64, count=k)
                U[:, i] = (idx + 0.5) / self._n_cat[i]
            else:
                v = np.asarray(col, dtype=np.float64)
                if self._log_mask[i]:
                    v = np.log(v)
                U[:, i] = (v - self._lo_t[i]) / self._enc_span[i]
        return U

    def from_unit_matrix(self, U: np.ndarray) -> list[dict[str, Any]]:
        """Decode a (k, dim) unit-cube matrix into k parameter dicts."""
        U = np.clip(np.asarray(U, dtype=np.float64), 0.0, 1.0)
        if U.ndim != 2:                  # a single point (incl. dim == 0)
            U = U.reshape(1, self.dim)
        k = len(U)
        const = {p.name: p.value for p in self.params if not p.is_searchable}
        out = [dict(const) for _ in range(k)]
        for i, p in enumerate(self.searchable):
            u = U[:, i]
            if self._cat_mask[i]:
                n = int(self._n_cat[i])
                idx = np.minimum((u * n).astype(np.int64), n - 1)
                for row, j in zip(out, idx):
                    row[p.name] = p.choices[j]
            else:
                v = self._lo_t[i] + u * self._dec_span[i]
                if self._log_mask[i]:
                    v = np.exp(v)
                if self._int_mask[i]:
                    for row, x in zip(out, np.rint(v)):
                        row[p.name] = int(x)
                else:
                    for row, x in zip(out, v):
                        row[p.name] = float(x)
        return out

    def to_unit_vector(self, params: dict[str, Any]) -> np.ndarray:
        return self.to_unit_matrix([params])[0]

    def from_unit_vector(self, u: np.ndarray) -> dict[str, Any]:
        return self.from_unit_matrix(np.asarray(u, dtype=np.float64)[None])[0]

    def grid(self, points_per_dim: int = 5) -> list[dict[str, Any]]:
        """Full-factorial lattice (categoricals enumerate all choices)."""
        axes = []
        for p in self.searchable:
            if p.kind == "categorical":
                # bin centers: one per choice under equal-width binning
                axes.append((np.arange(p.n_categories) + 0.5) / p.n_categories)
            elif p.kind in ("int", "logint"):
                n = min(points_per_dim, int(p.high - p.low) + 1)
                axes.append(np.linspace(0.0, 1.0, max(n, 1)))
            else:
                axes.append(np.linspace(0.0, 1.0, points_per_dim))
        mesh = np.meshgrid(*axes, indexing="ij") if axes else []
        if not mesh:
            return [self.from_unit_vector(np.zeros(0))]
        flat = np.stack([m.ravel() for m in mesh], axis=-1)
        return self.from_unit_matrix(flat)
