"""Pruning strategies for early termination of non-promising trials
(the paper's ``should_prune`` API, sec. 2)."""
from __future__ import annotations

from typing import Any

from .base import Pruner, NonePruner
from .median import MedianPruner, PercentilePruner
from .sha import SuccessiveHalvingPruner
from .hyperband import HyperbandPruner
from .patient import PatientPruner

_REGISTRY = {
    "none": NonePruner,
    "median": MedianPruner,
    "percentile": PercentilePruner,
    "sha": SuccessiveHalvingPruner,
    "asha": SuccessiveHalvingPruner,
    "hyperband": HyperbandPruner,
    "patient": PatientPruner,
}


def known_pruners() -> list[str]:
    """Registered pruner names (used by the API schema validation)."""
    return sorted(_REGISTRY)


def make_pruner(spec: dict[str, Any]) -> Pruner:
    spec = dict(spec or {"name": "none"})
    name = spec.pop("name", "none")
    try:
        cls = _REGISTRY[name]
    except KeyError:
        raise ValueError(f"unknown pruner {name!r}; known: {sorted(_REGISTRY)}")
    return cls(**spec)


__all__ = ["Pruner", "make_pruner", "known_pruners", "NonePruner", "MedianPruner",
           "PercentilePruner", "SuccessiveHalvingPruner", "HyperbandPruner",
           "PatientPruner"]
