"""Gradient-less optimization backends (the Optuna role in the paper).

All samplers implement ``suggest(space, trials, direction, rng) ->
params`` where ``trials`` is the study's full trial list (the numeric
samplers filter completed observations themselves).  On the service ask
path the samplers that set ``uses_cache`` additionally receive the
per-study ``ObservationCache`` (``cache=`` kwarg), so the observation
matrix is an O(1) incrementally maintained buffer instead of a per-ask
rescan of the history.  Registry keyed by the ``sampler`` spec of the
study config, e.g. ``{"name": "tpe"}``.

TPE and GP compute on a torch device (``device=``; ``None`` is the CUDA
device); the other samplers are numpy-only.  The device is a server
setting, never part of the spec.
"""
from __future__ import annotations

from typing import Any

from .base import Sampler
from .random import RandomSampler
from .grid import GridSampler
from .quasirandom import QuasiRandomSampler
from .tpe import TPESampler
from .gp import GPSampler
from .cmaes import CmaEsSampler
from .nsga2 import NSGA2Sampler

_REGISTRY = {
    "random": RandomSampler,
    "grid": GridSampler,
    "halton": QuasiRandomSampler,
    "quasirandom": QuasiRandomSampler,
    "tpe": TPESampler,
    "gp": GPSampler,
    "cmaes": CmaEsSampler,
    "nsga2": NSGA2Sampler,
}

_DEVICE_SAMPLERS = (TPESampler, GPSampler)


def known_samplers() -> list[str]:
    """Registered sampler names (used by the API schema validation)."""
    return sorted(_REGISTRY)


def make_sampler(spec: dict[str, Any], device: str | None = None) -> Sampler:
    spec = dict(spec or {"name": "tpe"})
    name = spec.pop("name", "tpe")
    try:
        cls = _REGISTRY[name]
    except KeyError:
        raise ValueError(f"unknown sampler {name!r}; known: {sorted(_REGISTRY)}")
    if cls in _DEVICE_SAMPLERS:
        if "device" in spec:
            raise ValueError("'device' is a server setting, not a sampler "
                             "option")
        return cls(**spec, device=device)
    return cls(**spec)


__all__ = ["Sampler", "make_sampler", "known_samplers", "RandomSampler", "GridSampler",
           "QuasiRandomSampler", "TPESampler", "GPSampler", "CmaEsSampler"]
