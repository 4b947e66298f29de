"""Arch registry + analytic bookkeeping."""
from __future__ import annotations

import math
from typing import Callable

from .config import ModelConfig

_REGISTRY: dict[str, Callable[[], ModelConfig]] = {}
_SMOKE: dict[str, Callable[[], ModelConfig]] = {}


def register(name: str, full: Callable[[], ModelConfig],
             smoke: Callable[[], ModelConfig]) -> None:
    _REGISTRY[name] = full
    _SMOKE[name] = smoke


def get_config(name: str, smoke: bool = False) -> ModelConfig:
    _ensure_loaded()
    table = _SMOKE if smoke else _REGISTRY
    if name not in table:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(table)}")
    return table[name]()


def list_archs() -> list[str]:
    _ensure_loaded()
    return sorted(_REGISTRY)


def _ensure_loaded() -> None:
    if not _REGISTRY:
        from .. import configs  # noqa: F401  (registers all archs)


def leaves(tree: dict):
    """The tensors of a nested dict, depth first."""
    for v in tree.values():
        yield from leaves(v) if isinstance(v, dict) else (v,)


def count_params(cfg: ModelConfig) -> int:
    """Exact parameter count from a ``meta``-device init (no allocation)."""
    from . import transformer
    params = transformer.init_params(cfg, device="meta")
    return sum(math.prod(p.shape) for p in leaves(params))


def count_active_params(cfg: ModelConfig) -> int:
    """Active-per-token params (MoE: top_k + shared experts only).  Only
    the MoE layers count experts (``mla_moe``'s leading dense layers hold
    none), and of those only the experts the config holds
    (``DeepSeekMoEConfig.held``): a token's top_k picks fall among them
    top_k x held / n_experts times, on average."""
    total = count_params(cfg)
    if cfg.moe is None:
        return total
    m = cfg.moe
    per_expert = 3 * cfg.d_model * m.d_expert
    layers = cfg.n_layers - getattr(cfg, "first_dense", 0)
    held = getattr(m, "held", m.n_experts)
    routed_total = layers * held * per_expert
    routed_active = layers * m.top_k * held * per_expert // m.n_experts
    return total - routed_total + routed_active
