"""AdamW with global-norm clipping, on nested dicts of tensors.

A line-by-line mirror of the reference's update, not ``torch.optim.AdamW``
(whose clipping epsilon and per-group decay differ): clip scale
``min(1, clip / max(gnorm, 1e-12))``, bias corrections from the
incremented step, decay only on leaves with ``ndim >= 2``, and the new
parameter ``p - lr * (m̂ / (√v̂ + eps) + wd * p)`` formed in fp32 and cast
back to the leaf's dtype.

``adamw_update`` writes the new parameters and moments into the given
tensors (under ``torch.no_grad()``), the counterpart of the reference's
buffer donation; one leaf at a time, so the fp32 temporaries are one
leaf's size.  ``opt_state_specs`` gives the state's logical sharding
axes (the moments mirror the parameters), as the reference's does.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch

from ..models.registry import leaves


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float | Callable[[torch.Tensor], torch.Tensor] = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    # moments dtype: fp32 masters by default; bf16 halves the state
    moment_dtype: Any = torch.float32


def _f32(x) -> float:
    """``x`` rounded to fp32, as a Python float."""
    return float(np.float32(x))


def _zeros_like(tree: dict, dtype: torch.dtype) -> dict:
    return {k: _zeros_like(v, dtype) if isinstance(v, dict)
            else torch.zeros(v.shape, dtype=dtype, device=v.device)
            for k, v in tree.items()}


def adamw_init(params: dict, cfg: AdamWConfig) -> dict:
    """-> {"m": tree, "v": tree, "step": 0-d int32}, on the parameters'
    device."""
    device = next(leaves(params)).device
    return {"m": _zeros_like(params, cfg.moment_dtype),
            "v": _zeros_like(params, cfg.moment_dtype),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def opt_state_specs(param_specs: Any) -> dict:
    """Logical axes for the optimizer state tree (mirrors the params)."""
    return {"m": param_specs, "v": param_specs, "step": ()}


def global_norm(tree: dict) -> torch.Tensor:
    sums = [torch.sum(torch.square(g.float())) for g in leaves(tree)]
    return torch.sqrt(torch.sum(torch.stack(sums)))


@torch.no_grad()
def adamw_update(grads: dict, opt_state: dict, params: dict,
                 cfg: AdamWConfig) -> tuple[dict, dict, dict]:
    """-> (params, opt_state, metrics); ``params`` and the moments are
    updated in place and returned, ``opt_state["step"]`` is a new
    tensor.  ``grads`` is not modified."""
    step = opt_state["step"] + 1
    f32 = dict(dtype=torch.float32, device=step.device)
    # the constants as host scalars holding their fp32 values (the
    # reference's jnp.float32 arithmetic); 0-d device tensors would send
    # every product with them to PyTorch's unvectorised broadcast kernel
    b1, b2 = _f32(cfg.b1), _f32(cfg.b2)
    omb1 = _f32(np.float32(1) - np.float32(b1))
    omb2 = _f32(np.float32(1) - np.float32(b2))
    lr = cfg.lr(step) if callable(cfg.lr) else _f32(cfg.lr)

    gnorm = global_norm(grads)
    scale = (torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-12),
                         max=1.0)
             if cfg.grad_clip else torch.ones((), **f32))

    c1 = 1.0 - b1 ** step.float()
    c2 = 1.0 - b2 ** step.float()

    def upd(p, g, m, v):
        g = g.float() * scale
        m32 = m if m.dtype == torch.float32 else m.float()
        v32 = v if v.dtype == torch.float32 else v.float()
        m32.mul_(b1).add_(omb1 * g)
        v32.mul_(b2).add_(omb2 * g * g)
        delta = (m32 / c1).div_((v32 / c2).sqrt_().add_(cfg.eps))
        if p.dim() >= 2:                 # no decay on norms/biases/scalars
            delta.add_(cfg.weight_decay * p.float())
        if p.dtype == torch.float32:
            p.sub_(lr * delta)
        else:
            p.copy_(p.float() - lr * delta)
        if m32 is not m:
            m.copy_(m32)
            v.copy_(v32)

    def walk(p, g, m, v):
        for k in p:
            if isinstance(p[k], dict):
                walk(p[k], g[k], m[k], v[k])
            else:
                upd(p[k], g[k], m[k], v[k])

    walk(params, grads, opt_state["m"], opt_state["v"])
    opt_state = {"m": opt_state["m"], "v": opt_state["v"], "step": step}
    if not torch.is_tensor(lr):
        lr = torch.tensor(lr, **f32)
    return params, opt_state, {"grad_norm": gnorm, "lr": lr}
