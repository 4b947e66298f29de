"""The train step on one device.

``make_train_step`` builds ``train_step(state, batch) -> (state,
metrics)``: one ``cfg.dtype`` copy of the fp32 matrices a step (the
reference's ``cast_weights``), gradients of ``transformer.loss_fn`` with
respect to that copy (per-layer remat inside the model), optional
microbatched accumulation in fp32 over the reference's strided split,
then the AdamW update, written into ``state``'s tensors in place.

The reference's distribution has no counterpart: the port runs on one
device and does not shard, so ``batch_axis``, ``grad_shardings`` and
``train_state_shardings`` are dropped, and ``init_train_state`` returns
the state without logical specs.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from ..core.kernels import resolve_device
from ..models import transformer
from ..models.config import ModelConfig
from ..models.registry import leaves
from ..optim import AdamWConfig, adamw_init, adamw_update


@dataclasses.dataclass
class TrainState:
    params: Any
    opt_state: Any

    def tree(self) -> dict:
        return {"params": self.params, "opt_state": self.opt_state}


def init_train_state(cfg: ModelConfig, opt_cfg: AdamWConfig, seed: int = 0,
                     device: Any = None) -> TrainState:
    """Parameters drawn from a ``torch.Generator`` seeded with ``seed``
    (other numbers than the reference's ``jax.random`` from the same
    seed) and zero AdamW moments, on ``device`` (None: CUDA, raising
    without a card)."""
    params = transformer.init_params(cfg, seed, resolve_device(device))
    return TrainState(params, adamw_init(params, opt_cfg))


def _map(fn: Callable, tree: dict) -> dict:
    return {k: _map(fn, v) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


def _unflatten(like: dict, flat: list) -> dict:
    it = iter(flat)
    return _map(lambda _: next(it), like)


def cast_weights(cfg: ModelConfig, params: dict) -> dict:
    """fp32 matrices -> one ``cfg.dtype`` copy; norms and other vectors
    stay fp32.  Every leaf of the result is a fresh autograd leaf that
    requires grad (detached from ``params``)."""
    def cast(p):
        if p.dtype == torch.float32 and p.dim() >= 2:
            p = p.to(cfg.dtype)
        return p.detach().requires_grad_()
    return _map(cast, params)


def make_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig,
                    n_microbatches: int = 1) -> Callable:
    """-> train_step(state_tree, batch) -> (state_tree, metrics).

    ``batch`` holds tensors on the state's device.  Microbatch ``j``
    takes rows ``j, n + j, 2n + j, ...`` (the reference's strided split);
    the gradients accumulate in fp32 and are scaled by ``1 / n``."""

    def grads_of(params_c: dict, batch: dict
                 ) -> tuple[torch.Tensor, dict, list[torch.Tensor]]:
        """(loss, parts, gradients), the first two detached so that no
        graph outlives the call."""
        loss, parts = transformer.loss_fn(params_c, cfg, batch)
        grads = torch.autograd.grad(loss, list(leaves(params_c)))
        return (loss.detach(), {k: v.detach() for k, v in parts.items()},
                list(grads))

    def train_step(state: dict, batch: dict) -> tuple[dict, dict]:
        params, opt_state = state["params"], state["opt_state"]
        params_c = cast_weights(cfg, params)
        if n_microbatches == 1:
            loss, parts, grads = grads_of(params_c, batch)
        else:
            B = next(iter(batch.values())).shape[0]
            if B % n_microbatches:
                raise ValueError(f"batch {B} does not split into "
                                 f"{n_microbatches} microbatches")
            for j in range(n_microbatches):
                mb = {k: v[j::n_microbatches] for k, v in batch.items()}
                l, _, g = grads_of(params_c, mb)
                if j == 0:      # 0 + g: a fp32 copy (autograd may alias)
                    acc = [t.float() if t.dtype != torch.float32
                           else t.clone() for t in g]
                    loss = l
                else:
                    for a, t in zip(acc, g):
                        a.add_(t)
                    loss = loss + l
                del g
            inv = 1.0 / n_microbatches
            grads = [a.mul_(inv) for a in acc]
            loss = loss * inv
            parts = {"ce": loss, "moe_aux": torch.zeros_like(loss)}
        del params_c
        new_params, new_opt, opt_metrics = adamw_update(
            _unflatten(params, grads), opt_state, params, opt_cfg)
        metrics = {"loss": loss.float(), **opt_metrics,
                   **{k: v.float() for k, v in parts.items()}}
        return {"params": new_params, "opt_state": new_opt}, metrics

    return train_step
