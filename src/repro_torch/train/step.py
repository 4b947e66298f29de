"""The train step.

``make_train_step`` builds ``train_step(state, batch) -> (state,
metrics)``: one ``cfg.dtype`` copy of the fp32 matrices a step (the
reference's ``cast_weights``), gradients of ``transformer.loss_fn`` with
respect to that copy (per-layer remat inside the model), optional
microbatched accumulation in fp32 over the reference's strided split,
then the AdamW update, written into ``state``'s tensors in place.
Under a profiler each phase records a span (``repro_torch.spans``):
``step.cast``, ``step.forward`` and ``step.backward`` a microbatch,
``step.optimizer``.

On a mesh the state is a tree of DTensors (``train_state_shardings``,
``repro_torch.dist.sharding.distribute``): ``batch_axis`` lays each
microbatch's rows over the DP axes and ``grad_shardings`` each
microbatch's gradients onto the parameters' layout (reduce-scatters
into the FSDP/TP shards), as the reference's constraints do.
``init_train_state`` returns the state alone; its logical specs are
``train_state_specs(cfg)``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from .. import spans
from ..dist import sharding as shd
from ..dist.context import is_dtensor
from ..models import transformer
from ..models.config import ModelConfig
from ..models.registry import leaves
from ..optim import AdamWConfig, adamw_init, adamw_update, opt_state_specs


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
    without a card; ``"meta"``: shapes only)."""
    params = transformer.init_params(cfg, seed, device)
    return TrainState(params, adamw_init(params, opt_cfg))


def train_state_specs(cfg: ModelConfig) -> dict:
    """The logical axes of ``init_train_state``'s tree."""
    pspecs = transformer.param_specs(cfg)
    return {"params": pspecs, "opt_state": opt_state_specs(pspecs)}


def train_state_shardings(specs: Any, state_tree: Any, mesh, rules):
    return shd.tree_shardings(specs, state_tree, mesh, rules)


def _plain(t: torch.Tensor) -> torch.Tensor:
    """A scalar as a plain tensor (a DTensor's value, replicated)."""
    return t.full_tensor() if is_dtensor(t) else t


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
                    n_microbatches: int = 1, batch_axis: Any = None,
                    grad_shardings: Any = None) -> Callable:
    """-> train_step(state_tree, batch) -> (state_tree, metrics).

    ``batch`` holds tensors on the state's device.  Microbatch ``j``
    takes rows ``j, n + j, 2n + j, ...`` (the reference's strided split);
    the gradients accumulate in fp32 and are scaled by ``1 / n``.

    ``batch_axis``: the mesh axis (or tuple) each microbatch's rows are
    laid over, every other mesh dim replicated; a plain tensor is taken
    as the same whole batch on every rank.  ``grad_shardings``: a tree
    of ``sharding.Sharding`` (the parameters' layouts) that each
    microbatch's gradients are redistributed to.  Both need the state on
    a mesh (DTensors)."""
    shardings = (None if grad_shardings is None
                 else list(leaves(grad_shardings)))

    def constrain_mb(mb: dict, mesh) -> dict:
        if batch_axis is None:
            return mb
        from torch.distributed.tensor import DTensor, Replicate, Shard
        dims = [mesh.mesh_dim_names.index(a)
                for a in ((batch_axis,) if isinstance(batch_axis, str)
                          else batch_axis)]
        rows = [Shard(0) if i in dims and mesh.shape[i] > 1 else Replicate()
                for i in range(mesh.ndim)]

        def one(t):
            if not is_dtensor(t):
                t = DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                                       run_check=False)
            return t.redistribute(mesh, rows)
        return {k: one(v) for k, v in mb.items()}

    def grads_of(params_c: dict, batch: dict, j: int = 0
                 ) -> tuple[torch.Tensor, dict, list[torch.Tensor]]:
        """(loss, parts, gradients) of microbatch ``j``, the first two
        detached so that no graph outlives the call, the gradients on
        ``grad_shardings``."""
        with spans.span("step.forward", microbatch=j):
            loss, parts = transformer.loss_fn(params_c, cfg, batch)
        with spans.span("step.backward", microbatch=j):
            grads = list(torch.autograd.grad(_plain(loss),
                                             list(leaves(params_c))))
            if shardings is not None:
                grads = [g.redistribute(s.mesh, list(s.placements))
                         for g, s in zip(grads, shardings)]
        return (_plain(loss).detach(),
                {k: _plain(v).detach() for k, v in parts.items()}, grads)

    def train_step(state: dict, batch: dict) -> tuple[dict, dict]:
        params, opt_state = state["params"], state["opt_state"]
        with spans.span("step.cast"):
            params_c = cast_weights(cfg, params)
        mesh = getattr(next(leaves(params)), "device_mesh", None)
        if n_microbatches == 1:
            loss, parts, grads = grads_of(params_c, constrain_mb(batch, mesh))
        else:
            B = next(iter(batch.values())).shape[0]
            if B % n_microbatches:
                raise ValueError(f"batch {B} does not split into "
                                 f"{n_microbatches} microbatches")
            n = n_microbatches
            for j in range(n):
                # rows j, n + j, ...: a view that keeps a sharded batch
                # dim sharded (the reference's strided resplit)
                mb = {k: v.unflatten(0, (B // n, n))[:, j]
                      for k, v in batch.items()}
                l, _, g = grads_of(params_c, constrain_mb(mb, mesh), j)
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
        with spans.span("step.optimizer"):
            new_params, new_opt, opt_metrics = adamw_update(
                _unflatten(params, grads), opt_state, params, opt_cfg)
        metrics = {"loss": loss.float(),
                   **{k: _plain(v) for k, v in opt_metrics.items()},
                   **{k: v.float() for k, v in parts.items()}}
        return {"params": new_params, "opt_state": new_opt}, metrics

    return train_step
