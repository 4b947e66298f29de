"""Activation layout constraints (the counterpart of the reference's
``repro.dist.context``).

A launcher sets the mesh axis that shards the activations' batch dim
(``activation_batch_axis``) and the one that carries sequence-parallel
attention (``attention_seq_axis``) for the duration of a step; the
models call ``constrain_batch``, ``constrain_seq`` and
``constrain_attn_seq`` where the reference calls them.  Each is the
identity when no context is active or when its tensor is not a DTensor,
so the models run unchanged on plain tensors.  Otherwise it
redistributes the DTensor on its own mesh:

* ``constrain_batch(x)``: dim 0 sharded over the batch axis; with
  ``exact=True`` every other mesh dim replicated (the reference's
  exact constraint), else its shardings left as they are.  A pending
  sum (``Partial``) is reduced either way: a constrained JAX array is a
  value, never a partial sum, and DTensor, which picks each op's layout
  on its own, would otherwise carry partial sums into the next products;
* ``constrain_seq(x)``: dim 1 (the sequence) sharded over the attention
  axis;
* ``constrain_attn_seq(q, k, v)``: ``q`` sequence-sharded and ``k``,
  ``v`` replicated over the attention axis, so every device holds the
  scores of its own queries against all keys;
* ``reduce_partial(y)``: a row-parallel product's partial sums summed
  (the all-reduce XLA puts after it); the blocks apply it to what they
  add to the residual stream, so that the stream stays a value;
* ``gather_weights(p)``: the FSDP all-gather.  Weights sharded over the
  mesh dims that carry the batch are gathered over them where a block
  uses them (XLA inserts these gathers in the reference); the backward
  of the gather reduce-scatters the gradients into the shards.
"""
from __future__ import annotations

import contextlib
import contextvars
import sys
from typing import Any, Iterator

import torch

from .sharding import Axis, _names

_BATCH: contextvars.ContextVar = contextvars.ContextVar(
    "repro_torch_batch_axis", default=(None, 1))
_ATTN_SEQ: contextvars.ContextVar = contextvars.ContextVar(
    "repro_torch_attention_seq_axis", default=(None, 1))


@contextlib.contextmanager
def _set(var: contextvars.ContextVar, axis: Axis, extent: int
         ) -> Iterator[None]:
    token = var.set((axis, extent))
    try:
        yield
    finally:
        var.reset(token)


def activation_batch_axis(axis: Axis, extent: int):
    """Shard the activations' batch dim over ``axis`` (``extent``
    devices) within the block."""
    return _set(_BATCH, axis, extent)


def attention_seq_axis(axis: Axis, extent: int):
    """Run ``attn_sp`` attention sequence-parallel over ``axis``."""
    return _set(_ATTN_SEQ, axis, extent)


def is_dtensor(x: Any) -> bool:
    """Whether ``x`` is a DTensor.  Looks the module up without importing
    it: no DTensor exists unless ``torch.distributed.tensor`` is loaded,
    so plain serving and training never load it."""
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and isinstance(x, mod.DTensor)


def _mesh_dims(x: Any, axis: Axis) -> list[int]:
    """The mesh dims of ``axis`` that hold more than one device (a
    placement on a dim of one is no layout at all)."""
    mesh = x.device_mesh
    names = list(mesh.mesh_dim_names)
    return [i for i in (names.index(a) for a in _names(axis))
            if mesh.shape[i] > 1]


class _PinGrad(torch.autograd.Function):
    """Identity whose backward lays the gradient out as the input: a
    sharding constraint holds for the cotangent too (JAX transposes one
    into the same constraint), and DTensor would otherwise let the
    gradient arrive in any layout, even one its views cannot take."""

    @staticmethod
    def forward(ctx, x):
        ctx.mesh, ctx.placements = x.device_mesh, tuple(x.placements)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        if tuple(g.placements) == ctx.placements:
            return g
        return g.redistribute(ctx.mesh, list(ctx.placements))


def _redistribute(x: Any, placements: list) -> Any:
    if list(x.placements) == placements:
        return _PinGrad.apply(x) if x.requires_grad else x
    return x.redistribute(x.device_mesh, placements)


def constrain_batch(x: torch.Tensor, exact: bool = False) -> torch.Tensor:
    axis, extent = _BATCH.get()
    if axis is None or not is_dtensor(x) or x.shape[0] % extent:
        return x
    from torch.distributed.tensor import Replicate, Shard
    dims = _mesh_dims(x, axis)
    placements = []
    for i, p in enumerate(x.placements):
        if i in dims:
            placements.append(Shard(0))
        elif exact or p.is_partial() or (p.is_shard() and p.dim == 0):
            placements.append(Replicate())
        else:
            placements.append(p)
    return _redistribute(x, placements)


def reduce_partial(x: torch.Tensor) -> torch.Tensor:
    if not is_dtensor(x) or not any(p.is_partial() for p in x.placements):
        return x
    from torch.distributed.tensor import Replicate
    return x.redistribute(x.device_mesh, [
        Replicate() if p.is_partial() else p for p in x.placements])


def gather_weights(tree: Any) -> Any:
    """``tree``'s DTensors (a dict of them or one) replicated over the
    batch axis's mesh dims, other placements kept; plain tensors as they
    are."""
    axis, _ = _BATCH.get()
    if axis is None:
        return tree
    from torch.distributed.tensor import Replicate

    def one(t):
        if not is_dtensor(t):
            return t
        dims = _mesh_dims(t, axis)
        placements = [Replicate() if i in dims else p
                      for i, p in enumerate(t.placements)]
        return _redistribute(t, placements)
    if not isinstance(tree, dict):
        return one(tree)
    return {k: gather_weights(v) for k, v in tree.items()}


def _seq_placements(x: Any, axis: Axis, placement: Any) -> list:
    from torch.distributed.tensor import Replicate
    dims = _mesh_dims(x, axis)
    out = []
    for i, p in enumerate(x.placements):
        if i in dims:
            out.append(placement)
        elif p.is_shard() and p.dim == 1:
            out.append(Replicate())
        else:
            out.append(p)
    return out


def constrain_seq(x: torch.Tensor) -> torch.Tensor:
    axis, _ = _ATTN_SEQ.get()
    if axis is None or not is_dtensor(x):
        return x
    from torch.distributed.tensor import Shard
    return _redistribute(x, _seq_placements(x, axis, Shard(1)))


def constrain_attn_seq(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
                       ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                  Axis]:
    """-> (q, k, v, the attention axis or None)."""
    axis, _ = _ATTN_SEQ.get()
    if axis is None or not is_dtensor(q):
        return q, k, v, None
    from torch.distributed.tensor import Replicate, Shard
    q = _redistribute(q, _seq_placements(q, axis, Shard(1)))
    k, v = (_redistribute(t, _seq_placements(t, axis, Replicate()))
            for t in (k, v))
    return q, k, v, axis
