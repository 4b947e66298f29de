"""Logical -> mesh mapping, divisibility-safe (the counterpart of the
reference's ``repro.dist.sharding``, which its tree lacks; its API is
what the reference's models, launchers and tests call).

A parameter or activation names one *logical* axis a dim (``"embed"``,
``"heads"``, ...; ``None`` for a dim that never shards).  ``Rules``
gives each logical axis an ordered tuple of candidate mesh axes; a
candidate is an axis name, a tuple of names sharded together (in mesh
order), or ``None`` (replicate).  ``logical_to_pspec`` takes, for each
dim in turn, the first candidate whose axes exist in the mesh, are not
used by an earlier dim, and whose extent divides the dim; a dim with no
such candidate is replicated.  So heads that do not divide the model
axis leave it to ``head_dim``, no mesh axis is used twice, and ``batch``
takes ``("pod", "data")`` only on a mesh with a ``pod`` axis.

A ``PSpec`` is a plain tuple with one entry a dim: ``None``, an axis
name or a tuple of names.  ``to_placements`` turns it into DTensor
placements on a ``DeviceMesh``: a dim over two mesh axes becomes
``Shard(i)`` on both mesh dims, in mesh order.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple

import torch

Axis = str | tuple[str, ...] | None
PSpec = tuple[Axis, ...]


@dataclasses.dataclass(frozen=True)
class Rules:
    """Candidate mesh axes per logical axis, tried in order."""
    batch: tuple = (("pod", "data"), "data", None)
    seq: tuple = (None,)
    embed: tuple = ("data", None)          # FSDP
    mlp: tuple = ("model", None)           # feature TP
    heads: tuple = ("model", None)
    kv_heads: tuple = ("model", None)
    head_dim: tuple = ("model", None)      # when the heads do not divide
    vocab: tuple = ("model", None)
    experts: tuple = (None,)
    layers: tuple = (None,)

    def replace(self, **kw: tuple) -> "Rules":
        return dataclasses.replace(self, **kw)


# training: FSDP over data (and pod), TP over model
RULES_TRAIN = Rules()
# serving: weights TP over model and replicated over data; the batch
# (and the caches) over data
RULES_DECODE = Rules(embed=(None,))
_RULES = {
    "train": RULES_TRAIN,
    "decode": RULES_DECODE,
    # expert parallelism: the experts over data, their features over model
    "train_ep": RULES_TRAIN.replace(experts=("data", None)),
    # sequence-parallel prefill: the sequence over model
    "prefill_sp": RULES_DECODE.replace(seq=("model", None)),
}


def get_rules(name: str) -> Rules:
    if name not in _RULES:
        raise KeyError(f"unknown rules {name!r}; known: {sorted(_RULES)}")
    return _RULES[name]


def mesh_axes(mesh: Any) -> dict[str, int]:
    """Axis name -> extent, for a ``DeviceMesh`` (whose ``shape`` is a
    tuple beside ``mesh_dim_names``) or a mesh whose ``shape`` is already
    such a dict (the reference's ``jax.sharding.Mesh``, test doubles)."""
    if isinstance(mesh.shape, dict):
        return dict(mesh.shape)
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def _names(axis: Axis) -> tuple[str, ...]:
    if axis is None:
        return ()
    return (axis,) if isinstance(axis, str) else tuple(axis)


def _mesh_extent(mesh: Any, axis: Axis) -> int:
    sizes = mesh_axes(mesh)
    return math.prod(sizes[a] for a in _names(axis))


def _pick(candidates: tuple, dim: int, sizes: dict[str, int],
          used: set[str]) -> Axis:
    for cand in candidates:
        if cand is None:
            return None
        names = _names(cand)
        if any(a not in sizes or a in used for a in names):
            continue
        if dim % math.prod(sizes[a] for a in names) == 0:
            return cand
    return None


def logical_to_pspec(logical: tuple, shape: tuple[int, ...], mesh: Any,
                     rules: Rules = RULES_TRAIN) -> PSpec:
    if len(logical) != len(shape):
        raise ValueError(f"axes {logical} do not match shape {shape}")
    sizes = mesh_axes(mesh)
    used: set[str] = set()
    out = []
    for name, dim in zip(logical, shape):
        entry = None if name is None else _pick(getattr(rules, name), dim,
                                                sizes, used)
        used.update(_names(entry))
        out.append(entry)
    return tuple(out)


def batch_axis(mesh: Any, global_batch: int,
               rules: Rules = RULES_TRAIN) -> Axis:
    """The mesh axis (or tuple) a batch of ``global_batch`` rows shards
    over; None when none divides it."""
    return logical_to_pspec(("batch",), (global_batch,), mesh, rules)[0]


def to_placements(pspec: PSpec, mesh: Any) -> list:
    """DTensor placements of ``pspec`` on a ``DeviceMesh``; a mesh dim of
    one device stays ``Replicate`` (the same layout)."""
    from torch.distributed.tensor import Replicate, Shard
    order = list(mesh.mesh_dim_names)
    placements = [Replicate() for _ in order]
    for dim, entry in enumerate(pspec):
        idx = [order.index(a) for a in _names(entry)]
        if idx != sorted(idx):
            raise ValueError(f"{entry} is not in mesh order {order}")
        for i in idx:
            if mesh.shape[i] > 1:
                placements[i] = Shard(dim)
    return placements


def _is_spec(x: Any) -> bool:
    return isinstance(x, tuple)


def tree_map_specs(fn, specs: Any, *trees: Any) -> Any:
    """``fn(spec, *leaves)`` over a specs tree (dicts of logical-axes
    tuples) and trees of the same keys."""
    if _is_spec(specs):
        return fn(specs, *trees)
    return {k: tree_map_specs(fn, specs[k], *(t[k] for t in trees))
            for k in specs}


def tree_pspecs(specs: Any, tree: Any, mesh: Any,
                rules: Rules = RULES_TRAIN) -> Any:
    return tree_map_specs(
        lambda s, t: logical_to_pspec(s, tuple(t.shape), mesh, rules),
        specs, tree)


class Sharding(NamedTuple):
    """One leaf's layout: its ``DeviceMesh`` and DTensor placements."""
    mesh: Any
    placements: tuple


def tree_shardings(specs: Any, tree: Any, mesh: Any,
                   rules: Rules = RULES_TRAIN) -> Any:
    return tree_map_specs(
        lambda s, t: Sharding(mesh, tuple(to_placements(
            logical_to_pspec(s, tuple(t.shape), mesh, rules), mesh))),
        specs, tree)


def distribute_leaf(sh: Sharding, t: torch.Tensor) -> Any:
    """``t`` as a DTensor laid out as ``sh``: every rank holds the whole
    tensor and keeps its own shard (no communication)."""
    from torch.distributed.tensor import distribute_tensor
    return distribute_tensor(t, sh.mesh, list(sh.placements),
                             src_data_rank=None)


def distribute(tree: Any, specs: Any, mesh: Any,
               rules: Rules = RULES_TRAIN) -> Any:
    """``tree``'s tensors as DTensors laid out by ``rules``.  Every rank
    holds the whole tensor (the same seed on every rank, or ``meta``
    shapes) and keeps its own shard: no communication."""
    return tree_map_specs(lambda s, sh, t: distribute_leaf(sh, t), specs,
                          tree_shardings(specs, tree, mesh, rules), tree)
