"""Products, the embedding lookup and the token NLL on each device's
shards, forward and backward.

DTensor picks a layout for every op that no constraint pins, the
backward's ops included, and PyTorch versions pick differently: the
same training cell came out at 9.72 GiB a device under 2.11 and 12.45
under 2.13.  Each op here states its layouts instead.  A custom autograd
function runs the op on each device's local shards, wraps the result
with the placements it has, and does the same for the gradients, so
every version runs the same local ops and collectives.  Layouts outside
the cases below go to DTensor's own op, as before.

* ``matmul(x, w)``: ``x @ w`` for x (..., k) and w (k, n).  On each mesh
  dim: x's rows sharded and w replicated give rows sharded (w's gradient
  a partial sum); x replicated and w's columns sharded give columns
  sharded (x's gradient a partial sum); k sharded in both gives a
  partial sum (the gradients exact); both replicated give replicated.
* ``embedding(table, ids)``: ``table[ids]``, rows as the ids', the
  embed dim as the table's.  A vocab-sharded table is not gathered:
  each device looks up the ids in its own range and one all-reduce sums
  the rows (Megatron's vocab-parallel embedding).  The table's gradient
  is each device's own rows, a partial sum over the ids' row shards.
* ``fan_out(x, n)``: ``n`` uses of ``x`` whose gradients are summed on
  the shards and laid out as ``x``: where some are partial sums and
  others whole, the whole ones are divided by the mesh dim's size (exact
  for a power of two), so one all-reduce sums them all.
* ``row_mean(x)``: ``x.mean(0)``, each device summing its own rows into
  a partial sum; the gradient spread back over each device's rows.
* ``rowwise(fn, x, *ws)``: ``fn(x, *ws)`` for an op on whole rows of
  x's last dim (a norm, the router's softmax and top-k), on each
  device's rows; the weights gathered, their gradient a partial sum
  over the row shards.
* ``nll(logits, labels)``: ``logsumexp(logits) - logits[labels]`` over
  the last dim.  Each device works on its own vocab range, with one
  all-reduce each for the max, the sum of exponentials and the gold
  logit (Megatron's vocab-parallel cross-entropy); the gradient
  ``softmax - onehot`` is local.
* ``local_map(fn, args, layouts, outs)``: any function (a scan, a decode
  core) on each device's shards, its inputs laid out as stated and its
  outputs wrapped with the placements stated; an input replicated over
  a mesh dim that shards another input gets a partial sum as its
  gradient there.  ``sum_over(t, mesh, dims)`` inside such a function
  sums a local tensor over mesh dims (one all-reduce, differentiable).
"""
from __future__ import annotations

from typing import Any

import torch

from .context import is_dtensor, reduce_partial


def wrap(local: torch.Tensor, mesh: Any, placements, shape) -> Any:
    """``local`` as a device's shard of a contiguous DTensor of global
    ``shape`` laid out as ``placements`` (no check, no communication;
    the strides are computed, not read off an allocated tensor)."""
    from torch.distributed.tensor import DTensor
    stride, acc = [], 1
    for n in reversed(tuple(shape)):
        stride.append(acc)
        acc *= max(n, 1)
    return DTensor.from_local(
        local, mesh, list(placements), run_check=False,
        shape=torch.Size(shape), stride=tuple(reversed(stride)))


def _local(g: Any, placements) -> torch.Tensor:
    """The gradient ``g`` laid out as ``placements``, a pending sum
    summed: its local shard."""
    from torch.distributed.tensor import Replicate
    want = [Replicate() if p.is_partial() else p for p in placements]
    if list(g.placements) != want:
        g = g.redistribute(g.device_mesh, want)
    return g.to_local()


# ------------------------------------------------------------------ #
# products
# ------------------------------------------------------------------ #
def _mm_plan(px, pw, last: int):
    """-> (out, grad x, grad w) placements, or None."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    out, gx, gw = [], [], []
    for a, b in zip(px, pw):
        if a.is_partial() or b.is_partial():
            return None
        if a.is_shard() and a.dim < last and b.is_replicate():
            out.append(a), gx.append(a), gw.append(Partial())
        elif a.is_replicate() and b.is_shard(1):
            out.append(Shard(last)), gx.append(Partial()), gw.append(b)
        elif a.is_shard(last) and b.is_shard(0):
            out.append(Partial()), gx.append(a), gw.append(b)
        elif a.is_replicate() and b.is_replicate():
            out.append(Replicate()), gx.append(a), gw.append(b)
        else:
            return None
    return tuple(out), tuple(gx), tuple(gw)


class _LocalMatmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, plan):
        ctx.plan = plan
        ctx.save_for_backward(x, w)
        y = x.to_local() @ w.to_local()
        return wrap(y, x.device_mesh, plan[0], (*x.shape[:-1], w.shape[1]))

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        out, gx_pl, gw_pl = ctx.plan
        g = _local(g, out)
        x_l, w_l = x.to_local(), w.to_local()
        gx = g @ w_l.mT
        gw = x_l.reshape(-1, x_l.shape[-1]).mT @ g.reshape(-1, g.shape[-1])
        mesh = x.device_mesh
        return (wrap(gx, mesh, gx_pl, x.shape),
                wrap(gw, mesh, gw_pl, w.shape), None)


def matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` for x (..., k) and w (k, n); on DTensors on each
    device's shards (the module's cases), else DTensor's own."""
    if not (is_dtensor(x) and is_dtensor(w)) or w.ndim != 2:
        return x @ w
    plan = _mm_plan(x.placements, w.placements, x.ndim - 1)
    if plan is None:
        return x @ w
    return _LocalMatmul.apply(x, w, plan)


# ------------------------------------------------------------------ #
# fan-out
# ------------------------------------------------------------------ #
class _FanOut(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, n):
        ctx.like = (x.device_mesh, tuple(x.placements), x.shape)
        ctx.set_materialize_grads(False)        # an unused one gets None
        return tuple(x.view_as(x) for _ in range(n))

    @staticmethod
    def backward(ctx, *gs):
        from torch.distributed.tensor import Partial
        mesh, like, shape = ctx.like
        gs = [g for g in gs if g is not None]
        if not gs:
            return None, None
        part = [any(g.placements[i].is_partial() for g in gs)
                for i in range(mesh.ndim)]
        target = [Partial() if part[i] and p.is_replicate() else p
                  for i, p in enumerate(like)]
        total = None
        for g in gs:
            keep = [g.placements[i] if part[i] and p.is_partial() else p
                    for i, p in enumerate(target)]
            if list(g.placements) != keep:
                g = g.redistribute(mesh, keep)
            local, scale = g.to_local(), 1
            for i, p in enumerate(g.placements):
                if target[i].is_partial() and p.is_replicate():
                    scale *= mesh.shape[i]
            if scale > 1:
                local = local / scale
            total = local if total is None else total + local
        out = wrap(total, mesh, target, shape)
        if target != list(like):
            out = out.redistribute(mesh, list(like))
        return out, None


def fan_out(x: torch.Tensor, n: int) -> tuple[torch.Tensor, ...]:
    """``n`` uses of ``x`` (the module's ``fan_out``); plain tensors and
    tensors autograd does not record come back as they are."""
    if not (is_dtensor(x) and x.requires_grad):
        return (x,) * n
    return _FanOut.apply(x, n)


# ------------------------------------------------------------------ #
# row-wise ops
# ------------------------------------------------------------------ #
def rowwise(fn, x: torch.Tensor, *ws: torch.Tensor) -> Any:
    """``fn(x, *ws)``, where ``fn`` works on whole rows of ``x``'s last
    dim and returns one tensor or a tuple of them, each with ``x``'s
    rows; on a DTensor ``x`` whose last dim no mesh dim shards, on each
    device's rows, else as it is."""
    last = x.ndim - 1
    if not is_dtensor(x) or any(p.is_partial() or p.is_shard(last)
                                for p in x.placements):
        return fn(x, *ws)
    from torch.distributed.tensor import Partial, Replicate
    mesh, pl = x.device_mesh, list(x.placements)
    whole = [Replicate()] * mesh.ndim
    grad = [Partial() if p.is_shard() else Replicate() for p in pl]
    ws_l = [w if not is_dtensor(w) else
            (w.redistribute(mesh, whole) if list(w.placements) != whole
             else w).to_local(grad_placements=grad) for w in ws]
    out = fn(x.to_local(), *ws_l)

    def one(t):
        return wrap(t, mesh, pl, (*x.shape[:last], *t.shape[last:]))
    return tuple(map(one, out)) if isinstance(out, tuple) else one(out)


class _RowMean(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        from torch.distributed.tensor import Partial, Replicate
        mesh, pl = x.device_mesh, list(x.placements)
        ctx.like = (mesh, pl, x.shape, x.to_local().shape[0])
        out = [Partial() if p.is_shard(0) else Replicate() for p in pl]
        local = x.to_local().sum(0) / x.shape[0]
        return wrap(local, mesh, out, x.shape[1:])

    @staticmethod
    def backward(ctx, g):
        from torch.distributed.tensor import Replicate
        mesh, pl, shape, rows = ctx.like
        g = _local(g, [Replicate()] * mesh.ndim)
        return wrap((g / shape[0]).expand(rows, *g.shape).contiguous(),
                    mesh, pl, shape)


def row_mean(x: torch.Tensor) -> torch.Tensor:
    """``x.mean(0)``; on a DTensor whose other dims no mesh dim shards,
    on each device's rows (the module's ``row_mean``)."""
    if not is_dtensor(x) or not all(p.is_replicate() or p.is_shard(0)
                                    for p in x.placements):
        return x.mean(0)
    return _RowMean.apply(x)


# ------------------------------------------------------------------ #
# embedding
# ------------------------------------------------------------------ #
class _LocalEmbedding(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, ids_l, r0, out, g_table, shape):
        t = table.to_local()
        idx = ids_l - r0
        inside = (idx >= 0) & (idx < t.shape[0])
        idx = idx.clamp(0, t.shape[0] - 1)
        ctx.plan = (table.device_mesh, table.shape, out, g_table)
        ctx.save_for_backward(idx, inside)
        y = t[idx]
        if any(p.is_partial() for p in out):
            y = y * inside[..., None].to(y.dtype)
        return wrap(y, table.device_mesh, out, shape)

    @staticmethod
    def backward(ctx, g):
        idx, inside = ctx.saved_tensors
        mesh, shape, out, g_table = ctx.plan
        from torch.distributed.tensor._utils import (
            compute_local_shape_and_global_offset)
        rows, _ = compute_local_shape_and_global_offset(shape, mesh,
                                                        g_table)
        g = _local(g, out) * inside[..., None].to(g.dtype)
        gt = g.new_zeros(rows[0], g.shape[-1]).index_add_(
            0, idx.reshape(-1), g.reshape(-1, g.shape[-1]))
        return wrap(gt, mesh, g_table, shape), None, None, None, None, None


def embedding(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``table[ids]`` for a (V, d) table; on a DTensor table on each
    device's rows of ``ids`` (a DTensor, or a plain tensor every rank
    holds whole).  Where the vocab is sharded each device looks up the
    ids in its own range and the rows are summed over the shards
    (Megatron's vocab-parallel embedding); the table is never gathered
    there."""
    if not is_dtensor(table):
        return table[ids]
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset)
    mesh = table.device_mesh
    table = reduce_partial(table)
    if not is_dtensor(ids):
        ids = DTensor.from_local(ids, mesh, [Replicate()] * mesh.ndim,
                                 run_check=False)
    tp, out, g_table = [], [], []
    for a, b in zip(ids.placements, table.placements):
        if a.is_shard() and b.is_shard(1):
            return torch.nn.functional.embedding(ids, table)
        if a.is_shard() and b.is_shard(0):
            b = Replicate()             # the ids' rows need every vocab row
        tp.append(b)
        if b.is_shard(0):
            out.append(Partial()), g_table.append(b)
        elif b.is_shard(1):
            out.append(Shard(ids.ndim)), g_table.append(b)
        else:
            out.append(a if a.is_shard() else Replicate())
            g_table.append(Partial() if a.is_shard() else b)
    if tp != list(table.placements):
        table = table.redistribute(mesh, tp)
    _, off = compute_local_shape_and_global_offset(table.shape, mesh, tp)
    y = _LocalEmbedding.apply(table, ids.to_local(), off[0], tuple(out),
                              tuple(g_table), (*ids.shape, table.shape[1]))
    return reduce_partial(y)


# ------------------------------------------------------------------ #
# token NLL
# ------------------------------------------------------------------ #
def _sum_over(t: torch.Tensor, mesh, vocab, rows, op: str) -> torch.Tensor:
    """The local (rows) ``t`` reduced with ``op`` over the vocab mesh
    dims."""
    if not any(vocab):
        return t
    from torch.distributed.tensor import DTensor, Partial
    src = [Partial(op) if v else p for v, p in zip(vocab, rows)]
    d = DTensor.from_local(t, mesh, src, run_check=False)
    return d.redistribute(mesh, list(rows)).to_local()


class _VocabNLL(torch.autograd.Function):
    @staticmethod
    def forward(ctx, logits, labels_l, offset, vocab, rows):
        mesh = logits.device_mesh
        l = logits.to_local()
        m = _sum_over(l.amax(-1), mesh, vocab, rows, "max")
        s = _sum_over(torch.exp(l - m[..., None]).sum(-1), mesh, vocab,
                      rows, "sum")
        lse = m + torch.log(s)
        idx = labels_l - offset
        inside = (idx >= 0) & (idx < l.shape[-1])
        idx = idx.clamp(0, l.shape[-1] - 1)
        pick = torch.gather(l, -1, idx[..., None])[..., 0]
        gold = _sum_over(torch.where(inside, pick, 0.0), mesh, vocab, rows,
                         "sum")
        ctx.save_for_backward(logits, lse, idx, inside)
        ctx.rows = rows
        return wrap(lse - gold, mesh, rows, logits.shape[:-1])

    @staticmethod
    def backward(ctx, g):
        logits, lse, idx, inside = ctx.saved_tensors
        g = _local(g, ctx.rows)
        l = logits.to_local()
        grad = torch.exp(l - lse[..., None])
        grad.scatter_add_(-1, idx[..., None], -inside.to(grad.dtype)[..., None])
        grad = grad * g[..., None]
        return (wrap(grad, logits.device_mesh, logits.placements,
                      logits.shape), None, None, None, None)


def nll(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """``logsumexp(logits) - logits[..., labels]`` over the last dim;
    on DTensor logits each device on its own vocab range."""
    if not is_dtensor(logits):
        return (torch.logsumexp(logits, dim=-1)
                - torch.gather(logits, -1, labels[..., None])[..., 0])
    from torch.distributed.tensor import DTensor, Replicate
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset)
    mesh, last = logits.device_mesh, logits.ndim - 1
    logits = reduce_partial(logits)
    vocab = tuple(p.is_shard(last) for p in logits.placements)
    rows = tuple(Replicate() if v else p
                 for v, p in zip(vocab, logits.placements))
    if not is_dtensor(labels):
        labels = DTensor.from_local(labels, mesh, [Replicate()] * mesh.ndim,
                                    run_check=False)
    labels_l = labels.redistribute(mesh, list(rows)).to_local()
    _, offset = compute_local_shape_and_global_offset(
        logits.shape, mesh, logits.placements)
    return _VocabNLL.apply(logits, labels_l, offset[last], vocab, rows)


# ------------------------------------------------------------------ #
# any function on each device's shards
# ------------------------------------------------------------------ #
def local_map(fn, args, layouts, outs) -> Any:
    """``fn(*args)``; where some argument is a DTensor, on each device's
    shards.  ``layouts`` gives each argument's placements (``None``: it
    goes in as it is: a plain tensor, a number); each DTensor is laid out
    so (a redistribution where it is not already) and taken local.  Its
    gradient comes back laid out the same, except over a mesh dim that
    it replicates and another argument shards: there the device used it
    for its share of the work only, and its gradient is a partial sum.
    ``outs`` gives the placements of each of ``fn``'s outputs (one list,
    or a tuple of lists for a tuple of outputs); their global shapes are
    the local ones times the shards."""
    if not any(is_dtensor(a) for a in args):
        return fn(*args)
    from torch.distributed.tensor import Partial
    mesh = next(a.device_mesh for a in args if is_dtensor(a))
    split = {i for lay in layouts if lay is not None
             for i, p in enumerate(lay) if p.is_shard()}
    local = []
    for a, lay in zip(args, layouts):
        if lay is None or not is_dtensor(a):
            local.append(a)
            continue
        lay = list(lay)
        if list(a.placements) != lay:
            a = a.redistribute(mesh, lay)
        grad = [Partial() if p.is_replicate() and i in split else p
                for i, p in enumerate(lay)]
        local.append(a.to_local(grad_placements=grad))
    out = fn(*local)

    def one(t, pl):                # evenly sharded: local x shards
        shape = list(t.shape)
        for n, p in zip(mesh.shape, pl):
            if p.is_shard():
                shape[p.dim] *= n
        return wrap(t.contiguous(), mesh, pl, shape)
    if isinstance(out, tuple):
        return tuple(one(t, pl) for t, pl in zip(out, outs))
    return one(out, outs)


def sum_over(t: torch.Tensor, mesh: Any, dims) -> torch.Tensor:
    """The local ``t`` summed over the mesh dims ``dims``, for use on
    each device's shard (inside ``local_map``): one all-reduce forward,
    and one backward, since each device's gradient of the sum is the
    share of its own shard and each term's gradient is their sum."""
    if mesh is None or not dims:
        return t
    from torch.distributed.tensor import DTensor, Partial, Replicate
    whole = [Replicate()] * mesh.ndim
    src = [Partial() if i in dims else Replicate() for i in range(mesh.ndim)]
    d = DTensor.from_local(t, mesh, src, run_check=False)
    return d.redistribute(mesh, whole).to_local(grad_placements=src)


def mesh_dims(x: Any, dim: int) -> list[int]:
    """The mesh dims on which the DTensor ``x`` shards its dim ``dim``
    (``[]`` for a plain tensor)."""
    if not is_dtensor(x):
        return []
    dim %= x.ndim
    return [i for i, p in enumerate(x.placements) if p.is_shard(dim)]


def layout(ndim: int, shards: dict[int, int]) -> list:
    """Placements over ``ndim`` mesh dims: ``Shard(shards[i])`` on the
    mesh dims ``shards`` names, ``Replicate`` on the rest."""
    from torch.distributed.tensor import Replicate, Shard
    return [Shard(shards[i]) if i in shards else Replicate()
            for i in range(ndim)]


def rows_heads_layouts(x: Any, heads: Any, roles: dict) -> dict:
    """Placements for a block's core on each device's rows and heads, on
    ``x``'s mesh: ``roles`` maps a name to (the dim of its rows, the dim
    of its heads), ``None`` for a tensor whole over those mesh dims.  The
    rows are sharded over the mesh dims that shard ``x``'s dim 0, the
    heads over those that shard ``heads``' dim 0 (a per-head weight) and
    not the rows.  Key ``"heads"``: those mesh dims.  On a plain ``x``
    every role is ``None`` and ``"heads"`` empty."""
    if not is_dtensor(x):
        return {**dict.fromkeys(roles), "heads": []}
    n = x.device_mesh.ndim
    rows = mesh_dims(x, 0)
    hd = [i for i in mesh_dims(heads, 0) if i not in rows]
    out = {name: layout(n, {**({i: r for i in rows} if r is not None
                                else {}),
                            **({i: h for i in hd} if h is not None
                               else {})})
           for name, (r, h) in roles.items()}
    return {**out, "heads": hd}


def local_offset(x: Any, dim: int, placements) -> int:
    """Where this device's shard of dim ``dim`` starts when the DTensor
    ``x``'s mesh lays a tensor of ``x``'s shape out as ``placements``
    (0 for a plain tensor)."""
    if not is_dtensor(x):
        return 0
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset)
    _, off = compute_local_shape_and_global_offset(
        x.shape, x.device_mesh, list(placements))
    return off[dim]
