"""DeepSeekMoE (arXiv:2401.06066) as DeepSeek-V2 runs it, on a device
that holds a share of the routed experts (expert parallelism).

    probs = softmax(fp32(x) fp32(W_r))            over all n_experts
    gates, ids = top_k(probs)                     not renormalised
    y = sum over the chosen experts e held here of gate_e expert_e(x)
        + shared(x)                               one SwiGLU, no gate

A device holds ``experts_held`` experts from ``expert_offset`` on
(``config.DeepSeekMoEConfig``) and computes their part of the layer for
every token routed to them; nothing stands in for the experts it lacks.
No token is dropped: the (token, k) pairs are sorted by expert, the held
ones first, and each held expert's three products run on its own rows.
On CUDA in bf16 they are three grouped GEMMs over the segments, their
offsets counted on the device, on a buffer of every pair's row, so the
host never waits for the routing (``torch._grouped_mm``); elsewhere one
product an expert on the held rows alone, their counts read on the host
once a layer (``moe.sync``).

The balance loss is DeepSeek-V2's per-sequence one, from the full
router (the same on every device of the deployment): for each row b,
sum_i f_bi P_bi with f_bi = count_bi E / (S K) and P_bi the row's mean
probability of expert i, averaged over the rows; ``aux_alpha`` scales it
in ``transformer.loss_fn``.

Under a profiler the layer records ``moe.route`` (router, softmax, top-k,
balance loss), ``moe.dispatch`` (the sort and the gather of the rows),
``moe.sync`` (off CUDA), ``moe.experts``, ``moe.combine`` and
``moe.shared`` (``repro_torch.spans``), and adds each held expert's pairs
to the ``moe.pairs`` counter, on the device, by layer.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .. import spans
from .config import ModelConfig
from .layers import ParamInit, init_mlp, mlp

PAIRS = "moe.pairs"


def init_moe(mk: ParamInit, cfg: ModelConfig, stacked: int | None = None
             ) -> dict:
    m = cfg.moe
    L = () if stacked is None else (stacked,)
    A = () if stacked is None else ("layers",)
    d, e, f, dt = cfg.d_model, m.held, m.d_expert, cfg.param_dtype
    return {"router": mk((*L, d, m.n_experts), dt, (*A, "embed", None)),
            "up": mk((*L, e, d, f), dt, (*A, "experts", "embed", "mlp")),
            "gate": mk((*L, e, d, f), dt, (*A, "experts", "embed", "mlp")),
            "down": mk((*L, e, f, d), dt, (*A, "experts", "mlp", "embed")),
            "shared": init_mlp(mk, d, f * m.n_shared, dt, True, stacked)}


def route(p: dict, cfg: ModelConfig, xt: torch.Tensor, rows: int
          ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """xt (T, d), ``rows`` sequences of T / rows tokens -> (gates (T, K)
    fp32, expert ids (T, K), the per-sequence balance loss, unscaled)."""
    m = cfg.moe
    probs = torch.softmax(xt.float() @ p["router"].float(), dim=-1)
    gates, ids = torch.topk(probs, m.top_k, dim=-1)
    return gates, ids, balance_loss(probs, ids, rows, m.n_experts)


def balance_loss(probs: torch.Tensor, ids: torch.Tensor, rows: int,
                 n_experts: int) -> torch.Tensor:
    """sum_i f_bi P_bi averaged over the rows b: probs (T, E), ids (T, K)
    for ``rows`` sequences laid one after another.  f_bi P_bi summed over
    i is E / (S K) times the sum over the row's picks of P_b at the
    picked expert."""
    T, K = ids.shape
    S = T // rows
    share = probs.reshape(rows, S, n_experts).mean(1)          # P_bi
    picked = share.gather(1, ids.reshape(rows, S * K))
    return picked.sum(1).mean() * (n_experts / (S * K))


def routed(p: dict, cfg: ModelConfig, xt: torch.Tensor, gates: torch.Tensor,
           ids: torch.Tensor, layer: int = 0) -> torch.Tensor:
    """The held experts' part of the layer: xt (T, d) -> (T, d), each
    token's sum over its chosen experts held here of gate x expert."""
    m = cfg.moe
    T, d = xt.shape
    K, E, dt = m.top_k, m.held, xt.dtype
    with spans.span("moe.dispatch"):
        # a pair's key: its expert's place among those held here, E for
        # an expert held elsewhere
        key = torch.remainder(ids - m.expert_offset, m.n_experts).clamp_(
            max=E).reshape(-1)
        ordered, order = torch.sort(key, stable=True)  # held pairs first
        # each held expert's end in the sorted pairs; not bincount, whose
        # CUDA kernel reads the largest key on the host
        ends = torch.searchsorted(ordered, torch.arange(
            1, E + 1, device=key.device), out_int32=True)
        on_device = grouped(xt)
        if spans.counting() or not on_device:
            counts = torch.diff(ends, prepend=ends.new_zeros(1))
            spans.count(PAIRS, layer, counts)
    if on_device:
        return _grouped_experts(p, xt, gates, key < E, order, ends)
    ye, pairs = _expert_by_expert(p, xt, order, counts, K)
    with spans.span("moe.combine"):
        w = (gates.reshape(-1)[pairs]).to(dt)[:, None]
        return torch.zeros(T * K, d, dtype=dt, device=xt.device).index_copy(
            0, pairs, ye * w).view(T, K, d).sum(1)


def grouped(xt: torch.Tensor) -> bool:
    """Whether the held experts' products run as grouped GEMMs with the
    segments' offsets on the device (``torch._grouped_mm``), as they
    must on CUDA, or one product an expert (off CUDA).  On CUDA without
    bf16 or without ``torch._grouped_mm`` it raises: the other path waits
    on the host in every MoE layer."""
    if not xt.is_cuda:
        return False
    if xt.dtype != torch.bfloat16 or not hasattr(torch, "_grouped_mm"):
        raise NotImplementedError(
            f"the held experts' grouped GEMMs on CUDA need bf16 and "
            f"torch._grouped_mm (got {xt.dtype}, torch {torch.__version__})")
    return True


class _ToPairs(torch.autograd.Function):
    """Each sorted pair's token row, x (T, d) -> (T K, d).  Backward, a
    token's gradient is the sum of its held pairs' rows (``at``, their
    place in the sorted order); a pair held elsewhere reads row 0, which
    the GEMMs always write, times 0."""

    @staticmethod
    def forward(ctx, x, tok, at, held):
        ctx.save_for_backward(at, held)
        return x.index_select(0, tok)

    @staticmethod
    def backward(ctx, g):
        at, held = ctx.saved_tensors
        rows = g.index_select(0, at.reshape(-1)).view(*at.shape, -1)
        return (torch.bmm(held.to(g.dtype)[:, None], rows)[:, 0],
                None, None, None)


class _FromPairs(torch.autograd.Function):
    """A token's sum over its pairs of weight x the pair's row, rows
    (T K, d) in sorted order at ``at`` and weights w (T, K), 0 for a pair
    held elsewhere (its ``at`` is row 0, always written) -> (T, d).
    Backward, each sorted row's gradient is its token's times its
    weight: 0 past the held rows."""

    @staticmethod
    def forward(ctx, rows, w, tok, at, order):
        picked = rows.index_select(0, at.reshape(-1)).view(*at.shape, -1)
        ctx.save_for_backward(picked, w, tok, order)
        return torch.bmm(w[:, None], picked)[:, 0]

    @staticmethod
    def backward(ctx, g):
        picked, w, tok, order = ctx.saved_tensors
        g_rows = g.index_select(0, tok) * w.reshape(-1)[order][:, None]
        g_w = torch.bmm(picked, g[:, :, None])[..., 0]
        return g_rows, g_w, None, None, None


def _grouped_experts(p: dict, xt: torch.Tensor, gates: torch.Tensor,
                     held: torch.Tensor, order: torch.Tensor,
                     ends: torch.Tensor) -> torch.Tensor:
    """Every (token, k) pair's row in ``order``, the held ones first, and
    three grouped GEMMs over the held experts' segments (offsets on the
    device): the shapes do not depend on the routing, so the host never
    waits for it.  The GEMMs leave the rows past the held pairs
    unwritten, and nothing reads them: a pair held elsewhere reads row 0
    at weight 0, forward and backward, and row 0 is always computed (the
    last segment reaches it where no pair is held here)."""
    T, K = gates.shape
    dt = xt.dtype
    with spans.span("moe.dispatch"):
        n = order.numel()
        place = torch.empty_like(order).scatter_(
            0, order, torch.arange(n, device=xt.device))
        held = held.view(T, K)
        at = torch.where(held, place.view(T, K), 0)
        # the last segment reaches row 0 at least, so that it is written
        offs = torch.cat([ends[:-1], ends[-1:].clamp(min=1)])
        tok = order // K
        xs = _ToPairs.apply(xt, tok, at, held)
    with spans.span("moe.experts"):
        up, gate, down = (p[k].to(dt) for k in ("up", "gate", "down"))
        h = torch._grouped_mm(xs, up, offs=offs) * F.silu(
            torch._grouped_mm(xs, gate, offs=offs))
        ye = torch._grouped_mm(h, down, offs=offs)
    with spans.span("moe.combine"):
        w = torch.where(held, gates, 0).to(dt)
        return _FromPairs.apply(ye, w, tok, at, order)


def _expert_by_expert(p: dict, xt: torch.Tensor, order: torch.Tensor,
                      counts: torch.Tensor, K: int
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """The held pairs' rows alone, one product an expert on its segment,
    the segments' sizes read on the host (``moe.sync``) -> (rows out,
    their pairs)."""
    dt = xt.dtype
    with spans.span("moe.sync"):
        sizes = counts.tolist()
    with spans.span("moe.dispatch"):
        pairs = order[:sum(sizes)]
        xs = xt[pairs // K]
    with spans.span("moe.experts"):
        # one unbind a weight: its backward is one stack, where indexing
        # each expert would add a zero tensor of all the experts' size
        outs, at = [], 0
        for size, u, g, d in zip(sizes, *(p[k].to(dt).unbind()
                                          for k in ("up", "gate", "down"))):
            xe = xs[at: at + size]
            outs.append(((xe @ u) * F.silu(xe @ g)) @ d)
            at += size
        return torch.cat(outs), pairs


def moe_ffn(p: dict, cfg: ModelConfig, x: torch.Tensor, layer: int = 0
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, d) -> (out (B, S, d), the balance loss fp32, unscaled)."""
    B, S, d = x.shape
    xt = x.reshape(B * S, d)
    with spans.span("moe.route"):
        gates, ids, aux = route(p, cfg, xt, B)
    y = routed(p, cfg, xt, gates, ids, layer)
    with spans.span("moe.shared"):
        y = y + mlp(p["shared"], xt, cfg.act)
    return y.reshape(B, S, d), aux
