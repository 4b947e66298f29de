"""Mixture-of-Experts FFN: top-k token-choice routing, GShard-style
grouped capacity, always-on shared experts (qwen2-moe) and the Switch
auxiliary load-balancing loss.

``moe_ffn`` computes the reference's function (``repro.models.moe``) in
PyTorch idiom: a cumsum gives each kept (token, k) its (expert, slot),
the tokens are gathered into an (E, G, C, d) buffer whose empty slots
stay zero, the three expert products run as batched matmuls over E, and
each token sums its gated rows of the output.
``moe_ffn_onehot`` is a plain transcription of the reference's one-hot
einsum dispatch; the tests and ``chip_smoke.py`` hold ``moe_ffn``
against it, and the model never calls it.

``torch.topk`` does not promise ``jax.lax.top_k``'s order among equal
probabilities.  Ties between fp32 router probabilities of seeded inputs
are vanishingly rare, and no test depends on one.
"""
from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from ..dist import shard_ops
from ..dist.context import constrain_batch, is_dtensor, reduce_partial
from .config import ModelConfig, MoEConfig
from .layers import ParamInit


def init_moe(mk: ParamInit, cfg: ModelConfig, stacked: int | None = None
             ) -> dict:
    m = cfg.moe
    L = () if stacked is None else (stacked,)
    A = () if stacked is None else ("layers",)
    d, e, f = cfg.d_model, m.n_experts, m.d_expert
    dt = cfg.param_dtype
    p = {"router": mk((*L, d, e), dt, (*A, "embed", None), scale=0.02),
         "up": mk((*L, e, d, f), dt, (*A, "experts", "embed", "mlp")),
         "gate": mk((*L, e, d, f), dt, (*A, "experts", "embed", "mlp")),
         "down": mk((*L, e, f, d), dt, (*A, "experts", "mlp", "embed"))}
    if m.n_shared:
        fs = f * m.n_shared
        p["shared_up"] = mk((*L, d, fs), dt, (*A, "embed", "mlp"))
        p["shared_gate"] = mk((*L, d, fs), dt, (*A, "embed", "mlp"))
        p["shared_down"] = mk((*L, fs, d), dt, (*A, "mlp", "embed"))
        p["shared_router"] = mk((*L, d, 1), dt, (*A, "embed", None),
                                scale=0.02)
    return p


# --------------------------------------------------------------------- #
# routing
# --------------------------------------------------------------------- #
def route(p: dict, cfg: ModelConfig, xt: torch.Tensor
          ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """xt (T, d) -> (gate values (T, K) fp32, expert ids (T, K), aux
    loss): the router product in ``cfg.dtype``, softmax in fp32, top-k,
    the renormalisation over the chosen k, and ``E * sum_e
    frac_tokens_e * frac_probs_e``."""
    m = cfg.moe
    logits = shard_ops.matmul(xt, p["router"].to(cfg.dtype)).float()
    gate_vals, expert_idx, probs, counts = shard_ops.rowwise(
        functools.partial(_pick, m=m), logits)
    # one-hot indices carry no gradient: frac_tokens is a constant
    frac_tokens = reduce_partial(shard_ops.row_mean(counts))
    frac_probs = reduce_partial(shard_ops.row_mean(probs))
    aux = m.n_experts * torch.sum(frac_tokens * frac_probs)
    return gate_vals, expert_idx, aux


def _pick(logits: torch.Tensor, m: MoEConfig) -> tuple[torch.Tensor, ...]:
    """A row's routing: (gate values, expert ids, probabilities, one-hot
    counts of its picks)."""
    probs = torch.softmax(logits, dim=-1)
    gate_vals, expert_idx = torch.topk(probs, m.top_k, dim=-1)
    if m.router_norm_topk:
        gate_vals = gate_vals / torch.clamp(
            gate_vals.sum(-1, keepdim=True), min=1e-9)
    counts = F.one_hot(expert_idx, m.n_experts).sum(1).float()
    return gate_vals, expert_idx, probs, counts


def group_capacity(m: MoEConfig, T: int) -> tuple[int, int]:
    """-> (Tg, cap): tokens a group (``group_size``, decremented until it
    divides T) and slots an expert has in a group, as the reference
    computes them."""
    Tg = min(m.group_size, T)
    while T % Tg:
        Tg -= 1
    cap = int(m.capacity_factor * m.top_k * Tg / m.n_experts)
    return Tg, max(cap, m.top_k)


def slots(expert_idx: torch.Tensor, m: MoEConfig, Tg: int | None = None
          ) -> tuple[torch.Tensor, torch.Tensor, int, int]:
    """expert_idx (T, K) -> (slot (T, K), keep (T, K), Tg, cap): each
    (token, k)'s position in its expert's buffer of its group, the
    running count over the group's (token, k) pairs in token-major order;
    ``keep`` is ``slot < cap``.  ``Tg`` (default: ``group_capacity``'s
    for T) is given when T is one device's share of the groups."""
    T, K = expert_idx.shape
    Tg, cap = group_capacity(m, T if Tg is None else Tg)
    idx = expert_idx.reshape(T // Tg, 1, Tg * K)
    # one-hot laid out (G, E, Tg*K): the count runs along the innermost
    # dim (along an outer dim, PyTorch's scan took 23.9 ms of a 167 ms
    # qwen2-moe-a2.7b prefill on an H100)
    onehot = idx == torch.arange(m.n_experts, device=idx.device)[:, None]
    pos = torch.cumsum(onehot, dim=2, dtype=torch.int32) - 1
    slot = torch.gather(pos, 1, idx).reshape(T, K).long()
    return slot, slot < cap, Tg, cap


# --------------------------------------------------------------------- #
# expert FFNs
# --------------------------------------------------------------------- #
def _experts(p: dict, dt: torch.dtype, xe: torch.Tensor) -> torch.Tensor:
    """xe (E, N, d) -> (E, N, d): each expert's SwiGLU on its rows, as
    batched matmuls over E."""
    h = torch.bmm(xe, p["up"].to(dt))
    h = h * F.silu(torch.bmm(xe, p["gate"].to(dt)))
    return torch.bmm(h, p["down"].to(dt))


def _grouped(p: dict, cfg: ModelConfig, xt: torch.Tensor,
             gate_vals: torch.Tensor, expert_idx: torch.Tensor
             ) -> torch.Tensor:
    """The capacity dispatch on the groups of ``group_capacity``.  On
    DTensors the groups are first laid out over the batch axis, as the
    reference constrains them (they align with the DP sharding, so the
    dispatch never crosses devices), and each device dispatches its own
    groups (``_dispatch_local``)."""
    T, d = xt.shape
    Tg, _ = group_capacity(cfg.moe, T)
    xg = constrain_batch(xt.reshape(T // Tg, Tg, d), exact=True)
    if is_dtensor(xg):
        return _dispatch_local(p, cfg, xg, gate_vals, expert_idx)
    return _dispatch(cfg.moe, xt, gate_vals, expert_idx, Tg,
                     lambda xe: _experts(p, xt.dtype, xe))


def _dispatch_local(p: dict, cfg: ModelConfig, xg: torch.Tensor,
                    gate_vals: torch.Tensor, expert_idx: torch.Tensor
                    ) -> torch.Tensor:
    """``_dispatch`` on each device's local groups of the DTensor ``xg``
    (G, Tg, d).  Its groups stay sharded over the mesh dims that shard
    dim 0 and are gathered over the others (where ``constrain_batch``
    could not shard them, over all).  Routing, slots and gathers run on
    local tensors; each block's expert buffer goes back into a DTensor
    sharded along its rows (the reference's per-block constraint) for the
    expert products against the sharded weights."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    G, Tg, d = xg.shape
    mesh = xg.device_mesh
    rows = [pl if pl.is_shard(0) else Replicate() for pl in xg.placements]

    def local(t: torch.Tensor) -> torch.Tensor:
        t = t.reshape(G, Tg, *t.shape[1:]).redistribute(mesh, rows)
        return t.to_local().reshape(-1, *t.shape[2:])

    def run(xe: torch.Tensor) -> torch.Tensor:
        xe = DTensor.from_local(xe, mesh, [Shard(1) if pl.is_shard(0)
                                           else pl for pl in rows],
                                run_check=False)
        ye = _experts(p, xg.dtype, xe)
        return ye.redistribute(mesh, xe.placements).to_local()

    y = _dispatch(cfg.moe, local(xg.reshape(G * Tg, d)), local(gate_vals),
                  local(expert_idx), Tg, run)
    return DTensor.from_local(y, mesh, rows, run_check=False)


def _dispatch(m: MoEConfig, xt: torch.Tensor, gate_vals: torch.Tensor,
              expert_idx: torch.Tensor, Tg: int, run) -> torch.Tensor:
    """The capacity dispatch: gather the tokens into an (E, G, C, d)
    buffer (each slot reads the token that fills it, an empty slot a zero
    row), run the experts (``run``), and give each token its K rows of
    the output weighted by their gates (a dropped one's gate is 0) in one
    batched product.  That product is the scatter-add of the gated
    outputs written as a gather: a token has exactly K rows, so it needs
    no atomics, and no step waits for the host to learn how many rows
    were kept.  With ``scan_groups`` > 1 the group blocks run in turn
    (only to bound the buffers: groups are independent)."""
    T, d = xt.shape
    K, E = m.top_k, m.n_experts
    dt = xt.dtype
    slot, keep, Tg, cap = slots(expert_idx, m, Tg)
    G = T // Tg
    ns = m.scan_groups
    blocks = ns if ns > 1 and G % ns == 0 else 1
    Gb, Tb = G // blocks, T // blocks
    n = E * Gb * cap
    dev = xt.device
    group = torch.div(torch.arange(Tb, device=dev), Tg,
                      rounding_mode="floor")[:, None]
    token = torch.arange(Tb, device=dev)[:, None].expand(Tb, K)
    ys = []
    for b in range(blocks):
        rows = slice(b * Tb, (b + 1) * Tb)
        kb = keep[rows]
        where = (expert_idx[rows] * Gb + group) * cap + slot[rows]
        # the token each slot reads: Tb (a zero row) unless one fills it;
        # a dropped (token, k) writes the spare entry n
        src = torch.full((n + 1,), Tb, device=dev).index_copy(
            0, torch.where(kb, where, n).reshape(-1), token.reshape(-1))
        xb = torch.cat([xt[rows], xt.new_zeros(1, d)])
        ye = run(xb[src[:n]].view(E, Gb * cap, d)).view(n, d)
        gates = (gate_vals[rows] * kb).to(dt)[:, None, :]      # (Tb,1,K)
        ys.append(torch.bmm(gates, ye[torch.where(kb, where, 0)])[:, 0])
    return torch.cat(ys)


def _dense(p: dict, cfg: ModelConfig, xt: torch.Tensor,
           gate_vals: torch.Tensor, expert_idx: torch.Tensor
           ) -> torch.Tensor:
    """Every expert on every token (the tiny smoke configs)."""
    dt = xt.dtype
    E = cfg.moe.n_experts
    y_all = _experts(p, dt, xt.expand(E, *xt.shape))      # (E, T, d)
    combine = torch.zeros(xt.shape[0], E, device=xt.device).scatter_add(
        1, expert_idx, gate_vals)                         # (T, E)
    return torch.einsum("te,etd->td", combine.to(dt), y_all)


def _shared(p: dict, cfg: ModelConfig, xt: torch.Tensor) -> torch.Tensor:
    dt = xt.dtype
    mm = shard_ops.matmul
    xr, xu, xg = shard_ops.fan_out(xt, 3)
    sg = torch.sigmoid(mm(xr, p["shared_router"].to(dt)).float())
    hs = mm(xu, p["shared_up"].to(dt))
    hs = hs * F.silu(mm(xg, p["shared_gate"].to(dt)))
    # summed over the model shards before the gate scales it and it
    # meets the routed experts' rows (DTensor would pick where to sum)
    return reduce_partial(mm(hs, p["shared_down"].to(dt))) * sg.to(dt)


def moe_ffn(p: dict, cfg: ModelConfig, x: torch.Tensor
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, d) -> (out (B, S, d), aux loss fp32)."""
    B, S, d = x.shape
    # the token rows keep x's batch layout (a no-op forward); on DTensors
    # it also lays their gradient out so before it is viewed back as x's
    xt = constrain_batch(x.reshape(B * S, d), exact=True)
    xt, xr, xs = shard_ops.fan_out(xt, 3)
    gate_vals, expert_idx, aux = route(p, cfg, xr)
    ffn = _dense if cfg.moe.dense_dispatch else _grouped
    y = ffn(p, cfg, xt, gate_vals, expert_idx)
    if cfg.moe.n_shared:
        y = y + _shared(p, cfg, xs)
    return y.reshape(B, S, d), aux


# --------------------------------------------------------------------- #
# the reference's one-hot formulation (a check, never the main path)
# --------------------------------------------------------------------- #
def onehot_dispatch(expert_idx: torch.Tensor, m: MoEConfig,
                    dtype: torch.dtype) -> torch.Tensor:
    """The reference's ``keep``-masked one-hot positions, (G, Tg, K, E,
    C) in ``dtype``; its nonzeros are the kept (token, k, expert, slot)
    assignments."""
    T, K = expert_idx.shape
    Tg, cap = group_capacity(m, T)
    assign = F.one_hot(expert_idx, m.n_experts).float()
    assign_g = assign.reshape(T // Tg, Tg, K, m.n_experts)
    flat = assign_g.reshape(T // Tg, Tg * K, m.n_experts)
    pos = (torch.cumsum(flat, dim=1) - 1.0).reshape(assign_g.shape)
    keep = (pos < cap) & (assign_g > 0)
    pos_oh = pos[..., None] == torch.arange(cap, device=pos.device)
    return (pos_oh & keep[..., None]).to(dtype)


def moe_ffn_onehot(p: dict, cfg: ModelConfig, x: torch.Tensor
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """``moe_ffn`` as the reference writes it (``repro/models/moe.py``):
    dense and grouped branches through one-hot dispatch and combine
    einsums."""
    m = cfg.moe
    dt = cfg.dtype
    B, S, d = x.shape
    T = B * S
    xt = x.reshape(T, d)
    gate_vals, expert_idx, aux = route(p, cfg, xt)
    assign = F.one_hot(expert_idx, m.n_experts).float()        # (T,K,E)
    if m.dense_dispatch:
        h = torch.einsum("td,edf->tef", xt, p["up"].to(dt))
        h = h * F.silu(torch.einsum("td,edf->tef", xt, p["gate"].to(dt)))
        y_all = torch.einsum("tef,efd->ted", h, p["down"].to(dt))
        combine = (assign * gate_vals[..., None]).sum(1)
        y = torch.einsum("te,ted->td", combine.to(dt), y_all)
    else:
        Tg, _ = group_capacity(m, T)
        G = T // Tg
        pos_oh = onehot_dispatch(expert_idx, m, dt)
        gates_g = gate_vals.reshape(G, Tg, m.top_k)
        dispatch = pos_oh.sum(2)                                # (G,Tg,E,C)
        combine = (pos_oh * gates_g.to(dt)[..., None, None]).sum(2)
        xe = torch.einsum("gtd,gtec->gecd", xt.reshape(G, Tg, d), dispatch)
        h = torch.einsum("gecd,edf->gecf", xe, p["up"].to(dt))
        h = h * F.silu(torch.einsum("gecd,edf->gecf", xe, p["gate"].to(dt)))
        ye = torch.einsum("gecf,efd->gecd", h, p["down"].to(dt))
        y = torch.einsum("gtec,gecd->gtd", combine, ye).reshape(T, d)
    if m.n_shared:
        y = y + _shared(p, cfg, xt)
    return y.reshape(B, S, d), aux
