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

import torch
import torch.nn.functional as F

from .config import ModelConfig, MoEConfig
from .layers import ParamInit


def init_moe(mk: ParamInit, cfg: ModelConfig, stacked: int | None = None
             ) -> dict:
    m = cfg.moe
    L = () if stacked is None else (stacked,)
    d, e, f = cfg.d_model, m.n_experts, m.d_expert
    dt = cfg.param_dtype
    p = {"router": mk((*L, d, e), dt, scale=0.02),
         "up": mk((*L, e, d, f), dt),
         "gate": mk((*L, e, d, f), dt),
         "down": mk((*L, e, f, d), dt)}
    if m.n_shared:
        p["shared_up"] = mk((*L, d, f * m.n_shared), dt)
        p["shared_gate"] = mk((*L, d, f * m.n_shared), dt)
        p["shared_down"] = mk((*L, f * m.n_shared, d), dt)
        p["shared_router"] = mk((*L, d, 1), dt, scale=0.02)
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
    logits = (xt @ p["router"].to(cfg.dtype)).float()
    probs = torch.softmax(logits, dim=-1)
    gate_vals, expert_idx = torch.topk(probs, m.top_k, dim=-1)
    if m.router_norm_topk:
        gate_vals = gate_vals / torch.clamp(
            gate_vals.sum(-1, keepdim=True), min=1e-9)
    # one-hot indices carry no gradient: frac_tokens is a constant
    frac_tokens = F.one_hot(expert_idx, m.n_experts).sum(1).float().mean(0)
    aux = m.n_experts * torch.sum(frac_tokens * probs.mean(0))
    return gate_vals, expert_idx, aux


def group_capacity(m: MoEConfig, T: int) -> tuple[int, int]:
    """-> (Tg, cap): tokens a group (``group_size``, decremented until it
    divides T) and slots an expert has in a group, as the reference
    computes them."""
    Tg = min(m.group_size, T)
    while T % Tg:
        Tg -= 1
    cap = int(m.capacity_factor * m.top_k * Tg / m.n_experts)
    return Tg, max(cap, m.top_k)


def slots(expert_idx: torch.Tensor, m: MoEConfig
          ) -> tuple[torch.Tensor, torch.Tensor, int, int]:
    """expert_idx (T, K) -> (slot (T, K), keep (T, K), Tg, cap): each
    (token, k)'s position in its expert's buffer of its group, the
    running count over the group's (token, k) pairs in token-major order;
    ``keep`` is ``slot < cap``."""
    T, K = expert_idx.shape
    Tg, cap = group_capacity(m, T)
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
    """The capacity dispatch: gather the tokens into an (E, G, C, d)
    buffer (each slot reads the token that fills it, an empty slot a zero
    row), run the experts, and give each token its K rows of the output
    weighted by their gates (a dropped one's gate is 0) in one batched
    product.  That product is the scatter-add of the gated outputs
    written as a gather: a token has exactly K rows, so it needs no
    atomics, and no step waits for the host to learn how many rows were
    kept.  With ``scan_groups`` > 1 the group blocks run in turn (only to
    bound the buffers: groups are independent)."""
    m = cfg.moe
    T, d = xt.shape
    K, E = m.top_k, m.n_experts
    dt = xt.dtype
    slot, keep, Tg, cap = slots(expert_idx, m)
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
        ye = _experts(p, dt, xb[src[:n]].view(E, Gb * cap, d)).view(n, d)
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
    sg = torch.sigmoid((xt @ p["shared_router"].to(dt)).float())
    hs = xt @ p["shared_up"].to(dt)
    hs = hs * F.silu(xt @ p["shared_gate"].to(dt))
    return (hs @ p["shared_down"].to(dt)) * sg.to(dt)


def moe_ffn(p: dict, cfg: ModelConfig, x: torch.Tensor
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, d) -> (out (B, S, d), aux loss fp32)."""
    B, S, d = x.shape
    xt = x.reshape(B * S, d)
    gate_vals, expert_idx, aux = route(p, cfg, xt)
    ffn = _dense if cfg.moe.dense_dispatch else _grouped
    y = ffn(p, cfg, xt, gate_vals, expert_idx)
    if cfg.moe.n_shared:
        y = y + _shared(p, cfg, xt)
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
