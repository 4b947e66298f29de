"""The DeepSeek-V2 stack (``block: "mla_moe"``, arXiv:2405.04434): in
every layer a pre-norm multi-head latent attention, then a pre-norm
dense SwiGLU MLP in the first ``first_k_dense_replace`` layers and a
DeepSeekMoE layer in the rest, each added to the residual stream.

Latent attention, with no query compression: q = x W_q, split per head
into a content part (``qk_nope_head_dim``) and a rotary part
(``qk_rope_head_dim``); [c, k_pe] = x W_kva, c the ``kv_lora_rank``
latent and k_pe one rotary key for every head; [k_nope, v] = RMSNorm(c)
W_kvb per head.  The rotary parts turn at YaRN's frequencies (factor,
original context, beta_fast and beta_slow of the ``mla`` group: pairs
below the correction range keep the plain frequency, pairs above it
take it over the factor, a linear ramp between), two halves of the
rotary dims as a pair.  Scores over (content + rotary width)^-1/2 x
mscale^2, mscale = 0.1 mscale_all_dim ln(factor) + 1; causal softmax.

DeepSeekMoE: the router's softmax over all ``n_experts`` experts, top
``top_k`` probabilities as the gates (not renormalised); each expert this
card holds (``experts_held`` from ``expert_offset``) runs on every row
and adds its output times the row's gate for it, 0 where the row did not
choose it (the same shapes whatever the routing, so a recomputed layer
matches its forward); the experts it does not hold add nothing.  The
shared experts are one SwiGLU, ungated.  The balance loss, from the full
router: for each row b, sum_i f_bi P_bi with f_bi = (picks of expert i in
the row) n_experts / (S top_k) and P_bi the row's mean probability of
expert i, averaged over the rows and summed over the MoE layers;
``aux_alpha`` times it is the training term.
"""
from __future__ import annotations

import math
from functools import partial

import torch
import torch.nn.functional as F

from .model import NEG_INF, Reference


def yarn_inv_freq(c: dict, device) -> torch.Tensor:
    m = c["mla"]
    dim, base = m["qk_rope_head_dim"], c["rope_theta"]

    def turning(turns: float) -> float:     # the pair turning `turns` times
        return (dim * math.log(m["original_max_position"]
                               / (turns * 2 * math.pi))
                / (2 * math.log(base)))
    lo = max(math.floor(turning(m["beta_fast"])), 0)
    hi = min(math.ceil(turning(m["beta_slow"])), dim - 1)
    i = torch.arange(dim // 2, dtype=torch.float32, device=device)
    plain = 1.0 / base ** (2 * i / dim)
    keep = 1.0 - torch.clamp((i - lo) / max(hi - lo, 1e-3), 0.0, 1.0)
    return plain / m["rope_factor"] * (1.0 - keep) + plain * keep


def rotate(x: torch.Tensor, inv: torch.Tensor) -> torch.Tensor:
    """x (b, S, H, dr) at positions 0..S-1: the halves as pairs."""
    S, h = x.shape[1], x.shape[-1] // 2
    ang = torch.arange(S, device=x.device, dtype=torch.float32)[:, None] * inv
    cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    x1, x2 = x[..., :h], x[..., h:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def latent_attention(ref: Reference, p: dict, x: torch.Tensor,
                     q_block: int = 1024) -> torch.Tensor:
    c, m = ref.c, ref.c["mla"]
    b, S, _ = x.shape
    H, dn, dr = c["n_heads"], m["qk_nope_head_dim"], m["qk_rope_head_dim"]
    dv, r = m["v_head_dim"], m["kv_lora_rank"]
    inv = yarn_inv_freq(c, x.device)
    q = ref.mm(x, p["wq"]).reshape(b, S, H, dn + dr)
    kva = ref.mm(x, p["wkv_a"])
    kv = ref.mm(ref.norm(kva[..., :r], p["kv_norm"]), p["wkv_b"]).reshape(
        b, S, H, dn + dv)
    q = torch.cat([q[..., :dn], rotate(q[..., dn:], inv)], dim=-1)
    k_pe = rotate(kva[..., None, r:], inv).expand(b, S, H, dr)
    k = torch.cat([kv[..., :dn], k_pe], dim=-1).transpose(1, 2)
    v = kv[..., dn:].transpose(1, 2)
    q = q.transpose(1, 2)
    ms = 0.1 * m["mscale_all_dim"] * math.log(m["rope_factor"]) + 1.0
    scale = (dn + dr) ** -0.5 * ms * ms
    pos = torch.arange(S, device=x.device)
    outs = []
    for q0 in range(0, S, q_block):
        sc = q[:, :, q0: q0 + q_block] @ k.transpose(-1, -2) * scale
        mask = pos[None, :] > pos[q0: q0 + q_block, None]
        outs.append(torch.softmax(sc.masked_fill(mask, NEG_INF), -1) @ v)
    o = torch.cat(outs, dim=2).transpose(1, 2).reshape(b, S, H * dv)
    return ref.mm(o, p["wo"])


def experts(ref: Reference, p: dict, x: torch.Tensor
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """-> (this card's routed part plus the shared experts, the balance
    loss) of the rows x (b, S, d)."""
    m = ref.c["moe"]
    b, S, d = x.shape
    E, K = m["n_experts"], m["top_k"]
    xt = x.reshape(b * S, d)
    probs = torch.softmax(ref.mm(xt, p["router"]), dim=-1)
    gates, ids = torch.topk(probs, K, dim=-1)
    chosen = F.one_hot(ids, E).float()                       # (T, K, E)
    weight = (chosen * gates[..., None]).sum(1)              # (T, E)
    y = ref.mlp(p["shared"], xt)
    for e in range(m["experts_held"]):       # every held expert, every row
        h = F.silu(xt @ p["gate"][e].float()) * (xt @ p["up"][e].float())
        y = y + weight[:, m["expert_offset"] + e, None] * (
            h @ p["down"][e].float())
    picks = chosen.reshape(b, S * K, E).sum(1)
    f = picks * E / (S * K)
    share = probs.reshape(b, S, E).mean(1)
    return y.reshape(b, S, d), (f * share).sum(1).mean()


def dense_block(ref: Reference, p: dict, x: torch.Tensor) -> torch.Tensor:
    x = x + latent_attention(ref, p["attn"], ref.norm(x, p["norm1"]))
    return x + ref.mlp(p["mlp"], ref.norm(x, p["norm2"]))


def moe_block(ref: Reference, p: dict, x: torch.Tensor
              ) -> tuple[torch.Tensor, torch.Tensor]:
    x = x + latent_attention(ref, p["attn"], ref.norm(x, p["norm1"]))
    y, aux = experts(ref, p["moe"], ref.norm(x, p["norm2"]))
    return x + y, aux


def unstack(tree: dict, n: int) -> list[dict]:
    """The ``n`` layers of a tree stacked along its leading dim, from one
    ``torch.unbind`` a leaf: the views a recomputed layer takes as its
    inputs, where indexing a layer would keep the fp8 control's rounded
    copy of its weights alive until the backward, and add a zero tensor
    of the whole stack's size to every layer's gradient."""
    cols = {k: unstack(v, n) if isinstance(v, dict) else torch.unbind(v)
            for k, v in tree.items()}
    return [{k: c[i] for k, c in cols.items()} for i in range(n)]


def stack(ref: Reference, x: torch.Tensor) -> torch.Tensor:
    c = ref.c
    first = c["first_k_dense_replace"]
    for p in unstack(ref.p["dense_blocks"], first):
        x = ref.run_block(partial(dense_block, ref), p, x)
    aux = 0.0
    for p in unstack(ref.p["blocks"], c["n_layers"] - first):
        x, a = ref.run_block(partial(moe_block, ref), p, x)
        aux = aux + a
    ref.train_term = c["moe"]["aux_alpha"] * aux
    return x
