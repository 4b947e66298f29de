"""The DeepSeek-V2 stack's work a token (``block: "mla_moe"``): in every
layer latent attention's four products (W_q, W_kva, W_kvb, W_o); in the
first ``first_k_dense_replace`` layers the gated MLP's three; in the rest
the router, the shared experts' three and the routed experts' three at
the share a token expects here: top_k x the experts held / n_experts
expert products.  A (q, k) pair and head costs q.k over the content and
rotary widths and p.v over the value width."""
from __future__ import annotations


def attention_weights(c: dict) -> int:
    m, d, h = c["mla"], c["d_model"], c["n_heads"]
    dq = m["qk_nope_head_dim"] + m["qk_rope_head_dim"]
    return 2 * (d * h * dq + d * (m["kv_lora_rank"] + m["qk_rope_head_dim"])
                + m["kv_lora_rank"] * h * (m["qk_nope_head_dim"]
                                           + m["v_head_dim"])
                + h * m["v_head_dim"] * d)


def moe_weights(c: dict) -> int:
    m, d = c["moe"], c["d_model"]
    expert = 6 * d * m["d_expert"]
    return (2 * d * m["n_experts"] + m["n_shared"] * expert
            + m["top_k"] * m["experts_held"] * expert // m["n_experts"])


def weight_flops(c: dict) -> int:
    dense = c["first_k_dense_replace"]
    return (c["n_layers"] * attention_weights(c)
            + dense * 6 * c["d_model"] * c["d_ff"]
            + (c["n_layers"] - dense) * moe_weights(c))


def attention_layers(c: dict) -> int:
    return c["n_layers"]


def pair_flops(c: dict) -> int:
    m = c["mla"]
    return 2 * (m["qk_nope_head_dim"] + m["qk_rope_head_dim"]
                + m["v_head_dim"])
