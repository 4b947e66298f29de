"""The dense decoder stack's work a token (``block: "attn"``): in each
layer Q, K, V and O, and the gated MLP's three products."""
from __future__ import annotations


def layer_weights(c: dict) -> int:
    d, h, kv, hd = c["d_model"], c["n_heads"], c["n_kv_heads"], c["head_dim"]
    return 2 * (d * h * hd + 2 * d * kv * hd + h * hd * d + 3 * d * c["d_ff"])


def weight_flops(c: dict) -> int:
    return c["n_layers"] * layer_weights(c)


def attention_layers(c: dict) -> int:
    return c["n_layers"]
