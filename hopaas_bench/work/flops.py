"""Model FLOPs, counted from a configuration's sizes alone.

The count is the model's work, not an implementation's: 2 FLOPs for each
multiply-add of every weight product at each application (the LM head
too; not the embedding lookup), and ``pair_flops`` for each visible
(q, k) pair and head of attention.  Norms, activations and other
elementwise work are not counted.  Training is 3x the forward (forward
and backward), recomputation not counted.

What a stack's layers hold is counted in ``work/flops_<block>.py``,
found by the configuration's ``block``: ``weight_flops(c)`` (a token's
weight products over the stack), ``attention_layers(c)`` and, where a
pair costs other than q.k and p.v at ``head_dim`` (4 * head_dim), as
latent attention's wider query and key head does, ``pair_flops(c)``.  A
block with routed experts counts the routed products a token expects on
this card in ``weight_flops``: top_k x the experts this card holds / the
router's width (its ``n_experts``) expert products, beside its shared
experts and its router.  The block's smoke configuration holds all of
its routed experts, so the FLOP test (``test_hopaas_bench_work.py``),
which counts every product of a forward, stays exact.
"""
from __future__ import annotations

import importlib

from .bounds import visible_pairs


def stack(c: dict):
    """``work/flops_<block>.py`` for the configuration's block."""
    return importlib.import_module(f"{__package__}.flops_{c['block']}")


def pair_flops(c: dict) -> int:
    """FLOPs of one visible (q, k) pair and head: the block's
    ``pair_flops(c)``, else 4 * head_dim (q.k and p.v, a multiply-add
    each a channel)."""
    s = stack(c)
    return s.pair_flops(c) if hasattr(s, "pair_flops") else 4 * c["head_dim"]


def forward_flops(c: dict, batch: int, seq: int) -> int:
    """Model FLOPs of one forward over ``batch`` sequences of ``seq``."""
    s = stack(c)
    per_token = s.weight_flops(c) + 2 * c["d_model"] * c["vocab_size"]
    attn = (s.attention_layers(c) * c["n_heads"] * pair_flops(c)
            * visible_pairs(seq))
    return batch * (seq * per_token + attn)


def train_flops(c: dict, batch: int, seq: int) -> int:
    return 3 * forward_flops(c, batch, seq)
