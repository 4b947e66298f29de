"""Model FLOPs, counted from a configuration's sizes alone.

The count is the model's work, not an implementation's: 2 FLOPs for each
multiply-add of every weight product at each application (the LM head
too; not the embedding lookup), and 4 * head_dim for each visible
(q, k) pair and head of attention.  Norms, activations and other
elementwise work are not counted.  Training is 3x the forward (forward
and backward), recomputation not counted.  What a stack's layers hold is
counted in ``work/flops_<block>.py``, found by the configuration's
``block``: ``weight_flops(c)`` (a token's weight products over the
stack) and ``attention_layers(c)``.
"""
from __future__ import annotations

import importlib

from .bounds import visible_pairs


def stack(c: dict):
    """``work/flops_<block>.py`` for the configuration's block."""
    return importlib.import_module(f"{__package__}.flops_{c['block']}")


def forward_flops(c: dict, batch: int, seq: int) -> int:
    """Model FLOPs of one forward over ``batch`` sequences of ``seq``."""
    s = stack(c)
    per_token = s.weight_flops(c) + 2 * c["d_model"] * c["vocab_size"]
    attn = (s.attention_layers(c) * c["n_heads"] * 4 * c["head_dim"]
            * visible_pairs(seq))
    return batch * (seq * per_token + attn)


def train_flops(c: dict, batch: int, seq: int) -> int:
    return 3 * forward_flops(c, batch, seq)
