"""Checkpoint surgery for deployment: TP head padding (copied from the
reference, on tensors).

40 attention heads cannot shard over a 16-way model axis; padding q/k/v
to the next multiple with zero heads is function-preserving (zero heads
contribute nothing through the zero rows of w_o) and is what production
TP serving stacks do (vLLM pads heads for exactly this reason).  Costs
(new_h/old_h - 1) extra attention FLOPs; buys collective-free attention.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .config import ModelConfig


def padded_heads(n: int, divisor: int) -> int:
    return ((n + divisor - 1) // divisor) * divisor


def pad_heads_config(cfg: ModelConfig, divisor: int) -> ModelConfig:
    """Config with q/kv heads padded up to a multiple of ``divisor``."""
    return cfg.replace(n_heads=padded_heads(cfg.n_heads, divisor),
                       n_kv_heads=padded_heads(cfg.n_kv_heads, divisor))


def _pad(t: torch.Tensor, axis: int, extra: int) -> torch.Tensor:
    """``t`` with ``extra`` zeros appended along ``axis``."""
    if extra == 0:
        return t
    widths = [0, 0] * (t.ndim - axis)      # F.pad counts from the last dim
    widths[-1] = extra
    return F.pad(t, widths)


def pad_heads_params(params: dict, cfg: ModelConfig,
                     new_cfg: ModelConfig) -> dict:
    """Zero-pad a real checkpoint to the padded head counts.  Only the
    attention tensors change; everything else is shared by reference."""
    dh, dkv = (new_cfg.n_heads - cfg.n_heads,
               new_cfg.n_kv_heads - cfg.n_kv_heads)

    def fix_block(block: dict) -> dict:
        if "attn" not in block:
            return block
        a = dict(block["attn"])
        off = 1 if a["wq"].ndim == 4 else 0      # stacked layers dim
        a["wq"] = _pad(a["wq"], off + 1, dh)
        a["wk"] = _pad(a["wk"], off + 1, dkv)
        a["wv"] = _pad(a["wv"], off + 1, dkv)
        a["wo"] = _pad(a["wo"], off + 0, dh)
        for name, extra in (("bq", dh), ("bk", dkv), ("bv", dkv)):
            if name in a:
                a[name] = _pad(a[name], off + 0, extra)
        return {**block, "attn": a}

    out = dict(params)
    if "blocks" in out and "attn" in out["blocks"]:
        out["blocks"] = fix_block(out["blocks"])
    if "shared" in out:
        out["shared"] = fix_block(out["shared"])
    return out
