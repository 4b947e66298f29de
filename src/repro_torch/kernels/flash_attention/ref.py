"""Plain PyTorch version of flash attention (GQA + causal + sliding
window), the kernel's correctness reference."""
from __future__ import annotations

import math

import torch


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: int | None = None,
                  q_offset: int = 0) -> torch.Tensor:
    """q: (B, Hq, S, hd); k,v: (B, Hkv, T, hd) -> (B, Hq, S, hd).
    Query row r sits at position ``q_offset + r``, key t at t.  Full
    materialised softmax in fp32; masked scores are -inf and fully
    masked rows (NaN after the softmax) give 0.  Output in q's dtype."""
    B, Hq, S, hd = q.shape
    Hkv, T = k.shape[1], k.shape[2]
    g = Hq // Hkv
    qg = q.reshape(B, Hkv, g, S, hd).float()
    s = torch.einsum("bkgsh,bkth->bkgst", qg, k.float()) / math.sqrt(hd)
    q_pos = q_offset + torch.arange(S, device=q.device)[:, None]
    k_pos = torch.arange(T, device=q.device)[None, :]
    mask = torch.ones((S, T), dtype=torch.bool, device=q.device)
    if causal:
        mask &= k_pos <= q_pos
    if window is not None:
        mask &= k_pos > q_pos - window
    s.masked_fill_(~mask, -math.inf)
    p = torch.softmax(s, dim=-1)
    del s
    p.masked_fill_(p.isnan(), 0.0)
    out = torch.einsum("bkgst,bkth->bkgsh", p, v.float())
    return out.reshape(B, Hq, S, hd).to(q.dtype)
