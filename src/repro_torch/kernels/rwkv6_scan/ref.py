"""Plain PyTorch version of the WKV6 scan: the sequential recurrence, the
kernel's correctness reference.

    o_t = r_t . (diag(u) k_t v_t^T + S_{t-1})
    S_t = diag(exp(logw_t)) S_{t-1} + k_t v_t^T
"""
from __future__ import annotations

import torch


def wkv6_ref(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             logw: torch.Tensor, u: torch.Tensor,
             S0: torch.Tensor | None = None
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """r,k,v,logw: (b,S,nh,hd); u: (nh,hd); S0: (b,nh,hd,hd) or None.
    -> (o (b,S,nh,hd) in r's dtype, S_final (b,nh,hd,hd) float32)."""
    b, S, nh, hd = r.shape
    St = (torch.zeros((b, nh, hd, hd), dtype=torch.float32, device=r.device)
          if S0 is None else S0.float())
    uf = u.float()[None, :, :, None]
    os_ = []
    for t in range(S):
        r_t, k_t, v_t, lw_t = (a[:, t].float() for a in (r, k, v, logw))
        kv = torch.einsum("bhd,bhe->bhde", k_t, v_t)
        os_.append(torch.einsum("bhd,bhde->bhe", r_t, St + uf * kv))
        St = St * torch.exp(lw_t)[..., None] + kv
    return torch.stack(os_, dim=1).to(r.dtype), St
