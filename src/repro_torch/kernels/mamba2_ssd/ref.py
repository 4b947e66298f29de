"""Plain PyTorch version of the SSD scan: the sequential (non-chunked)
recurrence, the kernel's correctness reference.

    h_t = exp(dt_t * A) h_{t-1} + dt_t * x_t B_t^T        (per head)
    y_t = C_t . h_t
"""
from __future__ import annotations

import torch


def ssd_ref(x: torch.Tensor, dt: torch.Tensor, a_log: torch.Tensor,
            B: torch.Tensor, C: torch.Tensor,
            h0: torch.Tensor | None = None
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (b,S,nh,hd); dt: (b,S,nh); a_log: (nh,); B,C: (b,S,ds).
    -> (y (b,S,nh,hd) in x's dtype, h_final (b,nh,hd,ds) float32)."""
    b, S, nh, hd = x.shape
    ds = B.shape[-1]
    A = -torch.exp(a_log.float())
    h = (torch.zeros((b, nh, hd, ds), dtype=torch.float32, device=x.device)
         if h0 is None else h0.float())
    ys = []
    for t in range(S):
        g = torch.exp(dt[:, t].float() * A)                      # (b,nh)
        upd = torch.einsum("bhd,bs->bhds",
                           (x[:, t] * dt[:, t, :, None]).float(),
                           B[:, t].float())
        h = h * g[:, :, None, None] + upd
        ys.append(torch.einsum("bhds,bs->bhd", h, C[:, t].float()))
    return torch.stack(ys, dim=1).to(x.dtype), h
