"""Mamba2 / SSD block (Dao & Gu 2024).

The sequence path runs the chunked SSD algorithm: ``ssm_impl="pallas"``
launches the hand-written CUDA kernel (``repro_torch.kernels.mamba2_ssd``;
its plain sequential version on the CPU), ``"ref"`` runs the chunked
form below in plain PyTorch, rounding where the reference's ``ref`` path
rounds.

Decode keeps O(1) state per layer: the SSM state (B,nh,hd,d_state) plus a
(d_conv-1)-deep causal-conv tail.  ``mamba2_decode`` writes the new state
into the tensors of ``state`` in place (the reference returns new arrays).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..kernels.mamba2_ssd import ops as ssd_ops
from .config import ModelConfig
from .layers import ParamInit, rmsnorm


def _dims(cfg: ModelConfig) -> tuple[int, int, int, int]:
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    n_heads = d_inner // s.head_dim
    return d_inner, n_heads, s.head_dim, s.d_state


def init_mamba2(mk: ParamInit, cfg: ModelConfig,
                stacked: int | None = None) -> dict:
    s = cfg.ssm
    d_inner, nh, hd, ds = _dims(cfg)
    d_xbc = d_inner + 2 * ds                     # conv runs over [x, B, C]
    L = () if stacked is None else (stacked,)
    A = () if stacked is None else ("layers",)
    d, dt = cfg.d_model, cfg.param_dtype
    return {
        # projections: z (gate), x, B, C, dt
        "in_z": mk((*L, d, d_inner), dt, (*A, "embed", "mlp")),
        "in_x": mk((*L, d, d_inner), dt, (*A, "embed", "mlp")),
        "in_b": mk((*L, d, ds), dt, (*A, "embed", None)),
        "in_c": mk((*L, d, ds), dt, (*A, "embed", None)),
        "in_dt": mk((*L, d, nh), dt, (*A, "embed", "heads")),
        "dt_bias": mk((*L, nh), dt, (*A, "heads"), init="zeros"),
        "conv_w": mk((*L, s.d_conv, d_xbc), dt, (*A, None, "mlp"),
                     scale=0.5),
        "conv_b": mk((*L, d_xbc), dt, (*A, "mlp"), init="zeros"),
        "a_log": mk((*L, nh), dt, (*A, "heads"), init="zeros"),
        "d_skip": mk((*L, nh), dt, (*A, "heads"), init="ones"),
        "norm": mk((*L, d_inner), dt, (*A, "mlp"), init="ones"),
        "out": mk((*L, d_inner, d), dt, (*A, "mlp", "embed")),
    }


def _causal_conv(xbc: torch.Tensor, w: torch.Tensor, b: torch.Tensor
                 ) -> torch.Tensor:
    """Depthwise causal conv.  xbc: (B,S,D); w: (K,D)."""
    K, S = w.shape[0], xbc.shape[1]
    pad = xbc.new_zeros((xbc.shape[0], K - 1, xbc.shape[2]))
    xp = torch.cat([pad, xbc], dim=1)                        # (B, S+K-1, D)
    out = xp[:, 0:S] * w[0]
    for i in range(1, K):
        out = out + xp[:, i: i + S] * w[i]
    return F.silu(out + b)


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, a_log: torch.Tensor,
                B: torch.Tensor, C: torch.Tensor, chunk: int,
                h0: torch.Tensor | None = None
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD scan in plain PyTorch.

    x: (b,S,nh,hd); dt: (b,S,nh); a_log: (nh,); B,C: (b,S,ds).
    Returns (y (b,S,nh,hd), h_final (b,nh,hd,ds)).
    """
    b, S, nh, hd = x.shape
    ds = B.shape[-1]
    Q = min(chunk, S)
    if S % Q:
        raise ValueError(f"seq {S} not divisible by chunk {Q}")
    nchunk = S // Q

    A = -torch.exp(a_log.float())                              # (nh,)
    lax_ = dt.float() * A                                      # (b,S,nh)
    xw = (x * dt[..., None]).to(x.dtype)                       # dt-weighted

    def rs(t, *shape):
        return t.reshape(b, nchunk, Q, *shape)

    xc, lc = rs(xw, nh, hd), rs(lax_, nh)
    Bc, Cc = rs(B, ds), rs(C, ds)
    cum = torch.cumsum(lc, dim=2)                              # (b,n,Q,nh)

    # --- intra-chunk: M[t,s] = (C_t . B_s) exp(cum_t - cum_s), s <= t
    scores = torch.einsum("bnts,bnqs->bntq", Cc, Bc)           # (b,n,Q,Q)
    decay = cum[:, :, :, None, :] - cum[:, :, None, :, :]      # (b,n,Q,Q,nh)
    causal = torch.tril(torch.ones((Q, Q), dtype=torch.bool,
                                   device=x.device))[None, None, :, :, None]
    # mask inside the exp argument (the dead branch would be +inf)
    M = torch.exp(decay.masked_fill(~causal, -torch.inf)) * scores[..., None]
    y_intra = torch.einsum("bntqh,bnqhd->bnthd", M.to(x.dtype), xc)

    # --- chunk summaries -> inter-chunk scan
    tail = cum[:, :, -1:, :] - cum                       # exp to chunk end
    Sc = torch.einsum("bnqs,bnqhd->bnhds", Bc.float(),
                      xc.float() * torch.exp(tail)[..., None])
    gamma = torch.exp(cum[:, :, -1, :])                        # (b,n,nh)

    h = (torch.zeros((b, nh, hd, ds), dtype=torch.float32, device=x.device)
         if h0 is None else h0.float())
    h_enter = []
    for i in range(nchunk):                      # state *entering* chunk i
        h_enter.append(h)
        h = h * gamma[:, i, :, None, None] + Sc[:, i]
    h_enter = torch.stack(h_enter, dim=1)                      # (b,n,nh,hd,ds)

    # --- inter-chunk contribution
    y_inter = torch.einsum("bnts,bnhds,bnth->bnthd", Cc.float(), h_enter,
                           torch.exp(cum)).to(x.dtype)
    y = (y_intra + y_inter).reshape(b, S, nh, hd)
    return y, h


def ssd_step(x: torch.Tensor, dt: torch.Tensor, a_log: torch.Tensor,
             B: torch.Tensor, C: torch.Tensor, h: torch.Tensor
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """Single-token recurrence.  x: (b,nh,hd); dt: (b,nh); B,C: (b,ds);
    h: (b,nh,hd,ds).  Returns (y, new h)."""
    A = -torch.exp(a_log.float())
    g = torch.exp(dt.float() * A)                              # (b,nh)
    upd = torch.einsum("bhd,bs->bhds", (x * dt[..., None]).float(),
                       B.float())
    h = h * g[:, :, None, None] + upd
    y = torch.einsum("bhds,bs->bhd", h, C.float())
    return y.to(x.dtype), h


def _project(p: dict, cfg: ModelConfig, u: torch.Tensor):
    """-> (z, [x, B, C] before the conv, dt in float32)."""
    dt_ = cfg.dtype
    z = u @ p["in_z"].to(dt_)
    xbc = torch.cat([u @ p["in_x"].to(dt_), u @ p["in_b"].to(dt_),
                     u @ p["in_c"].to(dt_)], dim=-1)
    dt = F.softplus((u @ p["in_dt"].to(dt_)).float()
                    + p["dt_bias"].float())
    return z, xbc, dt


def _output(p: dict, cfg: ModelConfig, y: torch.Tensor, xh: torch.Tensor,
            z: torch.Tensor, shape: torch.Size) -> torch.Tensor:
    d_inner = _dims(cfg)[0]
    y = y + xh * p["d_skip"].to(cfg.dtype)[:, None]
    y = y.reshape(*shape[:2], d_inner)
    y = rmsnorm(y * F.silu(z), p["norm"], cfg.norm_eps)
    return y @ p["out"].to(cfg.dtype)


def mamba2_seq(p: dict, cfg: ModelConfig, u: torch.Tensor) -> torch.Tensor:
    """Full-sequence Mamba2 block.  u: (B,S,d_model)."""
    d_inner, nh, hd, ds = _dims(cfg)
    z, xbc, dt = _project(p, cfg, u)
    xbc = _causal_conv(xbc, p["conv_w"].to(cfg.dtype),
                       p["conv_b"].to(cfg.dtype))
    xb, Bv, Cv = torch.split(xbc, [d_inner, ds, ds], dim=-1)
    xh = xb.unflatten(-1, (nh, hd))                # a view: no copy
    if cfg.ssm_impl == "pallas":
        y, _ = ssd_ops.ssd(xh, dt.to(cfg.dtype), p["a_log"], Bv, Cv,
                           chunk=cfg.ssm.chunk)
    else:
        y, _ = ssd_chunked(xh, dt.to(cfg.dtype), p["a_log"], Bv, Cv,
                           chunk=cfg.ssm.chunk)
    return _output(p, cfg, y, xh, z, u.shape)


def init_mamba2_state(cfg: ModelConfig, batch: int, mk: ParamInit,
                      stacked: int | None = None) -> dict:
    """Zero SSM states and conv tails, made by ``mk``."""
    s = cfg.ssm
    d_inner, nh, hd, ds = _dims(cfg)
    L = () if stacked is None else (stacked,)
    A = () if stacked is None else ("layers",)
    return {"h": mk((*L, batch, nh, hd, ds), torch.float32,
                    (*A, "batch", "heads", None, None), init="zeros"),
            "conv": mk((*L, batch, s.d_conv - 1, d_inner + 2 * ds),
                       cfg.dtype, (*A, "batch", None, "mlp"), init="zeros")}


def mamba2_decode(p: dict, cfg: ModelConfig, u: torch.Tensor,
                  state: dict) -> torch.Tensor:
    """One-token decode.  u: (B,1,d_model); state: {"h","conv"}, updated
    in place."""
    d_inner, nh, hd, ds = _dims(cfg)
    z, xbc, dt = _project(p, cfg, u)                           # (B,1,.)
    conv_in = torch.cat([state["conv"], xbc], dim=1)           # (B,K,d_xbc)
    w, b = p["conv_w"].to(cfg.dtype), p["conv_b"].to(cfg.dtype)
    out = F.silu((conv_in * w[None]).sum(1) + b)[:, None]      # (B,1,d_xbc)
    state["conv"].copy_(conv_in[:, 1:])
    xb, Bv, Cv = torch.split(out, [d_inner, ds, ds], dim=-1)
    xh = xb[:, 0].reshape(-1, nh, hd)
    y, h = ssd_step(xh, dt[:, 0].to(cfg.dtype), p["a_log"], Bv[:, 0],
                    Cv[:, 0], state["h"])
    state["h"].copy_(h)
    return _output(p, cfg, y, xh, z, u.shape)
