"""Mamba2 / SSD block (Dao & Gu 2024).

The sequence path runs the chunked SSD algorithm: ``ssm_impl="pallas"``
launches the hand-written CUDA kernel (``repro_torch.kernels.mamba2_ssd``;
its plain sequential version on the CPU), ``"ref"`` runs the chunked
form below in plain PyTorch, rounding where the reference's ``ref`` path
rounds.

Decode keeps O(1) state per layer: the SSM state (B,nh,hd,d_state) plus a
(d_conv-1)-deep causal-conv tail.  ``mamba2_decode`` writes the new state
into the tensors of ``state`` in place (the reference returns new arrays).

On DTensors (``repro_torch.dist``) the products run on each device's
shards (``dist.shard_ops.matmul``) and the core between them (conv, scan
or step, skip term, gate) on each device's rows and heads
(``shard_ops.local_map``): the SSD kernel gets its local shards; B and C,
shared by every head, stay whole over the heads' mesh dims, their
gradients partial sums over them; the norm over the sharded inner width
takes one all-reduce of its sum of squares.
"""
from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from ..dist import shard_ops
from ..dist.context import is_dtensor
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
    """-> (z, x, B, C, dt before its softplus), the products in
    ``cfg.dtype``; on DTensors on each device's shards."""
    us = shard_ops.fan_out(u, 5)
    return tuple(shard_ops.matmul(t, p[k].to(cfg.dtype)) for t, k in
                 zip(us, ("in_z", "in_x", "in_b", "in_c", "in_dt")))


def _whole(t: torch.Tensor) -> torch.Tensor:
    """A DTensor replicated on every mesh dim; a plain tensor as it is."""
    if not is_dtensor(t):
        return t
    from torch.distributed.tensor import Replicate
    whole = [Replicate()] * t.device_mesh.ndim
    return t if list(t.placements) == whole else t.redistribute(
        t.device_mesh, whole)


# the core's placements on each device's rows and heads
# (``shard_ops.rows_heads_layouts``): x, z and dt carry both, B and C
# (shared by every head) the rows only, the per-head weights the heads,
# the conv's weights neither (each device slices its channels), the state
# (b, nh, hd, ds) both
_ROLES = {"x": (0, 2), "bc": (0, None), "head": (None, 0),
          "conv": (None, None), "h": (0, 1)}


def _gated_core(cfg: ModelConfig, d_inner: int, x0: int, x, B, C, dt,
                dt_bias, conv_w, conv_b, a_log, d_skip, z):
    """The sequence block between its projections and its norm, on whole
    tensors or on one device's rows and heads: x and z (b,S,d) the
    channels of its heads, which start at channel ``x0``; B, C (b,S,ds);
    dt (b,S,nh) before its softplus; conv_w (K, d_inner + 2 ds) and
    conv_b whole.  -> (y + D x) * silu(z), (b,S,d)."""
    d, ds = x.shape[-1], B.shape[-1]
    if d != d_inner:             # this device's channels of x, then B, C
        conv_w = torch.cat([conv_w[:, x0:x0 + d], conv_w[:, d_inner:]], -1)
        conv_b = torch.cat([conv_b[x0:x0 + d], conv_b[d_inner:]], -1)
    xbc = _causal_conv(torch.cat([x, B, C], dim=-1), conv_w, conv_b)
    xb, Bv, Cv = torch.split(xbc, [d, ds, ds], dim=-1)
    dt = F.softplus(dt.float() + dt_bias.float())
    xh = xb.unflatten(-1, (-1, cfg.ssm.head_dim))       # a view: no copy
    if cfg.ssm_impl == "pallas":
        y, _ = ssd_ops.ssd(xh, dt.to(cfg.dtype), a_log, Bv, Cv,
                           chunk=cfg.ssm.chunk)
    else:
        y, _ = ssd_chunked(xh, dt.to(cfg.dtype), a_log, Bv, Cv,
                           chunk=cfg.ssm.chunk)
    y = y + xh * d_skip.to(cfg.dtype)[:, None]
    return y.flatten(2) * F.silu(z)


def _output(p: dict, cfg: ModelConfig, y: torch.Tensor) -> torch.Tensor:
    """The gated output through the norm (over the sharded inner width on
    DTensors) and the output projection."""
    y = rmsnorm(y, p["norm"], cfg.norm_eps)
    return shard_ops.matmul(y, p["out"].to(cfg.dtype))


def mamba2_seq(p: dict, cfg: ModelConfig, u: torch.Tensor) -> torch.Tensor:
    """Full-sequence Mamba2 block.  u: (B,S,d_model).  On DTensors the
    core (conv, scan, skip term and gate) runs on each device's rows and
    heads (``_ROLES``); no sharded dim is folded."""
    d_inner = _dims(cfg)[0]
    z, x, B, C, dt = _project(p, cfg, u)
    L = shard_ops.rows_heads_layouts(u, p["a_log"], _ROLES)
    x0 = shard_ops.local_offset(x, 2, L["x"])
    y = shard_ops.local_map(
        functools.partial(_gated_core, cfg, d_inner, x0),
        (x, B, C, dt, p["dt_bias"], _whole(p["conv_w"].to(cfg.dtype)),
         _whole(p["conv_b"].to(cfg.dtype)), p["a_log"], p["d_skip"], z),
        (L["x"], L["bc"], L["bc"], L["x"], L["head"], L["conv"],
         L["conv"], L["head"], L["head"], L["x"]), L["x"])
    return _output(p, cfg, y)


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


def _gated_step(cfg: ModelConfig, xb, B, C, dt, dt_bias, a_log, d_skip,
                z, h):
    """One token of the core after the conv, on whole tensors or on one
    device's rows and heads: xb, z (b,1,d); B, C (b,1,ds); dt (b,1,nh)
    before its softplus; h (b,nh,hd,ds).  -> ((y + D x) * silu(z), new
    h)."""
    dt = F.softplus(dt.float() + dt_bias.float())
    xh = xb[:, 0].unflatten(-1, (-1, cfg.ssm.head_dim))
    y, h = ssd_step(xh, dt[:, 0].to(cfg.dtype), a_log, B[:, 0], C[:, 0], h)
    y = y + xh * d_skip.to(cfg.dtype)[:, None]
    return y.flatten(1)[:, None] * F.silu(z), h


def mamba2_decode(p: dict, cfg: ModelConfig, u: torch.Tensor,
                  state: dict) -> torch.Tensor:
    """One-token decode.  u: (B,1,d_model); state: {"h","conv"}, updated
    in place.  On DTensors the step after the conv runs on each
    device's rows and heads, as ``mamba2_seq``'s core does."""
    d_inner, nh, hd, ds = _dims(cfg)
    z, x, B, C, dt = _project(p, cfg, u)                       # (B,1,.)
    xbc = torch.cat([x, B, C], dim=-1)
    conv_in = torch.cat([state["conv"], xbc], dim=1)           # (B,K,d_xbc)
    w, b = p["conv_w"].to(cfg.dtype), p["conv_b"].to(cfg.dtype)
    out = F.silu((conv_in * w[None]).sum(1) + b)[:, None]      # (B,1,d_xbc)
    state["conv"].copy_(conv_in[:, 1:])
    xb, Bv, Cv = torch.split(out, [d_inner, ds, ds], dim=-1)
    L = shard_ops.rows_heads_layouts(u, p["a_log"], _ROLES)
    y, h = shard_ops.local_map(
        functools.partial(_gated_step, cfg),
        (xb, Bv, Cv, dt, p["dt_bias"], p["a_log"], p["d_skip"], z,
         state["h"]),
        (L["x"], L["bc"], L["bc"], L["x"], L["head"], L["head"],
         L["head"], L["x"], L["h"]), (L["x"], L["h"]))
    state["h"].copy_(h)
    return _output(p, cfg, y)
