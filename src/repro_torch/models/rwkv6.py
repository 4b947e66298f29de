"""RWKV6 "Finch" block (Peng et al. 2024, arXiv:2404.05892).

Linear attention with *data-dependent per-channel decay*:
    S_t = diag(w_t) S_{t-1} + k_t ⊗ v_t
    o_t = r_t · (diag(u) k_t ⊗ v_t + S_{t-1})
The sequence path runs the chunked closed form: ``ssm_impl="pallas"``
launches the hand-written CUDA kernel (``repro_torch.kernels.rwkv6_scan``;
its plain sequential version on the CPU), ``"ref"`` runs the chunked form
below in plain PyTorch.  Each path casts ``logw`` and ``u`` where the
reference's path of the same name casts them.

Includes token-shift for the time-mix and the RWKV channel-mix FFN.
``rwkv6_decode`` writes the new state into the tensors of ``state`` in
place (the reference returns new arrays).

On DTensors (``repro_torch.dist``) the products run on each device's
shards (``dist.shard_ops``), and the scan or step on each device's rows
and heads (``shard_ops.local_map``): r, k, v, logw, u and the state keep
the heads' sharding and the WKV6 kernel gets its local shards.  ``ln_x``
norms the whole width, as the reference's does (``layers.rmsnorm``: one
all-reduce of the sum of squares); each device gates its heads'
channels and projects them with its rows of ``out`` (a partial sum).
"""
from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from ..dist import shard_ops
from ..dist.context import is_dtensor, reduce_partial
from ..kernels.rwkv6_scan import ops as wkv_ops
from .attention import _proj
from .config import ModelConfig
from .layers import ParamInit, rmsnorm


def _dims(cfg: ModelConfig) -> tuple[int, int]:
    hd = cfg.rwkv.head_dim
    nh = cfg.d_model // hd
    return nh, hd


def init_rwkv6(mk: ParamInit, cfg: ModelConfig,
               stacked: int | None = None) -> dict:
    nh, hd = _dims(cfg)
    L = () if stacked is None else (stacked,)
    A = () if stacked is None else ("layers",)
    d, dt = cfg.d_model, cfg.param_dtype
    r = cfg.rwkv.decay_lora
    vec, hh = (*A, "embed"), (*A, "heads", "head_dim")
    return {
        "mix_r": mk((*L, d), dt, vec, init="zeros"),
        "mix_k": mk((*L, d), dt, vec, init="zeros"),
        "mix_v": mk((*L, d), dt, vec, init="zeros"),
        "mix_w": mk((*L, d), dt, vec, init="zeros"),
        "mix_g": mk((*L, d), dt, vec, init="zeros"),
        "wr": mk((*L, d, nh, hd), dt, (*A, "embed", "heads", "head_dim")),
        "wk": mk((*L, d, nh, hd), dt, (*A, "embed", "heads", "head_dim")),
        "wv": mk((*L, d, nh, hd), dt, (*A, "embed", "heads", "head_dim")),
        "wg": mk((*L, d, d), dt, (*A, "embed", "embed")),
        # data-dependent decay: w_t = exp(-exp(w0 + (x W_a) W_b))
        "w0": mk((*L, nh, hd), dt, hh, init="zeros"),
        "wa": mk((*L, d, r), dt, (*A, "embed", None), scale=0.02),
        "wb": mk((*L, r, nh, hd), dt, (*A, None, "heads", "head_dim"),
                 scale=0.02),
        "u": mk((*L, nh, hd), dt, hh, init="zeros"),
        "ln_x": mk((*L, d), dt, vec, init="ones"),
        "out": mk((*L, d, d), dt, (*A, "embed", "embed")),
    }


def _token_shift(x: torch.Tensor, prev: torch.Tensor | None = None
                 ) -> torch.Tensor:
    """x_{t-1} stream.  prev: (B,1,d) carry for decode; zeros at t=0."""
    if prev is None:
        prev = torch.zeros_like(x[:, :1])
    return torch.cat([prev, x[:, :-1]], dim=1)


def wkv6_chunked(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 logw: torch.Tensor, u: torch.Tensor, chunk: int,
                 S0: torch.Tensor | None = None
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Chunked WKV6 in plain PyTorch.

    r,k,v: (b,S,nh,hd); logw: (b,S,nh,hd) (negative log-decays);
    u: (nh,hd).  Returns (o (b,S,nh,hd), S_final (b,nh,hd,hd)).

    Closed form: o_t = Σ_{s<t} (r_t ⊙ exp(W_{t-1}-W_s)) · k_s  v_s
                      + (r_t ⊙ u) · k_t  v_t
    with W the inclusive cumsum of logw along time.
    """
    b, S, nh, hd = r.shape
    Q = min(chunk, S)
    if S % Q:
        raise ValueError(f"seq {S} not divisible by chunk {Q}")
    nchunk = S // Q

    def rs(t):
        return t.reshape(b, nchunk, Q, nh, hd)

    rc, kc, vc = rs(r), rs(k), rs(v)
    lw = rs(logw.float())
    cum = torch.cumsum(lw, dim=2)                              # (b,n,Q,nh,hd)

    # intra-chunk: pairs (t, s) with s < t ; decay exp(W_{t-1} - W_s)
    dec_t = cum - lw                                           # W_{t-1}
    expo = dec_t[:, :, :, None] - cum[:, :, None, :, :]   # (b,n,t,s,nh,hd)
    strict = torch.tril(torch.ones((Q, Q), dtype=torch.bool,
                                   device=r.device), diagonal=-1
                        )[None, None, :, :, None, None]
    rdec = rc.float()[:, :, :, None] * torch.exp(
        expo.masked_fill(~strict, -torch.inf))            # (b,n,t,s,nh,hd)
    del expo
    scores = torch.einsum("bntshd,bnshd->bnths", rdec, kc.float())
    del rdec
    y_intra = torch.einsum("bnths,bnshd->bnthd", scores.to(r.dtype), vc)
    # diagonal bonus term
    diag = torch.einsum("bnthd,bnthd->bnth", rc * u.to(r.dtype), kc)
    y_intra = y_intra + diag[..., None] * vc

    # chunk summaries: S_i = Σ_s exp(W_Q - W_s) k_s ⊗ v_s ; carry scan
    tail = cum[:, :, -1:] - cum                                # (b,n,Q,nh,hd)
    Sc = torch.einsum("bnshd,bnshe->bnhde", kc.float() * torch.exp(tail),
                      vc.float())
    gamma = torch.exp(cum[:, :, -1])                           # (b,n,nh,hd)

    St = (torch.zeros((b, nh, hd, hd), dtype=torch.float32, device=r.device)
          if S0 is None else S0.float())
    S_enter = []
    for i in range(nchunk):                      # state *entering* chunk i
        S_enter.append(St)
        St = St * gamma[:, i, :, :, None] + Sc[:, i]
    S_enter = torch.stack(S_enter, dim=1)                      # (b,n,nh,hd,hd)

    # inter-chunk: o_t += (r_t ⊙ exp(W_{t-1})) · S_enter
    y_inter = torch.einsum("bnthd,bnhde->bnthe",
                           rc.float() * torch.exp(dec_t), S_enter)
    y = (y_intra + y_inter.to(r.dtype)).reshape(b, S, nh, hd)
    return y, St


def wkv6_step(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              logw: torch.Tensor, u: torch.Tensor, S: torch.Tensor
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """One token.  r,k,v,logw: (b,nh,hd); S: (b,nh,hd,hd)."""
    rf, kf, vf = r.float(), k.float(), v.float()
    kv = torch.einsum("bhd,bhe->bhde", kf, vf)
    o = torch.einsum("bhd,bhde->bhe", rf,
                     S + u.float()[None, :, :, None] * kv)
    S = S * torch.exp(logw.float())[..., None] + kv
    return o.to(r.dtype), S


def _mix(x: torch.Tensor, xs: torch.Tensor, mu: torch.Tensor
         ) -> torch.Tensor:
    return x + (xs - x) * mu


def _logw(w0: torch.Tensor, lw: torch.Tensor) -> torch.Tensor:
    """The data-dependent decay's negative log from ``w0`` and the LoRA
    product ``lw`` (B,S,nh,hd): float32, in (-inf, 0)."""
    wraw = w0.float() + lw.float()
    return -torch.exp(-0.5 + wraw)


def _time_mix_inputs(p: dict, cfg: ModelConfig, x: torch.Tensor,
                     xs: torch.Tensor):
    """-> (r, k, v, g, lw), r/k/v and the decay's LoRA product lw
    (B,S,nh,hd) (``_logw`` makes the decay of it).  On DTensors each
    mixed input's gradient is laid out as the input before the mix
    (``fan_out``): the mix runs on whole rows."""
    dt = cfg.dtype
    xu, xsu = shard_ops.fan_out(x, 5), shard_ops.fan_out(xs, 5)
    xr, xk, xv, xw, xg = (shard_ops.fan_out(_mix(a, b, p[f"mix_{c}"].to(dt)),
                                            1)[0]
                          for a, b, c in zip(xu, xsu, "rkvwg"))
    # (B,S,d) x (d,nh,hd) -> (B,S,nh,hd), on DTensors on the shards
    r = _proj(xr, p["wr"], dt)
    k = _proj(xk, p["wk"], dt)
    v = _proj(xv, p["wv"], dt)
    g = F.silu(shard_ops.matmul(xg, p["wg"].to(dt)))
    # data-dependent decay (negative log)
    lora = shard_ops.matmul(torch.tanh(xw), p["wa"].to(dt))
    return r, k, v, g, _proj(lora, p["wb"], dt)


# the time mix's placements on each device's rows and heads
# (``shard_ops.rows_heads_layouts``): r, k, v, the decay's LoRA product
# and the output's channels carry both, the per-head weights (w0, u)
# the heads, the state (b, nh, hd, hd) both
_ROLES = {"rkv": (0, 2), "head": (None, 0), "S": (0, 1)}


def _out(p: dict, cfg: ModelConfig, o: torch.Tensor, g: torch.Tensor,
         heads: list[int]) -> torch.Tensor:
    """The time mix's output (B,S,d) normed over its whole width, gated
    and projected; on DTensors each device gates its heads' channels
    (g laid out as o) and projects them with its rows of ``out``, a
    partial sum."""
    out = p["out"].to(cfg.dtype)
    if is_dtensor(o):
        from torch.distributed.tensor import Shard
        mesh = o.device_mesh
        if list(g.placements) != list(o.placements):
            g = g.redistribute(mesh, list(o.placements))
        want = [Shard(0) if i in heads else q
                for i, q in enumerate(out.placements)]
        if list(out.placements) != want:
            out = out.redistribute(mesh, want)
    return shard_ops.matmul(rmsnorm(o, p["ln_x"], cfg.norm_eps) * g, out)


def _scan(cfg: ModelConfig, chunk: int, r, k, v, w0, lw, u, S0=None):
    """The chunked WKV6 on whole tensors or one device's rows and heads
    -> (o (b,S,nh*hd), S_final)."""
    logw = _logw(w0, lw)
    if cfg.ssm_impl == "pallas":
        o, S_fin = wkv_ops.wkv6(r, k, v, logw.to(cfg.dtype),
                                u.to(cfg.dtype), chunk=chunk, S0=S0)
    else:
        o, S_fin = wkv6_chunked(r, k, v, logw, u, chunk=chunk, S0=S0)
    return o.flatten(2), S_fin


def rwkv6_seq(p: dict, cfg: ModelConfig, x: torch.Tensor,
              shift_prev: torch.Tensor | None = None,
              S0: torch.Tensor | None = None, return_state: bool = False):
    """Full-sequence RWKV6 time-mix.  x: (B,S,d).  On DTensors the scan
    runs on each device's rows and heads (``_ROLES``)."""
    r, k, v, g, lw = _time_mix_inputs(p, cfg, x, _token_shift(x,
                                                              shift_prev))
    chunk = cfg.ssm.chunk if cfg.ssm else 64
    L = shard_ops.rows_heads_layouts(x, p["u"], _ROLES)
    rkv, hh, S = L["rkv"], L["head"], L["S"]
    o, S_fin = shard_ops.local_map(
        functools.partial(_scan, cfg, chunk),
        (r, k, v, p["w0"], lw, p["u"], S0),
        (rkv, rkv, rkv, hh, rkv, hh, S), (rkv, S))
    out = _out(p, cfg, o, g, L["heads"])
    if return_state:
        return out, (x[:, -1:], S_fin)
    return out


def init_channel_mix(mk: ParamInit, cfg: ModelConfig,
                     stacked: int | None = None) -> dict:
    """RWKV channel-mix (the FFN of the RWKV stack):
    out = sigmoid(x_r W_r) * (relu(x_k W_k)^2 W_v)."""
    L = () if stacked is None else (stacked,)
    A = () if stacked is None else ("layers",)
    d, f, dt = cfg.d_model, cfg.d_ff, cfg.param_dtype
    return {
        "mix_k": mk((*L, d), dt, (*A, "embed"), init="zeros"),
        "mix_r": mk((*L, d), dt, (*A, "embed"), init="zeros"),
        "wk": mk((*L, d, f), dt, (*A, "embed", "mlp")),
        "wv": mk((*L, f, d), dt, (*A, "mlp", "embed")),
        "wr": mk((*L, d, d), dt, (*A, "embed", "embed")),
    }


def channel_mix(p: dict, cfg: ModelConfig, x: torch.Tensor,
                shift_prev: torch.Tensor | None = None) -> torch.Tensor:
    dt = cfg.dtype
    xs = _token_shift(x, shift_prev)
    (xa, xb), (xsa, xsb) = shard_ops.fan_out(x, 2), shard_ops.fan_out(xs, 2)
    xk = shard_ops.fan_out(_mix(xa, xsa, p["mix_k"].to(dt)), 1)[0]
    xr = shard_ops.fan_out(_mix(xb, xsb, p["mix_r"].to(dt)), 1)[0]
    k = torch.square(torch.relu(shard_ops.matmul(xk, p["wk"].to(dt))))
    kv = reduce_partial(shard_ops.matmul(k, p["wv"].to(dt)))
    return torch.sigmoid(shard_ops.matmul(xr, p["wr"].to(dt))) * kv


def init_rwkv6_state(cfg: ModelConfig, batch: int, mk: ParamInit,
                     stacked: int | None = None) -> dict:
    """Zero WKV states and token-shift carries, made by ``mk``."""
    nh, hd = _dims(cfg)
    L = () if stacked is None else (stacked,)
    A = () if stacked is None else ("layers",)
    shift, ax = (*L, batch, 1, cfg.d_model), (*A, "batch", None, "embed")
    return {"S": mk((*L, batch, nh, hd, hd), torch.float32,
                    (*A, "batch", "heads", None, None), init="zeros"),
            "shift_t": mk(shift, cfg.dtype, ax, init="zeros"),
            "shift_c": mk(shift, cfg.dtype, ax, init="zeros")}


def _step(r, k, v, w0, lw, u, S):
    """One token of WKV6 on whole tensors or one device's rows and heads:
    r, k, v, lw (b,1,nh,hd) -> (o (b,1,nh*hd), new S)."""
    logw = _logw(w0, lw)
    o, S = wkv6_step(r[:, 0], k[:, 0], v[:, 0], logw[:, 0], u, S)
    return o.flatten(1)[:, None], S


def rwkv6_decode(p: dict, cfg: ModelConfig, x: torch.Tensor, state: dict
                 ) -> torch.Tensor:
    """One-token time-mix decode.  x: (B,1,d); state: {"S", "shift"},
    updated in place (``shift`` becomes ``x``).  On DTensors the step
    runs on each device's rows and heads, as ``rwkv6_seq``'s scan."""
    r, k, v, g, lw = _time_mix_inputs(p, cfg, x, state["shift"])
    L = shard_ops.rows_heads_layouts(x, p["u"], _ROLES)
    rkv, hh, S = L["rkv"], L["head"], L["S"]
    o, S_new = shard_ops.local_map(
        _step, (r, k, v, p["w0"], lw, p["u"], state["S"]),
        (rkv, rkv, rkv, hh, rkv, hh, S), (rkv, S))
    state["S"].copy_(S_new)
    state["shift"].copy_(x)
    return _out(p, cfg, o, g, L["heads"])
