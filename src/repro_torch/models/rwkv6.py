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
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..kernels.rwkv6_scan import ops as wkv_ops
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


def _heads(x: torch.Tensor, w: torch.Tensor, dtype: torch.dtype
           ) -> torch.Tensor:
    """(B,S,d) x (d,nh,hd) -> (B,S,nh,hd), product in ``dtype``."""
    d, nh, hd = w.shape
    return (x @ w.to(dtype).reshape(d, nh * hd)).unflatten(-1, (nh, hd))


def _time_mix_inputs(p: dict, cfg: ModelConfig, x: torch.Tensor,
                     xs: torch.Tensor):
    """-> (r, k, v, g, logw float32), r/k/v/logw (B,S,nh,hd)."""
    dt = cfg.dtype
    xr, xk, xv, xw, xg = (_mix(x, xs, p[f"mix_{c}"].to(dt))
                          for c in "rkvwg")
    r = _heads(xr, p["wr"], dt)
    k = _heads(xk, p["wk"], dt)
    v = _heads(xv, p["wv"], dt)
    g = F.silu(xg @ p["wg"].to(dt))
    # data-dependent decay (negative log)
    lora = torch.tanh(xw) @ p["wa"].to(dt)
    wraw = p["w0"].float() + _heads(lora, p["wb"], dt).float()
    logw = -torch.exp(-0.5 + wraw)               # in (-inf, 0)
    return r, k, v, g, logw


def rwkv6_seq(p: dict, cfg: ModelConfig, x: torch.Tensor,
              shift_prev: torch.Tensor | None = None,
              S0: torch.Tensor | None = None, return_state: bool = False):
    """Full-sequence RWKV6 time-mix.  x: (B,S,d)."""
    r, k, v, g, logw = _time_mix_inputs(p, cfg, x, _token_shift(x,
                                                                shift_prev))
    chunk = cfg.ssm.chunk if cfg.ssm else 64
    if cfg.ssm_impl == "pallas":
        o, S_fin = wkv_ops.wkv6(r, k, v, logw.to(cfg.dtype),
                                p["u"].to(cfg.dtype), chunk=chunk, S0=S0)
    else:
        o, S_fin = wkv6_chunked(r, k, v, logw, p["u"], chunk=chunk, S0=S0)
    o = o.reshape(*x.shape[:2], cfg.d_model)
    o = rmsnorm(o, p["ln_x"], cfg.norm_eps) * g
    out = o @ p["out"].to(cfg.dtype)
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
    xk = _mix(x, xs, p["mix_k"].to(dt))
    xr = _mix(x, xs, p["mix_r"].to(dt))
    k = torch.square(torch.relu(xk @ p["wk"].to(dt)))
    kv = k @ p["wv"].to(dt)
    return torch.sigmoid(xr @ p["wr"].to(dt)) * kv


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


def rwkv6_decode(p: dict, cfg: ModelConfig, x: torch.Tensor, state: dict
                 ) -> torch.Tensor:
    """One-token time-mix decode.  x: (B,1,d); state: {"S", "shift"},
    updated in place (``shift`` becomes ``x``)."""
    r, k, v, g, logw = _time_mix_inputs(p, cfg, x, state["shift"])
    o, S = wkv6_step(r[:, 0], k[:, 0], v[:, 0], logw[:, 0], p["u"],
                     state["S"])
    state["S"].copy_(S)
    state["shift"].copy_(x)
    o = o.reshape(x.shape[0], 1, cfg.d_model)
    o = rmsnorm(o, p["ln_x"], cfg.norm_eps) * g
    return o @ p["out"].to(cfg.dtype)
